"""Device kernel launches in the traced window over the calls traced, in
the batched cells (an exact count)."""

from portbench.tracing import launches_per_call as read  # noqa: F401
