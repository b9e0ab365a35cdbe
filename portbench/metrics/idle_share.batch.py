"""Percent of the traced window in which the card ran no kernel and no
copy, in the batched cells: 1 - (kernels + copies) / wall."""

from portbench.tracing import idle_share as read  # noqa: F401
