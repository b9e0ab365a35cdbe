"""The 95th percentile of the batched calls' latencies on the host clock,
over the window's calls outside the traced stretch, in milliseconds: the
tail that ``p95_ms`` reports end to end, kept per layer in the cells where
it swings too widely between runs to carry a bound (see ``PERF.md``)."""

from portbench.harness import p95_ms


def read(ctx):
    if not ctx.latency_s:
        return None
    return p95_ms(ctx.latency_s)
