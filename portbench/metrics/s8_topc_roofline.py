"""Share of its roofline that the fused int8 scan (``s8_topc``: the scan
kernel with its top-c epilogue, and its merge kernel) reaches: the bound of
the traced calls' shapes (``roofline.s8_topc_cost``: b queries, the corpus's
rows, d dims, c = k x re-rank candidates) over the two kernels' device
time, in percent."""

from portbench import roofline
from portbench.tracing import matcher

KERNELS = matcher(r"S8TopcOp|topc_merge_kernel")


def read(ctx):
    t_us = ctx.trace.kernel_us(KERNELS)
    if t_us <= 0:
        return None
    rerank = int(ctx.config["index"]["search"]["kwargs"]["rerank"])
    bound = sum(roofline.bound_s(*roofline.s8_topc_cost(
        q.shape[0], ctx.rows, ctx.dims, ctx.k * rerank),
        roofline.INT8_OPS_PER_S) for q in ctx.queries)
    return 100.0 * bound / (t_us * 1e-6)
