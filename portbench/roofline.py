"""The yardstick of the kernels' roofline shares: the card's published
peaks and, for each kernel, the operations and bytes that a call's inputs
need, worked out from their shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit (the
run prints the card's own limit beside each share).  Bytes count each
input byte the work needs once and each needed output byte once, whatever
a kernel reads again or pads; operations count the multiply-adds the
inputs need (2 each).
"""

from __future__ import annotations

from typing import Sequence, Tuple

INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, peak_ops: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / peak_ops, nbytes / HBM_BYTES_PER_S)


def s8_topc_cost(b: int, n: int, d: int, c: int) -> Tuple[float, float]:
    """The fused int8 scan with its top-c (``s8_topc`` and its merge):
    b int8 queries against n int8 code rows of d dims, c candidates each.
    Bytes: the codes, one f32 row statistic a row, the int8 queries, and c
    (f32 score, i32 row) pairs out a query."""
    ops = 2.0 * b * n * d
    nbytes = n * d + 4.0 * n + b * d + 8.0 * b * c
    return ops, nbytes


def b3_cost(d: int, cell_rows: Sequence[int], pair_rows: Sequence[int]
            ) -> Tuple[float, float]:
    """The grouped int8 cell scores (``fpv_grouped_cell_scores_i8``) of one
    batch: ``cell_rows`` the live rows of each distinct probed cell,
    ``pair_rows`` those of the cell of each (query, probed cell) pair.
    Bytes: each probed cell's codes and f32 norms once, one int8 query a
    pair, one f32 score a (pair, row)."""
    pair_sum = float(sum(pair_rows))
    ops = 2.0 * d * pair_sum
    nbytes = float(sum(cell_rows)) * (d + 4) + len(pair_rows) * d \
        + 4.0 * pair_sum
    return ops, nbytes
