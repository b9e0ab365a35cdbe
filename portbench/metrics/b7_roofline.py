"""Share of its roofline that the grouped IVF-PQ ADC kernel
(``fpv_grouped_cell_scores_pq``, B7: its plan kernel and its main kernel)
reaches: the bound of the traced batches' probes (``b7_cost``) over the two
kernels' device time, in percent.

The bound is the larger of the bytes at the card's HBM rate and the adds at
its float32 rate outside the tensor cores (NVIDIA's H100 SXM data sheet,
67 TFLOP/s, an add one operation).  Bytes: each probed cell's live codes
once (M bytes a row), one bf16 table a query (M x K entries), one f32 sum
a (pair, live row); adds: M a (pair, live row).  Pairs a saturated cell
sheds are counted as work, so where a batch sheds, the share reads high.

Which cells a batch probes depends on the index, so the probes are worked
out here again by the index's own rule (``reference_ivfpq.probed``: q.c
over ||c|| for cosine, ties to the lower cell), each cell's live rows from
its row table.  The index is read only through what it reports and saves
(``stats()`` and ``export_sections()``).  The traced answers hold the rule
to the program, as ``b3_roofline`` does: every row they return has to lie
in one of its query's recomputed cells (``SLACK`` more allowed) or in the
overflow block; where one does not, the reader says so on stderr and
returns nothing."""

import sys

import numpy as np
import torch

from portbench import reference_ivfpq, roofline, spec
from portbench.tracing import matcher

KERNELS = matcher(r"::pq_kernel<|::plan_kernel\(")
FP32_FLOPS_PER_S = 67e12
SLACK = 4


def b7_cost(m: int, k: int, b: int, cell_rows, pair_rows):
    """(adds, bytes) of one batch of ``b`` queries: ``cell_rows`` the live
    rows of each distinct probed cell, ``pair_rows`` those of the cell of
    each (query, probed cell) pair; M subspaces of K codes."""
    pair_sum = float(np.sum(pair_rows))
    adds = m * pair_sum
    nbytes = float(np.sum(cell_rows)) * m + 2.0 * b * m * k + 4.0 * pair_sum
    return adds, nbytes


def read(ctx):
    t_us = ctx.trace.kernel_us(KERNELS)
    if t_us <= 0:
        return None
    index = ctx.collection._ann
    stats = index.stats()
    sections, _ = index.export_sections()
    nprobe, m, k = int(stats["nprobe"]), int(stats["m"]), int(stats["pq_k"])
    table = np.asarray(sections["ann_row_table"])
    overflow = np.asarray(sections["ann_overflow_rows"])
    live = (table >= 0).sum(axis=1)
    centroids = torch.as_tensor(np.asarray(sections["ann_centroids"],
                                           np.float32))
    outside = spec.reader("b3_roofline").outside
    bound, stray = 0.0, 0
    for q, answer in zip(ctx.queries, ctx.answers):
        with reference_ivfpq.exact_f32():
            _, wide = reference_ivfpq.probed(
                centroids, torch.as_tensor(np.asarray(q, np.float32)),
                nprobe + SLACK, ctx.config["metric"])
        wide = wide.numpy()
        stray += outside(wide, np.asarray(answer[2]), table, overflow)
        probe = wide[:, :nprobe]
        adds, nbytes = b7_cost(m, k, q.shape[0], live[np.unique(probe)],
                               live[probe.reshape(-1)])
        bound += max(adds / FP32_FLOPS_PER_S,
                     nbytes / roofline.HBM_BYTES_PER_S)
    if stray:
        print(f"b7_roofline: {stray} returned rows lie outside the probes "
              "worked out here; the program's routing has changed, so the "
              "metric is left out", file=sys.stderr)
        return None
    return 100.0 * bound / (t_us * 1e-6)
