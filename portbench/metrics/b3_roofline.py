"""Share of its roofline that the grouped int8 cell-score kernel
(``fpv_grouped_cell_scores_i8``, B3) reaches: the bound of the traced
batches' probes (``roofline.b3_cost``) over the kernel's device time, in
percent.

Which cells a batch probes depends on the index, so the probes are worked
out here again (``reference.probed_cells``: each query's ``nprobe``
closest centroids by cosine in float32, ties to the lower cell), each
cell's live rows from its row table.  The index is read only through what it reports and saves
(``stats()`` and ``export_sections()``: centroids, row table, overflow
rows, nprobe), never through its attributes; nothing it computes for a
search is read.

This rule is the program's routing as it stands.  The traced answers hold
it to that: every row they return has to lie in one of its query's
recomputed cells or in the overflow block (``SLACK`` cells more are
allowed, for near-ties that the card's products order otherwise).  Where
one does not (the program routes otherwise now), the reader says so on
stderr and returns nothing, so the metric goes silent instead of
wrong."""

import sys

import numpy as np

from portbench import roofline
from portbench.reference import probed_cells
from portbench.tracing import matcher

KERNELS = matcher(r"(stream_kernel|grouped_kernel)<signed char")
SLACK = 4


def outside(probe: np.ndarray, rows: np.ndarray, table: np.ndarray,
            overflow: np.ndarray) -> int:
    """Returned rows (>= 0) in neither a probed cell of their query nor the
    overflow block."""
    top = int(max(table.max(initial=-1), overflow.max(initial=-1),
                  rows.max(initial=-1))) + 1
    cell_of = np.full(top, -1, np.int64)
    cells, _ = np.nonzero(table >= 0)
    cell_of[table[table >= 0]] = cells
    cell_of[overflow[overflow >= 0]] = -2
    hit = rows >= 0
    c = cell_of[np.where(hit, rows, 0)]
    probed = (c[:, :, None] == probe[:, None, :]).any(axis=2)
    return int((hit & (c != -2) & ~probed).sum())


def read(ctx):
    t_us = ctx.trace.kernel_us(KERNELS)
    if t_us <= 0:
        return None
    index = ctx.collection._ann
    sections, _ = index.export_sections()
    nprobe = int(index.stats()["nprobe"])
    table = np.asarray(sections["ann_row_table"])
    overflow = np.asarray(sections["ann_overflow_rows"])
    live = (table >= 0).sum(axis=1)
    bound, stray = 0.0, 0
    for q, answer in zip(ctx.queries, ctx.answers):
        wide = probed_cells(sections["ann_centroids"], q, nprobe + SLACK)
        stray += outside(wide, np.asarray(answer[2]), table, overflow)
        probe = wide[:, :nprobe]
        pair_rows = live[probe.reshape(-1)]
        cell_rows = live[np.unique(probe)]
        bound += roofline.bound_s(*roofline.b3_cost(ctx.dims, cell_rows,
                                                    pair_rows),
                                  roofline.INT8_OPS_PER_S)
    if stray:
        print(f"b3_roofline: {stray} returned rows lie outside the probes "
              "worked out here; the program's routing has changed, so the "
              "metric is left out", file=sys.stderr)
        return None
    return 100.0 * bound / (t_us * 1e-6)
