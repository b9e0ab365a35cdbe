"""Grouped (cell-major) batched IVF search, the large-batch dispatch (port
of ``fastpyvectordb_tpu/ann/ivf_grouped.py``).

The (query -> probed cells) relation is inverted into a per-cell table of
query slots with one stable sort; every probed cell is then scored against
the queries probing it in one launch over the batch's compact list of
unique probed cells,

    (U, qcap, D) x cells[cell_ids[1:]] (U, cmax, D) -> (U, qcap, cmax),

so each probed cell is read once per batch however many queries probe it.
bf16 cells go through the ``grouped_cell_scores`` kernel, int8 cells
through ``grouped_cell_scores_i8`` (kernels/ivf_kernels.py); f32 cells go
through the plain batched product, as the JAX package sends them through
XLA.  Each query's pairs are then regrouped into one candidate row, merged
with the exact overflow scan, and either re-ranked exactly or top-k'd.

Probe priority under saturation is the JAX package's: pairs sort by
(cell, probe rank) and, at equal key, by query id (the sort is stable), so
a cell over ``qcap`` sheds its highest probe ranks, and at equal rank its
highest query ids, first.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.types import DistanceMetric
from ..kernels.distances import MASKED, mm_f32, smallest_k
from ..kernels.ivf_kernels import (grouped_cell_scores,
                                   grouped_cell_scores_i8,
                                   grouped_cell_scores_plain)
from ..profiling import annotate
from ..quant.scan import gather_rerank

__all__ = ["grouped_ivf_search_kernel", "grouped_cell_candidates",
           "grouped_qcap", "invert_pairs", "finish_grouped", "route",
           "probe_cells", "cell_score_args", "overflow_candidates",
           "select_candidates"]


def grouped_qcap(b: int, nprobe: int, nlist: int, cmax: int,
                 headroom: int = 8, budget_bytes: int = 2 << 30) -> int:
    """Per-cell query-slot capacity: pow2, ``headroom`` x the mean cell
    load, capped so an (nlist, qcap, cmax) f32 score tensor stays under
    ``budget_bytes``.  The JAX package's formula exactly: it decides which
    pairs a saturated cell sheds, and so decides results."""
    qcap_hbm = max(8, int(budget_bytes // max(nlist * cmax * 4, 1))
                   // 8 * 8)
    qcap = 8
    while qcap < min(headroom * b * nprobe / max(nlist, 1), b, qcap_hbm):
        qcap *= 2
    return int(min(qcap, qcap_hbm))


def route(qf: torch.Tensor, centroids: torch.Tensor,
          metric: DistanceMetric) -> torch.Tensor:
    """(B, nlist) routing scores, lower = better (f32 products)."""
    if metric == DistanceMetric.COSINE:
        qn = qf / torch.clamp(torch.linalg.norm(qf, dim=1, keepdim=True),
                              min=1e-30)
        cn = centroids / torch.clamp(
            torch.linalg.norm(centroids, dim=1, keepdim=True), min=1e-30)
        return -(qn @ cn.T)
    if metric == DistanceMetric.DOT:
        return -(qf @ centroids.T)
    csq = (centroids * centroids).sum(dim=1)
    return csq[None, :] - 2.0 * (qf @ centroids.T)


def probe_cells(croute: torch.Tensor, nprobe: int) -> torch.Tensor:
    """The ``nprobe`` best cells per query, best first, ties to the lower
    cell id (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(croute, dim=1, stable=True).indices[:, :nprobe]


def invert_pairs(probe: torch.Tensor, nlist: int, qcap: int) -> dict:
    """Invert (B, nprobe) probed cell ids, probe rank minor, into
    cell-major query-slot tables.  Keys and layouts as in the JAX package
    (all int64 here, ``cell_list`` int32 for the kernels):

      flat_cell (M,)  pair cell ids, original (B-major) order
      flat_q    (M,)  pair query ids, original order
      pair_rank (M,)  pair's slot rank within its cell
      pair_keep (M,)  pair survived qcap saturation
      dropped   ()    count of shed pairs
      qslot     (nlist, qcap) query id per slot, -1 = empty
      slot_q    (nlist, qcap) same, clamped to 0
      cell_list (U+1,) [n_uniq, compact -> cell ids...], U = min(nlist, M)
      qslot_c   (U, qcap) compact query slots, -1 = empty
      slot_qc   (U, qcap) same, clamped to 0
      cid_pair  (M,)  pair -> compact row
    """
    b, nprobe = probe.shape
    dev = probe.device
    m = b * nprobe
    flat_cell = probe.reshape(-1).long()
    flat_q = torch.arange(b, device=dev).repeat_interleave(nprobe)
    prank = torch.arange(nprobe, device=dev).repeat(b)
    # stable: equal (cell, rank) keys keep B-major order, so the lower
    # query id takes the lower slot, as with jnp.argsort
    order = torch.argsort(flat_cell * nprobe + prank, stable=True)
    scell = flat_cell[order]
    squery = flat_q[order]
    pos = torch.arange(m, device=dev)
    is_start = torch.ones((m,), dtype=torch.bool, device=dev)
    is_start[1:] = scell[1:] != scell[:-1]
    run_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank = pos - run_start
    keep = rank < qcap
    # ranks past qcap land in a spare column that is cut off (JAX scatters
    # with mode="drop"; filtering them out by mask would sync with the host)
    col = torch.clamp(rank, max=qcap)
    u = min(nlist, m)
    u_idx = torch.cumsum(is_start, dim=0) - 1

    def slots(rows, n):
        t = torch.full((n, qcap + 1), -1, dtype=torch.long, device=dev)
        t[rows, col] = squery
        return t[:, :qcap]

    qslot, qslot_c = slots(scell, nlist), slots(u_idx, u)
    inv = torch.empty_like(order)
    inv[order] = pos
    compact = torch.zeros((u,), dtype=torch.long, device=dev)
    compact[u_idx] = scell
    return {
        "flat_cell": flat_cell, "flat_q": flat_q,
        "pair_rank": rank[inv], "pair_keep": keep[inv],
        "dropped": (~keep).sum(),
        "qslot": qslot, "slot_q": torch.clamp(qslot, min=0),
        "cell_list": torch.cat([u_idx[-1:] + 1, compact]).to(torch.int32),
        "qslot_c": qslot_c, "slot_qc": torch.clamp(qslot_c, min=0),
        "cid_pair": u_idx[inv],
    }


def _qinv(qsq: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.clamp(torch.sqrt(qsq), min=1e-30)


def _qstats(qf: torch.Tensor):
    """The queries' (B,) squared norms and inverse norms."""
    qsq = (qf * qf).sum(dim=1)
    return qsq, _qinv(qsq)


def _metric_scores(metric: DistanceMetric, cross, vsq, qsq, qinv=None, *,
                   sqrt_l2: bool, rows=None):
    """Scores, lower = better, from cross terms ``q . x`` (R, C) and the
    rows' squared norms ``vsq`` (broadcast against ``cross``).  ``qsq`` /
    ``qinv`` are per query, (R,); with ``rows`` (R,) they are (B,) and
    ``rows`` names each cross row's query.  A missing ``qinv`` is derived
    from ``qsq`` where cosine needs it.  L2 stays squared unless
    ``sqrt_l2``."""
    if metric == DistanceMetric.COSINE:
        if qinv is None:
            qinv = _qinv(qsq)
        if rows is not None:
            qinv = qinv[rows]
        return 1.0 - cross * qinv[:, None] * torch.rsqrt(
            torch.clamp(vsq, min=1e-30))
    if metric == DistanceMetric.L2:
        if rows is not None:
            qsq = qsq[rows]
        d2 = torch.clamp(qsq[:, None] + vsq - 2.0 * cross, min=0.0)
        return torch.sqrt(d2) if sqrt_l2 else d2
    return -cross


def cell_score_args(qf, pairs: dict, cells, ok_cells, vmin, scale,
                    cell_norms, *, metric: DistanceMetric, qcap: int):
    """The score stage of one grouped batch as ``(fn, args)``: the scores
    function for the cell dtype (``grouped_cell_scores_i8`` for int8 cells,
    ``grouped_cell_scores`` for bf16, the plain batched product for f32)
    and its positional arguments in the compact slot layout of
    ``invert_pairs``; ``fn(*args, metric=metric)`` -> (U, qcap, cmax)."""
    b, d = qf.shape
    u = pairs["cell_list"].shape[0] - 1
    slot_qc = pairs["slot_qc"]
    qsq, qinv = _qstats(qf)
    if metric == DistanceMetric.COSINE:
        qstat_b = qinv
    elif metric == DistanceMetric.L2:
        qstat_b = qsq
    else:
        qstat_b = torch.zeros_like(qsq)
    head = (pairs["cell_list"],)
    tail = (cells, cell_norms, ok_cells.float())
    qstat = qstat_b[slot_qc]                                    # (U, qcap)
    if cells.dtype == torch.int8:
        # query-side scale folding (quant/scalar.py:folded_int_scores),
        # once per query before the slot gather
        rs = scale / 255.0
        qs = qf * rs[None, :]
        const = qf @ (128.0 * rs + vmin)
        qscale = torch.clamp(qs.abs().max(dim=1, keepdim=True).values,
                             min=1e-30) / 127.0
        qi = torch.clamp(torch.round(qs / qscale), -127, 127).to(torch.int8)
        qblk = qi[slot_qc.reshape(-1)].reshape(u, qcap, d)
        return grouped_cell_scores_i8, (*head, qblk, *tail,
                                        qscale[:, 0][slot_qc],
                                        const[slot_qc], qstat)
    qblk = qf.to(cells.dtype)[slot_qc.reshape(-1)].reshape(u, qcap, d)
    fn = (grouped_cell_scores if cells.dtype == torch.bfloat16
          else grouped_cell_scores_plain)
    return fn, (*head, qblk, *tail, qstat)


def grouped_cell_candidates(qf, croute, cells, row_table, ok_cells, vmin,
                            scale, cell_norms, *, metric: DistanceMetric,
                            nprobe: int, qcap: int):
    """Probe -> invert -> one launch over the probed cells -> regroup.
    Returns ``(cand_vals (B, nprobe*cmax) f32 lower=better (L2 squared),
    cand_rows (B, nprobe*cmax) from row_table, dropped)``."""
    b = qf.shape[0]
    nlist, cmax = row_table.shape
    with annotate("fpv.ann.route"):
        probe = probe_cells(croute, nprobe)
    with annotate("fpv.ann.invert"):
        pairs = invert_pairs(probe, nlist, qcap)
    del probe   # a view that holds the whole (B, nlist) sort
    with annotate("fpv.ann.score"):
        fn, args = cell_score_args(qf, pairs, cells, ok_cells, vmin, scale,
                                   cell_norms, metric=metric, qcap=qcap)
        s = fn(*args, metric=metric)
    with annotate("fpv.ann.regroup"):
        # each pair's own score row, then one candidate row per query
        u = s.shape[0]
        flat_slot = pairs["cid_pair"] * qcap + torch.clamp(
            pairs["pair_rank"], max=qcap - 1)
        pv = s.reshape(u * qcap, cmax)[flat_slot]
        pv = torch.where(pairs["pair_keep"][:, None], pv,
                         torch.full((), float(MASKED), device=pv.device))
        pr = row_table[pairs["flat_cell"]]
        return (pv.reshape(b, nprobe * cmax), pr.reshape(b, nprobe * cmax),
                pairs["dropped"])


def overflow_candidates(qf, overflow_vecs, overflow_rows, ok_overflow, *,
                        metric: DistanceMetric, k: int, compute_dtype: str):
    """The overflow block scored exactly: (vals (B, o'), rows (B, o')),
    lower = better (L2 squared), pre-reduced to each query's best k where
    the block holds more than 4k rows.  The block must not be empty."""
    b = qf.shape[0]
    cd = getattr(torch, compute_dtype)
    o = overflow_rows.shape[0]
    qsq, qinv = _qstats(qf)
    of = overflow_vecs.float()
    ovsq = (of * of).sum(dim=1)
    ocross = mm_f32(qf.to(cd), overflow_vecs.to(cd))
    os_ = _metric_scores(metric, ocross, ovsq[None, :], qsq, qinv,
                         sqrt_l2=False)
    os_ = torch.where(ok_overflow[None, :], os_,
                      torch.full((), float(MASKED), device=qf.device))
    # pre-reduce a big overflow block to k per query before the merge
    if o > 4 * max(k, 1):
        os_, opos = smallest_k(os_, min(k, o))
        return os_, overflow_rows[opos]
    return os_, overflow_rows[None].expand(b, o)


def finish_grouped(qf, cand_vals, cand_rows, overflow_vecs, overflow_rows,
                   ok_overflow, vectors, *, metric: DistanceMetric, k: int,
                   rerank: int, compute_dtype: str):
    """Exact-score the overflow block, merge it into the candidates, then
    ``select_candidates``."""
    if overflow_rows.shape[0] > 0:
        os_, orows_b = overflow_candidates(
            qf, overflow_vecs, overflow_rows, ok_overflow, metric=metric,
            k=k, compute_dtype=compute_dtype)
        cand_vals = torch.cat([cand_vals, os_], dim=1)
        cand_rows = torch.cat([cand_rows, orows_b.to(cand_rows.dtype)], dim=1)
    return select_candidates(qf, cand_vals, cand_rows, vectors, metric=metric,
                             k=k, rerank=rerank, compute_dtype=compute_dtype)


def select_candidates(qf, cand_vals, cand_rows, vectors, *,
                      metric: DistanceMetric, k: int, rerank: int,
                      compute_dtype: str):
    """Exact-re-rank the top rerank*k candidates against ``vectors``, or
    take the top-k directly.  L2 candidates arrive squared and leave
    sqrt'd."""
    if rerank > 0 and vectors is not None:
        c = int(min(max(k, k * rerank), cand_vals.shape[1]))
        cvals, cpos = smallest_k(cand_vals, c)
        crows = torch.take_along_dim(cand_rows, cpos, dim=1)
        return gather_rerank(qf, cvals, crows, vectors, metric, min(k, c),
                             compute_dtype)
    vals, pos = smallest_k(cand_vals, min(k, cand_vals.shape[1]))
    rows = torch.take_along_dim(cand_rows, pos, dim=1)
    if metric == DistanceMetric.L2:
        vals = torch.where(vals >= float(MASKED) * 0.5, vals,
                           torch.sqrt(torch.clamp(vals, min=0.0)))
    return vals, rows


def grouped_ivf_search_kernel(q, centroids, cells, row_table, overflow_vecs,
                              overflow_rows, ok_cells, ok_overflow, vmin,
                              scale, cell_norms,
                              vectors: Optional[torch.Tensor] = None, *,
                              metric: DistanceMetric, k: int, nprobe: int,
                              qcap: int, compute_dtype: str = "bfloat16",
                              rerank: int = 0):
    """Returns (dists (B, k) f32, rows (B, k), dropped) as device tensors."""
    qf = q.float()
    with annotate("fpv.ann.route"):
        croute = route(qf, centroids, metric)
    cand_vals, cand_rows, dropped = grouped_cell_candidates(
        qf, croute, cells, row_table, ok_cells, vmin, scale, cell_norms,
        metric=metric, nprobe=nprobe, qcap=qcap)
    del croute
    with annotate("fpv.ann.finish"):
        vals, rows = finish_grouped(
            qf, cand_vals, cand_rows, overflow_vecs, overflow_rows,
            ok_overflow, vectors, metric=metric, k=k, rerank=rerank,
            compute_dtype=compute_dtype)
    return vals, rows, dropped
