"""The plain IVF-PQ reference: an IVF-PQ search in float32 ``torch`` from an
index's saved sections and the corpus, and the comparison of the program's
answers and candidates with it.  It imports nothing of the program and
nothing of JAX; products run with TF32 off (``exact_f32``).

An index is what its ``export_sections()`` saves (``Index``): the centroids
(nlist, D), the codebooks (M, K, D / M), the PQ codes (nlist * cmax, M) of
each row's residual to its cell's centroid, each slot's reconstruction
norm ||centroid + decode(codes)||^2, the row table (nlist, cmax) padded
with -1 and the overflow rows padded with -1.  ``search`` follows the
index's semantics:

- routing by the index's rule for the metric: q.c over ||c|| (cosine), q.c
  (dot), -(||c||^2 - 2 q.c) (l2); the ``nprobe`` best cells, ties to the
  lower cell;
- optionally (``qcap``) the grouped dispatch's shedding: pairs sort by
  (cell, probe rank), then by query, and a cell keeps its first ``qcap``;
- each probed slot's ADC score: cross = q.c + sum_m lut[m, code_m], with
  lut[m, k] = q_m . codebook[m, k], the sum in f32 over m in order; then
  cosine 1 - cross / (||q|| sqrt(norm)), l2 the squared distance, dot
  -cross; empty slots and shed pairs drop out;
- the overflow rows scored exactly in f32 (with ``grouped``, a block of
  more than 4k rows pre-reduced to each query's best k, as the grouped
  dispatch does before the merge);
- the top c = rerank * k, then the exact re-rank of their rows in f32 and
  the top k (cosine ``1 - cos``, l2 the euclidean distance, dot ``-q.v``;
  lower is closer).

Departures from the program: the table is float32 here, where the grouped
dispatch stages it in bfloat16 on the card and on the CPU (the per-query
dispatch gathers float32 entries); sums and products may run in another
order.  ``compare`` turns each into a tolerance (``entry_bound``):

- ``adc_excess``: over the program's candidates (the rows it handed to its
  re-rank, with the scores it selected them by), the largest |program
  score - reference score| as a share of that candidate's own bound: the
  sum over its M table entries of half a bf16 ulp of each (zero for a
  float32 table), plus float32 rounding of the sums and products, in the
  score's units.  A sound program reads at most 1.  A table in fp8 (four
  significant bits to bf16's eight) or a dropped subspace reads far above.
- ``boundary_gap``: the largest amount by which a program candidate's
  reference score lies past the reference's c-th score, against
  2 x M x half a bf16 ulp of the largest entry of the query's table (the
  most a bf16 table can move a candidate and the boundary), in the score's
  units.
- ``missed``: the share of the reference's final top k that the program's
  answers leave out, against the share that rounding can explain: a
  reference top-k row within the bf16 band of the c-th score, a program
  answer from outside the reference's top c (it displaces one), or an
  exact distance within float32 rounding of the reference's (k+1)-th.  No
  query may miss more than it can explain.

The corpus stays on the host; rows move to the device a block of queries
at a time, so at 10M rows the reference fits on the card beside nothing
else.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import numpy as np
import torch

U32 = 2.0 ** -24        # half an ulp of 1.0 in float32
BF16_BITS = 8           # significant bits of a bfloat16
BLOCK_QUERIES = 32


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Index:
    """An IVF-PQ index's sections on ``device``."""

    def __init__(self, sections: dict, device):
        t = lambda a: torch.as_tensor(np.asarray(a)).to(device)  # noqa: E731
        self.device = device
        self.centroids = t(sections["ann_centroids"]).float()
        self.codebooks = t(sections["ann_codebooks"]).float()
        self.m, self.kk, self.ds = self.codebooks.shape
        table = t(sections["ann_row_table"]).long()
        self.nlist, self.cmax = table.shape
        self.table = table.reshape(-1)                        # slot -> row
        # (M, slots): one subspace's codes contiguous
        self.codes = t(sections["ann_pq_codes"]).reshape(-1, self.m).T \
            .contiguous()
        self.norms = t(sections["ann_pq_norms"]).float().reshape(-1)
        over = t(sections["ann_overflow_rows"]).long()
        self.overflow = over[over >= 0]
        n = int(max(self.table.max().item(),
                     self.overflow.max().item() if self.overflow.numel()
                     else -1)) + 1
        self.slot_of = torch.full((n,), -1, dtype=torch.long, device=device)
        live = self.table >= 0
        self.slot_of[self.table[live]] = torch.nonzero(live)[:, 0]
        self.in_overflow = torch.zeros((n,), dtype=torch.bool, device=device)
        self.in_overflow[self.overflow] = True
        live_norms = self.norms[live]
        self.rinv_max = float(torch.rsqrt(torch.clamp(
            live_norms, min=1e-30)).max()) if live_norms.numel() else 1.0


def route(centroids: torch.Tensor, q: torch.Tensor, metric: str):
    """(q.c (B, nlist), priority (B, nlist) higher = better)."""
    qc = q @ centroids.T
    if metric == "cosine":
        cn = torch.clamp(torch.linalg.norm(centroids, dim=1), min=1e-30)
        return qc, qc / cn[None, :]
    if metric == "dot":
        return qc, qc
    if metric == "l2":
        csq = (centroids * centroids).sum(dim=1)
        return qc, -(csq[None, :] - 2.0 * qc)
    raise ValueError(f"unknown metric {metric!r}")


def probed(centroids: torch.Tensor, q: torch.Tensor, nprobe: int,
           metric: str):
    """(q.c, the ``nprobe`` best cells (B, nprobe), best first)."""
    qc, prio = route(centroids, q, metric)
    return qc, torch.sort(-prio, dim=1, stable=True).indices[:, :nprobe]


def kept_pairs(probe: torch.Tensor, qcap: Optional[int]) -> torch.Tensor:
    """(B, nprobe) bool: the pairs a cell of ``qcap`` query slots keeps,
    pairs sorted by (cell, probe rank), then by query (None: all)."""
    if qcap is None:
        return torch.ones(probe.shape, dtype=torch.bool, device=probe.device)
    b, p = probe.shape
    cell = probe.reshape(-1)
    rank = torch.arange(p, device=probe.device).repeat(b)
    order = torch.argsort(cell * p + rank, stable=True)
    sc = cell[order]
    pos = torch.arange(sc.numel(), device=probe.device)
    start = torch.ones_like(sc, dtype=torch.bool)
    start[1:] = sc[1:] != sc[:-1]
    first = torch.cummax(torch.where(start, pos, 0), dim=0).values
    keep = torch.empty_like(start)
    keep[order] = (pos - first) < qcap
    return keep.reshape(b, p)


def tables(index: Index, q: torch.Tensor, absolute: bool = False
           ) -> torch.Tensor:
    """(B, M, K) f32: lut[b, m, k] = q_m . codebook[m, k] (``absolute``:
    |q_m| . |codebook[m, k]|, what bounds the products' rounding)."""
    qs = q.reshape(q.shape[0], index.m, index.ds)
    cb = index.codebooks
    if absolute:
        qs, cb = qs.abs(), cb.abs()
    return (qs[:, :, None, :] * cb[None]).sum(dim=3)


def half_ulp(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Half an ulp of |x| in a float format of ``bits`` significant bits
    (0 at 0)."""
    _, e = torch.frexp(x.abs())
    return torch.where(x != 0, torch.ldexp(torch.ones_like(x), e - bits - 1),
                       torch.zeros_like(x))


def _adc(index: Index, lut: torch.Tensor, slots: torch.Tensor,
         table_bits: Optional[int]):
    """For each query's ``slots`` (B, S): the ADC sum over m in order, the
    sum of |entries| and the sum of the entries' half ulps in a table of
    ``table_bits`` (None: float32, zeros)."""
    acc = torch.zeros(slots.shape, dtype=torch.float32, device=slots.device)
    mag = torch.zeros_like(acc)
    ulp = torch.zeros_like(acc)
    safe = torch.clamp(slots, min=0)
    for j in range(index.m):
        e = torch.gather(lut[:, j, :], 1, index.codes[j][safe].long())
        acc += e
        mag += e.abs()
        if table_bits is not None:
            ulp += half_ulp(e, table_bits)
    return acc, mag, ulp


def _metric(cross, qsq, vsq, metric: str) -> torch.Tensor:
    """Candidate scores, lower = closer (l2 squared)."""
    if metric == "cosine":
        return 1.0 - cross / (torch.sqrt(qsq) * torch.sqrt(
            torch.clamp(vsq, min=1e-30)))
    if metric == "l2":
        return torch.clamp(qsq + vsq - 2.0 * cross, min=0.0)
    return -cross


def _scale(qsq, vsq, metric: str):
    """d score / d cross, in magnitude."""
    if metric == "cosine":
        return 1.0 / (torch.sqrt(torch.clamp(qsq, min=1e-30))
                      * torch.sqrt(torch.clamp(vsq, min=1e-30)))
    return torch.full_like(vsq, 2.0 if metric == "l2" else 1.0)


def _exact(q: torch.Tensor, v: torch.Tensor, metric: str) -> torch.Tensor:
    """(b, r) exact distances of (b, r, D) rows, lower = closer."""
    cross = torch.bmm(v, q[:, :, None])[:, :, 0]
    if metric == "cosine":
        return 1.0 - cross / (torch.linalg.norm(q, dim=1, keepdim=True)
                              * torch.linalg.norm(v, dim=2))
    if metric == "l2":
        return torch.sqrt(torch.clamp(
            (q * q).sum(1, keepdim=True) + (v * v).sum(2) - 2.0 * cross,
            min=0.0))
    return -cross


def _rows(corpus: np.ndarray, rows: torch.Tensor, device) -> torch.Tensor:
    r = rows.cpu().numpy()
    v = corpus[np.clip(r, 0, None).reshape(-1)].reshape(
        r.shape + (corpus.shape[1],))
    return torch.as_tensor(np.ascontiguousarray(v, np.float32)).to(device)


class _Block:
    """One block of queries: routing, kept pairs (``keep``, the batch's; None
    keeps all) and tables."""

    def __init__(self, index: Index, q: torch.Tensor, metric: str,
                 nprobe: int, keep: Optional[torch.Tensor]):
        self.qc, self.probe = probed(index.centroids, q, nprobe, metric)
        self.keep = kept_pairs(self.probe, None) if keep is None else keep
        self.lut = tables(index, q)
        self.qsq = (q * q).sum(dim=1, keepdim=True)


def _kept(index: Index, q: torch.Tensor, nprobe: int, metric: str,
          qcap: Optional[int]) -> Optional[torch.Tensor]:
    """The whole batch's kept pairs under ``qcap`` (None: no shedding)."""
    if qcap is None:
        return None
    return kept_pairs(probed(index.centroids, q, nprobe, metric)[1], qcap)


def search(index: Index, corpus: np.ndarray, queries: np.ndarray, k: int,
           metric: str, nprobe: int, rerank: int, *, grouped: bool = True,
           qcap: Optional[int] = None, block: int = BLOCK_QUERIES
           ) -> Dict[str, np.ndarray]:
    """The reference search of ``queries`` (as the program pads them:
    ``qcap``'s shedding counts every query given).  Returns numpy arrays:
    ``rows`` / ``dists`` (B, k), the top c ``cand_rows`` / ``cand_scores``
    (B, c) and ``cth`` (B,) the c-th candidate score, ``exact`` (B, c) the
    candidates' exact distances ascending, ``table_max`` (B,) the largest
    |entry| of each query's table."""
    dev = index.device
    with exact_f32():
        q_all = torch.as_tensor(np.ascontiguousarray(queries, np.float32)
                                ).to(dev)
        keep_all = _kept(index, q_all, nprobe, metric, qcap)
        over_v = _rows(corpus, index.overflow, dev)
        over_sq = (over_v * over_v).sum(1)[None, :]
        out: Dict[str, list] = {}
        for s in range(0, q_all.shape[0], block):
            q = q_all[s:s + block]
            b = q.shape[0]
            blk = _Block(index, q, metric, nprobe, None if keep_all is None
                         else keep_all[s:s + b])
            slots = (blk.probe[:, :, None] * index.cmax + torch.arange(
                index.cmax, device=dev)).reshape(b, -1)
            acc, _, _ = _adc(index, blk.lut, slots, None)
            cross = blk.qc.gather(1, blk.probe).repeat_interleave(
                index.cmax, dim=1) + acc
            sc = _metric(cross, blk.qsq, index.norms[slots], metric)
            rows = index.table[slots]
            live = (rows >= 0) & blk.keep.repeat_interleave(index.cmax, dim=1)
            sc = torch.where(live, sc, torch.full_like(sc, float("inf")))
            orows = index.overflow[None].expand(b, -1)
            osc = _metric(q @ over_v.T, blk.qsq, over_sq, metric)
            if grouped and osc.shape[1] > 4 * max(k, 1):
                osc, pos = torch.topk(osc, k, dim=1, largest=False)
                orows = torch.take_along_dim(orows, pos, dim=1)
            sc = torch.cat([sc, osc], dim=1)
            rows = torch.cat([rows, orows], dim=1)
            c = min(rerank * k, sc.shape[1])
            cs, pos = torch.topk(sc, c, dim=1, largest=False)
            cr = torch.take_along_dim(rows, pos, dim=1)
            ex = _exact(q, _rows(corpus, cr, dev), metric)
            ex = torch.where(torch.isfinite(cs), ex,
                             torch.full_like(ex, float("inf")))
            ex, order = torch.sort(ex, dim=1, stable=True)
            for name, v in (("rows", torch.take_along_dim(cr, order, 1)[:, :k]),
                            ("dists", ex[:, :k]), ("cand_rows", cr),
                            ("cand_scores", cs), ("cth", cs[:, -1]),
                            ("exact", ex),
                            ("table_max", blk.lut.abs().amax(dim=(1, 2)))):
                out.setdefault(name, []).append(v.cpu())
    return {name: torch.cat(v).numpy() for name, v in out.items()}


def candidate_scores(index: Index, corpus: np.ndarray, queries: np.ndarray,
                     rows: np.ndarray, metric: str, nprobe: int, *,
                     qcap: Optional[int] = None, table_bits: Optional[int]
                     = BF16_BITS, block: int = BLOCK_QUERIES
                     ) -> Dict[str, np.ndarray]:
    """The reference's candidate score of each query's ``rows`` (B, r):
    ``score`` (ADC for a row of a probed, kept cell, exact for an overflow
    row, inf for any other row) and ``bound``, the most the program's score
    of that candidate may differ from it: its entries' half ulps in a table
    of ``table_bits`` significant bits (None: a float32 table) plus float32
    rounding, in the score's units."""
    dev = index.device
    out: Dict[str, list] = {"score": [], "bound": []}
    with exact_f32():
        q_all = torch.as_tensor(np.ascontiguousarray(queries, np.float32)
                                ).to(dev)
        keep_all = _kept(index, q_all, nprobe, metric, qcap)
        r_all = torch.as_tensor(np.asarray(rows, np.int64)).to(dev)
        for s in range(0, q_all.shape[0], block):
            q, r = q_all[s:s + block], r_all[s:s + block]
            b = q.shape[0]
            rr = torch.clamp(r, min=0, max=index.slot_of.numel() - 1)
            blk = _Block(index, q, metric, nprobe, None if keep_all is None
                         else keep_all[s:s + b])
            slot = index.slot_of[rr]
            cell = torch.clamp(slot, min=0) // index.cmax
            hit = (blk.probe[:, None, :] == cell[:, :, None]) & \
                blk.keep[:, None, :]
            reach = (slot >= 0) & (r >= 0) & hit.any(dim=2)
            acc, mag, ulp = _adc(index, blk.lut, slot, table_bits)
            absacc, _, _ = _adc(index, tables(index, q, absolute=True), slot,
                                None)
            qc = blk.qc.gather(1, cell)
            vsq = index.norms[torch.clamp(slot, min=0)]
            sc = _metric(qc + acc, blk.qsq, vsq, metric)
            # float32 rounding: the D-term product q.c, the M-term sum, the
            # table's own ds-term products, the epilogue
            qcabs = (q.abs() @ index.centroids.abs().T).gather(1, cell)
            f32 = 2 * U32 * (q.shape[1] * qcabs + index.m * mag
                             + index.ds * absacc)
            bound = (ulp + f32) * _scale(blk.qsq, vsq, metric) \
                + 16 * U32 * (1.0 + sc.abs())
            # overflow rows: the exact score and float32 rounding
            over = index.in_overflow[rr] & (r >= 0)
            v = _rows(corpus, torch.where(over, r, 0), dev)
            cross = torch.bmm(v, q[:, :, None])[:, :, 0]
            vsq_o = (v * v).sum(2)
            osc = _metric(cross, blk.qsq, vsq_o, metric)
            vabs = torch.bmm(v.abs(), q.abs()[:, :, None])[:, :, 0]
            obound = 2 * U32 * q.shape[1] * vabs * _scale(
                blk.qsq, vsq_o, metric) + 16 * U32 * (1.0 + osc.abs())
            inf = torch.full_like(sc, float("inf"))
            out["score"].append(torch.where(
                over, osc, torch.where(reach, sc, inf)).cpu())
            out["bound"].append(torch.where(over, obound, bound).cpu())
    return {name: torch.cat(v).numpy() for name, v in out.items()}


def band(ref: Dict[str, np.ndarray], queries: np.ndarray, metric: str,
         m: int, rinv_max: float, table_bits: Optional[int] = BF16_BITS
         ) -> np.ndarray:
    """(B,) the most a table of ``table_bits`` can move a candidate and the
    c-th score together: 2 x M x half an ulp of the query's largest entry,
    in the score's units (a float32 table: float32 rounding)."""
    top = torch.as_tensor(ref["table_max"]).double()
    bits = 24 if table_bits is None else table_bits
    cross = 2 * m * half_ulp(top, bits)
    q = np.asarray(queries, np.float64)
    if metric == "cosine":
        scale = rinv_max / np.maximum(np.linalg.norm(q, axis=1), 1e-30)
    else:
        scale = np.full(q.shape[0], 2.0 if metric == "l2" else 1.0)
    return cross.numpy() * scale + 32 * U32


def compare(index: Index, corpus: np.ndarray, queries: np.ndarray,
            metric: str, k: int, nprobe: int, rerank: int, program: dict, *,
            grouped: bool = True, qcap: Optional[int] = None,
            table_bits: Optional[int] = BF16_BITS) -> Dict[str, float]:
    """The program's ``rows`` (B, k) and ``cand_rows`` / ``cand_scores``
    (B, c: the rows it re-ranked and the scores it chose them by) against
    the reference on the same index.  Each number beside its tolerance:
    ``adc_excess`` (<= 1), ``boundary_gap`` / ``band`` (per query),
    ``missed`` / ``missed_explained`` (per query: ``unexplained`` counts
    the queries over); see the module's docstring."""
    ref = search(index, corpus, queries, k, metric, nprobe, rerank,
                 grouped=grouped, qcap=qcap)
    cand = np.asarray(program["cand_rows"], np.int64)
    got = candidate_scores(index, corpus, queries, cand, metric, nprobe,
                           qcap=qcap, table_bits=table_bits)
    pscore = np.asarray(program["cand_scores"], np.float64)
    live = (cand >= 0) & (pscore < 1e30)
    err = np.abs(pscore - got["score"]) / got["bound"]
    # a live candidate the reference cannot reach is infinitely far past
    gap = np.where(~live, -np.inf, np.where(
        np.isinf(got["score"]), np.inf,
        got["score"] - np.where(np.isinf(got["score"]), 0.0,
                                ref["cth"][:, None])))
    tol = band(ref, queries, metric, index.m, index.rinv_max, table_bits)
    prow = np.asarray(program["rows"], np.int64)
    missed = np.array([k - len(set(a.tolist()) & set(t.tolist()))
                       for a, t in zip(prow, ref["rows"])])
    # what rounding explains: reference top-k rows inside the band, program
    # answers from outside the reference's top c, float32 ties at the k-th
    ref_top = candidate_scores(index, corpus, queries, ref["rows"], metric,
                               nprobe, qcap=qcap, table_bits=table_bits)
    inband = (ref_top["score"] > ref["cth"][:, None] - tol[:, None]).sum(1)
    outside = np.array([len(set(a.tolist()) - set(c.tolist()))
                        for a, c in zip(prow, ref["cand_rows"])])
    kth = ref["exact"][:, min(k, ref["exact"].shape[1] - 1)]
    ties = (ref["dists"] >= kth[:, None] - 64 * U32).sum(1) \
        if ref["exact"].shape[1] > k else np.zeros(len(prow), np.int64)
    explained = inband + outside + ties
    gap_q = gap.max(axis=1)
    worst = int(np.argmax(gap_q - tol))
    return {"adc_excess": float(np.where(live, err, 0.0).max()),
            "boundary_gap": float(gap_q.max()),
            "boundary_gap_over_band": float(np.max(gap_q / tol)),
            "band_at_worst": float(tol[worst]),
            "missed": float(missed.sum() / prow.size),
            "missed_explained": float(np.minimum(explained, k).sum()
                                      / prow.size),
            "unexplained": int((missed > explained).sum())}


def passes(numbers: Dict[str, float]) -> bool:
    return (numbers["adc_excess"] <= 1.0
            and numbers["boundary_gap_over_band"] <= 1.0
            and numbers["unexplained"] == 0)
