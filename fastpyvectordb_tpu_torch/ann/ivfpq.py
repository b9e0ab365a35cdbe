"""IVF-PQ — a coarse inverted file over product-quantized residual codes
(port of ``fastpyvectordb_tpu/ann/ivfpq.py``).

The router is IVF's (quant/kmeans.py k-means, capacity-capped balanced
assignment with an exactly scanned overflow block, ann/ivf.py); the cells
hold PQ codes of each row's residual to its centroid, M bytes a row.  With
the residual decomposition  q.x^ = q.centroid + sum_m q_m.codebook[m, code_m]
the ADC table is cell-independent: one (B, M, K) product a batch, the
routing product supplies q.centroid, and per-row reconstruction norms are
precomputed at build time, so cosine, L2 and dot reduce to the same three
tensors.  An exact re-rank of the top rerank*k rows restores what the codes
lose.

Two dispatches, as in the JAX package: per query (each query gathers its
probed cells' codes; the overflow block scored in f32) and, once
b * nprobe >= nlist, grouped (ann/ivf_grouped.py's slot tables; every probed
cell's codes scored once per batch for all its queries by the
``grouped_cell_scores_pq`` kernel, kernels/ivf_kernels.py; the overflow
block scored in ``compute_dtype`` and pre-reduced to k by
``overflow_candidates``).  Grouped candidates stay in the squared-L2 domain
until ``select_candidates`` takes the root.

The search path records IVF's spans (``profiling.annotate``) where the
stage is IVF's and its own where it is not: ``fpv.ann.search`` (root),
``.upload``, ``.route``, ``.invert`` (grouped), ``.lut`` (the per-query ADC
tables), ``.score`` (the grouped kernel, or the per-query gather and ADC
sum), ``.regroup`` (grouped), ``.overflow`` (the exact overflow block),
``.finish`` (the top c and the exact re-rank) and ``.fetch``.

The row table, cell capacity and persisted sections are the JAX package's,
so a file written by either package means the same index in both.  Sub-batch
caps derive from the card's free memory (``InvertedFile._mem_budget``) instead
of the JAX package's constants sized for a 16 GB chip.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import DistanceMetric
from ..kernels.distances import MASKED, mm_f32, smallest_k
from ..kernels.ivf_kernels import grouped_cell_scores_pq
from ..profiling import annotate
from ..quant.kmeans import kmeans_fit, kmeans_fit_batched
from ..quant.product import _encode as _pq_encode
from ..quant.scan import gather_rerank
from ..utils import next_pow2
from .ivf import InvertedFile, _assign_topm, _balanced_assignment
from .ivf_grouped import (_metric_scores, _qstats, invert_pairs,
                          overflow_candidates, probe_cells,
                          select_candidates)

_ENC_CHUNK = 131_072       # rows encoded per build step


def _recon_norms(codes: torch.Tensor, codebooks: torch.Tensor,
                 base: torch.Tensor, *, chunk: int = 16384) -> torch.Tensor:
    """||base + decode(codes)||^2 per row, chunked: codes (N, M) uint8,
    codebooks (M, K, ds), base (N, D) f32 (the assigned centroids)."""
    n, m = codes.shape
    sub = torch.arange(m, device=codes.device)[None, :]
    out = torch.empty((n,), dtype=torch.float32, device=codes.device)
    for s in range(0, n, chunk):
        dec = codebooks[sub, codes[s:s + chunk].long()]        # (c, M, ds)
        xhat = base[s:s + chunk] + dec.reshape(dec.shape[0], -1)
        out[s:s + chunk] = (xhat * xhat).sum(dim=1)
    return out


def _query_luts(qf: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(B, D) f32 x (M, K, ds) -> (B, M, K) q_m . codebook[m, k] in f32."""
    b = qf.shape[0]
    m, kk, ds = codebooks.shape
    qsub = qf.reshape(b, m, ds).transpose(0, 1)                # (M, B, ds)
    return torch.bmm(qsub, codebooks.transpose(1, 2)).transpose(0, 1)


def _adc_sum(lut, codes_g, m, kk, b, nprobe, cmax):
    """ADC cross-products of the probed blocks: adc[b, p, c] =
    sum_m lut[b, m, codes_g[b, p, c, m]], summed in f32.

    The JAX package's two lowerings, by value: ``kk <= 32`` contracts a
    one-hot of the codes with a bf16 LUT on the MXU, so its terms are the
    bf16-rounded table entries; ``kk > 32`` gathers the f32 table.  Here
    both are the table gather (a one-hot would only multiply by 1), over
    the bf16-rounded table when ``kk <= 32``."""
    if kk <= 32:
        lut = lut.bfloat16().float()
    flat = lut.reshape(b, m * kk)
    offs = torch.arange(m, device=codes_g.device) * kk
    idx = (codes_g.long() + offs).reshape(b, -1)
    return torch.gather(flat, 1, idx).reshape(b, nprobe * cmax, m).sum(
        dim=2).reshape(b, nprobe, cmax)


def _pq_route(qf, centroids, metric):
    """Route queries to cells, keeping the raw q.centroid products (half of
    every candidate's score under the residual decomposition).  Returns
    (qc (B, nlist), route (B, nlist), higher = better)."""
    qc = qf @ centroids.T
    if metric == DistanceMetric.COSINE:
        cn = torch.clamp(torch.linalg.norm(centroids, dim=1), min=1e-30)
        return qc, qc / cn[None, :]
    if metric == DistanceMetric.DOT:
        return qc, qc
    csq = (centroids * centroids).sum(dim=1)
    return qc, -(csq[None, :] - 2.0 * qc)


def cell_extents(row_table: torch.Tensor) -> torch.Tensor:
    """(nlist,) int32: each cell's occupied extent, the index of its last
    live slot (``row_table >= 0``) + 1; 0 for an empty cell, cmax for a
    full one.  A build fills each cell as a prefix and nothing inserts into
    a cell after it, so this is the cell's row count; tombstoned rows stay
    inside it.  ``grouped_cell_scores_pq`` scores a cell's rows below it
    alone."""
    pos = torch.arange(1, row_table.shape[1] + 1, dtype=torch.int32,
                       device=row_table.device)
    return torch.where(row_table >= 0, pos, 0).amax(dim=1).to(torch.int32)


def pq_cell_score_args(qf, probe, codes_t, codebooks, extents, *,
                       qcap: int):
    """The score stage of one grouped batch: ``(pairs, args)`` with the
    ``invert_pairs`` tables and the ``grouped_cell_scores_pq`` operands
    (compact cell list, per-query bf16 ADC tables (B, M*K), compact slot
    table, transposed codes, cell extents)."""
    b = qf.shape[0]
    nlist, m, _ = codes_t.shape
    with annotate("fpv.ann.invert"):
        pairs = invert_pairs(probe, nlist, qcap)
    with annotate("fpv.ann.lut"):
        lut = _query_luts(qf, codebooks).reshape(b, m * codebooks.shape[1])
        lut = lut.bfloat16()
    return pairs, (pairs["cell_list"], lut, pairs["qslot_c"].to(torch.int32),
                   codes_t, extents)


def _grouped_pq_candidates(qf, qc, probe, codes_t, codebooks, norms,
                           row_table, ok_cells, extents, *, metric,
                           qcap: int):
    """Cell-major ADC scoring of one grouped batch: every probed cell's
    codes are scored once for all the queries probing it by the
    ``grouped_cell_scores_pq`` kernel, reading each query's bf16 ADC table
    through the slot table, over each cell's rows below its extent
    (``cell_extents(row_table)``); the q.centroid term, reconstruction
    norms and validity are applied at the regroup over per-pair rows, where
    ``ok_cells`` (False on every padding slot) masks the rows the kernel
    left unwritten.  Returns
    (cand_vals (B, nprobe*cmax) f32 lower = better — L2 in the SQUARED
    domain — cand_rows, dropped)."""
    b = qf.shape[0]
    cmax = codes_t.shape[2]
    nprobe = probe.shape[1]
    pairs, args = pq_cell_score_args(qf, probe, codes_t, codebooks,
                                     extents, qcap=qcap)
    with annotate("fpv.ann.score"):
        s = grouped_cell_scores_pq(*args)
    with annotate("fpv.ann.regroup"):
        # each pair's own (live) slot row; a shed pair reads its cell's
        # last slot, which is live, and is masked below
        u = s.shape[0]
        flat_cell = pairs["flat_cell"]
        flat_slot = pairs["cid_pair"] * qcap + torch.clamp(
            pairs["pair_rank"], max=qcap - 1)
        pv = s.reshape(u * qcap, cmax)[flat_slot]             # (Mp, cmax)
        cross = pv + torch.take_along_dim(qc, probe, dim=1).reshape(-1)[
            :, None]
        rn = norms[flat_cell]
        rok = ok_cells[flat_cell]
        sc = _metric_scores(metric, cross, rn, (qf * qf).sum(dim=1),
                            sqrt_l2=False, rows=pairs["flat_q"])
        sc = torch.where(pairs["pair_keep"][:, None] & rok, sc,
                         torch.full((), float(MASKED), device=sc.device))
        return (sc.reshape(b, nprobe * cmax),
                row_table[flat_cell].reshape(b, nprobe * cmax),
                pairs["dropped"])


def _grouped_ivfpq_search_kernel(q, centroids, codebooks, codes_t, norms,
                                 row_table, extents, overflow_vecs,
                                 overflow_rows, ok_cells, ok_overflow,
                                 vectors: Optional[torch.Tensor], *,
                                 metric: DistanceMetric, k: int, nprobe: int,
                                 qcap: int, rerank: int,
                                 compute_dtype: str = "bfloat16"):
    """Grouped (cell-major) IVF-PQ search: returns (dists (B, k) f32,
    rows (B, k), dropped) device tensors.  The same candidate set as the
    per-query dispatch when qcap sheds nothing (cells partition the
    corpus)."""
    qf = q.float()
    with annotate("fpv.ann.route"):
        qc, route = _pq_route(qf, centroids, metric)
        probe = probe_cells(-route, nprobe)
    cand_vals, cand_rows, dropped = _grouped_pq_candidates(
        qf, qc, probe, codes_t, codebooks, norms, row_table, ok_cells,
        extents, metric=metric, qcap=qcap)
    if overflow_rows.shape[0] > 0:
        with annotate("fpv.ann.overflow"):
            os_, orows = overflow_candidates(
                qf, overflow_vecs, overflow_rows, ok_overflow, metric=metric,
                k=k, compute_dtype=compute_dtype)
            cand_vals = torch.cat([cand_vals, os_], dim=1)
            cand_rows = torch.cat([cand_rows, orows.to(cand_rows.dtype)],
                                  dim=1)
    with annotate("fpv.ann.finish"):
        vals, rows = select_candidates(
            qf, cand_vals, cand_rows, vectors, metric=metric, k=k,
            rerank=rerank, compute_dtype=compute_dtype)
    return vals, rows, dropped


def _ivfpq_search_kernel(q, centroids, codebooks, codes, norms, row_table,
                         overflow_vecs, overflow_rows, ok_cells, ok_overflow,
                         vectors, *, metric: DistanceMetric, k: int, c: int,
                         nprobe: int, rerank_dtype: str = "bfloat16",
                         do_rerank: bool = True):
    """The per-query dispatch: route, ADC-score each query's probed cells
    and the overflow block (in f32), mask, then either the top-k or an
    exact re-rank of the top-c.  L2 scores are sqrt'd."""
    b = q.shape[0]
    nlist, cmax, m = codes.shape
    kk = codebooks.shape[1]
    qf = q.float()
    with annotate("fpv.ann.route"):
        qc, route = _pq_route(qf, centroids, metric)
        probe = probe_cells(-route, nprobe)
    with annotate("fpv.ann.lut"):
        lut = _query_luts(qf, codebooks)
    qsq, qinv = _qstats(qf)
    with annotate("fpv.ann.score"):
        cand = row_table[probe].reshape(b, -1)
        ok = ok_cells[probe].reshape(b, -1)
        adc = _adc_sum(lut, codes[probe], m, kk, b, nprobe, cmax)
        cross = (torch.take_along_dim(qc, probe, dim=1)[:, :, None]
                 + adc).reshape(b, -1)
        s = _metric_scores(metric, cross, norms[probe].reshape(b, -1), qsq,
                           qinv, sqrt_l2=True)
    o = overflow_rows.shape[0]
    if o > 0:
        with annotate("fpv.ann.overflow"):
            ovsq = (overflow_vecs * overflow_vecs).sum(dim=1)
            s = torch.cat([s, _metric_scores(
                metric, mm_f32(qf, overflow_vecs), ovsq[None, :], qsq, qinv,
                sqrt_l2=True)], dim=1)
            cand = torch.cat([cand, overflow_rows[None].expand(b, o)], dim=1)
            ok = torch.cat([ok, ok_overflow[None].expand(b, o)], dim=1)
    with annotate("fpv.ann.finish"):
        s = torch.where(ok, s, torch.full((), float(MASKED),
                                          device=s.device))
        if not do_rerank:
            vals, pos = smallest_k(s, k)
            return vals, torch.take_along_dim(cand, pos, dim=1)
        cvals, cpos = smallest_k(s, c)
        crows = torch.take_along_dim(cand, cpos, dim=1)
        return gather_rerank(qf, cvals, crows, vectors, metric, min(k, c),
                             rerank_dtype)


class IVFPQIndex(InvertedFile):
    """Inverted-file product-quantized index over a collection's store; its
    tensors live on the collection's device."""

    _QM_BUDGET = 2 << 30
    _QM_PAD = 1
    # the grouped regroup's (b * nprobe, cmax) temporaries
    _REGROUP_BYTES = 24

    def __init__(self, centroids, codebooks, codes, norms, row_table,
                 overflow_vecs, overflow_rows, collection, nprobe: int,
                 rerank: int = 8):
        # rerank: the candidate factor, c = rerank * k
        super().__init__(centroids, row_table, overflow_vecs, overflow_rows,
                         collection, nprobe, rerank)
        self.codebooks = codebooks          # (M, K, ds) f32
        self.codes = codes                  # (nlist, cmax, M) uint8
        self.norms = norms                  # (nlist, cmax) f32

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, collection, nlist: Optional[int] = None,
              nprobe: Optional[int] = None, m: Optional[int] = None,
              pq_k: int = 256, iters: int = 10, pq_iters: int = 12,
              seed: int = 0, max_cell_factor: float = 1.5,
              spill_choices: int = 8, train_sample: int = 200_000,
              rerank: int = 16) -> "IVFPQIndex":
        """The JAX package's defaults: 8-bit PQ (K=256) with M = D/8
        subspaces (D/4 for K <= 32), cell factor 1.5, 8 spill choices, an
        exact re-rank of 16k candidates.  Codes and reconstruction norms
        are encoded a block of rows at a time on the device and scattered
        straight into the cell-major layout."""
        store = collection._store
        n = store.count
        if n == 0:
            raise ValueError("cannot build IVF-PQ over an empty collection")
        vectors = store.vectors   # capacity buffer; n bounds every read
        dev = store.device
        d = vectors.shape[1]
        if m is None:
            m = max(1, d // 4) if pq_k <= 32 else max(1, d // 8)
        while d % m:              # snap M down to a divisor of D
            m -= 1
        if nlist is None:
            nlist = int(min(max(int(math.sqrt(n)) * 2, 8), 8192,
                            max(n // 4, 1)))
        nlist = max(1, min(nlist, n))
        if nprobe is None:
            nprobe = max(1, min(nlist, collection.config.ivf_nprobe))
        centroids = kmeans_fit(vectors, seed, k=nlist, iters=iters,
                               chunk=int(min(16384, next_pow2(n))), n=n)
        topm = _assign_topm(vectors, centroids, m=min(spill_choices, nlist),
                            n=n).cpu().numpy()
        # capacity: a multiple of 128 once the corpus fills it, else of 8
        # (the JAX package's rule; the row table is persisted)
        raw_cap = int(max_cell_factor * n / nlist)
        cap = (-(-raw_cap // 128) * 128 if raw_cap >= 128
               else int(max(8, (raw_cap + 7) // 8 * 8)))
        table, counts, overflow = _balanced_assignment(topm, nlist, cap)

        # each assigned row's cell and slot; overflow rows have none
        cell_of = np.full(n, -1, np.int64)
        flat = table.reshape(-1)
        live = flat >= 0
        cell_of[flat[live]] = np.repeat(np.arange(nlist, dtype=np.int64),
                                        cap)[live]
        assigned = np.nonzero(cell_of >= 0)[0]
        pos_of = np.full(n, -1, np.int64)
        pos_of[flat[live]] = np.nonzero(live)[0]

        def on_dev(a):
            return torch.as_tensor(a, device=dev)

        # shared residual codebooks from a training block of residuals
        t = min(train_sample, assigned.size)
        rs = (vectors[on_dev(assigned[:t])].float()
              - centroids[on_dev(cell_of[assigned[:t]])])
        sub = rs.reshape(t, m, d // m).transpose(0, 1).contiguous()
        del rs
        codebooks = kmeans_fit_batched(sub, seed + 1, k=pq_k, iters=pq_iters,
                                       chunk=min(16384, max(256, t)))
        del sub

        codes = torch.zeros((nlist * cap, m), dtype=torch.uint8, device=dev)
        norms = torch.zeros((nlist * cap,), dtype=torch.float32, device=dev)
        for s in range(0, assigned.size, _ENC_CHUNK):
            rows = assigned[s:s + _ENC_CHUNK]
            base = centroids[on_dev(cell_of[rows])]
            cc = _pq_encode(vectors[on_dev(rows)].float() - base, codebooks)
            slots = on_dev(pos_of[rows])
            codes[slots] = cc
            norms[slots] = _recon_norms(cc, codebooks, base)

        opad = (-overflow.size) % 8
        orows = on_dev(np.concatenate([overflow,
                                       np.full(opad, -1, np.int32)]))
        # the overflow block is scored exactly, in f32
        ovecs = vectors[torch.clamp(orows, min=0).long()].float()
        idx = cls(centroids, codebooks, codes.reshape(nlist, cap, m),
                  norms.reshape(nlist, cap), on_dev(table), ovecs, orows,
                  collection, nprobe, rerank=rerank)
        idx._cell_counts = counts
        return idx

    def _codes_t_cached(self) -> torch.Tensor:
        """(nlist, M, cmax) transposed codes for the grouped kernel (code
        bytes contiguous along the cell's rows), built at the first grouped
        search and kept while ``self.codes`` is the same tensor."""
        memo = getattr(self, "_codes_t_memo", None)
        if memo is None or memo[0] is not self.codes:
            memo = (self.codes, self.codes.transpose(1, 2).contiguous())
            self._codes_t_memo = memo
        return memo[1]

    def _extents_cached(self) -> torch.Tensor:
        """``cell_extents(self.row_table)``, on the index's device, made at
        the first grouped search and kept while ``self.row_table`` is the
        same tensor (the row table is never written in place)."""
        memo = getattr(self, "_extents_memo", None)
        if memo is None or memo[0] is not self.row_table:
            memo = (self.row_table, cell_extents(self.row_table))
            self._extents_memo = memo
        return memo[1]

    def _k_max(self, nprobe: int) -> int:
        return nprobe * self.row_table.shape[1] + int(
            self.overflow_rows.shape[0])

    def _query_bytes(self, nprobe: int) -> int:
        # per-query transients: the gathered codes, their int64 table index
        # and the gathered f32 entries (13 bytes a code)
        return nprobe * self.row_table.shape[1] * self.codes.shape[2] * 13

    def _kernel(self, grouped: bool, k: int, okc, oko, nprobe: int,
                rerank: int):
        """Grouped: cell-major (``_grouped_pq_candidates``); else each
        query gathers its probed cells' codes."""
        cfg = self._collection.config
        vectors = self._collection._store.vectors
        if grouped:
            codes_t = self._codes_t_cached()
            extents = self._extents_cached()
            return lambda q, qcap: _grouped_ivfpq_search_kernel(
                q, self.centroids, self.codebooks, codes_t, self.norms,
                self.row_table, extents, self.overflow_vecs,
                self.overflow_rows, okc, oko,
                vectors if rerank > 0 else None, metric=cfg.metric, k=k,
                nprobe=nprobe, qcap=qcap, rerank=rerank,
                compute_dtype=cfg.compute_dtype)
        c = int(min(max(k, k * rerank), self._k_max(nprobe)))
        return lambda q: _ivfpq_search_kernel(
            q, self.centroids, self.codebooks, self.codes, self.norms,
            self.row_table, self.overflow_vecs, self.overflow_rows, okc, oko,
            vectors, metric=cfg.metric, k=k, c=c, nprobe=nprobe,
            rerank_dtype=cfg.compute_dtype, do_rerank=rerank > 0)

    def search(self, queries: np.ndarray, k: int,
               mask: Optional[np.ndarray] = None, overfetch: int = 1,
               nprobe: Optional[int] = None, rerank: Optional[int] = None,
               max_query_batch: int = 256,
               grouped: Optional[bool] = None,
               qcap: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        return self._search(queries, k, mask, overfetch, nprobe, rerank,
                            max_query_batch, grouped, qcap)

    # ------------------------------------------------------------------
    def _rebuild(self, kw: dict) -> "IVFPQIndex":
        kw.setdefault("m", self.codes.shape[2])
        kw.setdefault("pq_k", self.codebooks.shape[1])
        kw["rerank"] = self.rerank
        return IVFPQIndex.build(self._collection, **kw)

    def stats(self) -> dict:
        counts = getattr(self, "_cell_counts", None)
        return {
            "kind": "ivfpq",
            "nlist": int(self.centroids.shape[0]),
            "cmax": int(self.row_table.shape[1]),
            "m": int(self.codes.shape[2]),
            "pq_k": int(self.codebooks.shape[1]),
            "nprobe": self.nprobe,
            "rerank": self.rerank,
            "built_count": self._built_count,
            "codes_bytes": int(self.codes.numel()),
            "overflow_rows": int((self.overflow_rows >= 0).sum()),
            "cell_balance": (float(counts.std() / max(counts.mean(), 1e-9))
                             if counts is not None else None),
        }

    def memory_usage(self) -> dict:
        n = self._built_count
        orig = n * self.centroids.shape[1] * 4
        quant = (self.codes.numel() + self.norms.numel() * 4
                 + self.row_table.numel() * 4 + self.codebooks.numel() * 4
                 + self.centroids.numel() * 4)
        return {"original_bytes": orig, "index_bytes": int(quant),
                "compression_ratio": orig / max(quant, 1)}

    # -- persistence ---------------------------------------------------
    def export_sections(self) -> tuple:
        """(sections, meta) for the collection's FPVT container, laid out
        as the JAX package writes them: codes, norms and tables verbatim
        (they cannot be rebuilt from the store without k-means)."""
        m = self.codes.shape[2]
        return ({"ann_centroids": self.centroids.cpu().numpy(),
                 "ann_codebooks": self.codebooks.cpu().numpy(),
                 "ann_pq_codes": self.codes.reshape(-1, m).cpu().numpy(),
                 "ann_pq_norms": self.norms.reshape(-1, 1).cpu().numpy(),
                 "ann_row_table":
                     self.row_table.to(torch.int32).cpu().numpy(),
                 "ann_overflow_rows":
                     self.overflow_rows.to(torch.int32).cpu().numpy()},
                {"kind": "ivfpq", "nprobe": self.nprobe,
                 "rerank": self.rerank, "built_count": self._built_count,
                 "nlist": int(self.centroids.shape[0]),
                 "cmax": int(self.row_table.shape[1])})

    @classmethod
    def from_sections(cls, collection, sections: dict, meta: dict
                      ) -> "IVFPQIndex":
        store = collection._store
        dev = store.device
        nlist, cmax = int(meta["nlist"]), int(meta["cmax"])

        def tensor(name, default=None):
            return torch.as_tensor(np.array(sections.get(name, default))
                                   ).to(dev)

        codes = tensor("ann_pq_codes").reshape(nlist, cmax, -1)
        orows = tensor("ann_overflow_rows", np.zeros(0, np.int32)
                       ).to(torch.int32)
        ovecs = store.vectors[torch.clamp(orows, min=0).long()].float()
        idx = cls(tensor("ann_centroids").float(),
                  tensor("ann_codebooks").float(), codes,
                  tensor("ann_pq_norms").reshape(nlist, cmax).float(),
                  tensor("ann_row_table").to(torch.int32), ovecs, orows,
                  collection, int(meta["nprobe"]),
                  rerank=int(meta.get("rerank", 8)))
        return idx._loaded(meta)

    def tune(self, queries: np.ndarray, target_recall: float = 0.95,
             k: int = 10, max_nprobe: Optional[int] = None,
             max_rerank: int = 64) -> Tuple[int, int, float]:
        """Jointly tune (nprobe, rerank) against the exact scan: double
        nprobe (the cheaper knob) up to its limit, then deepen the re-rank
        pool.  Installs and returns the settings and the recall reached."""
        store = self._collection._store
        cfg = self._collection.config
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        _, exact_r = store.search(q, k, cfg.metric,
                                  compute_dtype=cfg.compute_dtype)
        limit = max_nprobe or self.centroids.shape[0]
        npb = max(1, self.nprobe)
        rr = max(4, self.rerank)
        while True:
            _, rows = self.search(q, k, nprobe=npb, rerank=rr)
            rec = self._recall(rows, exact_r, k)
            if rec >= target_recall or (npb >= limit and rr >= max_rerank):
                self.nprobe, self.rerank = int(npb), int(rr)
                return int(npb), int(rr), rec
            if npb < limit:
                npb = min(limit, npb * 2)
            else:
                rr = min(max_rerank, rr * 2)
