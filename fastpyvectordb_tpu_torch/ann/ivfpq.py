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
``finish_grouped``).  Grouped candidates stay in the squared-L2 domain until
``finish_grouped`` takes the root.

The row table, cell capacity and persisted sections are the JAX package's,
so a file written by either package means the same index in both.  Sub-batch
caps derive from the card's free memory (``IVFIndex._mem_budget``) instead
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
from ..quant.kmeans import kmeans_fit, kmeans_fit_batched
from ..quant.product import _encode as _pq_encode
from ..quant.scan import gather_rerank
from ..utils import next_pow2
from .ivf import (IVFIndex, _assign_topm, _balanced_assignment, _to_numpy,
                  ok_slot_masks)
from .ivf_grouped import (finish_grouped, grouped_qcap, invert_pairs,
                          probe_cells)

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


def pq_cell_score_args(qf, probe, codes_t, codebooks, *, qcap: int):
    """The score stage of one grouped batch: ``(pairs, args)`` with the
    ``invert_pairs`` tables and the ``grouped_cell_scores_pq`` operands
    (compact cell list, per-query bf16 ADC tables (B, M*K), compact slot
    table, transposed codes)."""
    b = qf.shape[0]
    nlist, m, _ = codes_t.shape
    pairs = invert_pairs(probe, nlist, qcap)
    lut = _query_luts(qf, codebooks).reshape(b, m * codebooks.shape[1])
    return pairs, (pairs["cell_list"], lut.bfloat16(),
                   pairs["qslot_c"].to(torch.int32), codes_t)


def _grouped_pq_candidates(qf, qc, probe, codes_t, codebooks, norms,
                           row_table, ok_cells, *, metric, qcap: int):
    """Cell-major ADC scoring of one grouped batch: every probed cell's
    codes are scored once for all the queries probing it by the
    ``grouped_cell_scores_pq`` kernel, reading each query's bf16 ADC table
    through the slot table; the q.centroid term, reconstruction norms and
    validity are applied at the regroup over per-pair rows.  Returns
    (cand_vals (B, nprobe*cmax) f32 lower = better — L2 in the SQUARED
    domain — cand_rows, dropped)."""
    b = qf.shape[0]
    cmax = codes_t.shape[2]
    nprobe = probe.shape[1]
    pairs, args = pq_cell_score_args(qf, probe, codes_t, codebooks,
                                     qcap=qcap)
    s = grouped_cell_scores_pq(*args)
    # regroup: each pair's own (live) slot row; a shed pair reads its
    # cell's last slot, which is live, and is masked below
    u = s.shape[0]
    flat_cell = pairs["flat_cell"]
    flat_slot = pairs["cid_pair"] * qcap + torch.clamp(pairs["pair_rank"],
                                                       max=qcap - 1)
    pv = s.reshape(u * qcap, cmax)[flat_slot]                 # (Mp, cmax)
    cross = pv + torch.take_along_dim(qc, probe, dim=1).reshape(-1)[:, None]
    rn = norms[flat_cell]
    rok = ok_cells[flat_cell]
    qsq = (qf * qf).sum(dim=1)
    if metric == DistanceMetric.COSINE:
        qinv = (1.0 / torch.clamp(torch.sqrt(qsq), min=1e-30))[
            pairs["flat_q"]]
        sc = 1.0 - cross * qinv[:, None] * torch.rsqrt(
            torch.clamp(rn, min=1e-30))
    elif metric == DistanceMetric.L2:
        sc = torch.clamp(qsq[pairs["flat_q"]][:, None] + rn - 2.0 * cross,
                         min=0.0)
    else:
        sc = -cross
    sc = torch.where(pairs["pair_keep"][:, None] & rok, sc,
                     torch.full((), float(MASKED), device=sc.device))
    return (sc.reshape(b, nprobe * cmax),
            row_table[flat_cell].reshape(b, nprobe * cmax), pairs["dropped"])


def _grouped_ivfpq_search_kernel(q, centroids, codebooks, codes_t, norms,
                                 row_table, overflow_vecs, overflow_rows,
                                 ok_cells, ok_overflow,
                                 vectors: Optional[torch.Tensor], *,
                                 metric: DistanceMetric, k: int, nprobe: int,
                                 qcap: int, rerank: int,
                                 compute_dtype: str = "bfloat16"):
    """Grouped (cell-major) IVF-PQ search: returns (dists (B, k) f32,
    rows (B, k), dropped) device tensors.  The same candidate set as the
    per-query dispatch when qcap sheds nothing (cells partition the
    corpus)."""
    qf = q.float()
    qc, route = _pq_route(qf, centroids, metric)
    probe = probe_cells(-route, nprobe)
    cand_vals, cand_rows, dropped = _grouped_pq_candidates(
        qf, qc, probe, codes_t, codebooks, norms, row_table, ok_cells,
        metric=metric, qcap=qcap)
    vals, rows = finish_grouped(
        qf, cand_vals, cand_rows, overflow_vecs, overflow_rows, ok_overflow,
        vectors, metric=metric, k=k, rerank=rerank,
        compute_dtype=compute_dtype)
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
    qc, route = _pq_route(qf, centroids, metric)
    probe = probe_cells(-route, nprobe)
    lut = _query_luts(qf, codebooks)
    cand = row_table[probe].reshape(b, -1)
    ok = ok_cells[probe].reshape(b, -1)
    adc = _adc_sum(lut, codes[probe], m, kk, b, nprobe, cmax)
    cross = (torch.take_along_dim(qc, probe, dim=1)[:, :, None]
             + adc).reshape(b, -1)
    qsq = (qf * qf).sum(dim=1)
    qinv = 1.0 / torch.clamp(torch.sqrt(qsq[:, None]), min=1e-30)

    def metric_scores(vsq, xr):
        if metric == DistanceMetric.COSINE:
            return 1.0 - xr * qinv * torch.rsqrt(torch.clamp(vsq, min=1e-30))
        if metric == DistanceMetric.L2:
            return torch.sqrt(torch.clamp(qsq[:, None] + vsq - 2.0 * xr,
                                          min=0.0))
        return -xr

    s = metric_scores(norms[probe].reshape(b, -1), cross)
    o = overflow_rows.shape[0]
    if o > 0:
        ovsq = (overflow_vecs * overflow_vecs).sum(dim=1)
        s = torch.cat([s, metric_scores(ovsq[None, :],
                                        mm_f32(qf, overflow_vecs))], dim=1)
        cand = torch.cat([cand, overflow_rows[None].expand(b, o)], dim=1)
        ok = torch.cat([ok, ok_overflow[None].expand(b, o)], dim=1)
    s = torch.where(ok, s, torch.full((), float(MASKED), device=s.device))
    if not do_rerank:
        vals, pos = smallest_k(s, k)
        return vals, torch.take_along_dim(cand, pos, dim=1)
    cvals, cpos = smallest_k(s, c)
    crows = torch.take_along_dim(cand, cpos, dim=1)
    return gather_rerank(qf, cvals, crows, vectors, metric, min(k, c),
                         rerank_dtype)


class IVFPQIndex:
    """Inverted-file product-quantized index over a collection's store; its
    tensors live on the collection's device."""

    # the same rule as IVF: a quarter of the card's free memory on CUDA
    _mem_budget = IVFIndex._mem_budget

    def __init__(self, centroids, codebooks, codes, norms, row_table,
                 overflow_vecs, overflow_rows, collection, nprobe: int,
                 rerank: int = 8):
        self.device = collection._store.device
        self.centroids = centroids          # (nlist, D) f32
        self.codebooks = codebooks          # (M, K, ds) f32
        self.codes = codes                  # (nlist, cmax, M) uint8
        self.norms = norms                  # (nlist, cmax) f32
        self.row_table = row_table          # (nlist, cmax) int32, -1 = pad
        self.overflow_vecs = overflow_vecs  # (O, D) f32
        self.overflow_rows = overflow_rows  # (O,) int32, -1 = padding
        self._collection = collection
        self.nprobe = nprobe
        self.rerank = rerank                # candidate factor c = rerank*k
        self.stale = False
        self._built_count = collection._store.count
        self._built_n_valid = collection._store.n_valid
        self.last_dropped = 0
        self.last_qcap = None
        self._free_bytes = None   # device memory free at the first search

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

    # ------------------------------------------------------------------
    def _codes_t_cached(self) -> torch.Tensor:
        """(nlist, M, cmax) transposed codes for the grouped kernel (code
        bytes contiguous along the cell's rows), built at the first grouped
        search and kept while ``self.codes`` is the same tensor."""
        memo = getattr(self, "_codes_t_memo", None)
        if memo is None or memo[0] is not self.codes:
            memo = (self.codes, self.codes.transpose(1, 2).contiguous())
            self._codes_t_memo = memo
        return memo[1]

    def _search_grouped(self, q: np.ndarray, k: int, okc, oko, nprobe: int,
                        rerank: int, qcap: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Cell-major batched dispatch (``_grouped_pq_candidates``)."""
        cfg = self._collection.config
        nlist, cmax = self.row_table.shape
        codes_t = self._codes_t_cached()
        # sub-batches keep the (U <= nlist, qcap, cmax) f32 kernel output
        # and the (b * nprobe, cmax) regroup temporaries under the budget
        budget = self._mem_budget(2 << 30)
        qcap_hbm = max(8, int(budget // max(nlist * cmax * 4, 1)))
        sub_score = max(8, (qcap_hbm * nlist) // (4 * nprobe) // 8 * 8)
        sub_pairs = max(8, int(budget // max(nprobe * cmax * 24, 1))
                        // 8 * 8)
        sub_max = min(sub_score, sub_pairs)
        ncand = nprobe * cmax + int(self.overflow_rows.shape[0])
        vectors = self._collection._store.vectors if rerank > 0 else None
        outs_d, outs_r = [], []
        self.last_dropped = 0
        for s in range(0, q.shape[0], sub_max):
            subq = q[s: s + sub_max]
            real = subq.shape[0]
            # zero rows pad to a multiple of 8, as in the JAX package: they
            # take slots too, so the padding is part of the result
            subq = np.pad(subq, ((0, (-real) % 8), (0, 0)))
            sub_qcap = (grouped_qcap(subq.shape[0], nprobe, nlist, cmax)
                        if qcap is None else min(qcap, qcap_hbm))
            dd, rr, dropped = _grouped_ivfpq_search_kernel(
                torch.as_tensor(subq).to(self.device), self.centroids,
                self.codebooks, codes_t, self.norms, self.row_table,
                self.overflow_vecs, self.overflow_rows, okc, oko, vectors,
                metric=cfg.metric, k=min(k, ncand), nprobe=nprobe,
                qcap=int(sub_qcap), rerank=rerank,
                compute_dtype=cfg.compute_dtype)
            self.last_dropped += int(dropped)
            self.last_qcap = int(sub_qcap)
            d_, r_ = _to_numpy(dd, rr, real)
            outs_d.append(d_)
            outs_r.append(r_)
        return np.concatenate(outs_d), np.concatenate(outs_r)

    def search(self, queries: np.ndarray, k: int,
               mask: Optional[np.ndarray] = None, overfetch: int = 1,
               nprobe: Optional[int] = None, rerank: Optional[int] = None,
               max_query_batch: int = 256,
               grouped: Optional[bool] = None,
               qcap: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        if self.stale:
            self.__dict__.update(self.rebuilt().__dict__)
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        nlist, cmax = self.row_table.shape
        nprobe = int(min(nprobe or self.nprobe, nlist))
        if mask is not None and overfetch > 1:
            nprobe = int(min(nlist, nprobe * overfetch))
        okc, oko = ok_slot_masks(
            self, np.ascontiguousarray(mask, dtype=bool) if mask is not None
            and not isinstance(mask, np.ndarray) else mask)
        rr = int(self.rerank if rerank is None else rerank)
        # large batches go cell-major: once b * nprobe rivals nlist, reading
        # each probed cell once beats per-query code gathers
        if grouped is None:
            grouped = q.shape[0] * nprobe >= nlist
        if grouped:
            return self._search_grouped(q, k, okc, oko, nprobe, rerank=rr,
                                        qcap=qcap)
        cfg = self._collection.config
        m = self.codes.shape[2]
        ncand = nprobe * cmax + int(self.overflow_rows.shape[0])
        c = int(min(max(k, k * rr), ncand))
        # per-query transients: the gathered codes, their int64 table index
        # and the gathered f32 entries (13 bytes a code)
        per_q = max(nprobe * cmax * m * 13, 1)
        safe_b = max(8, int(self._mem_budget(2 << 30) // per_q) // 8 * 8)
        max_query_batch = int(min(max_query_batch, safe_b))
        store = self._collection._store
        outs_d, outs_r = [], []
        for s in range(0, q.shape[0], max_query_batch):
            sub = q[s: s + max_query_batch]
            d, r = _ivfpq_search_kernel(
                torch.as_tensor(sub).to(self.device), self.centroids,
                self.codebooks, self.codes, self.norms, self.row_table,
                self.overflow_vecs, self.overflow_rows, okc, oko,
                store.vectors, metric=cfg.metric, k=min(k, ncand), c=c,
                nprobe=nprobe, rerank_dtype=cfg.compute_dtype,
                do_rerank=rr > 0)
            d_, r_ = _to_numpy(d, r, sub.shape[0])
            outs_d.append(d_)
            outs_r.append(r_)
        return np.concatenate(outs_d), np.concatenate(outs_r)

    # ------------------------------------------------------------------
    def mark_stale(self) -> None:
        self.stale = True

    def rebuilt(self) -> "IVFPQIndex":
        """A fresh index built with this index's recipe (its build
        parameters, with the runtime-tuned ``nprobe`` / ``rerank``) over the
        collection's current rows; used by the stale path and by the
        collection's background rebuild."""
        kw = dict(getattr(self, "_build_kwargs", {}))
        kw.setdefault("nlist", self.centroids.shape[0])
        kw.setdefault("m", self.codes.shape[2])
        kw.setdefault("pq_k", self.codebooks.shape[1])
        kw["nprobe"] = self.nprobe
        kw["rerank"] = self.rerank
        new = IVFPQIndex.build(self._collection, **kw)
        new._build_kwargs = dict(getattr(self, "_build_kwargs", {}))
        return new

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
        idx._built_count = int(meta["built_count"])
        # growth past built_count is served by the collection's tail merge;
        # only an impossible shrink (container mismatch) forces a rebuild
        idx.stale = idx._built_count > store.count
        return idx

    def _recall(self, rows, exact_r, k: int) -> float:
        return float(np.mean([len(set(a.tolist()) & set(e.tolist())) / k
                              for a, e in zip(rows, exact_r)]))

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

    def tune_nprobe(self, queries: np.ndarray, target_recall: float = 0.95,
                    k: int = 10, max_nprobe: Optional[int] = None) -> int:
        """The smallest nprobe (from nprobe/4, doubling) whose recall@k
        clears ``target_recall``; sets and returns it."""
        store = self._collection._store
        cfg = self._collection.config
        _, exact_r = store.search(queries, k, cfg.metric,
                                  compute_dtype=cfg.compute_dtype)
        limit = max_nprobe or self.centroids.shape[0]
        nprobe = max(1, self.nprobe // 4)
        while nprobe <= limit:
            _, r = self.search(queries, k, nprobe=nprobe)
            if self._recall(r, exact_r, k) >= target_recall:
                self.nprobe = nprobe
                return nprobe
            nprobe *= 2
        self.nprobe = limit
        return limit
