"""IVF-Flat ANN index (port of ``fastpyvectordb_tpu/ann/ivf.py``).

k-means (quant/kmeans.py) partitions the corpus into ``nlist`` cells with
capacity-capped balanced assignment (rows spill to their next-nearest cell;
rows that fit none of their choices become an always-scanned overflow
block).  Cell contents are materialised as a cell-major (nlist, cmax, D)
tensor on the collection's device, in the serving dtype or as int8 codes.
A query scores the centroids, probes its ``nprobe`` nearest cells, scores
their rows and the overflow block, and takes the top-k, optionally after an
exact re-rank.  Large batches go cell-major instead (ann/ivf_grouped.py),
through the hand-written grouped cell-score kernels.

The row table and the cell capacity (a multiple of 128) are those of the
JAX package, so a file written by either package means the same index in
both; the cell tensor is rebuilt from the rows on load.  Selection is exact
``torch.topk`` (the JAX package's approximate top-k exists on the TPU
only), and probed cells tie-break to the lower cell id as ``lax.top_k``
does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import DistanceMetric
from ..kernels.distances import MASKED, corpus_stats, mm_f32, smallest_k
from ..kernels.ivf_kernels import bmm_f32
from ..profiling import annotate
from ..quant.kmeans import kmeans_fit
from ..quant.scalar import ScalarQuantizer, _dequant, _encode, _train
from ..quant.scan import gather_rerank
from ..utils import next_pow2
from .ivf_grouped import (_metric_scores, _qstats,
                          grouped_ivf_search_kernel, grouped_qcap,
                          probe_cells, route)


def _assign_topm(data: torch.Tensor, centroids: torch.Tensor, *, m: int,
                 chunk: int = 16384, n: Optional[int] = None
                 ) -> torch.Tensor:
    """Top-m nearest centroids (int32, nearest first) for the first ``n``
    rows of a possibly capacity-padded buffer, chunked over rows."""
    if n is None:
        n = data.shape[0]
    csq = (centroids * centroids).sum(dim=1)
    out = torch.empty((n, m), dtype=torch.int32, device=data.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        dist = csq[None, :] - 2.0 * (data[s:e].float() @ centroids.T)
        out[s:e] = torch.topk(dist, m, dim=1, largest=False).indices
    return out


def _encode_cells(vectors: torch.Tensor, safe: torch.Tensor,
                  vmin: torch.Tensor, scale: torch.Tensor, *, blk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather + scalar-quantise the cell tensor ``blk`` cells at a time:
    (cap, D) store buffer, (nlist, cmax) row ids (padding -> row 0) ->
    ((nlist, cmax, D) int8 codes, (nlist, cmax) f32 norms of the
    DEQUANTISED rows).  No full-capacity code buffer is ever made."""
    nlist, cmax = safe.shape
    d = vectors.shape[1]
    cells = torch.empty((nlist, cmax, d), dtype=torch.int8,
                        device=vectors.device)
    norms = torch.empty((nlist, cmax), dtype=torch.float32,
                        device=vectors.device)
    for s in range(0, nlist, blk):
        ids = safe[s:s + blk].reshape(-1)
        c = _encode(vectors[ids], vmin, scale)
        vhat = _dequant(c, vmin, scale)
        cells[s:s + blk] = c.reshape(-1, cmax, d)
        norms[s:s + blk] = (vhat * vhat).sum(dim=1).reshape(-1, cmax)
    return cells, norms


def _gather_cells(vectors: torch.Tensor, safe: torch.Tensor,
                  dtype: torch.dtype, *, blk: int) -> torch.Tensor:
    """The (nlist, cmax, D) serving-dtype cell tensor, ``blk`` cells at a
    time (an f32 store is never gathered whole before the cast)."""
    nlist, cmax = safe.shape
    cells = torch.empty((nlist, cmax, vectors.shape[1]), dtype=dtype,
                        device=vectors.device)
    for s in range(0, nlist, blk):
        cells[s:s + blk] = vectors[safe[s:s + blk].reshape(-1)].to(
            dtype).reshape(-1, cmax, vectors.shape[1])
    return cells


def _cell_blk(nlist: int, cmax: int) -> int:
    # ~100k rows per block: the f32 encode intermediate stays ~300 MB at
    # D=768 whatever the corpus size
    return max(1, min(nlist, -(-100_000 // cmax)))


def _balanced_assignment(topm: np.ndarray, nlist: int, cap: int
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy capacity-capped assignment from per-row top-m cell choices
    (the JAX package's function, verbatim: the same choices give the same
    row table).

    Returns (row_table (nlist, cap) int32 padded with -1, counts (nlist,),
    overflow_rows).  Rows overflowing their nearest cell spill to the
    next-nearest cell with space; rows that fit none of their m choices
    become OVERFLOW — scanned exactly on every query rather than dumped
    into an arbitrary far cell where no probe would ever find them (that
    silently caps recall)."""
    n, m = topm.shape
    counts = np.zeros(nlist, dtype=np.int64)
    table = np.full((nlist, cap), -1, dtype=np.int32)
    # pass 1..m: vectorized-ish greedy by choice rank
    unassigned = np.arange(n, dtype=np.int64)
    for rank in range(m):
        if unassigned.size == 0:
            break
        choice = topm[unassigned, rank].astype(np.int64)
        # process cell by cell so capacity is respected deterministically
        order = np.argsort(choice, kind="stable")
        rows_sorted = unassigned[order]
        cells_sorted = choice[order]
        starts = np.searchsorted(cells_sorted, np.arange(nlist))
        ends = np.searchsorted(cells_sorted, np.arange(nlist) + 1)
        next_unassigned = []
        for c in range(nlist):
            seg = rows_sorted[starts[c]:ends[c]]
            if seg.size == 0:
                continue
            space = cap - counts[c]
            take = seg[:space]
            if take.size:
                table[c, counts[c]: counts[c] + take.size] = take
                counts[c] += take.size
            if seg.size > space:
                next_unassigned.append(seg[space:])
        unassigned = (np.concatenate(next_unassigned)
                      if next_unassigned else np.empty(0, dtype=np.int64))
    return table, counts, unassigned.astype(np.int32)


def ok_slot_masks(index, extra: Optional[np.ndarray] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot liveness ((nlist, cmax) and (O,) bool): slot occupied AND
    row not tombstoned (AND ``extra``, a host row mask over [0, count),
    when given).

    Memoized on (store, its ``version``, row table, overflow rows):
    the store tombstones its validity tensor in place, so the tensor's
    identity cannot key the memo.  A host ``extra`` (the collection's
    cached filter mask) is memoized per mask identity as well, for at most
    four filters.  Every gather clamps the -1 padding to row 0 and masks it
    by ``>= 0``: torch indexing would wrap -1 to the last row."""
    store = index._collection._store
    rt, orows = index.row_table, index.overflow_rows
    memo = getattr(index, "_ok_memo", None)
    if (memo is None or memo[0] is not store or memo[1] != store.version
            or memo[2] is not rt or memo[3] is not orows):
        safe_c = torch.clamp(rt, min=0).long()
        safe_o = torch.clamp(orows, min=0).long()
        okc = (rt >= 0) & store.valid[safe_c]
        oko = (orows >= 0) & store.valid[safe_o]
        memo = (store, store.version, rt, orows, okc, oko, safe_c, safe_o)
        index._ok_memo = memo
    okc, oko, safe_c, safe_o = memo[4:]
    if extra is None:
        return okc, oko
    fmemo = getattr(index, "_okf_memo", None)
    key = id(extra)
    hit = fmemo.get(key) if fmemo is not None else None
    # an entry holds its mask, so the id cannot be reused while it lives,
    # and the base memo it was made from
    if hit is not None and hit[0] is extra and hit[1] is memo:
        return hit[2], hit[3]
    m = np.zeros((int(store.capacity),), dtype=bool)
    m[: extra.shape[0]] = extra
    dm = torch.as_tensor(m, device=store.device)
    okcf, okof = okc & dm[safe_c], oko & dm[safe_o]
    if fmemo is None or len(fmemo) >= 4:  # bound the pinned masks
        fmemo = {}
        index._okf_memo = fmemo
    fmemo[key] = (extra, memo, okcf, okof)
    return okcf, okof


def _ivf_search_kernel(q, centroids, cells, row_table, overflow_vecs,
                       overflow_rows, ok_cells, ok_overflow, vmin, scale,
                       cell_norms, vectors: Optional[torch.Tensor] = None, *,
                       metric: DistanceMetric, k: int, nprobe: int,
                       compute_dtype: str = "bfloat16", rerank: int = 0):
    """The per-query dispatch: route, gather each query's probed cells
    (B, nprobe*cmax, D), score them and the overflow block, mask, top-k
    (after an exact re-rank of the top rerank*k when ``rerank > 0``).
    ``cell_norms`` are the cells' squared norms (dequantised for int8).
    Returns (dists (B, k), rows (B, k)) device tensors; L2 is sqrt'd."""
    qf = q.float()
    b, d = qf.shape
    cmax = cells.shape[1]
    cd = getattr(torch, compute_dtype)
    with annotate("fpv.ann.route"):
        probe = probe_cells(route(qf, centroids, metric), nprobe)
    with annotate("fpv.ann.gather_score"):
        vecs = cells[probe].reshape(b, nprobe * cmax, d)
        cand = row_table[probe].reshape(b, -1)
        ok = ok_cells[probe].reshape(b, -1)
        vsq = cell_norms[probe].reshape(b, -1)
        qsq, qinv = _qstats(qf)
        if cells.dtype == torch.int8:
            # q . dequant(c) = (q * rs) . c + q . (128 rs + vmin): the
            # gathered block stays codes; norms are the dequantised rows'
            rs = scale / 255.0
            const = qf @ (128.0 * rs + vmin)
            cross = bmm_f32((qf * rs[None, :]).to(cd)[:, None, :],
                            vecs.to(cd))[:, 0, :] + const[:, None]
        else:
            cross = bmm_f32(qf.to(cells.dtype)[:, None, :], vecs)[:, 0, :]
        s = _metric_scores(metric, cross, vsq, qsq, qinv, sqrt_l2=True)
        o = overflow_rows.shape[0]
        if o > 0:
            of = overflow_vecs.float()
            ocross = mm_f32(qf.to(cd), overflow_vecs.to(cd))
            s = torch.cat([s, _metric_scores(
                metric, ocross, (of * of).sum(dim=1)[None, :], qsq, qinv,
                sqrt_l2=True)], dim=1)
            cand = torch.cat([cand, overflow_rows[None].expand(b, o)],
                             dim=1)
            ok = torch.cat([ok, ok_overflow[None].expand(b, o)], dim=1)
    with annotate("fpv.ann.finish"):
        s = torch.where(ok, s, torch.full((), float(MASKED),
                                          device=s.device))
        if rerank > 0 and vectors is not None:
            c = int(min(max(k, k * rerank), s.shape[1]))
            cvals, cpos = smallest_k(s, c)
            crows = torch.take_along_dim(cand, cpos, dim=1)
            return gather_rerank(qf, cvals, crows, vectors, metric,
                                 min(k, c), compute_dtype)
        vals, pos = smallest_k(s, k)
        return vals, torch.take_along_dim(cand, pos, dim=1)


def _upload(q: np.ndarray, mult: int, device) -> torch.Tensor:
    """The queries on the device, padded with zero rows to a multiple of
    ``mult``."""
    with annotate("fpv.ann.upload"):
        q = np.pad(q, ((0, (-q.shape[0]) % mult), (0, 0)))
        return torch.as_tensor(q).to(device)


def _to_numpy(d: torch.Tensor, r: torch.Tensor, real: int):
    with annotate("fpv.ann.fetch"):
        return (d[:real].cpu().numpy(),
                r[:real].to(torch.int32).cpu().numpy())


class InvertedFile:
    """What IVF and IVF-PQ share: cells of rows around ``nlist`` centroids
    (a (nlist, cmax) row table, -1 = padding) and an always-scanned overflow
    block over a collection's store, and the search path between the
    collection and the kernels: the query intake, the choice of dispatch,
    one sub-batch loop, and the pairs a full cell shed, kept on the card.

    A kind supplies its tensors, ``_kernel`` (its two dispatches' kernel
    calls), ``_k_max`` (the candidates a query can have) and the values
    that size a query-major sub-batch (``_query_bytes``, ``_QM_BUDGET``,
    ``_QM_PAD``) and, where its regroup bounds it, a grouped one
    (``_REGROUP_BYTES``).  They decide results or memory, so they are
    constants of the kind and nothing a caller sets."""

    _QM_BUDGET: int            # default query-major budget, bytes
    _QM_PAD: int               # query-major pad multiple (capped by the batch)
    _REGROUP_BYTES = 0         # grouped regroup bytes a (pair, cell row)

    def __init__(self, centroids: torch.Tensor, row_table: torch.Tensor,
                 overflow_vecs: torch.Tensor, overflow_rows: torch.Tensor,
                 collection, nprobe: int, rerank: int):
        self.device = collection._store.device
        self.centroids = centroids        # (nlist, D) f32
        self.row_table = row_table        # (nlist, cmax) int32, -1 = padding
        self.overflow_vecs = overflow_vecs  # (O, D) always-scanned block
        self.overflow_rows = overflow_rows  # (O,) int32, -1 = padding
        self._collection = collection
        self.nprobe = nprobe
        self.rerank = rerank
        self.stale = False
        self._built_count = collection._store.count
        self._built_n_valid = collection._store.n_valid
        self._dropped = []       # the last grouped search's shed counts
        self.last_qcap = None
        self._free_bytes = None  # device memory free at the first search

    @property
    def last_dropped(self) -> int:
        """Pairs the last grouped search shed where a cell was full.  Kept
        on the card and read here, so the search never waits for it."""
        return sum(int(x) for x in self._dropped)

    def _mem_budget(self, default: int) -> int:
        """Bytes a search dispatch's largest transient may take: a quarter
        of the card's memory free at the index's first search on CUDA;
        elsewhere the JAX package's constant (sized for a 16 GB chip).
        It only splits batches."""
        if self.device.type != "cuda":
            return default
        if self._free_bytes is None:
            self._free_bytes = torch.cuda.mem_get_info(self.device)[0]
        return int(self._free_bytes // 4)

    def _search(self, queries, k, mask, overfetch, nprobe, rerank,
                max_query_batch, grouped, qcap
                ) -> Tuple[np.ndarray, np.ndarray]:
        with annotate("fpv.ann.search"):
            if self.stale:
                self.__dict__.update(self.rebuilt().__dict__)
            q = np.ascontiguousarray(queries, dtype=np.float32)
            if q.ndim == 1:
                q = q[None, :]
            nlist, cmax = self.row_table.shape
            nprobe = int(min(nprobe or self.nprobe, nlist))
            if mask is not None and overfetch > 1:
                # filtered queries: the mask is fused into candidate
                # scoring, so recall under selective filters is recovered
                # by probing more cells (the IVF analogue of over-fetching)
                nprobe = int(min(nlist, nprobe * overfetch))
            okc, oko = ok_slot_masks(
                self, np.ascontiguousarray(mask, dtype=bool)
                if mask is not None and not isinstance(mask, np.ndarray)
                else mask)
            rr = int(self.rerank if rerank is None else rerank)
            k = min(k, self._k_max(nprobe))
            # large batches go cell-major: once the per-query gather would
            # move more than the whole cell tensor, read each cell once
            if grouped is None:
                grouped = q.shape[0] * nprobe >= nlist
            if grouped:
                # sub-batches keep an (nlist, qcap, cmax) f32 block, and a
                # kind's regroup temporaries, under the budget
                budget = self._mem_budget(2 << 30)
                qcap_hbm = max(8, int(budget // max(nlist * cmax * 4, 1)))
                step = max(8, (qcap_hbm * nlist) // (4 * nprobe) // 8 * 8)
                if self._REGROUP_BYTES:
                    step = min(step, max(8, int(budget // max(
                        nprobe * cmax * self._REGROUP_BYTES, 1)) // 8 * 8))

                def qcap_of(real: int) -> int:
                    # zero rows pad to a multiple of 8, as in the JAX
                    # package: they take slots too, so the padding is part
                    # of the result
                    return int(grouped_qcap(real + (-real) % 8, nprobe,
                                            nlist, cmax)
                               if qcap is None else min(qcap, qcap_hbm))
                return self._sub_batches(
                    q, step, 8, self._kernel(True, k, okc, oko, nprobe, rr),
                    qcap_of)
            per_q = max(self._query_bytes(nprobe), 1)
            safe_b = max(8, int(self._mem_budget(self._QM_BUDGET) // per_q)
                         // 8 * 8)
            step = int(min(max_query_batch, safe_b))
            return self._sub_batches(
                q, step, min(step, self._QM_PAD),
                self._kernel(False, k, okc, oko, nprobe, rr))

    def _sub_batches(self, q: np.ndarray, step: int, pad: int, kernel,
                     qcap_of=None) -> Tuple[np.ndarray, np.ndarray]:
        """``kernel`` over ``q`` ``step`` rows at a time, each sub-batch
        uploaded with zero rows to a multiple of ``pad``, its answers
        fetched and concatenated.  Grouped (``qcap_of``: a sub-batch's real
        rows -> its qcap), the kernel also returns the pairs it shed, which
        stay on the card."""
        if qcap_of is not None:
            self._dropped = []
        outs_d, outs_r = [], []
        for s in range(0, q.shape[0], step):
            sub = q[s: s + step]
            real = sub.shape[0]
            qd = _upload(sub, pad, self.device)
            if qcap_of is None:
                d, r = kernel(qd)
            else:
                sub_qcap = qcap_of(real)
                d, r, dropped = kernel(qd, sub_qcap)
                self._dropped.append(dropped)
                self.last_qcap = sub_qcap
            d, r = _to_numpy(d, r, real)
            outs_d.append(d)
            outs_r.append(r)
        return np.concatenate(outs_d), np.concatenate(outs_r)

    # ------------------------------------------------------------------
    def mark_stale(self) -> None:
        self.stale = True

    def rebuilt(self) -> "InvertedFile":
        """A fresh index built with this index's recipe over the
        collection's current rows: the original build parameters, with the
        runtime knobs (``nprobe``, ``rerank``) carried over.  Used by the
        stale path and by the collection's background rebuild."""
        kw = dict(getattr(self, "_build_kwargs", {}))
        kw.setdefault("nlist", self.centroids.shape[0])
        kw["nprobe"] = self.nprobe
        new = self._rebuild(kw)
        new._build_kwargs = dict(getattr(self, "_build_kwargs", {}))
        return new

    def _loaded(self, meta: dict) -> "InvertedFile":
        self._built_count = int(meta["built_count"])
        # growth past built_count is served by the collection's tail merge;
        # only an impossible shrink (container mismatch) forces a rebuild
        self.stale = self._built_count > self._collection._store.count
        return self

    def _recall(self, rows, exact_r, k: int) -> float:
        return float(np.mean([len(set(a.tolist()) & set(e.tolist())) / k
                              for a, e in zip(rows, exact_r)]))

    def tune_nprobe(self, queries: np.ndarray, target_recall: float = 0.95,
                    k: int = 10, max_nprobe: Optional[int] = None) -> int:
        """The smallest nprobe (from nprobe/4, doubling) whose recall@k
        against the exact scan clears ``target_recall`` on the given
        queries; sets and returns it."""
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


class IVFIndex(InvertedFile):
    """Inverted-file flat index over a collection's device store; its
    tensors live on the collection's device."""

    _QM_BUDGET = 4 << 30
    _QM_PAD = 8

    def __init__(self, centroids: torch.Tensor, cells: torch.Tensor,
                 row_table: torch.Tensor, overflow_vecs: torch.Tensor,
                 overflow_rows: torch.Tensor, collection, nprobe: int):
        # rerank: the exact re-rank factor (int8 builds set 4)
        super().__init__(centroids, row_table, overflow_vecs, overflow_rows,
                         collection, nprobe, rerank=0)
        self.cells = cells                # (nlist, cmax, D) serving dtype
        self.quantizer = None    # set when cells are int8 codes
        self.cell_norms = None   # (nlist, cmax) f32

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, collection, nlist: Optional[int] = None,
              nprobe: Optional[int] = None, iters: int = 10,
              seed: int = 0, max_cell_factor: float = 1.5,
              spill_choices: int = 8,
              cell_dtype: Optional[str] = None) -> "IVFIndex":
        """``cell_dtype="int8"`` stores the cells as scalar-quantised codes
        (a quarter of f32 cells' memory) with dequantised norms; the
        default keeps cells in the serving dtype."""
        store = collection._store
        n = store.count
        if n == 0:
            raise ValueError("cannot build IVF index over an empty collection")
        # the capacity buffer as-is, in the storage dtype: k-means and the
        # assignment take an explicit n bound instead of a copy
        vectors = store.vectors
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
        # cell capacity rounds to a multiple of 128, as in the JAX package:
        # the row table is persisted and must mean the same in both
        cap = int(max(128, -(-int(max_cell_factor * n / nlist) // 128) * 128))
        table, counts, overflow = _balanced_assignment(topm, nlist, cap)
        dtype = (torch.bfloat16 if collection.config.compute_dtype
                 == "bfloat16" else torch.float32)
        dev = store.device
        table_t = torch.as_tensor(table, device=dev)
        safe = torch.clamp(table_t, min=0).long()
        blk = _cell_blk(nlist, cap)
        quant = None
        cell_norms = None
        if cell_dtype == "int8":
            quant = ScalarQuantizer(dims=int(vectors.shape[1]), device=dev)
            # strided sample, not the insertion-order prefix: a drifting
            # corpus would otherwise clip rows outside the prefix's range
            step = max(1, n // 200_000)
            sample = torch.arange(0, n, step, device=dev)[:200_000]
            quant.vmin, quant.scale = _train(vectors[sample])
            cells, cell_norms = _encode_cells(vectors, safe, quant.vmin,
                                              quant.scale, blk=blk)
            cell_norms = torch.where(table_t >= 0, cell_norms, 0.0)
        else:
            cells = _gather_cells(vectors, safe, dtype, blk=blk)
        opad = (-overflow.size) % 8
        orows = np.concatenate([overflow, np.full(opad, -1, np.int32)])
        orows_t = torch.as_tensor(orows, device=dev)
        ovecs = vectors[torch.clamp(orows_t, min=0).long()].to(dtype)
        idx = cls(centroids, cells, table_t, ovecs, orows_t, collection,
                  nprobe)
        idx._cell_counts = counts
        if quant is not None:
            idx.quantizer = quant
            idx.cell_norms = cell_norms
            # int8 cell scores scramble the order near the top-k boundary;
            # a 4x exact re-rank recovers it
            idx.rerank = 4
        return idx

    def _quant_params(self):
        if self.quantizer is not None:
            return self.quantizer.vmin, self.quantizer.scale
        d = self.centroids.shape[1]
        return (torch.zeros((d,), device=self.device),
                torch.ones((d,), device=self.device))

    def _cell_norms_cached(self) -> torch.Tensor:
        """Per-(cell, position) squared row norms, built once: int8 builds
        already hold the dequantised norms; serving-dtype cells compute
        them at their first use."""
        if self.cell_norms is None:
            nlist, cmax, d = self.cells.shape
            sq = corpus_stats(self.cells.reshape(-1, d))["sq"]
            self.cell_norms = torch.where(self.row_table >= 0,
                                          sq.reshape(nlist, cmax), 0.0)
        return self.cell_norms

    def _k_max(self, nprobe: int) -> int:
        return self.row_table.shape[1] * nprobe

    def _query_bytes(self, nprobe: int) -> int:
        # the per-query gather: (nprobe, cmax, D) cells plus their
        # converted copy
        return (nprobe * self.row_table.shape[1] * self.centroids.shape[1]
                * (self.cells.element_size() + 4))

    def _kernel(self, grouped: bool, k: int, okc, oko, nprobe: int,
                rerank: int):
        """Grouped: cell-major (ivf_grouped.py), each probed cell read once
        per batch and scored against all queries probing it; else the
        per-query gather."""
        cfg = self._collection.config
        vmin, scale = self._quant_params()
        args = (self.centroids, self.cells, self.row_table,
                self.overflow_vecs, self.overflow_rows, okc, oko, vmin, scale,
                self._cell_norms_cached(),
                self._collection._store.vectors if rerank > 0 else None)
        kw = dict(metric=cfg.metric, k=k, nprobe=nprobe,
                  compute_dtype=cfg.compute_dtype, rerank=rerank)
        if grouped:
            return lambda q, qcap: grouped_ivf_search_kernel(
                q, *args, qcap=qcap, **kw)
        return lambda q: _ivf_search_kernel(q, *args, **kw)

    def search(self, queries: np.ndarray, k: int,
               mask: Optional[np.ndarray] = None, overfetch: int = 1,
               nprobe: Optional[int] = None,
               max_query_batch: int = 64,
               grouped: Optional[bool] = None,
               qcap: Optional[int] = None,
               rerank: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        return self._search(queries, k, mask, overfetch, nprobe, rerank,
                            max_query_batch, grouped, qcap)

    # ------------------------------------------------------------------
    def _rebuild(self, kw: dict) -> "IVFIndex":
        if self.quantizer is not None:
            kw.setdefault("cell_dtype", "int8")
        new = IVFIndex.build(self._collection, **kw)
        new.rerank = self.rerank
        return new

    def stats(self) -> dict:
        counts = getattr(self, "_cell_counts", None)
        return {
            "kind": "ivf",
            "cell_dtype": str(self.cells.dtype).replace("torch.", ""),
            "nlist": int(self.centroids.shape[0]),
            "cmax": int(self.row_table.shape[1]),
            "nprobe": self.nprobe,
            "built_count": self._built_count,
            "cells_bytes": int(self.cells.numel()
                               * self.cells.element_size()),
            "overflow_rows": int((self.overflow_rows >= 0).sum()),
            "cell_balance": (float(counts.std() / max(counts.mean(), 1e-9))
                             if counts is not None else None),
        }

    # -- persistence ---------------------------------------------------
    def export_sections(self) -> tuple:
        """(sections, meta) for the collection's FPVT container, laid out
        as the JAX package writes them.  The cell tensor is rebuilt from
        the row table on load."""
        sections = {
            "ann_centroids": self.centroids.cpu().numpy(),
            "ann_row_table": self.row_table.to(torch.int32).cpu().numpy(),
            "ann_overflow_rows":
                self.overflow_rows.to(torch.int32).cpu().numpy()}
        meta = {"kind": "ivf", "nprobe": self.nprobe,
                "rerank": self.rerank, "built_count": self._built_count}
        if self.quantizer is not None:
            sections["ann_sq_vmin"] = self.quantizer.vmin.cpu().numpy()
            sections["ann_sq_scale"] = self.quantizer.scale.cpu().numpy()
            meta["cell_dtype"] = "int8"
        return sections, meta

    @classmethod
    def from_sections(cls, collection, sections: dict, meta: dict
                      ) -> "IVFIndex":
        store = collection._store
        dev = store.device

        def tensor(name, default=None):
            a = sections.get(name, default)
            return torch.as_tensor(np.array(a)).to(dev)

        centroids = tensor("ann_centroids").float()
        table = tensor("ann_row_table").to(torch.int32)
        orows = tensor("ann_overflow_rows",
                       np.zeros(0, np.int32)).to(torch.int32)
        dtype = (torch.bfloat16 if collection.config.compute_dtype
                 == "bfloat16" else torch.float32)
        safe = torch.clamp(table, min=0).long()
        blk = _cell_blk(table.shape[0], table.shape[1])
        quant = None
        cell_norms = None
        if meta.get("cell_dtype") == "int8":
            # re-encode through the persisted quantizer: the codes are
            # determined by vmin / scale and the store's rows
            quant = ScalarQuantizer(device=dev)
            quant.vmin = tensor("ann_sq_vmin").float()
            quant.scale = tensor("ann_sq_scale").float()
            quant.dims = int(quant.vmin.shape[0])
            cells, cell_norms = _encode_cells(store.vectors, safe, quant.vmin,
                                              quant.scale, blk=blk)
            cell_norms = torch.where(table >= 0, cell_norms, 0.0)
        else:
            cells = _gather_cells(store.vectors, safe, dtype, blk=blk)
        ovecs = store.vectors[torch.clamp(orows, min=0).long()].to(dtype)
        idx = cls(centroids, cells, table, ovecs, orows, collection,
                  int(meta["nprobe"]))
        if quant is not None:
            idx.quantizer = quant
            idx.cell_norms = cell_norms
        # older containers predate the rerank knob: the build default of
        # their cell dtype (int8 -> 4, serving dtype -> 0)
        idx.rerank = int(meta.get("rerank", 4 if quant is not None else 0))
        return idx._loaded(meta)
