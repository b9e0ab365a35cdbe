"""Graph ANN: fixed-degree neighbour table + batched beam search (port of
``fastpyvectordb_tpu/ann/graph_ann.py``).

The index is a flat ``(N, R)`` int32 neighbour table on the collection's
device, and search is a batched, fixed-shape best-first beam search:

  * **Build.**  The R-NN graph is computed exactly with chunked distance
    products (bf16 operands, f32 sums) and ``torch.topk``; each chunk is
    split so that no (rows, N) f32 distance block passes 4 GB.  The JAX
    package selects with the TPU's approximate top-k above 65,536 rows;
    here selection is exact at every size.  Reverse and pseudo-random
    long-range links (numpy, the JAX package's code verbatim) keep every
    node reachable, and each query routes to its own entry points through
    k-means centroid medoids.
  * **Search.**  Each of ``iters`` rounds expands the E best not-yet-
    expanded beam entries (gather their neighbour lists, one batched
    product for all B queries), merges the candidates into the beam and
    deduplicates by a stable sort on node id (the expanded flag rides a
    composite key, so the expanded copy of a node survives).  The rounds
    run on the device with no host synchronisation; the result is fetched
    once at the end.  Every selection is a stable ascending sort, which
    orders ties as ``lax.top_k`` does (lower position first), so a search
    over sections carried across from the JAX package follows the JAX
    beam's trajectory.

Recall is controlled by (beam width W, expansion width E, iterations T);
``tune`` picks the cheapest setting clearing a recall target against the
exact path.  The k-means draws from a ``torch.Generator``
(quant/kmeans.py), so an own build's centroids and medoids differ from the
JAX package's for one seed; the neighbour table, fill and reverse links
follow the same rules.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.types import DistanceMetric
from ..kernels.distances import MASKED, mm_f32
from ..kernels.ivf_kernels import bmm_f32
from ..quant.kmeans import kmeans_fit
from ..utils import next_pow2

_MASKED = float(MASKED)
# bytes of one (rows, N) f32 distance block of the k-NN build (the port's
# score budget, quant/scan.py QuantizedScan._score_hbm_budget)
_KNN_BLOCK_BYTES = 4 << 30


def _scores_vs_rows(q: torch.Tensor, vecs: torch.Tensor, metric,
                    compute_dtype: str) -> torch.Tensor:
    """q (B, D) f32, vecs (B, C, D) any dtype -> (B, C) f32 scores (lower =
    closer), in the norm-expansion form.  The rows' squared norms are
    summed in f32 from the gathered rows in their storage dtype; the cross
    term is an f32-output batched product of ``compute_dtype`` operands,
    never rounded to bf16."""
    metric = DistanceMetric.parse(metric)
    cd = getattr(torch, compute_dtype)
    qf = q.float()
    b, c, d = vecs.shape
    flat = vecs.reshape(b * c, 1, d)
    vsq = bmm_f32(flat, flat).reshape(b, c)
    cross = bmm_f32(qf.to(cd)[:, None, :], vecs.to(cd))[:, 0, :]
    if metric == DistanceMetric.COSINE:
        qinv = 1.0 / torch.clamp(torch.linalg.norm(qf, dim=1, keepdim=True),
                                 min=1e-30)
        rinv = torch.rsqrt(torch.clamp(vsq, min=1e-30))
        return 1.0 - cross * qinv * rinv
    if metric == DistanceMetric.L2:
        qsq = (qf * qf).sum(dim=1)
        return torch.clamp(qsq[:, None] + vsq - 2.0 * cross, min=0.0)
    return -cross


def _ascending(s: torch.Tensor, n: int) -> torch.Tensor:
    """Positions of the ``n`` smallest entries of each row, ties to the
    lower position (``lax.top_k`` of the negated scores)."""
    return torch.argsort(s, dim=1, stable=True)[:, :n]


def _beam_search_kernel(q: torch.Tensor, vectors: torch.Tensor,
                        neighbors: torch.Tensor, centroids: torch.Tensor,
                        medoids: torch.Tensor, init_ok: torch.Tensor,
                        filtermask: Optional[torch.Tensor], *, metric, k: int,
                        beam: int = 64, expand: int = 4, iters: int = 12,
                        n_init: int = 16, compute_dtype: str = "bfloat16"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batched beam search on the device.

    q (B, D) f32; vectors (cap, D) the store; neighbors (N, R) int32 with
    tombstoned targets already -1; centroids (n_e, D) f32 and medoids
    (n_e,) int32 the routing entries, init_ok (n_e,) their liveness;
    filtermask (cap,) bool or None (applied after navigation).  Returns
    (scores (B, min(k, beam)) f32, rows int32); L2 scores are sqrt'd,
    missing hits score ``MASKED``."""
    metric = DistanceMetric.parse(metric)
    b = q.shape[0]
    r = neighbors.shape[1]
    w = beam
    qf = q.float()

    def gather_scores(rows):  # (B, C) int64 -> (B, C) f32
        s = _scores_vs_rows(qf, vectors[rows.clamp(min=0)], metric,
                            compute_dtype)
        # tombstoned targets are already -1 in the neighbour table
        return torch.where(rows >= 0, s, _MASKED)

    # ---- route each query to its own entry points ----------------------
    if metric == DistanceMetric.COSINE:
        qn = qf / torch.clamp(torch.linalg.norm(qf, dim=1, keepdim=True),
                              min=1e-30)
        cn = centroids / torch.clamp(
            torch.linalg.norm(centroids, dim=1, keepdim=True), min=1e-30)
        croute = -(qn @ cn.T)
    elif metric == DistanceMetric.DOT:
        croute = -(qf @ centroids.T)
    else:
        csq = (centroids * centroids).sum(dim=1)
        croute = csq[None, :] - 2.0 * (qf @ centroids.T)
    e0 = min(n_init, w, medoids.shape[0])
    route = _ascending(croute, e0)                          # (B, e0)
    init_ids = medoids[route].long()
    init_scores = torch.where(init_ok[route], gather_scores(init_ids),
                              _MASKED)
    ids = F.pad(init_ids, (0, w - e0), value=-1)
    scores = F.pad(init_scores, (0, w - e0), value=_MASKED)
    expanded = torch.zeros((b, w), dtype=torch.bool, device=q.device)

    fresh = torch.zeros((b, expand * r), dtype=torch.bool, device=q.device)
    first = torch.zeros((b, 1), dtype=torch.bool, device=q.device)
    invalid_key = 2 * neighbors.shape[0] + 2
    for _ in range(iters):
        # pick the E best unexpanded entries and mark them expanded
        sel = torch.where(expanded | (ids < 0), _MASKED, scores)
        pos = _ascending(sel, expand)                        # (B, E)
        exp_ids = ids.gather(1, pos)
        expanded = expanded.scatter(1, pos, True)
        # gather neighbour lists; invalid expansion rows contribute nothing
        nb = neighbors[exp_ids.clamp(min=0)].long()          # (B, E, R)
        cand = torch.where((exp_ids < 0)[:, :, None], -1, nb).reshape(
            b, expand * r)
        cand_scores = gather_scores(cand)
        # merge beam + candidates
        all_ids = torch.cat([ids, cand], dim=1)
        all_scores = torch.cat([scores, cand_scores], dim=1)
        all_exp = torch.cat([expanded, fresh], dim=1)
        # dedup by id: composite key 2*id + (1 - expanded), so the expanded
        # copy of a node sorts first and survives (int64: no overflow)
        real = (all_ids >= 0) & (all_scores < _MASKED * 0.5)
        id_key = torch.where(real, all_ids * 2 + (~all_exp).long(),
                             invalid_key)
        order = torch.argsort(id_key, dim=1, stable=True)
        s_ids = all_ids.gather(1, order)
        s_scores = all_scores.gather(1, order)
        s_exp = all_exp.gather(1, order)
        dup = torch.cat([first, s_ids[:, 1:] == s_ids[:, :-1]], dim=1)
        s_scores = torch.where(dup, _MASKED, s_scores)
        # keep the best W by score
        keep = _ascending(s_scores, w)
        ids = s_ids.gather(1, keep)
        scores = s_scores.gather(1, keep)
        expanded = s_exp.gather(1, keep)
        ids = torch.where(scores >= _MASKED * 0.5, -1, ids)

    if filtermask is not None:
        # post-navigation filtering: the beam navigates the full graph (a
        # mask inside navigation would make filtered-out regions
        # impassable); only the final selection applies the filter
        fok = (ids >= 0) & filtermask[ids.clamp(min=0)]
        scores = torch.where(fok, scores, _MASKED)
    pos = _ascending(scores, min(k, w))
    out_ids = ids.gather(1, pos)
    out_scores = scores.gather(1, pos)
    if metric == DistanceMetric.L2:
        out_scores = torch.where(out_scores >= _MASKED * 0.5, out_scores,
                                 torch.sqrt(torch.clamp(out_scores, min=0.0)))
    return out_scores, out_ids.int()


def _knn_graph_chunk(vectors: torch.Tensor, sq_norms: torch.Tensor,
                     start: int, *, r: int, chunk: int,
                     block_bytes: int = _KNN_BLOCK_BYTES) -> torch.Tensor:
    """Exact R-NN (int32 (chunk, r), nearest first) of rows [start,
    start+chunk) against the full corpus, self excluded.  The product
    takes bf16 operands with f32 sums; the chunk is scored in blocks of
    rows whose (rows, N) f32 distance block fits ``block_bytes``."""
    n = vectors.shape[0]
    vb = vectors.to(torch.bfloat16)
    rows = max(1, block_bytes // (4 * n))
    out = torch.empty((chunk, r), dtype=torch.int32, device=vectors.device)
    for s in range(start, start + chunk, rows):
        e = min(s + rows, start + chunk)
        d2 = mm_f32(vb[s:e], vb).mul_(-2.0)
        d2.add_(sq_norms[s:e, None]).add_(sq_norms[None, :])
        d2.diagonal(offset=s).fill_(_MASKED)      # exclude self: column s+i
        out[s - start:e - start] = torch.topk(
            d2, r, dim=1, largest=False, sorted=True).indices
        del d2
    return out


def _snap_medoids(vectors: torch.Tensor, sqn: torch.Tensor,
                  cents: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Nearest corpus row (int32) per centroid, chunked over centroids: the
    full (n_entries, N) distance matrix would be GBs at large entry
    counts.  Ties go to the lower row, as ``jnp.argmin``'s do."""
    out = torch.empty((cents.shape[0],), dtype=torch.int32,
                      device=vectors.device)
    for s in range(0, cents.shape[0], chunk):
        cc = cents[s:s + chunk]
        d2 = ((cc * cc).sum(dim=1)[:, None] + sqn[None, :]
              - 2.0 * (cc @ vectors.T))
        out[s:s + chunk] = torch.argmin(d2, dim=1)
    return out


def _link_table(fwd: np.ndarray, r: int, seed: int) -> np.ndarray:
    """The (n, r) int32 neighbour table: the forward k-NN links (n, knn),
    then ``r - knn`` slots a row of reverse links over a self-loop-free
    random fill (the JAX package's build code verbatim, on
    ``np.random.default_rng(seed)``: the same forward table gives the same
    table)."""
    n, knn = fwd.shape
    if knn >= r:
        return fwd
    rng = np.random.default_rng(seed)
    extra = r - knn
    fill = np.empty((n, extra), dtype=np.int32)
    # self-loop-free random fill as the default
    offs = rng.integers(1, n, (n, extra), dtype=np.int64)
    fill[:] = ((np.arange(n, dtype=np.int64)[:, None] + offs)
               % n).astype(np.int32)
    # reverse edges, vectorized: for each forward edge u->v give v up to
    # `extra` slots pointing back at u (random subset)
    srcs = np.repeat(np.arange(n, dtype=np.int64), knn)
    dsts = fwd.reshape(-1).astype(np.int64)
    perm = rng.permutation(srcs.size)
    srcs, dsts = srcs[perm], dsts[perm]
    order = np.argsort(dsts, kind="stable")
    dsts_s, srcs_s = dsts[order], srcs[order]
    grp_start = np.searchsorted(dsts_s, np.arange(n))
    pos = np.arange(dsts_s.size) - grp_start[dsts_s]
    sel = pos < extra
    fill[dsts_s[sel], pos[sel]] = srcs_s[sel]
    return np.concatenate([fwd, fill], axis=1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GraphANN:
    """Neighbour-table ANN index over a collection's device store."""

    def __init__(self, neighbors: torch.Tensor, centroids: torch.Tensor,
                 medoids: torch.Tensor, collection, beam: int = 128,
                 expand: int = 8, iters: int = 16, n_init: int = 32):
        self.neighbors = neighbors     # (N, R) int32
        self.centroids = centroids     # (n_e, D) f32 routing centroids
        self.medoids = medoids         # (n_e,) int32 rows nearest each
        self._collection = collection
        self.beam, self.expand, self.iters = beam, expand, iters
        self.n_init = n_init
        self.stale = False
        self._built_count = collection._store.count
        self._built_n_valid = collection._store.n_valid
        self._nav_memo = None
        # seconds of each build stage (knn, links, kmeans, medoids); empty
        # for an index loaded from sections
        self.build_seconds: dict = {}

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, collection, r: int = 32, n_entries: int = 4096,
              random_links: int = 4, seed: int = 0, chunk: int = 4096,
              **search_params) -> "GraphANN":
        """Exact R-NN graph on the device + random long-range links +
        medoid entry points."""
        store = collection._store
        n = store.count
        if n == 0:
            raise ValueError("cannot build GraphANN over an empty collection")
        metric = collection.config.metric
        if metric == DistanceMetric.DOT:
            raise ValueError(
                "graph ANN does not support dot-product (MIPS) "
                "collections: the L2 edge graph excludes the high-norm "
                "rows inner-product search needs — use kind='ivf' or the "
                "int8 quantized scan for dot metrics")
        dev = store.device
        times = {}
        t0 = time.perf_counter()
        vectors = store.vectors[:n].float()
        if metric == DistanceMetric.COSINE:
            # edges follow the SEARCH metric: build over unit vectors (the
            # cosine order); search still scores the real store
            vectors = vectors / torch.clamp(
                torch.linalg.norm(vectors, dim=1, keepdim=True), min=1e-30)
        sqn = (vectors * vectors).sum(dim=1)
        chunk = int(min(chunk, n))
        # half the degree budget goes to forward KNN links; the rest to
        # reverse links (every node gets in-edges) and random long-range
        # links
        knn = max(r // 2, r - random_links - r // 4) if n > r * 4 else r
        # tiny collections: top-k cannot exceed the corpus size (excluding
        # self), and fill / reverse links need n >= 2
        knn = max(1, min(knn, n - 1)) if n > 1 else 1
        vb = vectors.to(torch.bfloat16)
        fwd_dev = torch.empty((n, knn), dtype=torch.int32, device=dev)
        for start in range(0, n, chunk):
            s = min(start, max(n - chunk, 0))  # overlap final ragged chunk
            fwd_dev[s:s + chunk] = _knn_graph_chunk(vb, sqn, s, r=knn,
                                                    chunk=chunk)
        del vb
        fwd = fwd_dev.cpu().numpy()
        del fwd_dev
        t1 = time.perf_counter()
        times["knn"] = t1 - t0
        neighbors = torch.as_tensor(_link_table(fwd, r, seed), device=dev)
        t2 = time.perf_counter()
        times["links"] = t2 - t1
        # per-query routing structure: k-means centroids + medoid rows
        # (cap at n/8 so small collections don't degenerate into k = n)
        n_entries = max(1, min(n_entries, max(16, n // 8)))
        cents = kmeans_fit(vectors, seed, k=n_entries, iters=5,
                           chunk=int(min(16384, n)))
        _sync(dev)
        t3 = time.perf_counter()
        times["kmeans"] = t3 - t2
        medoids = _snap_medoids(vectors, sqn, cents)
        _sync(dev)
        times["medoids"] = time.perf_counter() - t3
        idx = cls(neighbors, cents, medoids, collection, **search_params)
        idx.build_seconds = times
        return idx

    # ------------------------------------------------------------------
    def _nav_tables(self, store) -> Tuple[torch.Tensor, torch.Tensor]:
        """(neighbour table with tombstoned targets set to -1, medoid
        liveness), memoized on the store, its ``version`` and the
        neighbour tensor: deletes write ``store.valid`` in place, so the
        tensor's identity cannot key the memo."""
        memo = self._nav_memo
        if (memo is None or memo[0] is not store
                or memo[1] != store.version or memo[2] is not self.neighbors):
            valid = store.valid
            nb = self.neighbors
            ok_n = (nb >= 0) & valid[nb.clamp(min=0).long()]
            init_ok = (self.medoids >= 0) & valid[
                self.medoids.clamp(min=0).long()]
            memo = (store, store.version, nb, torch.where(ok_n, nb, -1),
                    init_ok)
            self._nav_memo = memo
        return memo[3], memo[4]

    def search(self, queries, k: int, mask: Optional[np.ndarray] = None,
               overfetch: int = 1, beam: Optional[int] = None,
               iters: Optional[int] = None, expand: Optional[int] = None,
               n_init: Optional[int] = None, device_out: bool = False):
        """Top-k of (B, D) queries (numpy, or a tensor).  Returns (dists,
        rows) as numpy (f32, int32), or with ``device_out`` as the device
        tensors (no host synchronisation happens in that call)."""
        if self.stale:
            self.__dict__.update(self.rebuilt().__dict__)
        store = self._collection._store
        cfg = self._collection.config
        if isinstance(queries, torch.Tensor):
            q = queries.to(store.device, torch.float32)
            q = q[None, :] if q.ndim == 1 else q
        else:
            qh = np.ascontiguousarray(queries, dtype=np.float32)
            q = store._upload_queries(qh[None, :] if qh.ndim == 1 else qh,
                                      None)
        nbr_masked, init_ok = self._nav_tables(store)
        filtermask = None
        # None checks, not `or`: an explicit 0 override (sweeps measuring
        # the no-routing / no-expansion corner) must not fall back to the
        # built defaults
        w = self.beam if beam is None else beam
        expand = self.expand if expand is None else expand
        iters = self.iters if iters is None else iters
        n_init = self.n_init if n_init is None else n_init
        if mask is not None:
            m = np.zeros((store.capacity,), dtype=bool)
            m[: mask.shape[0]] = mask
            filtermask = torch.as_tensor(m, device=store.device)
            # post-filter semantics need headroom: widen the beam so up to
            # k*overfetch filtered survivors fit among the W beam entries
            want = max(k * max(overfetch, 1), w)
            w = min(512, next_pow2(want)) if want > w else w
        if k > w:
            # the search returns min(k, beam) columns: widen rather than
            # truncate, keeping the filter's overfetch headroom; no cap
            want = k if filtermask is None else k * max(overfetch, 1)
            w = next_pow2(want)
        vals, rows = _beam_search_kernel(
            q, store.vectors, nbr_masked, self.centroids, self.medoids,
            init_ok, filtermask, metric=cfg.metric, k=k, beam=w,
            expand=expand, iters=iters, n_init=n_init,
            compute_dtype="bfloat16" if cfg.compute_dtype == "bfloat16"
            else "float32")
        if device_out:
            return vals, rows
        return vals.cpu().numpy(), rows.cpu().numpy()

    def mark_stale(self) -> None:
        self.stale = True

    def rebuilt(self) -> "GraphANN":
        """A fresh index built with this index's recipe (build kwargs +
        runtime-tuned beam/expand/iters/n_init) over the collection's
        current rows; shared by the stale path and Collection's
        background rebuild."""
        kw = dict(getattr(self, "_build_kwargs", {}))
        kw.setdefault("r", self.neighbors.shape[1])
        kw.setdefault("n_entries", self.medoids.shape[0])
        kw.update(beam=self.beam, expand=self.expand,
                  iters=self.iters, n_init=self.n_init)
        return GraphANN.build(self._collection, **kw)

    def stats(self) -> dict:
        n, r = self.neighbors.shape
        return {"kind": "graph", "nodes": n, "degree": r,
                "entries": int(self.medoids.shape[0]),
                "n_init": self.n_init,
                "beam": self.beam, "expand": self.expand,
                "iters": self.iters,
                "graph_bytes": int(n * r * 4)}

    # -- persistence ---------------------------------------------------
    def export_sections(self) -> tuple:
        return ({"ann_neighbors": self.neighbors.cpu().numpy(),
                 "ann_centroids": self.centroids.cpu().numpy(),
                 "ann_medoids": self.medoids.cpu().numpy()},
                {"kind": "graph", "beam": self.beam, "expand": self.expand,
                 "iters": self.iters, "n_init": self.n_init,
                 "built_count": self._built_count})

    @classmethod
    def from_sections(cls, collection, sections: dict, meta: dict
                      ) -> "GraphANN":
        dev = collection._store.device

        def put(name, dtype):
            return torch.as_tensor(np.array(sections[name], dtype=dtype),
                                   device=dev)

        idx = cls(put("ann_neighbors", np.int32),
                  put("ann_centroids", np.float32),
                  put("ann_medoids", np.int32), collection,
                  beam=int(meta["beam"]), expand=int(meta["expand"]),
                  iters=int(meta["iters"]),
                  n_init=int(meta.get("n_init", 16)))
        idx._built_count = int(meta["built_count"])
        # growth past built_count is served by the collection's tail merge;
        # only an impossible shrink (container mismatch) forces a rebuild
        idx.stale = idx._built_count > collection._store.count
        return idx

    def tune(self, queries: np.ndarray, target_recall: float = 0.95,
             k: int = 10) -> dict:
        """Smallest (beam, iters) clearing the recall target on a sample."""
        store = self._collection._store
        cfg = self._collection.config
        _, exact_rows = store.search(queries, k, cfg.metric,
                                     compute_dtype=cfg.compute_dtype)
        for beam in (32, 64, 128, 256):
            for iters in (8, 16, 32):
                _, rows = self.search(queries, k, beam=beam, iters=iters)
                rec = np.mean([
                    len(set(a.tolist()) & set(e.tolist())) / k
                    for a, e in zip(rows, exact_rows)])
                if rec >= target_recall:
                    self.beam, self.iters = beam, iters
                    return {"beam": beam, "iters": iters,
                            "recall": float(rec)}
        return {"beam": self.beam, "iters": self.iters, "recall": float(rec)}
