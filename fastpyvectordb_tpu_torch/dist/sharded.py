"""Multi-card sharded exact search with a distributed top-k merge (port of
``fastpyvectordb_tpu/dist/sharded.py``).

The corpus is row-sharded over the mesh's "data" axis; every shard computes
its block's distances and a *local* top-k, the (vals, global-row) partials
are all-gathered (dist/collectives.py) and a final top-k of n_data * k
entries gives the global result.  On a 2-D mesh the query batch is split
over the "query" axis as well.

Also the distributed Lloyd's step for IVF / PQ codebooks
(``build_sharded_kmeans_step``): per-shard assignment and partial sums,
``psum`` over the data axis, centroid update.

The distance product is a plain ``torch.mm`` (``kernels/distances.py
mm_f32``): the JAX package computes it outside any Pallas kernel too.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.types import DistanceMetric
from ..kernels.distances import MASKED, corpus_stats, mm_f32, smallest_k
from ..kernels.topk import merge_top_k
from .mesh import (DATA_AXIS, QUERY_AXIS, Mesh, ShardedArray, on_devices,
                   replicate, shard_corpus)

KMEANS_CHUNK = 65536   # rows of one assignment product of the k-means step


def _local_scores(q, v, metric, compute_dtype, vsq=None, rinv=None):
    """(B, D) x a (N_shard, D) block -> (B, N_shard) f32, lower = closer
    (L2 squared).  Operands round to ``compute_dtype``; sums are f32."""
    cd = getattr(torch, compute_dtype)
    qf = q.float()

    def mm(a):
        return mm_f32(a.to(cd), v.to(cd))

    if metric == DistanceMetric.COSINE:
        qn = qf / torch.clamp(torch.linalg.norm(qf, dim=1, keepdim=True),
                              min=1e-30)
        if rinv is None:
            rinv = corpus_stats(v)["rinv"]
        return 1.0 - mm(qn) * rinv[None, :]
    if metric == DistanceMetric.L2:
        if vsq is None:
            vsq = corpus_stats(v)["sq"]
        qsq = (qf * qf).sum(dim=1)
        return torch.clamp(qsq[:, None] + vsq[None, :] - 2.0 * mm(qf),
                           min=0.0)
    return -mm(qf)


def split_queries(mesh: Mesh, queries) -> dict:
    """The query batch of each local query row: whole on a 1-D mesh,
    split in equal parts over the query axis of a 2-D one."""
    q = queries if isinstance(queries, torch.Tensor) else \
        torch.as_tensor(queries)
    nq = mesh.n_query
    if q.shape[0] % nq:
        raise ValueError(f"batch {q.shape[0]} not divisible by the query "
                         f"axis {nq}")
    bq = q.shape[0] // nq
    return {g: q[g * bq:(g + 1) * bq] for g in mesh.local_rows()}


def build_sharded_search(mesh: Mesh, *, metric: DistanceMetric, k: int,
                         compute_dtype: str = "float32", sqrt_l2: bool = True,
                         with_stats: bool = False):
    """A sharded search function over ``mesh``:
    ``fn(queries (B, D), vectors (N, D), valid (N,)[, vsq, rinv])`` ->
    ``(dists (B, k), rows (B, k))`` on the mesh's output device.  Arrays
    that are not yet ``ShardedArray``s are row-sharded on the way in;
    queries are split over the query axis when the mesh has one."""
    metric = DistanceMetric.parse(metric)
    coll = mesh.collectives

    def local(q, v, valid, vsq, rinv, j):
        shard_rows = v.shape[0]
        s = _local_scores(q, v, metric, compute_dtype, vsq=vsq, rinv=rinv)
        s = s.masked_fill_(~valid[None, :], float(MASKED))
        vals, idx = smallest_k(s, min(k, shard_rows))
        return vals, idx + j * shard_rows

    def fn(queries, vectors, valid, *stats):
        vectors, valid = shard_corpus(mesh, vectors, valid)
        stats = shard_corpus(mesh, *stats) if stats else ()
        if isinstance(stats, ShardedArray):
            stats = (stats,)
        outs = []
        for g, qg in split_queries(mesh, queries).items():
            parts, qd = [], on_devices(qg, mesh, g)
            for j in coll.axis_index(g):
                st = [s.block(g, j) for s in stats] or [None, None]
                parts.append(local(qd[j], vectors.block(g, j),
                                   valid.block(g, j), *st, j))
            vals, rows = merge_top_k(
                coll.all_gather(g, [p[0] for p in parts]),
                coll.all_gather(g, [p[1] for p in parts]),
                min(k, mesh.n_data * parts[0][0].shape[1]))
            if metric == DistanceMetric.L2 and sqrt_l2:
                vals = torch.where(vals >= float(MASKED), vals,
                                   torch.sqrt(torch.clamp(vals, min=0.0)))
            outs.append((vals, rows))
        return coll.join_queries(outs)

    return fn


def _assign_chunk(x, centroids, csq, chunk: int):
    """argmin_k ||x - c_k||^2 over a block, a fixed-shape product a chunk:
    the tail chunk is zero-padded to ``chunk`` rows, so every row's
    distances come from the same product shape however the corpus is
    split, and every split assigns a row alike."""
    out = torch.empty((x.shape[0],), dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], chunk):
        blk = x[s:s + chunk].float()
        n = blk.shape[0]
        if n < chunk and x.shape[0] > chunk:
            blk = torch.nn.functional.pad(blk, (0, 0, 0, chunk - n))
        dist = csq[None, :] - 2.0 * (blk @ centroids.T)
        out[s:s + n] = torch.argmin(dist, dim=1)[:n]
    return out


def build_sharded_kmeans_step(mesh: Mesh, *, k: int):
    """One distributed Lloyd's step: ``fn(data (N, D), weights (N,),
    centroids (k, D))`` -> ``(new centroids (k, D), counts (k,))``, data
    sharded on the data axis, centroids replicated, per-shard sums and
    counts ``psum``-ed.  Dead centroids keep their place.  Assignment ties
    go to the lower centroid (``argmin``, as ``jnp.argmin``)."""
    coll = mesh.collectives

    def local(data, weights, centroids):
        chunk = KMEANS_CHUNK
        csq = (centroids * centroids).sum(dim=1)
        a = _assign_chunk(data, centroids, csq, chunk)
        w = weights.float()
        sums = torch.zeros((k, data.shape[1]), dtype=torch.float32,
                           device=data.device)
        for s in range(0, data.shape[0], chunk):
            sums.index_add_(0, a[s:s + chunk],
                            data[s:s + chunk].float() * w[s:s + chunk, None])
        counts = torch.zeros((k,), dtype=torch.float32, device=data.device)
        counts.index_add_(0, a, w)
        return sums, counts

    def fn(data, weights, centroids):
        data, weights = shard_corpus(mesh, data, weights)
        cent = replicate(mesh, centroids)
        g = mesh.local_rows()[0]
        parts = [local(data.block(g, j), weights.block(g, j),
                       cent.on(mesh.device(g, j)).float())
                 for j in coll.axis_index(g)]
        sums = coll.psum(g, [p[0] for p in parts])
        counts = coll.psum(g, [p[1] for p in parts])
        c0 = cent.on(sums.device).float()
        alive = counts > 0
        new_c = torch.where(alive[:, None],
                            sums / torch.clamp(counts, min=1.0)[:, None], c0)
        return new_c, counts

    return fn


class ShardedSearcher:
    """A row-sharded corpus and its search, with the per-row stats
    computed once at construction (the corpus is an immutable snapshot)."""

    def __init__(self, mesh: Mesh, vectors, valid, *,
                 metric: DistanceMetric, compute_dtype: str = "float32"):
        self.mesh = mesh
        ndata = mesh.shape[DATA_AXIS]
        n = vectors.shape[0]
        if n % ndata:
            raise ValueError(f"corpus rows {n} not divisible by data axis "
                             f"{ndata}; pad to a power-of-two bucket first")
        self.vectors, self.valid = shard_corpus(mesh, vectors, valid)
        self.metric = DistanceMetric.parse(metric)
        self.compute_dtype = compute_dtype
        stats = {pos: corpus_stats(b)
                 for pos, b in self.vectors.blocks.items()}
        self.vsq = ShardedArray(mesh, {p: s["sq"] for p, s in stats.items()},
                                (n,))
        self.rinv = ShardedArray(mesh, {p: s["rinv"]
                                        for p, s in stats.items()}, (n,))

    def search(self, queries, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        fn = build_sharded_search(self.mesh, metric=self.metric, k=k,
                                  compute_dtype=self.compute_dtype,
                                  with_stats=True)
        return fn(queries, self.vectors, self.valid, self.vsq, self.rinv)


__all__ = ["build_sharded_search", "build_sharded_kmeans_step",
           "ShardedSearcher", "DATA_AXIS", "QUERY_AXIS"]
