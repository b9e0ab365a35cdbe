"""The multi-shard dry run (port of ``__graft_entry__.py``'s
``_dryrun_impl``): every sharded path once, at a small size, on a
single-process mesh of ``n`` logical shards.  It runs the distributed
k-means step, the sharded exact search (on a 2-D (query, data) mesh when
``n`` is even and >= 4), ``ShardedIVF`` with f32 and int8 cells,
``ShardedInt8``, ``ShardedIVFPQ``, the grouped IVF-PQ dispatch at the K=256
default, and a write-ahead-logged collection reloaded from disk; any failed
check raises.
"""

from __future__ import annotations

import tempfile

import numpy as np


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Drive every sharded path on ``n_devices`` logical shards of
    ``device`` (default the CUDA cards; shards share a card when there are
    fewer cards than shards)."""
    import torch

    from ..core.collection import Collection
    from ..core.types import CollectionConfig, DistanceMetric
    from ..core.vectordb import VectorDB
    from .mesh import logical_mesh
    from .sharded import build_sharded_kmeans_step, build_sharded_search
    from .sharded_ann import ShardedInt8, ShardedIVF, ShardedIVFPQ

    # 2-D (query, data) mesh when possible: exercises both axes
    qp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = logical_mesh(n_devices, query_parallel=qp, device=device)
    dev = mesh.out_device()

    n, d, b, k, kc = 64 * n_devices, 32, 8, 5, 4
    rng = np.random.default_rng(0)
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    vt = torch.as_tensor(v, device=dev)
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    weights = torch.ones((n,), dtype=torch.float32, device=dev)

    # training step: one distributed Lloyd's iteration (psum over data)
    step = build_sharded_kmeans_step(mesh, k=kc)
    _, counts = step(vt, weights, vt[:kc])
    _check(int(counts.sum()) == n, "k-means counts do not sum to N")

    # forward step: sharded exact search with the distributed top-k merge
    search = build_sharded_search(mesh, metric=DistanceMetric.COSINE, k=k)
    vals, rows = search(torch.as_tensor(q, device=dev), vt, valid)
    _check(tuple(vals.shape) == (b, k) and tuple(rows.shape) == (b, k),
           "exact search shape")
    _check(bool(((rows >= 0) & (rows < n)).all()), "exact search rows")

    # sharded IVF: tables split along the cell axis, per-shard routing
    col = Collection(CollectionConfig(name="dry", dimensions=d, metric="l2"),
                     device=dev)
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    col.build_ann(kind="ivf", nlist=4 * n_devices, nprobe=4, iters=2)
    _, rows = ShardedIVF.from_index(mesh, col._ann).search(q, k)
    _check(rows.shape == (b, k) and (rows < n).all(), "ShardedIVF")

    # int8 cells + the row-sharded exact re-rank assembled with pmin
    col.build_ann(kind="ivf", nlist=4 * n_devices, nprobe=4, iters=2,
                  cell_dtype="int8")
    sivf8 = ShardedIVF.from_index(mesh, col._ann)
    _check(sivf8.rerank > 0, "int8 cells carry no re-rank")
    _, rows = sivf8.search(q, k)
    _check(rows.shape == (b, k) and (rows < n).all(), "ShardedIVF int8")

    # row-sharded int8 coarse scan + shard-local exact re-rank
    scan = col.enable_quantized_scan("int8")
    _, rows = ShardedInt8.from_scan(mesh, scan).search(q, k)
    _check(rows.shape == (b, k) and (rows < max(n, 1024)).all(),
           "ShardedInt8")

    # cell-sharded ADC scoring, merged candidates, pmin-assembled re-rank
    col.build_ann(kind="ivfpq", nlist=4 * n_devices, nprobe=4, iters=2,
                  m=8, pq_k=16, pq_iters=2)
    _, rows = ShardedIVFPQ.from_index(mesh, col._ann).search(q, k)
    _check(rows.shape == (b, k) and (rows < n).all(), "ShardedIVFPQ")

    # the default IVF-PQ geometry (K=256) through the grouped dispatch
    col.build_ann(kind="ivfpq", nlist=4 * n_devices, nprobe=4, iters=2,
                  pq_iters=2)
    _check(int(col._ann.codebooks.shape[1]) == 256, "IVF-PQ K")
    _, rows = col._ann.search(q, k, grouped=True)
    _check(rows.shape[0] == b and (rows < n).all(), "grouped IVF-PQ")

    # a write-ahead-logged collection: durable inserts replay on reload
    with tempfile.TemporaryDirectory() as td:
        db = VectorDB(td, device=dev)
        wcol = db.create_collection("wal_dry", dimensions=d,
                                    durability="wal")
        wcol.insert_batch(v[:16], [f"w{i}" for i in range(16)])
        wcol2 = VectorDB(td, device=dev).get_collection("wal_dry")
        _check(wcol2.count() == 16, "WAL reload count")
        _, _, wr = wcol2.search_arrays(q[:2], k)
        _check(wr.shape == (2, k), "WAL reload search")
