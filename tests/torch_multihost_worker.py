"""Worker for tests/test_torch_multihost.py: one of two localhost gloo
processes of the port's multi-process path, with two CPU shards each:
initialize -> global_mesh -> shard_local_corpus -> one sharded exact
search, one ShardedInt8 search and a (query, data) search whose rows are
the two ranks, each checked against a host truth.

Usage: python torch_multihost_worker.py <process_id> <num_processes> <port>
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N_LOCAL, D, B, K = 128, 32, 4, 5


def truth(q, full, k):
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    vn = full / np.linalg.norm(full, axis=1, keepdims=True)
    s = 1.0 - qn @ vn.T
    rows = np.argsort(s, axis=1)[:, :k]
    return np.take_along_axis(s, rows, axis=1), rows


def main() -> None:
    pid, nproc, port = (int(a) for a in sys.argv[1:4])
    import torch
    import torch.distributed as dist
    from fastpyvectordb_tpu_torch import Collection, CollectionConfig
    from fastpyvectordb_tpu_torch.dist import multihost
    from fastpyvectordb_tpu_torch.dist.sharded import build_sharded_search
    from fastpyvectordb_tpu_torch.dist.sharded_ann import ShardedInt8
    multihost.initialize(f"localhost:{port}", nproc, pid, device="cpu",
                         timeout=60)
    multihost.initialize(f"localhost:{port}", nproc, pid, device="cpu")
    assert dist.get_world_size() == nproc and dist.get_backend() == "gloo"
    mesh = multihost.global_mesh(devices=["cpu", "cpu"])
    assert mesh.shape == {"data": 2 * nproc}, mesh.shape
    assert mesh.local_data(0) == [2 * pid, 2 * pid + 1]

    # each process's block is seeded by its rank: every process can
    # rebuild the whole corpus for the truth, none holds it in the mesh
    blocks = [np.random.default_rng(seed).standard_normal(
        (N_LOCAL, D)).astype(np.float32) for seed in range(nproc)]
    full = np.concatenate(blocks)
    v = multihost.shard_local_corpus(mesh, blocks[pid])
    valid = multihost.shard_local_corpus(mesh, np.ones((N_LOCAL,), bool))
    assert v.shape == (nproc * N_LOCAL, D) and len(v.blocks) == 2
    q = np.random.default_rng(99).standard_normal((B, D)).astype(np.float32)
    gt_vals, gt_rows = truth(q, full, K)

    d, r = build_sharded_search(mesh, metric="cosine", k=K)(q, v, valid)
    np.testing.assert_allclose(d.numpy(), gt_vals, atol=1e-5)
    assert all(set(a) == set(b) for a, b in zip(r.tolist(),
                                                gt_rows.tolist()))
    np.testing.assert_array_equal(np.asarray(v), full)

    # the quantized searcher over the same mesh: each rank keeps its rows
    col = Collection(CollectionConfig(name="m", dimensions=D,
                                      metric="cosine"), device="cpu")
    col.insert_batch(full, [f"v{i}" for i in range(full.shape[0])])
    s8 = ShardedInt8.from_scan(mesh, col.enable_quantized_scan(
        "int8", tune=False))
    assert len(s8.codes.blocks) == 2
    d8, r8 = s8.search(q, K, rerank=8)
    hits = np.mean([len(set(a) & set(b)) / K
                    for a, b in zip(r8.tolist(), gt_rows.tolist())])
    assert hits >= 0.9, hits
    np.testing.assert_allclose(np.sort(d8, 1)[:, 0], gt_vals[:, 0],
                               atol=1e-5)

    # (query, data) grid: each rank is one query row of two data shards;
    # every rank gets the whole batch's result
    mesh2 = multihost.global_mesh(query_parallel=nproc,
                                  devices=["cpu", "cpu"])
    assert mesh2.shape == {"query": nproc, "data": 2}
    d2, r2 = build_sharded_search(mesh2, metric="cosine", k=K)(
        torch.as_tensor(q), torch.as_tensor(full),
        torch.ones(full.shape[0], dtype=torch.bool))
    np.testing.assert_allclose(d2.numpy(), gt_vals, atol=1e-5)
    assert all(set(a) == set(b) for a, b in zip(r2.tolist(),
                                                gt_rows.tolist()))
    dist.barrier()
    dist.destroy_process_group()
    print(f"MULTIHOST_OK pid={pid}", flush=True)


if __name__ == "__main__":
    main()
