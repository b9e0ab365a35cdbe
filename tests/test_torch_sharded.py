"""The port's sharded exact search, k-means step and meshes
(fastpyvectordb_tpu_torch/dist/mesh.py, collectives.py, sharded.py)
against the JAX package on the same seeded inputs: the JAX side on the
8-device CPU mesh of tests/conftest.py, the port on
``make_mesh(8, device="cpu")``, eight logical CPU shards of one process."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import fastpyvectordb_tpu as J
import fastpyvectordb_tpu_torch as T
from fastpyvectordb_tpu.dist import mesh as jmesh
from fastpyvectordb_tpu.dist import sharded as jsh
from fastpyvectordb_tpu_torch.dist import mesh as tmesh
from fastpyvectordb_tpu_torch.dist import sharded as tsh
from fastpyvectordb_tpu_torch.dist.mesh import DATA_AXIS, QUERY_AXIS
from torch_parity import assert_same_topk

METRICS = ["cosine", "l2", "ip"]


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return jmesh.make_mesh(), tmesh.make_mesh(8, device="cpu")


def _data(seed, n, d, b):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32))


def _exact(q, v, metric, k):
    if metric == "cosine":
        s = 1 - (q / np.linalg.norm(q, axis=1, keepdims=True)) @ (
            v / np.linalg.norm(v, axis=1, keepdims=True)).T
    elif metric == "l2":
        s = np.sqrt(np.maximum(((q[:, None] - v[None]) ** 2).sum(-1), 0))
    else:
        s = -(q @ v.T)
    rows = np.argsort(s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, rows, axis=1), rows


@pytest.mark.parametrize("metric", METRICS)
def test_sharded_search_matches_jax(meshes, metric):
    jm, tm = meshes
    v, q = _data(1, 1024, 16, 6)
    valid = np.ones((1024,), bool)
    valid[::7] = False
    jd, jr = jsh.ShardedSearcher(jm, jnp.asarray(v), jnp.asarray(valid),
                                 metric=metric).search(jnp.asarray(q), 10)
    searcher = tsh.ShardedSearcher(tm, torch.as_tensor(v),
                                   torch.as_tensor(valid), metric=metric)
    td, tr = searcher.search(torch.as_tensor(q), 10)
    assert td.shape == (6, 10) and tr.shape == (6, 10)
    assert_same_topk(np.asarray(jd), np.asarray(jr), td.numpy(), tr.numpy(),
                     rtol=1e-5)
    # and against a host scan of the live rows
    live = np.flatnonzero(valid)
    hd, hr = _exact(q, v[live], metric, 10)
    assert_same_topk(hd, live[hr], td.numpy(), tr.numpy(), rtol=1e-5,
                     atol=1e-5)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_build_sharded_search_unsharded_inputs(meshes, compute_dtype):
    jm, tm = meshes
    v, q = _data(2, 512, 24, 4)
    jfn = jsh.build_sharded_search(jm, metric="l2", k=7,
                                   compute_dtype=compute_dtype)
    tfn = tsh.build_sharded_search(tm, metric="l2", k=7,
                                   compute_dtype=compute_dtype)
    jd, jr = jfn(jnp.asarray(q), jnp.asarray(v), jnp.ones((512,), bool))
    td, tr = tfn(q, v, np.ones((512,), bool))
    rtol = 1e-5 if compute_dtype == "float32" else 1e-3
    assert_same_topk(np.asarray(jd), np.asarray(jr), td.numpy(), tr.numpy(),
                     rtol=rtol)


def test_sharded_respects_validity(meshes):
    _, tm = meshes
    v, _ = _data(3, 512, 8, 1)
    valid = np.zeros((512,), bool)
    valid[100:200] = True
    searcher = tsh.ShardedSearcher(tm, torch.as_tensor(v),
                                   torch.as_tensor(valid), metric="l2")
    d, rows = searcher.search(torch.as_tensor(v[:2]), 16)
    assert ((rows >= 100) & (rows < 200)).all()
    # more hits asked than live rows on one shard: padding stays MASKED
    d, rows = searcher.search(torch.as_tensor(v[:2]), 120)
    assert int((d < 1e38).sum(dim=1).min()) == 100


def test_query_data_2d_mesh():
    tm = tmesh.make_mesh(query_parallel=2, device="cpu")
    assert tm.shape == {QUERY_AXIS: 2, DATA_AXIS: 4}
    jm = jmesh.make_mesh(query_parallel=2)
    v, q = _data(4, 256, 8, 4)
    jd, jr = jsh.build_sharded_search(jm, metric="l2", k=5)(
        jnp.asarray(q), jnp.asarray(v), jnp.ones((256,), bool))
    td, tr = tsh.build_sharded_search(tm, metric="l2", k=5)(
        torch.as_tensor(q), torch.as_tensor(v), torch.ones(256, dtype=bool))
    assert_same_topk(np.asarray(jd), np.asarray(jr), td.numpy(), tr.numpy(),
                     rtol=1e-5)
    hd, hr = _exact(q, v, "l2", 5)
    assert np.array_equal(np.sort(tr.numpy(), 1), np.sort(hr, 1))
    with pytest.raises(ValueError, match="query axis"):
        tsh.build_sharded_search(tm, metric="l2", k=5)(
            torch.as_tensor(q[:3]), torch.as_tensor(v),
            torch.ones(256, dtype=bool))


@pytest.mark.parametrize("weighted", [False, True])
def test_sharded_kmeans_step_matches_jax(meshes, weighted):
    jm, tm = meshes
    rng = np.random.default_rng(5)
    n, d, k = 512, 8, 6
    data = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.random(n).astype(np.float32) + 0.5 if weighted
         else np.ones((n,), np.float32))
    c0 = data[:k].copy()
    jc, jn = jsh.build_sharded_kmeans_step(jm, k=k)(
        jnp.asarray(data), jnp.asarray(w), jnp.asarray(c0))
    tc, tn = tsh.build_sharded_kmeans_step(tm, k=k)(
        torch.as_tensor(data), torch.as_tensor(w), torch.as_tensor(c0))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    assert abs(float(tn.sum()) - float(w.sum())) < 1e-3
    # one shard and eight shards assign alike
    one = tmesh.make_mesh(1, device="cpu")
    c1, n1 = tsh.build_sharded_kmeans_step(one, k=k)(data, w, c0)
    # (weighted counts are f32 sums, added in another order)
    np.testing.assert_allclose(n1.numpy(), tn.numpy(),
                               rtol=1e-6 if weighted else 0)
    np.testing.assert_allclose(c1.numpy(), tc.numpy(), rtol=1e-5, atol=1e-6)


def test_kmeans_step_fixed_chunk_shapes(monkeypatch):
    # a chunk smaller than a shard: the tail chunk is padded, and the
    # result equals the unchunked step
    rng = np.random.default_rng(6)
    data = rng.standard_normal((1000, 8)).astype(np.float32)
    c0 = data[:5].copy()
    w = np.ones((1000,), np.float32)
    mesh4 = tmesh.logical_mesh(4, device="cpu")
    cb, nb = tsh.build_sharded_kmeans_step(mesh4, k=5)(data, w, c0)
    monkeypatch.setattr(tsh, "KMEANS_CHUNK", 64)
    ca, na = tsh.build_sharded_kmeans_step(mesh4, k=5)(data, w, c0)
    np.testing.assert_array_equal(na.numpy(), nb.numpy())
    np.testing.assert_allclose(ca.numpy(), cb.numpy(), rtol=1e-5, atol=1e-6)
    assert int(na.sum()) == 1000


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_collection_as_sharded_searcher(rng, metric):
    cfg = dict(name="s", dimensions=8, metric=metric)
    tcol = T.Collection(T.CollectionConfig(**cfg), device="cpu")
    jcol = J.Collection(J.CollectionConfig(**cfg))
    v = rng.standard_normal((300, 8)).astype(np.float32)
    for c in (tcol, jcol):
        c.insert_batch(v, [f"v{i}" for i in range(300)])
        c.delete("v5")
    s = tcol.as_sharded_searcher()
    assert s.mesh.shape == {DATA_AXIS: 8}
    vals, rows = s.search(torch.as_tensor(v[:4]), 3)
    assert rows[0, 0] == 0 and rows[1, 0] == 1
    # the tombstoned row never appears
    _, r5 = s.search(torch.as_tensor(v[5:6]), 1)
    assert int(r5[0, 0]) != 5
    jd, jr = jcol.as_sharded_searcher().search(jnp.asarray(v[:16]), 5)
    td, tr = s.search(v[:16], 5)
    assert_same_topk(np.asarray(jd), np.asarray(jr), td.numpy(), tr.numpy(),
                     rtol=1e-5)


def test_make_mesh_errors():
    with pytest.raises(ValueError, match="only 8"):
        tmesh.make_mesh(9, device="cpu")
    with pytest.raises(ValueError, match="query_parallel"):
        tmesh.make_mesh(8, query_parallel=3, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_corpus(tmesh.make_mesh(8, device="cpu"),
                           np.zeros((12, 2), np.float32))
    with pytest.raises(ValueError, match="axes"):
        tmesh.Mesh(["cpu"], ("rows",))
    if torch.cuda.is_available():
        assert tmesh.make_mesh().devices[0].type == "cuda"
    else:
        # the card is the default: no silent move to the CPU
        with pytest.raises(RuntimeError, match="cuda"):
            tmesh.make_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            tmesh.logical_mesh(4)
    # an explicit device list may repeat a device
    m = tmesh.Mesh(["cpu"] * 4)
    assert m.shape == {DATA_AXIS: 4} and m.local_data(0) == [0, 1, 2, 3]
    assert tmesh.logical_mesh(16, query_parallel=4,
                              device="cpu").shape == {QUERY_AXIS: 4,
                                                      DATA_AXIS: 4}


def test_shard_and_replicate_blocks():
    m = tmesh.make_mesh(4, device="cpu")
    a = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    sa = tmesh.shard_corpus(m, a)
    assert sa.shape == (8, 3) and sa.block(0, 2).shape == (2, 3)
    # a block on its own device is a view of the caller's tensor
    assert sa.block(0, 1).data_ptr() == a[2].data_ptr()
    np.testing.assert_array_equal(np.asarray(sa), a.numpy())
    r = tmesh.replicate(m, torch.ones(3))
    assert r.on(torch.device("cpu")).shape == (3,)
    assert tmesh.shard_corpus(m, sa) is sa


def test_global_mesh_and_local_shard_single_process(rng):
    from fastpyvectordb_tpu_torch.dist import multihost
    mesh = multihost.global_mesh(devices=["cpu"])
    assert mesh.shape[DATA_AXIS] == 8
    local = rng.standard_normal((64, 4)).astype(np.float32)
    arr = multihost.shard_local_corpus(mesh, local)
    assert arr.shape == (64, 4)
    np.testing.assert_allclose(np.asarray(arr), local, rtol=1e-6)
    mesh2 = multihost.global_mesh(query_parallel=2, devices=["cpu"])
    assert mesh2.shape == {QUERY_AXIS: 2, DATA_AXIS: 4}
    # one process: initialize with nothing to join is a no-op
    multihost.initialize()


@pytest.mark.parametrize("n", [1, 4, 8])
def test_dryrun_multichip_cpu(n):
    from fastpyvectordb_tpu_torch.dist.dryrun import dryrun_multichip
    dryrun_multichip(n, device="cpu")
