"""The port's graph ANN (fastpyvectordb_tpu_torch/ann/graph_ann.py and the
collection's graph paths) against the JAX package on the same seeded numpy
inputs, on the CPU.

(a) The building blocks: ``_scores_vs_rows`` for the three metrics, the
    exact k-NN chunk, the fill and reverse links and the medoid snap.
(b) The beam search on sections the JAX package built and saved, opened by
    the port: with f32 compute the same hits (the stable sorts follow
    ``lax.top_k``'s tie order, so the beam takes the JAX trajectory), with
    bf16 compute a mean id overlap >= 0.98; filtered, unfiltered and with
    k > beam.
(c) The port's own build at the JAX tests' bounds (tests/test_graph_ann.py,
    the graph cases of tests/test_incremental.py and
    tests/test_ann.py::test_graph_ann_persistence_roundtrip).  k-means
    draws from ``jax.random`` on one side and a ``torch.Generator`` on the
    other, so an own build's routing entries differ from the JAX build's.
(d) Files both ways between the packages, and ``optimize()`` on a graph
    collection."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import fastpyvectordb_tpu as J
import fastpyvectordb_tpu_torch as T
from fastpyvectordb_tpu.ann import graph_ann as jg
from fastpyvectordb_tpu.core import costmodel as jcm
from fastpyvectordb_tpu.persist.format import load_container as j_load
from fastpyvectordb_tpu_torch.ann import graph_ann as tg
from fastpyvectordb_tpu_torch.core import costmodel as tcm
from fastpyvectordb_tpu_torch.core.types import DistanceMetric as TMetric
from fastpyvectordb_tpu.core.types import DistanceMetric as JMetric
from torch_parity import MASKED, assert_same_topk, clustered, mean_overlap

# f32 parity: |port - jax| <= F32_TOL * max(|jax|, 1); the sums run in
# another order, nothing else differs
F32_TOL = 1e-5
# bf16 operands: the same bf16 values on both sides, f32 sums in another
# order
BF16_TOL = 1e-3


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= tol * np.maximum(np.abs(want), 1.0)
                  ), np.abs(got - want).max()


def _ids(res):
    return [[h.id for h in hits] for hits in res]


def _recall(approx, exact, k):
    return np.mean([len(set(a) & set(e)) / k for a, e in zip(approx, exact)])


# ---------------------------------------------------------------------------
# (a) building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["cosine", "l2", "ip"])
@pytest.mark.parametrize("storage,compute", [("float32", "float32"),
                                             ("float32", "bfloat16"),
                                             ("bfloat16", "bfloat16")])
def test_scores_vs_rows_matches_jax(metric, storage, compute):
    rng = np.random.default_rng(3)
    b, c, d = 6, 40, 48
    q = rng.standard_normal((b, d)).astype(np.float32)
    vecs = rng.standard_normal((b, c, d)).astype(np.float32)
    jv = jnp.asarray(vecs).astype(storage)
    tv = torch.from_numpy(vecs).to(getattr(torch, storage))
    want = jg._scores_vs_rows(jnp.asarray(q), jv, JMetric.parse(metric),
                              compute)
    got = tg._scores_vs_rows(torch.from_numpy(q), tv, TMetric.parse(metric),
                             compute)
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want),
           F32_TOL if compute == "float32" else BF16_TOL)


def _build_inputs(n=1100, d=24, seed=5):
    rng = np.random.default_rng(seed)
    v, _ = clustered(rng, n, d, n_centers=12)
    return v, (v * v).sum(axis=1).astype(np.float32)


def test_knn_graph_chunk_matches_jax_up_to_ties():
    v, sq = _build_inputs()
    n, r, chunk = v.shape[0], 9, 300
    vb = torch.from_numpy(v).bfloat16()
    # the distances both packages select on, in f64 from the bf16 operands
    vb64 = vb.double().numpy()
    sq64 = sq.astype(np.float64)
    for start in (0, 300, n - chunk):       # the last one overlaps
        want = np.asarray(jg._knn_graph_chunk(
            jnp.asarray(v), jnp.asarray(sq), jnp.int32(start), r=r,
            chunk=chunk, n_static=n))
        # 4 KB blocks: 93 rows a block, so the chunk is scored in parts
        got = tg._knn_graph_chunk(vb, torch.from_numpy(sq), start, r=r,
                                  chunk=chunk, block_bytes=4 * 93 * n).numpy()
        rows = np.arange(start, start + chunk)
        assert not (got == rows[:, None]).any()      # self excluded

        def dist(ids):
            return (sq64[rows, None] + sq64[ids] - 2.0 * np.einsum(
                "cd,ckd->ck", vb64[rows], vb64[ids]))
        assert_same_topk(dist(want), want, dist(got), got, rtol=1e-5,
                         atol=1e-5)


def test_link_table_is_the_jax_fill_given_the_same_forward_table():
    # the JAX build's table: forward k-NN columns, then the fill and the
    # reverse links; the port's _link_table on those forward columns must
    # give it back exactly
    rng = np.random.default_rng(8)
    n, d = 700, 16
    v = rng.standard_normal((n, d)).astype(np.float32)
    jc = J.Collection(J.CollectionConfig(name="g", dimensions=d,
                                         metric="l2"))
    jc.insert_batch(v, [f"v{i}" for i in range(n)])
    with pytest.warns(UserWarning):
        jc.build_ann(kind="graph", r=16, chunk=256, seed=11, tune=False)
    tbl = np.asarray(jc._ann.neighbors)
    knn = max(16 // 2, 16 - 4 - 16 // 4)
    got = tg._link_table(tbl[:, :knn].copy(), 16, 11)
    assert got.dtype == np.int32 and np.array_equal(got, tbl)
    # knn == r: the forward table is the table
    assert np.array_equal(tg._link_table(tbl[:, :4], 4, 0), tbl[:, :4])


def test_snap_medoids_matches_jax():
    v, sq = _build_inputs(n=2000, d=32, seed=9)
    rng = np.random.default_rng(10)
    # 300 centroids: two chunks of 256, the second ragged
    cents = (v[rng.integers(0, 2000, 300)]
             + 0.05 * rng.standard_normal((300, 32))).astype(np.float32)
    want = np.asarray(jg._snap_medoids(jnp.asarray(v), jnp.asarray(sq),
                                       jnp.asarray(cents)))
    got = tg._snap_medoids(torch.from_numpy(v), torch.from_numpy(sq),
                           torch.from_numpy(cents))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# (b) the beam search on JAX-built sections carried across
# ---------------------------------------------------------------------------

N, D = 2500, 32


@pytest.fixture(scope="module", params=[
    ("l2", "float32"), ("cosine", "float32"), ("cosine", "bfloat16")],
    ids=lambda p: f"{p[0]}-{p[1]}")
def carried(request, tmp_path_factory):
    """A JAX collection with a graph index, saved; the port's VectorDB over
    the same directory; held-out queries."""
    metric, dtype = request.param
    rng = np.random.default_rng(21)
    v, centers = clustered(rng, N, D, n_centers=20,
                           normalize=metric == "cosine")
    path = tmp_path_factory.mktemp(f"g_{metric}_{dtype}")
    jdb = J.VectorDB(path)
    jc = jdb.create_collection("g", dimensions=D, metric=metric,
                               compute_dtype=dtype, storage_dtype=dtype)
    jc.insert_batch(v, [f"v{i}" for i in range(N)],
                    [{"m": i % 4} for i in range(N)])
    with pytest.warns(UserWarning):
        jc.build_ann(kind="graph", r=12, chunk=512, n_entries=64, beam=32,
                     iters=8, tune=False)
    jdb.save()
    tc = T.VectorDB(path, device="cpu")["g"]
    q = (centers[rng.integers(0, 20, 24)]
         + 0.5 * rng.standard_normal((24, D))).astype(np.float32)
    return jc, tc, q, dtype


def _hold(want, got, dtype):
    if dtype == "float32":
        assert_same_topk(*want, *got, rtol=F32_TOL)
    else:
        # bf16 products: near-equal candidates may swap and steer the beam
        assert mean_overlap(want[1], got[1]) >= 0.98


def test_carried_index_equals_the_jax_one(carried):
    jc, tc, _, _ = carried
    assert tc.config.index == "graph" and not tc._ann.stale
    for name in ("neighbors", "centroids", "medoids"):
        a, b = np.asarray(getattr(jc._ann, name)), \
            getattr(tc._ann, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert tc._ann.stats() == jc._ann.stats()


@pytest.mark.parametrize("k,beam", [(10, None), (5, 16), (40, 16)],
                         ids=["k10", "k5-beam16", "k40-beam16"])
def test_beam_search_matches_jax(carried, k, beam):
    jc, tc, q, dtype = carried
    want = jc._ann.search(q, k, beam=beam)
    got = tc._ann.search(q, k, beam=beam)
    assert got[0].shape == want[0].shape == (len(q), k)
    assert got[1].dtype == np.int32
    _hold(want, got, dtype)


@pytest.mark.parametrize("k", [8, 40], ids=["k8", "k40"])
def test_filtered_beam_search_matches_jax(carried, k):
    jc, tc, q, dtype = carried
    mask = (np.arange(N) % 4) == 1
    want = jc._ann.search(q, k, mask=mask, overfetch=10)
    got = tc._ann.search(q, k, mask=mask, overfetch=10)
    ok = got[0] < MASKED * 0.5
    assert ok.any() and (got[1][ok] % 4 == 1).all()
    _hold(want, got, dtype)
    # through the collection: the filter goes through the same search
    f = J.Filter.eq("m", 1), T.Filter.eq("m", 1)
    a = jc.search_batch(q[:6], k=k, filter=f[0], exact=False)
    b = tc.search_batch(q[:6], k=k, filter=f[1], exact=False)
    if dtype == "float32":
        assert_same_topk([[h.score for h in r] for r in a],
                         [[int(h.id[1:]) for h in r] for r in a],
                         [[h.score for h in r] for r in b],
                         [[int(h.id[1:]) for h in r] for r in b],
                         rtol=F32_TOL)


# ---------------------------------------------------------------------------
# (c) the port's own build at the JAX tests' bounds
# ---------------------------------------------------------------------------

def _port_collection(name, d, metric="l2", device="cpu"):
    return T.Collection(T.CollectionConfig(name=name, dimensions=d,
                                           metric=metric), device=device)


@pytest.fixture(scope="module")
def built():
    # tests/test_graph_ann.py's fixture
    rng = np.random.default_rng(17)
    n, d = 3000, 24
    centers = rng.standard_normal((24, d)).astype(np.float32) * 2
    v = centers[rng.integers(0, 24, n)] + 0.4 * rng.standard_normal(
        (n, d)).astype(np.float32)
    col = _port_collection("g", d)
    col.insert_batch(v, [f"v{i}" for i in range(n)],
                     [{"m": i % 3} for i in range(n)])
    with pytest.warns(UserWarning, match="graph"):
        col.build_ann(kind="graph", r=16, chunk=1024, beam=64, iters=12)
    q = centers[rng.integers(0, 24, 16)] + 0.4 * rng.standard_normal(
        (16, d)).astype(np.float32)
    return col, v, q


def test_graph_shape_and_no_self_loops(built):
    col, v, q = built
    tbl = col._ann.neighbors.numpy()
    assert tbl.shape == (3000, 16) and tbl.dtype == np.int32
    assert (tbl == np.arange(3000)[:, None]).sum() == 0
    assert (tbl >= 0).all() and (tbl < 3000).all()
    assert set(col._ann.build_seconds) == {"knn", "links", "kmeans",
                                           "medoids"}


def test_recall_vs_exact(built):
    col, v, q = built
    exact = _ids(col.search_batch(q, k=10, exact=True))
    approx = _ids(col.search_batch(q, k=10, exact=False))
    assert _recall(approx, exact, 10) >= 0.9


def test_results_are_deduplicated(built):
    col, v, q = built
    _, rows = col._ann.search(q, 10)
    for r in rows:
        real = r[r >= 0]
        assert len(set(real.tolist())) == len(real)


def test_wider_beam_not_worse(built):
    col, v, q = built
    _, exact_rows = col._store.search(q, 10, col.config.metric)

    def rec(rows):
        return np.mean([len(set(a.tolist()) & set(e.tolist())) / 10
                        for a, e in zip(rows, exact_rows)])
    _, narrow = col._ann.search(q, 10, beam=16, iters=4)
    _, wide = col._ann.search(q, 10, beam=128, iters=16)
    assert rec(wide) >= rec(narrow)
    assert rec(wide) >= 0.9


def test_filtered_graph_search(built):
    col, v, q = built
    res = col.search_batch(q[:4], k=5, filter=T.Filter.eq("m", 1),
                           exact=False)
    assert all(h.metadata["m"] == 1 for hits in res for h in hits)
    assert any(hits for hits in res)


def test_tune(built):
    col, v, q = built
    out = col._ann.tune(q, target_recall=0.9, k=10)
    assert out["recall"] >= 0.9
    assert (col._ann.beam, col._ann.iters) == (out["beam"], out["iters"])


def test_graph_ann_k_larger_than_beam(built):
    """Unfiltered k > beam widens the beam rather than truncate."""
    col, v, q = built
    old = col._ann.beam
    try:
        col.set_search_params(beam=16)
        hits = col.search(q[0], k=40, exact=False)
        assert len(hits) == 40, len(hits)
    finally:
        col.set_search_params(beam=old)


def test_n_init_and_device_out_overrides(built):
    col, v, q = built
    ann = col._ann
    vals, rows = ann.search(q[:4], 5, n_init=4)
    assert isinstance(rows, np.ndarray) and rows.shape == (4, 5)
    dvals, drows = ann.search(q[:4], 5, n_init=4, device_out=True)
    assert isinstance(drows, torch.Tensor)      # stays on the device
    assert np.array_equal(drows.numpy(), rows)
    assert np.allclose(dvals.numpy(), vals)
    # a tensor of queries takes the same path
    _, trows = ann.search(torch.from_numpy(q[:4]), 5, n_init=4)
    assert np.array_equal(trows, rows)
    _, wide = ann.search(q[:4], 5, n_init=ann.medoids.shape[0])
    assert wide.shape == (4, 5)


def test_insert_served_via_tail_merge(built):
    col, v, q = built
    col.insert(np.full(24, 7.5, dtype=np.float32), id="far")
    assert not col._ann.stale  # incremental: no rebuild on insert
    hits = col.search(np.full(24, 7.5, dtype=np.float32), k=1, exact=False)
    assert hits[0].id == "far"


def test_deleted_rows_vanish_and_memo_refreshes(rng):
    """Tombstoned rows are never returned.  Deleted neighbour targets are
    pre-masked to -1 in a memoized navigation table; a delete writes
    ``store.valid`` in place, so the memo must key on the store version."""
    n, d = 600, 16
    v = rng.standard_normal((n, d)).astype(np.float32)
    col = _port_collection("gdel", d)
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    with pytest.warns(UserWarning):
        col.build_ann(kind="graph", r=8, chunk=256)
    _, rows = col._ann.search(v[:8], 1)
    assert (rows[:, 0] == np.arange(8)).all()
    valid = col._store.valid
    col.delete_batch([f"v{i}" for i in range(8)])
    assert col._store.valid is valid          # written in place
    _, rows = col._ann.search(v[:16], 5)
    assert not (set(rows.ravel().tolist()) & set(range(8))), rows[:, 0]
    # the survivors must still be reachable through the masked table
    assert (rows[8:, 0] == np.arange(8, 16)).all()
    # and a second delete after the memo was rebuilt
    col.delete("v8")
    _, rows = col._ann.search(v[8:10], 3)
    assert 8 not in rows.ravel().tolist()


def test_zero_iter_override_is_respected():
    """iters=0 means zero expansion rounds (entry points only)."""
    rng = np.random.default_rng(0)
    col = _port_collection("g0", 16)
    col.insert_batch(rng.standard_normal((800, 16)).astype(np.float32),
                     [f"v{i}" for i in range(800)])
    with pytest.warns(UserWarning):
        col.build_ann(kind="graph", r=8, n_entries=64, iters=6)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    _, r_def = col._ann.search(q, 5)
    _, r0 = col._ann.search(q, 5, iters=0)
    assert r0.shape == (4, 5)
    assert not np.array_equal(r0, r_def)  # 0 rounds != 6 rounds


def test_dot_metric_refuses_to_build():
    col = _port_collection("gd", 8, metric="ip")
    col.insert_batch(np.eye(8, dtype=np.float32))
    with pytest.warns(UserWarning), pytest.raises(ValueError, match="dot"):
        col.build_ann(kind="graph")


# -- tests/test_incremental.py's graph cases --------------------------------

INC_D = 20


def _mk(n, seed=3, **ann_kwargs):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, INC_D)).astype(np.float32)
    col = T.Collection(T.CollectionConfig(name="inc", dimensions=INC_D,
                                          metric="l2"), device="cpu")
    col.insert_batch(v, [f"v{i}" for i in range(n)],
                     [{"g": i % 4} for i in range(n)])
    with pytest.warns(UserWarning):
        col.build_ann(kind="graph", **ann_kwargs)
    return col, v, rng


def test_insert_after_build_no_rebuild():
    col, v, rng = _mk(1200, r=8, chunk=256)
    built_count = col._ann._built_count
    target = np.full((INC_D,), 7.5, dtype=np.float32)
    col.insert(target, id="tail-hit")
    assert not col._ann.stale
    hits = col.search(target, k=3, exact=False)
    assert hits[0].id == "tail-hit"
    assert col._ann._built_count == built_count  # merge path, not rebuild


def test_delete_after_build_no_rebuild():
    col, v, rng = _mk(1200, r=8, chunk=256)
    built_count = col._ann._built_count
    assert col.delete("v5")
    assert not col._ann.stale
    hits = col.search(v[5], k=5, exact=False)
    assert "v5" not in [h.id for h in hits]
    assert col._ann._built_count == built_count


def test_selective_filter_routes_to_exact():
    col, v, rng = _mk(3000, r=8, chunk=512)
    for i in range(12):
        col.update_metadata(f"v{i * 250}", {"rare": True})
    f = T.Filter.eq("rare", True)
    res = col.search_batch(v[:8], k=6, filter=f)
    exact = col.search_batch(v[:8], k=6, filter=f, exact=True)
    assert _ids(res) == _ids(exact)
    assert all(len(r) == 6 for r in res)


def test_moderate_filter_graph_ann_recall():
    col, v, rng = _mk(3000, r=12, chunk=512)
    f = T.Filter.eq("g", 2)  # 25% of rows
    res = col.search_batch(v[:12], k=8, filter=f)
    exact = col.search_batch(v[:12], k=8, filter=f, exact=True)
    assert all(h.metadata["g"] == 2 for r in res for h in r)
    assert _recall(_ids(res), _ids(exact), 8) >= 0.5


def test_background_rebuild_swaps_in_a_graph():
    """Tail growth past the drift threshold rebuilds the graph in the
    background with the caller's build parameters."""
    col, v, rng = _mk(64, r=8, chunk=256, n_entries=16, beam=32, iters=6)
    old = col._ann
    extra = rng.standard_normal((4200, INC_D)).astype(np.float32)
    col.insert_batch(extra, [f"x{i}" for i in range(4200)])
    assert col.search(extra[7], k=3, exact=False)[0].id == "x7"
    assert col.wait_for_rebuild(timeout=120)
    assert col._ann is not old and col._ann._built_count == 64 + 4200
    assert col._ann.stats()["degree"] == 8 and col._ann.beam == 32
    assert col.search(extra[9], k=3, exact=False)[0].id == "x9"


# -- tests/test_ann.py::test_graph_ann_persistence_roundtrip ----------------

def test_graph_ann_persistence_roundtrip(tmp_path, rng):
    v = rng.standard_normal((400, 16)).astype(np.float32)
    col = T.Collection(T.CollectionConfig(name="g", dimensions=16,
                                          metric="l2"),
                       base_path=tmp_path / "g", device="cpu")
    col.insert_batch(v, [f"v{i}" for i in range(400)])
    with pytest.warns(UserWarning):
        col.build_ann(kind="graph", r=8, chunk=256)
    col.save()
    col2 = T.Collection(T.CollectionConfig(name="g", dimensions=16),
                        base_path=tmp_path / "g", device="cpu")
    assert col2._ann is not None and col2.config.index == "graph"
    assert torch.equal(col2._ann.neighbors, col._ann.neighbors)
    assert col2.search(v[7], k=1, exact=False)[0].id == "v7"


# ---------------------------------------------------------------------------
# (d) files both ways, optimize()
# ---------------------------------------------------------------------------

def _ann_sections(path):
    c = j_load(path / "g" / "collection.fpvt")
    return {k: c.read(k) for k in c.keys() if k.startswith("ann_")}, \
        c.meta["ann"]


def test_files_both_ways(carried, tmp_path):
    jc, tc, q, dtype = carried
    # the port's save of the JAX file: byte-identical ann_* sections
    tc.base_path = tmp_path / "g"
    tc.save()
    jdir = jc.base_path.parent
    want, want_meta = _ann_sections(jdir)
    got, got_meta = _ann_sections(tmp_path)
    assert got_meta == want_meta and set(got) == set(want) == {
        "ann_neighbors", "ann_centroids", "ann_medoids"}
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape and got[k].tobytes() == want[k].tobytes(), k
    # ... which the JAX package opens and serves as it served its own
    jc2 = J.VectorDB(tmp_path)["g"]
    assert jc2.config.index == "graph"
    a, b = jc.search_arrays(q, k=10), jc2.search_arrays(q, k=10)
    assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])


def test_port_built_graph_opens_in_jax(tmp_path):
    rng = np.random.default_rng(4)
    v, centers = clustered(rng, 1500, 24, n_centers=10)
    tdb = T.VectorDB(tmp_path, device="cpu")
    tc = tdb.create_collection("g", dimensions=24, metric="cosine")
    tc.insert_batch(v, [f"v{i}" for i in range(1500)])
    with pytest.warns(UserWarning):
        tc.build_ann(kind="graph", r=12, chunk=512, n_entries=64, tune=False)
    tc.delete("v3")
    tdb.save()
    jc = J.VectorDB(tmp_path)["g"]
    assert jc.config.index == "graph" and not jc._ann.stale
    assert np.array_equal(np.asarray(jc._ann.neighbors),
                          tc._ann.neighbors.numpy())
    q = (centers[rng.integers(0, 10, 16)]
         + 0.5 * rng.standard_normal((16, 24))).astype(np.float32)
    want = jc._ann.search(q, 10)
    got = tc._ann.search(q, 10)
    assert_same_topk(*want, *got, rtol=F32_TOL)
    assert 2 not in got[1] and 3 not in got[1].ravel().tolist()
    # and back: the JAX package's save of it opens in the port unchanged
    jc.save()
    tc2 = T.VectorDB(tmp_path, device="cpu")["g"]
    assert torch.equal(tc2._ann.neighbors, tc._ann.neighbors)
    assert torch.equal(tc2._ann.centroids, tc._ann.centroids)


def test_collection_from_sections_carries_a_graph(carried):
    jc, _, q, dtype = carried
    arrays = jc._store.export_arrays()
    ann_sections, ann_meta = jc._ann.export_sections()
    sections = {"vectors": arrays["vectors"], "valid": arrays["valid"],
                "ids": jc._row_to_id, "metadata": jc._metadata,
                **ann_sections}
    meta = {"config": jc.config.to_dict(), "kind": "collection",
            "ann": ann_meta}
    col = T.collection_from_sections(meta, sections, device="cpu")
    assert col.config.index == "graph"
    _hold(jc._ann.search(q, 10), col._ann.search(q, 10), dtype)


def test_optimize_reports_the_graph(carried):
    """optimize() on a graph collection prices the ann mode with
    ``graph_cost`` (both packages, the same bytes) and does not raise."""
    jc, tc, _, dtype = carried
    rep_t = tc.optimize(k=5, build=False, install=False)
    rep_j = jc.optimize(k=5, build=False, install=False)
    assert "ann" in rep_t and rep_t["installed"] is None
    a = tc._ann
    store_b = 4 if dtype == "float32" else 2
    assert rep_t["ann"]["cost_us_model"] == pytest.approx(tcm.graph_cost(
        D, store_b, a.beam, a.iters, a.expand, 12).cost_us, rel=1e-12)
    assert rep_t["ann"]["bytes_per_query"] == rep_j["ann"]["bytes_per_query"]
    assert rep_t["ann"]["recall"] == pytest.approx(rep_j["ann"]["recall"],
                                                   abs=0.05)
    assert jcm.graph_cost(D, store_b, a.beam, a.iters, a.expand,
                          12).gather_rows == tcm.graph_cost(
        D, store_b, a.beam, a.iters, a.expand, 12).gather_rows


@pytest.mark.cuda
def test_search_on_the_card_never_syncs():
    """The beam search on the card, on the CPU build's tables: no host
    synchronisation in a ``device_out`` search, and the CPU's hits.  The
    card's products sum in another order, and a near-tie that falls the
    other way steers the beam elsewhere (seen on an H100: the last hit of
    one query of 64), so the hits are held to a mean overlap >= 0.98."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(2)
    v, centers = clustered(rng, 4096, 64, n_centers=16)
    cpu = _port_collection("c", 64, metric="cosine")
    card = _port_collection("c", 64, metric="cosine", device="cuda")
    for c in (cpu, card):
        c.insert_batch(v)
        with pytest.warns(UserWarning):
            c.build_ann(kind="graph", r=16, n_entries=64, tune=False)
    # the card's build selects the same forward links up to ties
    card._ann.neighbors = cpu._ann.neighbors.cuda()
    card._ann.centroids = cpu._ann.centroids.cuda()
    card._ann.medoids = cpu._ann.medoids.cuda()
    q = (centers[rng.integers(0, 16, 64)]
         + 0.5 * rng.standard_normal((64, 64))).astype(np.float32)
    want = cpu._ann.search(q, 10)
    qd = torch.as_tensor(q, device="cuda")
    card._ann.search(qd, 10, device_out=True)      # the memo
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d, r = card._ann.search(qd, 10, device_out=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert r.dtype == torch.int32 and r.shape == (64, 10)
    assert mean_overlap(want[1], r.cpu().numpy()) >= 0.98
    # a row both found scores alike (f32 sums in another order)
    for wd, wr, gd, gr in zip(*want, d.cpu().numpy(), r.cpu().numpy()):
        got = dict(zip(gr.tolist(), gd.tolist()))
        for row, score in zip(wr.tolist(), wd.tolist()):
            if row in got:
                assert got[row] == pytest.approx(score, rel=1e-4, abs=1e-6)


def test_ties_fall_as_in_the_jax_beam():
    """The selections order equal scores by position, as ``lax.top_k``
    does.  Then a corpus of every row twice: each query's hits come in
    copies of equal score (equal up to the last bits: a product's sum order
    depends on its shape), and the port returns the JAX package's hits."""
    s = torch.tensor([[1.0, 0.0, 1.0, 0.0, 1.0, 0.0]])
    assert tg._ascending(s, 6).tolist() == [[1, 3, 5, 0, 2, 4]]
    rng = np.random.default_rng(12)
    half, d = 700, 16
    v = rng.standard_normal((half, d)).astype(np.float32)
    v = np.concatenate([v, v])
    jc = J.Collection(J.CollectionConfig(name="t", dimensions=d,
                                         metric="l2"))
    jc.insert_batch(v, [f"v{i}" for i in range(2 * half)])
    with pytest.warns(UserWarning):
        jc.build_ann(kind="graph", r=8, chunk=512, n_entries=32, beam=16,
                     iters=6, tune=False)
    arrays = jc._store.export_arrays()
    sections, meta = jc._ann.export_sections()
    tc = T.collection_from_sections(
        {"config": jc.config.to_dict(), "ann": meta},
        {"vectors": arrays["vectors"], "valid": arrays["valid"],
         "ids": jc._row_to_id, "metadata": jc._metadata, **sections},
        device="cpu")
    q = (v[rng.integers(0, half, 32)]
         + 0.3 * rng.standard_normal((32, d))).astype(np.float32)
    for k in (4, 10):   # even: a pair of copies is never cut at k
        want, got = jc._ann.search(q, k), tc._ann.search(q, k)
        assert_same_topk(*want, *got, rtol=F32_TOL)
        # the copies of a row come in pairs
        assert (got[1][:, 0::2] % half == got[1][:, 1::2] % half).all()


def test_graph_path_never_imports_jax(tmp_path):
    # the test process has jax loaded (tests/conftest.py): build, search,
    # save and reopen a graph in a fresh interpreter with jax blocked
    import subprocess
    import sys
    import textwrap
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import warnings
        import numpy as np
        import fastpyvectordb_tpu_torch as T
        warnings.simplefilter("ignore")
        v = np.random.default_rng(0).standard_normal((300, 8)).astype("f4")
        db = T.VectorDB(sys.argv[1], device="cpu")
        c = db.create_collection("g", dimensions=8, metric="l2")
        c.insert_batch(v)
        c.build_ann(kind="graph", r=8, n_entries=16)
        assert c._ann.search(v[5], 1)[1][0, 0] == 5
        db.save()
        c2 = T.VectorDB(sys.argv[1], device="cpu")["g"]
        assert c2.config.index == "graph"
        assert c2._ann.search(v[7], 1)[1][0, 0] == 7
        assert not any(m.split(".")[0] in ("jax", "fastpyvectordb_tpu")
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
