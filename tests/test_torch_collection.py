"""The PyTorch port's slice as a whole (fastpyvectordb_tpu_torch) against the
JAX package: one seeded clustered corpus goes into a JAX ``VectorDB`` and a
port ``VectorDB(device="cpu")``, and every public path of the slice must
answer alike — exact search (3 metrics, filters, tombstones, upsert,
k > count, empty collections, NaN/Inf rows), the int8 and int4 two-stage
``search_quantized``, and save/load in both directions."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import fastpyvectordb_tpu as J
import fastpyvectordb_tpu_torch as T
from torch_parity import assert_same_topk, clustered, mean_overlap

METRICS = ["cosine", "l2", "ip"]
N, D = 2000, 64
# exact scan: the same f32 products summed in another order; distances
# measured within 2.1e-7 of each other, held at 1e-5 relative
RTOL = 1e-5


def _corpus(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    v, centers = clustered(rng, n, d, n_centers=32)
    q = (centers[rng.integers(0, 32, 24)]
         + 0.5 * rng.standard_normal((24, d))).astype(np.float32)
    ids = [f"v{i}" for i in range(n)]
    metas = [{"cat": i % 5, "year": 2000 + i % 30} for i in range(n)]
    return v, q, ids, metas


def _pair(metric, path_j=None, path_t=None, **cfg):
    v, q, ids, metas = _corpus()
    jdb, tdb = J.VectorDB(path_j), T.VectorDB(path_t, device="cpu")
    jc = jdb.create_collection("c", dimensions=D, metric=metric, **cfg)
    tc = tdb.create_collection("c", dimensions=D, metric=metric, **cfg)
    jc.insert_batch(v, ids, metas)
    tc.insert_batch(v, ids, metas)
    return (jdb, jc), (tdb, tc), v, q


def _same(jres, tres, rtol=RTOL):
    (jid, jd, jr), (tid, td, tr) = jres, tres
    assert_same_topk(np.where(jr < 0, 3e38, jd), jr,
                     np.where(tr < 0, 3e38, td), tr, rtol=rtol)
    np.testing.assert_array_equal(jid == None, tid == None)  # noqa: E711


@pytest.mark.parametrize("metric", METRICS)
def test_exact_search_filters_deletes_upsert(metric):
    (_, jc), (_, tc), v, q = _pair(metric)
    _same(jc.search_arrays(q, k=10), tc.search_arrays(q, k=10))
    flt = J.Filter.and_([J.Filter.eq("cat", 2), J.Filter.gt("year", 2010)])
    tflt = T.Filter.and_([T.Filter.eq("cat", 2), T.Filter.gt("year", 2010)])
    _same(jc.search_arrays(q, k=10, filter=flt),
          tc.search_arrays(q, k=10, filter=tflt))
    # tombstones, an upsert that moves a row, metadata updates
    dead = [f"v{i}" for i in range(0, N, 7)]
    assert jc.delete_batch(dead) == tc.delete_batch(dead) == len(dead)
    for c in (jc, tc):
        c.upsert(v[1] * 0.5 + v[2] * 0.5, "v3", {"cat": 2, "year": 2029})
        c.update_metadata("v8", {"cat": 2})
    _same(jc.search_arrays(q, k=10), tc.search_arrays(q, k=10))
    _same(jc.search_arrays(q, k=10, filter=flt),
          tc.search_arrays(q, k=10, filter=tflt))
    jhits, thits = jc.search(q[0], k=5), tc.search(q[0], k=5)
    assert [h.metadata for h in jhits] == [h.metadata for h in thits]
    np.testing.assert_allclose([h.score for h in thits],
                               [h.score for h in jhits], rtol=RTOL)
    assert jc.count() == tc.count() and jc.get("v3") == tc.get("v3")
    # compact renumbers rows identically
    assert jc.compact() == tc.compact()
    _same(jc.search_arrays(q, k=10), tc.search_arrays(q, k=10))


@pytest.mark.parametrize("metric", METRICS)
def test_exact_search_bf16_compute(metric):
    (_, jc), (_, tc), _, q = _pair(metric, compute_dtype="bfloat16")
    _same(jc.search_arrays(q, k=10), tc.search_arrays(q, k=10))


def test_k_above_count_empty_and_filter_matching_nothing():
    jdb, tdb = J.VectorDB(None), T.VectorDB(None, device="cpu")
    jc = jdb.create_collection("e", dimensions=8)
    tc = tdb.create_collection("e", dimensions=8)
    q = np.ones((2, 8), np.float32)
    assert tc.search(q[0], k=3) == jc.search(q[0], k=3) == []
    _same(jc.search_arrays(q, k=3), tc.search_arrays(q, k=3))
    assert tc.search_quantized(q, k=3) == [[], []]
    rng = np.random.default_rng(1)
    v = rng.standard_normal((6, 8)).astype(np.float32)
    for c in (jc, tc):
        c.insert_batch(v, [f"i{i}" for i in range(6)],
                       [{"t": i} for i in range(6)])
        c.delete("i2")
    _same(jc.search_arrays(q, k=20), tc.search_arrays(q, k=20))
    assert len(tc.search(q[0], k=20)) == 5
    assert tc.search(q[0], k=5, filter=T.Filter.eq("t", 99)) == []
    with pytest.raises(ValueError):
        tc.insert(np.ones(7, np.float32))           # wrong dims
    with pytest.raises(ValueError):
        tc.insert_batch(v[:1], ["i1"])              # duplicate id


@pytest.mark.parametrize("metric", METRICS)
def test_nan_inf_rows_never_surface(metric):
    v, q, ids, _ = _corpus(n=300)
    bad = {5: np.nan, 17: np.inf}
    for r, x in bad.items():
        v[r] = x
    v[40, 3] = np.nan
    jc = J.VectorDB(None).create_collection("n", dimensions=D, metric=metric)
    tc = T.VectorDB(None, device="cpu").create_collection(
        "n", dimensions=D, metric=metric)
    jc.insert_batch(v, ids)
    tc.insert_batch(v, ids)
    (jid, jd, _), (tid, td, _) = (jc.search_arrays(q, k=10),
                                  tc.search_arrays(q, k=10))
    for b in range(len(q)):
        jv = [i for i in jid[b] if i is not None]
        tv = [i for i in tid[b] if i is not None]
        # lax.top_k ranks NaN scores first, where they take result slots
        # and are then dropped; torch.topk ranks them last.  The port
        # returns the JAX hits and fills the freed slots with the next
        # finite ones.
        assert not {"v5", "v17", "v40"} & set(tv)
        assert np.isfinite(td[b][: len(tv)]).all()
        assert len(tv) == 10 and set(jv) <= set(tv)
        np.testing.assert_allclose(
            np.sort(td[b][[tv.index(i) for i in jv]]),
            np.sort(jd[b][jid[b] != None]), rtol=RTOL)  # noqa: E711


def _recall(rows, truth):
    return mean_overlap(rows, truth)


@pytest.mark.parametrize("metric", METRICS)
def test_search_quantized_int8_and_int4(metric):
    (_, jc), (_, tc), _, q = _pair(metric)
    _, _, truth = tc.search_arrays(q, k=10)
    jc.enable_quantized_scan("int8", tune=False)
    tc.enable_quantized_scan("int8", tune=False)
    np.testing.assert_array_equal(tc._quantized.codes.numpy(),
                                  np.asarray(jc._quantized.codes))
    flt_j, flt_t = J.Filter.eq("cat", 1), T.Filter.eq("cat", 1)
    # int8: identical codes and integer products, exact candidates and an
    # exact re-rank on both sides -> ids up to ties
    _same(jc.search_quantized_arrays(q, k=10),
          tc.search_quantized_arrays(q, k=10))
    _same(jc.search_quantized_arrays(q, k=10, filter=flt_j),
          tc.search_quantized_arrays(q, k=10, filter=flt_t))
    jhits = jc.search_quantized(q[:2], k=4)
    thits = tc.search_quantized(q[:2], k=4)
    assert [[h.id for h in r] for r in jhits] == \
        [[h.id for h in r] for r in thits]
    # int4: the JAX package scores the CPU coarse stage with int4mm (an
    # int8-quantized query), the port with the plain int4_scores (bf16
    # operands): different coarse orders, so hold the final top-10 to
    # overlap and recall
    jc.enable_quantized_scan("int4", tune=False)
    tc.enable_quantized_scan("int4", tune=False)
    np.testing.assert_array_equal(tc._quantized.codes.numpy(),
                                  np.asarray(jc._quantized.codes))
    _, _, jr = jc.search_quantized_arrays(q, k=10)
    _, _, tr = tc.search_quantized_arrays(q, k=10)
    assert mean_overlap(jr, tr) >= 0.98
    assert abs(_recall(tr, truth) - _recall(jr, truth)) <= 0.01


def test_quantized_tail_merge_and_deletes():
    (_, jc), (_, tc), v, q = _pair("cosine")
    for c in (jc, tc):
        c.enable_quantized_scan("int8", tune=False)
        c.delete_batch([f"v{i}" for i in range(0, 200)])
        c.insert_batch(v[:50] + 0.01, [f"n{i}" for i in range(50)])
    # tombstones masked, appended rows served by the exact tail merge
    (jid, _, _), (tid, _, _) = (jc.search_quantized_arrays(q, k=10),
                                tc.search_quantized_arrays(q, k=10))
    _same(jc.search_quantized_arrays(q, k=10),
          tc.search_quantized_arrays(q, k=10))
    assert not any(i in {f"v{j}" for j in range(200)}
                   for i in tid.ravel().tolist())
    # rerank=1 returns coarse-unit scores, rescored before the merge
    _same(jc.search_quantized_arrays(q, k=10, rerank=1),
          tc.search_quantized_arrays(q, k=10, rerank=1), rtol=1e-4)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_save_load_both_directions(tmp_path, kind):
    (jdb, jc), (tdb, tc), _, q = _pair("l2", tmp_path / "j", tmp_path / "t")
    for c in (jc, tc):
        c.delete_batch(["v1", "v2"])
        c.enable_quantized_scan(kind, tune=False)
    jdb.save()
    tdb.save()
    # the port writes the JAX package's container byte for byte
    jfile = tmp_path / "j" / "c" / "collection.fpvt"
    tfile = tmp_path / "t" / "c" / "collection.fpvt"
    assert jfile.read_bytes() == tfile.read_bytes()
    # JAX-saved -> port-loaded, port-saved -> JAX-loaded
    t_from_j = T.VectorDB(tmp_path / "j", device="cpu")["c"]
    j_from_t = J.VectorDB(tmp_path / "t")["c"]
    assert t_from_j._quantized.kind == kind and t_from_j.count() == N - 2
    for a, b in ((jc, t_from_j), (j_from_t, tc)):
        _same(a.search_arrays(q, k=10), b.search_arrays(q, k=10))
        _, _, ra = a.search_quantized_arrays(q, k=10)
        _, _, rb = b.search_quantized_arrays(q, k=10)
        assert mean_overlap(ra, rb) >= (1.0 if kind == "int8" else 0.98)


@pytest.mark.cuda
def test_cuda_quantized_snapshot_reload_odd_rows(tmp_path):
    # a saved snapshot holds built_count codes (here 1001, not a multiple
    # of 8); reloaded on the card, the int8 scan must still run
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    v, q, ids, _ = _corpus(n=1001)
    jdb = J.VectorDB(tmp_path / "j")
    jc = jdb.create_collection("c", dimensions=D, metric="cosine")
    jc.insert_batch(v, ids)
    jc.enable_quantized_scan("int8", tune=False)
    jdb.save()
    tc = T.VectorDB(tmp_path / "j", device="cuda")["c"]
    assert tc._quantized.built_count == 1001
    _same(jc.search_quantized_arrays(q, k=10),
          tc.search_quantized_arrays(q, k=10))


def test_collection_from_sections():
    (_, jc), (_, tc), _, q = _pair("cosine")
    jc.enable_quantized_scan("int8", tune=False)
    jc.delete("v4")
    arrays = jc._store.export_arrays()
    q_sections, q_meta = jc._quantized.export_sections()
    sections = {"vectors": arrays["vectors"], "valid": arrays["valid"],
                "ids": jc._row_to_id, "metadata": jc._metadata, **q_sections}
    meta = {"config": jc.config.to_dict(), "kind": "collection",
            "quantized": q_meta}
    col = T.collection_from_sections(meta, sections, device="cpu")
    assert col.count() == jc.count() and col.get("v4") is None
    _same(jc.search_arrays(q, k=10), col.search_arrays(q, k=10))
    _same(jc.search_quantized_arrays(q, k=10),
          col.search_quantized_arrays(q, k=10))


def test_unported_paths_raise_and_keep_ann_data(tmp_path):
    # every path is ported now: a JAX file with a graph ANN section opens
    # with its index (kept, not dropped) and serves it, and the port builds
    # the graph kind itself
    (jdb, jc), _, _, q = _pair("l2", tmp_path / "j")
    with pytest.warns(UserWarning):
        jc.build_ann("graph", r=8, n_entries=16, tune=False)
    jdb.save()
    tj = T.VectorDB(tmp_path / "j", device="cpu")["c"]
    assert tj.config.index == "graph" and tj._ann is not None
    assert np.array_equal(tj._ann.neighbors.numpy(),
                          np.asarray(jc._ann.neighbors))
    _same(jc.search_arrays(q, k=10), tj.search_arrays(q, k=10))
    g = T.VectorDB(None, device="cpu").create_collection("g", dimensions=4)
    pts = np.random.default_rng(0).standard_normal((40, 4)).astype(np.float32)
    g.insert_batch(pts, [f"p{i}" for i in range(40)])
    with pytest.warns(UserWarning, match="graph"):
        g.build_ann(kind="graph", r=8)
    assert g.config.index == "graph" and g._ann.stats()["nodes"] == 40
    assert g.search(pts[7], k=1, exact=False)[0].id == "p7"
    tc = T.VectorDB(None, device="cpu").create_collection("x", dimensions=4)
    tc.insert(np.ones(4, np.float32), "a")
    # the WAL, optimize, prewarm, the stream and the sharded searcher are
    # ported: none raises
    _, rows = tc.as_sharded_searcher().search(np.ones((1, 4), np.float32), 1)
    assert int(rows[0, 0]) == 0
    assert tc.optimize()["installed"] == "exact"
    assert set(tc.prewarm(max_batch=2)) == {"exact_b1", "exact_b2"}
    assert len(list(tc.search_arrays_stream([np.ones((1, 4), np.float32)],
                                            k=1))) == 1
    T.VectorDB(tmp_path / "w", device="cpu").create_collection(
        "w", dimensions=4, durability="wal")
    # a JAX-written write-ahead log is replayed, not skipped
    jw = J.VectorDB(tmp_path / "jw").create_collection(
        "w", dimensions=4, durability="wal")
    jw.insert(np.ones(4, np.float32), "a")
    assert T.VectorDB(tmp_path / "jw", device="cpu")["w"].all_ids() == ["a"]


def _tombstoned_pair():
    (_, jc), (_, tc), v, q = _pair("cosine")
    dead = [f"v{i}" for i in range(0, N, 9)]
    assert jc.delete_batch(dead) == tc.delete_batch(dead)
    return jc, tc, v, q


def test_upsert2_reports_whether_the_id_existed():
    jc, tc, v, _ = _tombstoned_pair()
    # a live id, a tombstoned id (v0 was deleted) and a new one
    for rid, vec in (("v5", v[1]), ("v0", v[2]), ("fresh", v[3])):
        want = jc.upsert2(vec, rid, {"cat": 9})
        got = tc.upsert2(vec, rid, {"cat": 9})
        assert got == want and isinstance(got[1], bool)
    assert [jc.upsert2(v[4], "v5")[1], tc.upsert2(v[4], "v5")[1]] == [True] * 2
    assert tc.upsert(v[6], "v7", {"cat": 1}) == jc.upsert(v[6], "v7",
                                                          {"cat": 1}) == "v7"
    assert tc.count() == jc.count() and tc.get("v0") == jc.get("v0")
    np.testing.assert_array_equal(tc.get("v7", True)["vector"],
                                  jc.get("v7", True)["vector"])


def test_metadata_for_rows_copies_and_masks_out_of_range():
    jc, tc, _, q = _tombstoned_pair()
    _, _, rows = tc.search_arrays(q, k=6, filter=T.Filter.eq("cat", 3))
    rows = np.concatenate([rows, np.full((len(q), 1), -1),
                           np.full((len(q), 1), N + 5),
                           np.zeros((len(q), 1), int)], axis=1)  # v0: dead
    want, got = jc.metadata_for_rows(rows), tc.metadata_for_rows(rows)
    assert got == want
    assert got[0][6] is None and got[0][7] is None and got[0][8] == {}
    got[0][0]["cat"] = "changed"                    # copies, not views
    assert tc.metadata_for_rows(rows)[0][0]["cat"] == 3


@pytest.mark.parametrize("metric", METRICS)
def test_brute_force_search_is_the_exact_scan(metric):
    (_, jc), (_, tc), _, q = _pair(metric)
    for c in (jc, tc):
        c.delete_batch([f"v{i}" for i in range(0, N, 9)])
        c.build_ann("ivf", tune=False, nlist=16)
    flt_j, flt_t = J.Filter.eq("cat", 3), T.Filter.eq("cat", 3)
    for kw_j, kw_t in (({}, {}), ({"filter": flt_j}, {"filter": flt_t})):
        jh = jc.brute_force_search(q[0], k=7, **kw_j)
        th = tc.brute_force_search(q[0], k=7, **kw_t)
        assert [h.id for h in th] == [h.id for h in jh]
        assert [h.metadata for h in th] == [h.metadata for h in jh]
        np.testing.assert_allclose([h.score for h in th],
                                   [h.score for h in jh], rtol=RTOL,
                                   atol=1e-6)
        exact = tc.search(q[0], k=7, exact=True, **kw_t)
        assert [h.id for h in th] == [h.id for h in exact]
    vec = tc.brute_force_search(q[0], k=2, include_vectors=True)[0]
    np.testing.assert_array_equal(vec.vector,
                                  tc.get(vec.id, True)["vector"])


def test_ids_matching_list_ids_and_all_ids():
    jc, tc, _, _ = _tombstoned_pair()
    flt_j = J.Filter.and_([J.Filter.eq("cat", 2), J.Filter.gt("year", 2010)])
    flt_t = T.Filter.and_([T.Filter.eq("cat", 2), T.Filter.gt("year", 2010)])
    want = jc.ids_matching(flt_j)
    assert tc.ids_matching(flt_t) == want and 0 < len(want) < tc.count()
    assert "v0" not in want and tc.ids_matching(T.Filter.eq("cat", 77)) == []
    assert tc.all_ids() == jc.all_ids() and len(tc.all_ids()) == tc.count()
    assert "v0" not in tc.all_ids()
    for kw in ({}, {"limit": 7}, {"limit": 5, "offset": 3},
               {"limit": 10, "offset": tc.count() - 4}):
        assert tc.list_ids(**kw) == jc.list_ids(**kw)
    assert len(tc.list_ids()) == 100 and tc.list_ids(3, 1) == tc.all_ids()[1:4]


def test_default_device_is_cuda(tmp_path):
    # construction with no device means CUDA; on a host without a card
    # it raises instead of falling back to the CPU
    if torch.cuda.is_available():
        assert T.VectorDB(None).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        T.VectorDB(None)
    with pytest.raises(RuntimeError, match="cuda"):
        T.Collection(T.CollectionConfig(name="x", dimensions=4))
    with pytest.raises(RuntimeError, match="cuda"):
        T.BigCollection(4)
    # the standalone quantizers too: host arrays go to the card unless the
    # caller names the CPU, and so does a loaded quantizer
    from fastpyvectordb_tpu_torch.core.store import DeviceVectorStore
    from fastpyvectordb_tpu_torch.quant.binary import BinaryQuantizer
    from fastpyvectordb_tpu_torch.quant.int4 import Int4Quantizer
    from fastpyvectordb_tpu_torch.quant.product import ProductQuantizer
    from fastpyvectordb_tpu_torch.quant.scalar import ScalarQuantizer
    v = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    for cls in (ScalarQuantizer, Int4Quantizer, BinaryQuantizer,
                lambda **kw: ProductQuantizer(m=2, k=4, **kw)):
        with pytest.raises(RuntimeError, match="cuda"):
            cls().train(v)
        assert cls(device="cpu").train(v).encode(v).device.type == "cpu"
        # a tensor keeps its own device
        assert cls().train(torch.as_tensor(v)).device.type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceVectorStore(8)
    sq = ScalarQuantizer(device="cpu").train(v)
    sq.save(tmp_path / "sq.fpvt")
    with pytest.raises(RuntimeError, match="cuda"):
        ScalarQuantizer.load(tmp_path / "sq.fpvt")
    assert ScalarQuantizer.load(tmp_path / "sq.fpvt",
                                device="cpu").vmin.device.type == "cpu"


def test_port_never_imports_jax(tmp_path):
    # the test process has jax loaded (tests/conftest.py), so the check
    # runs in a fresh interpreter with jax blocked
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import fastpyvectordb_tpu_torch as T
        import fastpyvectordb_tpu_torch.ann.ivfpq  # binary, pq, all kernels
        import fastpyvectordb_tpu_torch.kernels.s8_kernels
        import fastpyvectordb_tpu_torch.persist.format
        import fastpyvectordb_tpu_torch.persist.wal
        import fastpyvectordb_tpu_torch.core.costmodel
        from fastpyvectordb_tpu_torch.core.outofcore import (
            QuantizedOutOfCoreSearcher)
        from fastpyvectordb_tpu_torch.state import collection_from_sections
        db = T.VectorDB(sys.argv[1], device="cpu")
        c = db.create_collection("c", dimensions=8)
        c.insert_batch(np.eye(8, dtype=np.float32), list("abcdefgh"))
        c.enable_quantized_scan("int4", tune=False)
        assert c.search_quantized(np.eye(8, dtype=np.float32)[:1], k=1
                                  )[0][0].id == "a"
        db.save()
        assert T.VectorDB(sys.argv[1], device="cpu")["c"].count() == 8
        w = T.VectorDB(sys.argv[1] + "/w", device="cpu").create_collection(
            "w", dimensions=8, durability="wal")
        w.insert_batch(np.eye(8, dtype=np.float32), list("abcdefgh"))
        assert T.VectorDB(sys.argv[1] + "/w", device="cpu")["w"].count() == 8
        ooc = QuantizedOutOfCoreSearcher(np.eye(8, dtype=np.float32),
                                         codec="int8", device="cpu")
        assert ooc.search(np.eye(8, dtype=np.float32)[3], k=1)[1][0, 0] == 3
        c.enable_quantized_scan("int8", tune=False)
        assert c.search_quantized(np.eye(8, dtype=np.float32)[:1], k=1
                                  )[0][0].id == "a"
        big = T.BigCollection(8, codec="int8", base_path=sys.argv[1] + "/big",
                              device="cpu")
        big.insert_batch(np.eye(8, dtype=np.float32), list("abcdefgh"))
        big.save()
        assert T.BigCollection(8, base_path=sys.argv[1] + "/big",
                               device="cpu").search(
            np.eye(8, dtype=np.float32)[2], k=1)[0].id == "c"
        # the serving layer and the feature layers it imports
        from fastpyvectordb_tpu_torch.server.app import create_app
        import fastpyvectordb_tpu_torch.server.router
        import fastpyvectordb_tpu_torch.server.__main__
        import fastpyvectordb_tpu_torch.realtime
        import fastpyvectordb_tpu_torch.http_client
        import fastpyvectordb_tpu_torch.api.client
        import fastpyvectordb_tpu_torch.embeddings as E
        import fastpyvectordb_tpu_torch.graphdb as G
        import fastpyvectordb_tpu_torch.native
        create_app(sys.argv[1] + "/srv", device="cpu")
        assert E.TransformerEmbedder(dimensions=8, n_layers=1, n_heads=2,
                                     vocab_size=64, max_len=4,
                                     device="cpu").embed("a b").shape == (8,)
        g = G.GraphDB()
        g.create_node(["A"], id="x")
        assert len(g.query("MATCH (n:A) RETURN n")) == 1
        assert T.Client(None, embedding_provider="hashing",
                        device="cpu").list_collections() == []
        # multi-card search, the hybrid collection and profiling
        from fastpyvectordb_tpu_torch.dist import mesh as M
        import fastpyvectordb_tpu_torch.dist.sharded
        import fastpyvectordb_tpu_torch.dist.sharded_ann
        import fastpyvectordb_tpu_torch.dist.multihost
        import fastpyvectordb_tpu_torch.dist.collectives
        from fastpyvectordb_tpu_torch.dist.dryrun import dryrun_multichip
        from fastpyvectordb_tpu_torch.hybrid import HybridCollection
        from fastpyvectordb_tpu_torch import profiling
        dryrun_multichip(2, device="cpu")
        h = HybridCollection(T.CollectionConfig(name="h", dimensions=8),
                             text_fields=["t"], device="cpu")
        h.insert_batch(np.eye(8, dtype=np.float32), list("abcdefgh"),
                       [{"t": "red fox"}] + [{"t": "dog"}] * 7)
        assert h.hybrid_search(np.eye(8, dtype=np.float32)[0], "fox",
                               k=1)[0].id == "a"
        with profiling.trace(sys.argv[1] + "/trace", device="cpu"):
            with profiling.annotate("x"):
                h.search(np.eye(8, dtype=np.float32)[0], k=1)
        assert M.make_mesh(4, device="cpu").shape == {"data": 4}
        assert not any(m.startswith(("fastpyvectordb_tpu.", "benchmarks"))
                       or m == "fastpyvectordb_tpu" for m in sys.modules)
        assert not any(m in ("jax", "ml_dtypes")
                       or m.startswith(("jax.", "jaxlib"))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
    """)
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, cwd=root,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    # nor does any file of the port, or its card check, name a module of
    # the JAX package
    import re
    jax_module = re.compile(r"\bfastpyvectordb_tpu\.\w|"
                            r"\b(from|import)\s+fastpyvectordb_tpu\b(?!_)")
    files = [*(root / "fastpyvectordb_tpu_torch").rglob("*.py"),
             root / "chip_smoke.py"]
    assert len(files) > 40
    named = [str(f) for f in files if jax_module.search(f.read_text())]
    assert not named, named


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_batch_splits_at_the_score_budget(kind, monkeypatch):
    # a kind whose kernel writes a (B, N) 4-byte block (int4; int8 past the
    # fused scan's TOPC_MAX candidates) searches a batch whose block would
    # pass the budget in power-of-two sub-batches, with the same hits; the
    # fused int8 scan writes no block and takes the batch whole
    from fastpyvectordb_tpu_torch.quant import scan as tscan
    (_, _), (_, tc), _, q = _pair("cosine")
    tc.enable_quantized_scan(kind, tune=False)
    whole = tc.search_quantized_arrays(q, k=10)
    n_rows = tc._quantized.codes.shape[0]
    monkeypatch.setattr(tscan.QuantizedScan, "_score_hbm_budget",
                        8 * n_rows * 4)          # 8-query sub-batches
    calls = []
    name = f"_{kind}_two_stage"
    orig = getattr(tscan, name)
    monkeypatch.setattr(tscan, name,
                        lambda *a, **kw: calls.append(a[0].shape[0])
                        or orig(*a, **kw))
    _same(whole, tc.search_quantized_arrays(q, k=10), rtol=1e-6)
    if kind == "int8":
        assert calls == [24]
        calls.clear()
        monkeypatch.setattr(tscan, "TOPC_MAX", 8)   # c = 40 is past it
        _same(whole, tc.search_quantized_arrays(q, k=10), rtol=1e-6)
    assert calls == [8, 8, 8]
