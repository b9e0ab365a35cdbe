"""The port's serving-mode tools on the CPU: ``Collection.optimize`` with
its cost model (fastpyvectordb_tpu_torch/core/costmodel.py),
``Collection.prewarm`` and the pipelined ``search_arrays_stream``.

The JAX package's own tests of these (tests/test_collection.py) run on
both packages; then parity: with the JAX module's constants set to the
port's, ``exact_cost``, ``graph_cost`` and ``ivf_cost`` outside its int8
branch agree; two tests pin what the port corrects in the JAX module (the
pq flops term takes the quantizer's K; int8 IVF cells take the int8 rate);
one ``optimize`` profile names its winner outright; the stream yields
``search_arrays``' triples bit for bit, and the wire encodings agree with
the JAX package's."""

import types

import numpy as np
import pytest

import fastpyvectordb_tpu as J
import fastpyvectordb_tpu_torch as T
from fastpyvectordb_tpu.core import costmodel as jcm
from fastpyvectordb_tpu_torch.core import costmodel as tcm
from torch_parity import assert_same_topk, mean_overlap


def _package(name):
    if name == "jax":
        return types.SimpleNamespace(
            name=name, Filter=J.Filter, CollectionConfig=J.CollectionConfig,
            Collection=J.Collection, cm=jcm)
    return types.SimpleNamespace(
        name=name, Filter=T.Filter, CollectionConfig=T.CollectionConfig,
        Collection=lambda cfg, base_path=None: T.Collection(
            cfg, base_path=base_path, device="cpu"), cm=tcm)


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _package(request.param)


@pytest.fixture()
def rng():
    return np.random.default_rng(42)


def make_collection(pkg, metric="cosine", dims=16, **kw):
    return pkg.Collection(pkg.CollectionConfig(name="t", dimensions=dims,
                                               metric=metric, **kw))


def _rank(report):
    eligible = {m: v for m, v in report.items()
                if isinstance(v, dict) and v.get("eligible")}
    return min(eligible, key=lambda m: eligible[m].get(
        "cost_us_measured", eligible[m]["cost_us_model"]))


# ---- the JAX package's tests (tests/test_collection.py) on both ---------

def test_prewarm_compiles_enabled_paths(pkg):
    rng = np.random.default_rng(9)
    col = pkg.Collection(pkg.CollectionConfig(name="pw", dimensions=8,
                                              metric="l2"))
    assert col.prewarm() == {}  # empty collection: nothing to run
    col.insert_batch(rng.standard_normal((300, 8)).astype(np.float32),
                     [f"v{i}" for i in range(300)])
    t = col.prewarm(max_batch=4)
    assert set(t) == {"exact_b1", "exact_b2", "exact_b4"}
    assert all(v >= 0 for v in t.values())
    col.enable_quantized_scan("int8", tune=False)
    col.build_ann(kind="ivf", nlist=4, nprobe=2, iters=2)
    t = col.prewarm(max_batch=2)
    assert set(t) == {"exact_b1", "exact_b2", "quantized_b1",
                      "quantized_b2", "ann_b1", "ann_b2"}
    t = col.prewarm(max_batch=1, modes=("exact",))
    assert set(t) == {"exact_b1"}


def test_prewarm_covers_non_pow2_max_batch(pkg):
    rng = np.random.default_rng(1)
    col = pkg.Collection(pkg.CollectionConfig(name="pw2", dimensions=8,
                                              metric="l2"))
    col.insert_batch(rng.standard_normal((100, 8)).astype(np.float32),
                     [f"v{i}" for i in range(100)])
    t = col.prewarm(max_batch=3)
    assert set(t) == {"exact_b1", "exact_b2", "exact_b4"}


def test_optimize_installs_cheapest_eligible_mode(pkg, tmp_path):
    rng = np.random.default_rng(7)
    n, d = 5000, 32
    v = rng.standard_normal((n, d)).astype(np.float32)
    cfg = dict(name="opt", dimensions=d, metric="l2")
    col = pkg.Collection(pkg.CollectionConfig(**cfg),
                         base_path=tmp_path / "opt")
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    report = col.optimize(target_recall=0.9, k=5)
    assert report["exact"]["eligible"]
    assert report["quantized"]["recall"] >= 0.9
    for mode in ("exact", "quantized"):
        assert report[mode]["cost_us_model"] > 0
        assert report[mode]["bytes_per_query"] > 0
    assert report["installed"] == _rank(report)
    assert col.search(v[11], k=3)[0].id == "v11"
    assert col.search(v[11], k=3, exact=True)[0].id == "v11"
    col.save()
    col2 = pkg.Collection(pkg.CollectionConfig(**cfg),
                          base_path=tmp_path / "opt")
    assert col2._serving_mode == report["installed"]
    assert col2.search(v[11], k=3)[0].id == "v11"


def test_optimize_tiny_corpus_stays_exact(pkg):
    rng = np.random.default_rng(8)
    col = pkg.Collection(pkg.CollectionConfig(name="opt2", dimensions=8,
                                              metric="cosine"))
    col.insert_batch(rng.standard_normal((50, 8)).astype(np.float32),
                     [f"v{i}" for i in range(50)])
    report = col.optimize()
    assert report["installed"] == "exact"   # no quantizer below 4096 rows
    assert col.search(rng.standard_normal(8).astype(np.float32),
                      k=3) is not None


def test_optimize_ranks_ivfpq_by_cost_not_bytes(pkg, tmp_path):
    rng = np.random.default_rng(9)
    n, d = 6000, 64
    v = rng.standard_normal((n, d)).astype(np.float32)
    cfg = dict(name="optpq", dimensions=d, metric="l2")
    col = pkg.Collection(pkg.CollectionConfig(**cfg),
                         base_path=tmp_path / "optpq")
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    col.enable_quantized_scan("int8")
    col.build_ann("ivfpq", nlist=64, m=16, tune_target=0.9)
    report = col.optimize(target_recall=0.9, k=5, build=False)
    assert "ann" in report and "quantized" in report
    assert (report["ann"]["bytes_per_query"]
            < report["quantized"]["bytes_per_query"]
            < report["exact"]["bytes_per_query"])
    assert report["installed"] == _rank(report)
    assert col.search(v[42], k=3)[0].id == "v42"
    col.save()
    col2 = pkg.Collection(pkg.CollectionConfig(**cfg),
                          base_path=tmp_path / "optpq")
    assert col2._serving_mode == report["installed"]
    assert col2.search(v[42], k=3)[0].id == "v42"


def test_search_arrays_stream_matches_sync(pkg, rng):
    col = make_collection(pkg, dims=24)
    col.insert_batch(rng.standard_normal((300, 24), dtype=np.float32),
                     [f"v{i}" for i in range(300)])
    batches = [rng.standard_normal((b, 24), dtype=np.float32)
               for b in (1, 7, 32, 3)]
    got = list(col.search_arrays_stream(iter(batches), k=5, depth=2))
    assert len(got) == len(batches)
    for q, (ids, scores, rows) in zip(batches, got):
        eids, escores, erows = col.search_arrays(q, k=5)
        assert (ids == eids).all()
        np.testing.assert_allclose(scores, escores, rtol=1e-5)
        assert (rows == erows).all()


def test_search_arrays_stream_empty_and_filtered(pkg, rng):
    col = make_collection(pkg, dims=8)
    (ids, scores, rows), = col.search_arrays_stream(
        iter([np.zeros((2, 8), np.float32)]), k=4)
    assert ids.shape == (2, 4) and (rows == -1).all()
    col.insert_batch(rng.standard_normal((50, 8), dtype=np.float32),
                     [f"v{i}" for i in range(50)],
                     [{"grp": i % 2} for i in range(50)])
    q = rng.standard_normal((3, 8), dtype=np.float32)
    flt = pkg.Filter().eq("grp", 1)
    (sids, _, srows), = col.search_arrays_stream(iter([q]), k=6, filter=flt)
    eids, _, erows = col.search_arrays(q, k=6, filter=flt)
    assert (srows == erows).all() and (sids == eids).all()


def test_search_arrays_stream_int8_wire_high_overlap(pkg, rng):
    col = make_collection(pkg, dims=32)
    col.insert_batch(rng.standard_normal((2000, 32), dtype=np.float32),
                     [f"v{i}" for i in range(2000)])
    q = rng.standard_normal((16, 32), dtype=np.float32)
    (_, _, r8), = col.search_arrays_stream(iter([q]), k=10,
                                           wire_dtype="int8")
    _, _, rref = col.search_arrays(q, k=10)
    assert mean_overlap(r8, rref) >= 0.9


def test_search_arrays_stream_ann_fallback(pkg, rng):
    col = make_collection(pkg, dims=16)
    col.insert_batch(rng.standard_normal((600, 16), dtype=np.float32),
                     [f"v{i}" for i in range(600)])
    col.build_ann("ivf", nlist=8, tune=False)
    batches = [rng.standard_normal((4, 16), dtype=np.float32)
               for _ in range(3)]
    got = list(col.search_arrays_stream(iter(batches), k=5))
    assert len(got) == 3
    for q, (ids, scores, rows) in zip(batches, got):
        _, _, erows = col.search_arrays(q, k=5)
        assert (rows == erows).all()


# ---- the cost model --------------------------------------------------

@pytest.fixture()
def jax_at_port_constants(monkeypatch):
    monkeypatch.setattr(jcm, "HBM_BW", tcm.HBM_BW)
    monkeypatch.setattr(jcm, "MXU_RATE", dict(tcm.TENSOR_RATE))
    monkeypatch.setattr(jcm, "GATHER_ROW_LAT", tcm.GATHER_ROW_LAT)
    monkeypatch.setattr(jcm, "SERIAL_DISPATCH", tcm.SERIAL_DISPATCH)


PROFILES = [(1_000_000, 768, 1024), (6000, 64, 256), (4096, 96, 1)]


@pytest.mark.parametrize("n,d,batch", PROFILES)
def test_costmodel_agrees_with_jax_at_the_same_constants(
        jax_at_port_constants, n, d, batch):
    for store_b, cd in ((4, "float32"), (2, "bfloat16"), (2, "float16")):
        a, b = jcm.exact_cost(n, d, store_b, cd, batch), \
            tcm.exact_cost(n, d, store_b, cd, batch)
        assert b.cost_us == pytest.approx(a.cost_us, rel=1e-12)
    for args in ((d, 2, 128, 16, 4, 32), (d, 4, 64, 8, 2, 16)):
        assert tcm.graph_cost(*args).cost_us == pytest.approx(
            jcm.graph_cost(*args).cost_us, rel=1e-12)
    # bf16 / f32 cells and IVF-PQ codes (the branches without int8 cells)
    for cell_b, pq_k in ((2 * d, 0), (4 * d, 0), (d // 4, 16), (16, 256)):
        for nlist, nprobe, over, rr in ((2048, 16, 0, 40), (64, 8, 300, 0)):
            args = (n, d, cell_b, nlist, nprobe, over, 2, rr, batch)
            assert tcm.ivf_cost(*args, pq_k=pq_k).cost_us == pytest.approx(
                jcm.ivf_cost(*args, pq_k=pq_k).cost_us, rel=1e-12)


def test_pq_flops_term_takes_the_quantizers_k():
    # the JAX module counts 2 n M 16 whatever K is; the port counts K
    n, d, m = 1_000_000, 768, 96
    for k in (16, 256):
        c = tcm.quantized_cost(n, d, "pq", m, 2, 0, 1024, pq_k=k)
        assert c.flops == 2.0 * n * m * k
    assert jcm.quantized_cost(n, d, "pq", m, 2, 0, 1024).flops == \
        2.0 * n * m * 16
    # optimize() passes the quantizer's K (256 by default) to the model
    rng = np.random.default_rng(5)
    col = T.Collection(T.CollectionConfig(name="k", dimensions=16),
                       device="cpu")
    col.insert_batch(rng.standard_normal((4500, 16)).astype(np.float32),
                     [f"v{i}" for i in range(4500)])
    col.enable_quantized_scan("pq", tune=False, m=4, k=256)
    report = col.optimize(target_recall=0.0, build=False, serving_batch=256)
    want = tcm.quantized_cost(col.count(), 16, "pq", 4, 4,
                              col._quantized.default_rerank * 10, 256,
                              pq_k=256)
    assert report["quantized"]["cost_us_model"] == pytest.approx(
        want.cost_us)


def test_ivf_int8_cells_take_the_int8_rate():
    # cell_bytes is a row's bytes: D for int8 cells.  The JAX module
    # compares it with 1.01 (bytes per dimension) and so never picks the
    # int8 rate; the port compares bytes per dimension
    n, d = 1_000_000, 768
    i8 = tcm.ivf_cost(n, d, d, 2048, 64, 0, 4, 0, 4096)
    bf = tcm.ivf_cost(n, d, 2 * d, 2048, 64, 0, 4, 0, 4096)
    assert i8.rate == tcm.TENSOR_RATE["int8"]
    assert bf.rate == tcm.TENSOR_RATE["bfloat16"]
    assert jcm.ivf_cost(n, d, d, 2048, 64, 0, 4, 0, 4096).rate == \
        jcm.MXU_RATE["bfloat16"]


def test_costmodel_orders_the_headline_profile():
    # 1M x 768, B=1024, the orderings the card measures too (PERF.md §5,
    # busy ms a batch: int8 two-stage 7.4, IVF-PQ 14.6, exact bf16 28.4):
    # the int8 two-stage scan below the exact bf16 scan and below IVF-PQ
    # with a deep re-rank (np64, rr128, m=96, K=256, nlist 2000); the graph
    # beam's serial rounds worst.  (The model puts the exact scan below
    # IVF-PQ: it counts the GEMM, not the passes over the score block.)
    n, d, b = 1_000_000, 768, 1024
    exact = tcm.exact_cost(n, d, 2, "bfloat16", b).cost_us
    int8 = tcm.quantized_cost(n, d, "int8", d, 4, 40, b).cost_us
    ivfpq = tcm.ivf_cost(n, d, 96, 2000, 64, 0, 4, 1280, b,
                         pq_k=256).cost_us
    graph = tcm.graph_cost(d, 4, 128, 16, 4, 32).cost_us
    assert int8 < exact and int8 < ivfpq
    assert graph > 10 * max(exact, int8, ivfpq)


def test_optimize_names_its_winner_outright():
    # 5,000 x 32 rows, l2, an int8 scan tuned to recall 1.0: the exact
    # scan streams 640 kB a batch of 256; the two-stage scan adds >= 40
    # gathered rows a query, each costing GATHER_ROW_LAT at least.  Any
    # sane constants make the exact scan the winner (on the CPU the model
    # decides)
    rng = np.random.default_rng(7)
    col = T.Collection(T.CollectionConfig(name="w", dimensions=32,
                                          metric="l2"), device="cpu")
    v = rng.standard_normal((5000, 32)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(5000)])
    report = col.optimize(target_recall=0.9, k=5)
    assert report["quantized"]["eligible"]
    assert report["installed"] == "exact" and col._serving_mode == "exact"
    assert "cost_us_measured" not in report["exact"]


# ---- the stream against the JAX package ----------------------------------

@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_stream_wires_match_jax(rng, wire, compute):
    v = rng.standard_normal((700, 48)).astype(np.float32)
    batches = [rng.standard_normal((b, 48)).astype(np.float32)
               for b in (5, 64, 1, 17)]
    res = []
    for pkg in (_package("jax"), _package("torch")):
        col = make_collection(pkg, dims=48, metric="l2",
                              compute_dtype=compute)
        col.insert_batch(v, [f"v{i}" for i in range(700)])
        res.append(list(col.search_arrays_stream(iter(batches), k=8,
                                                 depth=3, wire_dtype=wire)))
        if pkg.name == "torch":   # the stream is search_arrays bit for bit
            for q, (ids, d, r) in zip(batches, res[-1]):
                if wire is None:
                    eid, ed, er = col.search_arrays(q, k=8)
                    np.testing.assert_array_equal(d, ed)
                    np.testing.assert_array_equal(r, er)
                    assert (ids == eid).all()
    rtol = 1e-5 if compute == "float32" else 2e-3
    for (jid, jd, jr), (tid, td, tr) in zip(*res):
        assert_same_topk(jd, jr, td, tr, rtol=rtol, atol=1e-5)
