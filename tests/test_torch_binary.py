"""The port's binary tier (fastpyvectordb_tpu_torch: quant/binary.py,
kernels/hamming_kernels.py and the binary kind of quant/scan.py) against the
JAX package on the same seeded inputs.

The JAX Pallas kernels (``hamming_mxu_scores``, ``hamming_scores``) run in
interpret mode, as the JAX package's own tests run them; on the CPU the
port's wrappers run their plain PyTorch versions, which must equal them bit
for bit (integer counts).  Thresholds and codes are bit-identical.  Integer
Hamming scores tie massively and ``torch.topk`` breaks ties in no promised
order, so two-stage results are held to the same top-k up to ties when the
candidate pool covers every live row, and to >= 0.98 mean overlap when it
cuts.  The ``cuda``-marked tests at the end run on a card."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastpyvectordb_tpu as J
import fastpyvectordb_tpu_torch as T
from fastpyvectordb_tpu.core.types import DistanceMetric
from fastpyvectordb_tpu.kernels import pallas_quant
from fastpyvectordb_tpu.quant import scan as jscan
from fastpyvectordb_tpu.quant.binary import BinaryQuantizer as JBinary
from fastpyvectordb_tpu.quant.binary import _hamming as j_hamming
from fastpyvectordb_tpu_torch.kernels import hamming_kernels as hk
from fastpyvectordb_tpu_torch.quant import scan as tscan
from fastpyvectordb_tpu_torch.quant.binary import BinaryQuantizer as TBinary
from torch_parity import (assert_same_tied_topk, assert_same_topk, clustered,
                          mean_overlap)

METRICS = ["cosine", "l2", "ip"]
N, D = 1500, 64


def _data(n=300, d=40, b=5, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# (a) B5 / B6: plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,b", [(300, 40, 5), (100, 70, 13), (257, 96, 9)])
def test_hamming_mxu_plain_matches_pallas(n, d, b):
    """B5: the JAX kernel takes +-1 bf16 query bits and word-major codes
    padded to its tiles (test_pallas_kernels.py:108); the port takes packed
    words and row-major codes.  The counts are equal, bit for bit."""
    v, q = _data(n, d, b)
    jb = JBinary().train(v)
    codes_t = jnp.asarray(jb.encode(v)).T
    w = codes_t.shape[0]
    codes_tp = jnp.pad(codes_t, ((0, 0), (0, (-n) % 128)))
    bits = q > np.asarray(jb.thresholds)[None, :]
    bits = np.pad(bits, ((0, (-b) % 8), (0, w * 32 - d)))
    qpm = jnp.asarray(2.0 * bits - 1.0, dtype=jnp.bfloat16)
    want = np.asarray(pallas_quant.hamming_mxu_scores(
        qpm, codes_tp, tile_n=128, interpret=True))[:b, :n]
    tb = TBinary(device="cpu").train(v)
    got = hk.hamming_mxu_scores(tb.encode(q), tb.encode(v))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,d,b", [(300, 40, 5), (100, 70, 13)])
def test_hamming_scores_plain_matches_pallas(n, d, b):
    """B6: ``hamming_distances(use_pallas=True)`` in interpret mode on
    aligned data and on 70-d / 13 x 100 data (test_pallas_kernels.py:48,57)
    against the port's ``hamming_distances``."""
    v, q = _data(n, d, b)
    jb = JBinary().train(v)
    want = np.asarray(jb.hamming_distances(q, jb.encode(v), use_pallas=True))
    np.testing.assert_array_equal(
        want, np.asarray(j_hamming(jb.encode(q), jb.encode(v))))
    tb = TBinary(device="cpu").train(v)
    got = tb.hamming_distances(q, tb.encode(v))
    assert got.dtype == torch.int32 and got.shape == (b, n)
    np.testing.assert_array_equal(got.numpy(), want)
    # the word-major entry gives the same counts
    np.testing.assert_array_equal(
        tb.hamming_distances_t(tb.encode(q), tb.encode(v).T).numpy(), want)


@pytest.mark.parametrize("n,d,b", [(100, 20, 5), (130, 768, 9),
                                   (70, 1500, 13)])
def test_pm1_queries_give_hamming_counts(n, d, b):
    """The +-1 int8 expansion the CUDA kernel multiplies (W 1 / 24 / 47):
    (32W - a+- . c+-) / 2 with ``pm1_queries`` on both sides equals
    ``hamming_scores_plain`` and the Pallas ``hamming_mxu_scores``."""
    v, q = _data(n, d, b, seed=d)
    tb = TBinary(device="cpu").train(v)
    qc, codes = tb.encode(q), tb.encode(v)
    w = codes.shape[1]
    qpm, cpm = hk.pm1_queries(qc), hk.pm1_queries(codes)
    assert qpm.dtype == torch.int8 and qpm.shape == (b, qpm.shape[1])
    assert qpm.shape[1] % hk.KSTEP == 0 and 0 <= qpm.shape[1] - 32 * w \
        < hk.KSTEP
    assert (qpm[:, 32 * w:] == 0).all() and (qpm[:, :32 * w] != 0).all()
    got = (32 * w - qpm.int() @ cpm.int().T) // 2
    np.testing.assert_array_equal(got.numpy(),
                                  hk.hamming_scores_plain(qc, codes).numpy())
    jb = JBinary().train(v)
    codes_t = jnp.pad(jnp.asarray(jb.encode(v)).T, ((0, 0), (0, (-n) % 128)))
    bits = np.pad(q > np.asarray(jb.thresholds)[None, :],
                  ((0, (-b) % 8), (0, w * 32 - d)))
    want = np.asarray(pallas_quant.hamming_mxu_scores(
        jnp.asarray(2.0 * bits - 1.0, dtype=jnp.bfloat16), codes_t,
        tile_n=128, interpret=True))[:b, :n]
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_use_plain_version_and_count_nothing():
    v, q = _data()
    tb = TBinary(device="cpu").train(v)
    before = dict(hk.LAUNCHES)
    hk.hamming_scores(tb.encode(q), tb.encode(v))
    hk.hamming_mxu_scores(tb.encode(q), tb.encode(v))
    assert hk.LAUNCHES == before


@pytest.mark.parametrize("mxu", [False, True])
def test_non_cpu_tensor_never_falls_back(mxu):
    codes = torch.empty((16, 2), dtype=torch.int32, device="meta")
    fn = hk.hamming_mxu_scores if mxu else hk.hamming_scores
    with pytest.raises(ValueError, match="CUDA"):
        fn(torch.zeros((3, 2), dtype=torch.int32), codes)


# ---------------------------------------------------------------------------
# (b) the quantizer: thresholds and codes bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [40, 70, 96])
@pytest.mark.parametrize("method", ["median", "mean", "fixed"])
def test_thresholds_and_codes_bit_identical(method, d):
    v, q = _data(700, d, 9, seed=d)
    kw = {"method": method, "fixed_threshold": 0.1} if method == "fixed" \
        else {"method": method}
    jb, tb = JBinary().train(v, **kw), TBinary(device="cpu").train(v, **kw)
    np.testing.assert_array_equal(tb.thresholds.numpy(),
                                  np.asarray(jb.thresholds))
    jc, tc = np.asarray(jb.encode(v)), tb.encode(v)
    assert jc.dtype == np.uint32 and tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy().view(np.uint32), jc)
    np.testing.assert_array_equal(tb.encode(q).numpy().view(np.uint32),
                                  np.asarray(jb.encode(q)))
    assert tb.memory_usage(700) == jb.memory_usage(700)
    jd, jr = jb.search(q, jc, k=7)
    td, tr = tb.search(q, tc, k=7)
    assert_same_tied_topk(jd, jr, td, tr,
                          scores=np.asarray(j_hamming(jb.encode(q), jc)))


def test_quantizer_save_load_cross_package(tmp_path):
    v, _ = _data()
    jb = JBinary().train(v)
    jb.save(tmp_path / "j.fpvt")
    tb = TBinary.load(tmp_path / "j.fpvt", device="cpu")
    np.testing.assert_array_equal(tb.thresholds.numpy(),
                                  np.asarray(jb.thresholds))
    tb.save(tmp_path / "t.fpvt")
    assert (tmp_path / "j.fpvt").read_bytes() == \
        (tmp_path / "t.fpvt").read_bytes()
    back = JBinary.load(tmp_path / "t.fpvt")
    np.testing.assert_array_equal(np.asarray(back.encode(v)),
                                  tb.encode(v).numpy().view(np.uint32))


# ---------------------------------------------------------------------------
# (c) the binary two-stage functions
# ---------------------------------------------------------------------------

def _two_stage_inputs(n=900, d=70, seed=21):
    rng = np.random.default_rng(seed)
    v, centers = clustered(rng, n, d)
    q = (centers[rng.integers(0, len(centers), 12)]
         + 0.5 * rng.standard_normal((12, d))).astype(np.float32)
    mask = rng.random(n) < 0.8
    return v, q, mask


def _jax_binary_two_stage(v, q, mask, metric, c, monkeypatch):
    """The JAX fused binary two-stage (the TPU dispatch) with its Pallas
    kernel in interpret mode and its caller's padding: B to 8, the
    word-major codes to the 1024-column tile, the mask False on padding."""
    jb = JBinary().train(v)
    codes_t = jnp.asarray(jb.encode(v)).T
    pad = (-v.shape[0]) % 1024
    codes_tp = jnp.pad(codes_t, ((0, 0), (0, pad)))
    mask_p = jnp.pad(jnp.asarray(mask), (0, pad))
    qp = np.pad(q, ((0, (-len(q)) % 8), (0, 0)))
    monkeypatch.setattr(pallas_quant, "hamming_mxu_scores", functools.partial(
        pallas_quant.hamming_mxu_scores, interpret=True))
    jscan._binary_two_stage.clear_cache()
    try:
        jd, jr = jscan._binary_two_stage(
            jnp.asarray(qp), jb.thresholds, codes_tp, jnp.asarray(v), mask_p,
            dims=v.shape[1], metric=DistanceMetric.parse(metric), k=10, c=c,
            rerank_dtype="float32")
        return np.asarray(jd)[:len(q)], np.asarray(jr)[:len(q)]
    finally:
        jscan._binary_two_stage.clear_cache()


@pytest.mark.parametrize("metric", METRICS)
def test_binary_two_stage_matches_pallas_path(metric, monkeypatch):
    """c covers every row: the candidate sets are equal, so the exact
    re-rank gives the same top-k up to ties."""
    v, q, mask = _two_stage_inputs()
    jd, jr = _jax_binary_two_stage(v, q, mask, metric, c=v.shape[0],
                                   monkeypatch=monkeypatch)
    tb = TBinary(device="cpu").train(v)
    td, tr = tscan._binary_two_stage(
        torch.as_tensor(q), tb.thresholds, tb.encode(v), torch.as_tensor(v),
        torch.as_tensor(mask), dims=v.shape[1], metric=DistanceMetric.parse(
            metric), k=10, c=v.shape[0], rerank_dtype="float32")
    assert_same_topk(jd, jr, td.numpy(), tr.numpy(), rtol=1e-5)
    assert mask[tr.numpy()].all()


def test_binary_two_stage_cut_overlaps(monkeypatch):
    """c < n: Hamming ties at the cut may keep other rows on each side."""
    v, q, mask = _two_stage_inputs()
    jd, jr = _jax_binary_two_stage(v, q, mask, "cosine", c=160,
                                   monkeypatch=monkeypatch)
    tb = TBinary(device="cpu").train(v)
    _, tr = tscan._binary_two_stage(
        torch.as_tensor(q), tb.thresholds, tb.encode(v), torch.as_tensor(v),
        torch.as_tensor(mask), dims=v.shape[1], metric=DistanceMetric.COSINE,
        k=10, c=160, rerank_dtype="float32")
    assert mean_overlap(jr, tr.numpy()) >= 0.98


def test_hamming_coarse_topk_matches():
    """The rerank <= 1 scan: chunked per-chunk top-k + merge, against the
    JAX function; the sorted counts are equal, ids up to ties."""
    v, q, mask = _two_stage_inputs()
    jb = JBinary().train(v)
    jd, jr = jscan._hamming_coarse_topk(
        jnp.asarray(jb.encode(q)).T, jnp.asarray(jb.encode(v)).T,
        jnp.asarray(mask), k=25, chunk=256)
    tb = TBinary(device="cpu").train(v)
    td, tr = tscan._hamming_coarse_topk(tb.encode(q), tb.encode(v),
                                        torch.as_tensor(mask), k=25,
                                        chunk=256)
    counts = hk.hamming_scores_plain(tb.encode(q), tb.encode(v)).numpy()
    assert_same_tied_topk(jd, jr, td.numpy(), tr.numpy(), scores=counts)
    assert mask[tr.numpy()].all()


# ---------------------------------------------------------------------------
# (d) the collection's binary snapshot
# ---------------------------------------------------------------------------

def _pair(metric, path_j=None, path_t=None, n=N, **cfg):
    rng = np.random.default_rng(0)
    v, centers = clustered(rng, n, D, n_centers=24)
    q = (centers[rng.integers(0, 24, 16)]
         + 0.5 * rng.standard_normal((16, D))).astype(np.float32)
    ids = [f"v{i}" for i in range(n)]
    metas = [{"cat": i % 5} for i in range(n)]
    jdb, tdb = J.VectorDB(path_j), T.VectorDB(path_t, device="cpu")
    jc = jdb.create_collection("c", dimensions=D, metric=metric, **cfg)
    tc = tdb.create_collection("c", dimensions=D, metric=metric, **cfg)
    jc.insert_batch(v, ids, metas)
    tc.insert_batch(v, ids, metas)
    return (jdb, jc), (tdb, tc), v, q


def _same(jres, tres, rtol=1e-5):
    (jid, jd, jr), (tid, td, tr) = jres, tres
    assert_same_topk(np.where(jr < 0, 3e38, jd), jr,
                     np.where(tr < 0, 3e38, td), tr, rtol=rtol)
    np.testing.assert_array_equal(jid == None, tid == None)  # noqa: E711


@pytest.mark.parametrize("metric", METRICS)
def test_search_quantized_binary(metric):
    (_, jc), (_, tc), _, q = _pair(metric)
    js = jc.enable_quantized_scan("binary", tune=False)
    ts = tc.enable_quantized_scan("binary", tune=False)
    assert ts.default_rerank == js.default_rerank == 128
    np.testing.assert_array_equal(ts.codes.numpy().view(np.uint32),
                                  np.asarray(js.codes))
    # the default depth (128 x 10 of 1500 rows) and a full-depth pool: the
    # JAX CPU path re-ranks in f32 as the port's fused path does here
    _same(jc.search_quantized_arrays(q, k=10, rerank=N),
          tc.search_quantized_arrays(q, k=10, rerank=N))
    _, _, jr = jc.search_quantized_arrays(q, k=10)
    _, _, tr = tc.search_quantized_arrays(q, k=10)
    assert mean_overlap(jr, tr) >= 0.98
    flt_j, flt_t = J.Filter.eq("cat", 1), T.Filter.eq("cat", 1)
    _same(jc.search_quantized_arrays(q, k=10, rerank=N, filter=flt_j),
          tc.search_quantized_arrays(q, k=10, rerank=N, filter=flt_t))
    tid, _, _ = tc.search_quantized_arrays(q, k=10, filter=flt_t)
    assert all(int(i[1:]) % 5 == 1 for i in tid.ravel() if i is not None)
    # rerank=1: Hamming counts straight from the coarse scan
    jid, jd, jr = jc.search_quantized_arrays(q, k=10, rerank=1)
    tid, td, tr = tc.search_quantized_arrays(q, k=10, rerank=1)
    assert_same_tied_topk(jd, jr, td, tr,
                          scores=ts.coarse_distances(q).numpy())
    np.testing.assert_array_equal(jid == None, tid == None)  # noqa: E711
    np.testing.assert_array_equal(
        ts.coarse_distances(q).numpy(),
        np.asarray(js.coarse_distances(q)))
    assert ts.memory_usage() == js.memory_usage()


def test_binary_tombstones_and_tail_merge():
    (_, jc), (_, tc), v, q = _pair("cosine")
    for c in (jc, tc):
        c.enable_quantized_scan("binary", tune=False)
        c.delete_batch([f"v{i}" for i in range(0, 200)])
        c.insert_batch(v[:40] + 0.01, [f"n{i}" for i in range(40)])
    _same(jc.search_quantized_arrays(q, k=10, rerank=N),
          tc.search_quantized_arrays(q, k=10, rerank=N))
    tid, _, _ = tc.search_quantized_arrays(q, k=10)
    assert not {f"v{j}" for j in range(200)} & set(tid.ravel().tolist())
    # rerank=1 scores are Hamming counts, rescored exactly before the merge
    _, _, jr = jc.search_quantized_arrays(q, k=10, rerank=1)
    _, _, tr = tc.search_quantized_arrays(q, k=10, rerank=1)
    assert mean_overlap(jr, tr) >= 0.9


def test_binary_batch_split_at_the_score_budget(monkeypatch):
    (_, _), (_, tc), _, q = _pair("l2")
    tc.enable_quantized_scan("binary", tune=False)
    whole = tc.search_quantized_arrays(q, k=10, rerank=N)
    n_rows = tc._quantized.codes.shape[0]
    monkeypatch.setattr(tscan.QuantizedScan, "_score_hbm_budget",
                        8 * n_rows * 4)          # 8-query sub-batches
    calls = []
    orig = tscan._binary_two_stage
    monkeypatch.setattr(tscan, "_binary_two_stage",
                        lambda *a, **kw: calls.append(a[0].shape[0])
                        or orig(*a, **kw))
    _same(whole, tc.search_quantized_arrays(q, k=10, rerank=N), rtol=0)
    assert calls == [8, 8]


@pytest.mark.parametrize("kind", ["binary", "int8"])
def test_save_load_both_directions(tmp_path, kind):
    (jdb, jc), (tdb, tc), _, q = _pair("l2", tmp_path / "j", tmp_path / "t")
    for c in (jc, tc):
        c.delete_batch(["v1", "v2"])
        c.enable_quantized_scan(kind, tune=False)
    jdb.save()
    tdb.save()
    # the port writes the JAX package's container byte for byte (binary
    # words as uint32)
    assert (tmp_path / "j" / "c" / "collection.fpvt").read_bytes() == \
        (tmp_path / "t" / "c" / "collection.fpvt").read_bytes()
    t_from_j = T.VectorDB(tmp_path / "j", device="cpu")["c"]
    j_from_t = J.VectorDB(tmp_path / "t")["c"]
    assert t_from_j._quantized.kind == kind
    assert t_from_j._quantized.codes.dtype == tc._quantized.codes.dtype
    for a, b in ((jc, t_from_j), (j_from_t, tc)):
        _same(a.search_quantized_arrays(q, k=10, rerank=N),
              b.search_quantized_arrays(q, k=10, rerank=N))


@pytest.mark.parametrize("rebuild", ["inline", "background"])
def test_threshold_rebuild_keeps_the_binary_recipe(rebuild):
    """``enable_quantized_scan``'s kwargs (here ``method="mean"``) are the
    snapshot's recipe: a threshold-triggered rebuild, inline or in the
    background, must train with them again."""
    (_, jc), (_, tc), v, q = _pair("cosine", rebuild=rebuild)
    for c in (jc, tc):
        c.enable_quantized_scan("binary", tune=False, method="mean")
    np.testing.assert_array_equal(tc._quantized.quantizer.thresholds.numpy(),
                                  np.asarray(jc._quantized.quantizer.thresholds))
    old = tc._quantized
    tc.delete_batch([f"v{i}" for i in range(0, N, 2)] +
                    [f"v{i}" for i in range(1, 400, 2)])  # > half the rows
    tc.search_quantized_arrays(q, k=10)
    assert tc.wait_for_rebuild(60)
    new = tc._quantized
    assert new is not old and new.built_n_valid == tc.count()
    # the rebuilt thresholds are the mean of the live rows (strided sample
    # of the capacity buffer's first count rows, as at any build)
    store = tc._store
    n = store.count
    sample = store.vectors[:n].float().numpy()
    np.testing.assert_array_equal(new.quantizer.thresholds.numpy(),
                                  sample.mean(axis=0))
    assert not np.array_equal(new.quantizer.thresholds.numpy(),
                              np.median(sample, axis=0))


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_bf16_snapshot_rounds_the_query_only_on_fused_paths(metric):
    """bf16 serving rounds the query to bf16 only for the fused two-stage
    pipelines (the JAX package's q_dev()); the rerank <= 1 coarse top-k
    takes the f32 query, as the JAX general path does."""
    (_, jc), (_, tc), _, q = _pair(metric, compute_dtype="bfloat16")
    js = jc.enable_quantized_scan("int8", tune=False)
    ts = tc.enable_quantized_scan("int8", tune=False)
    td, tr = ts.search(q, k=10, rerank=1)
    qz = ts.quantizer
    vsq, rinv = ts._stats()
    n = ts.codes.shape[0]
    want_d, _ = tscan._int8_coarse_topk(
        torch.as_tensor(q), ts.codes, qz.vmin, qz.scale, vsq, rinv,
        ts._valid(n), metric=ts.metric, k=10)
    np.testing.assert_allclose(td, want_d.numpy(), rtol=0, atol=1e-6)
    jd, jr = js.search(q, k=10, rerank=1)
    # the int8 tolerance of the JAX package's tests
    assert_same_topk(jd, jr, td, tr, rtol=2e-2)


def test_enable_quantized_scan_accepts_and_ignores_unknown_kwargs():
    # the JAX package forwards kwargs to QuantizedScan.build, where int8
    # and int4 ignore them
    (_, jc), (_, tc), _, q = _pair("l2", n=300)
    jc.enable_quantized_scan("int8", tune=False, foo=1)
    tc.enable_quantized_scan("int8", tune=False, foo=1)
    assert tc._quant_kwargs == {"foo": 1}
    _same(jc.search_quantized_arrays(q, k=5),
          tc.search_quantized_arrays(q, k=5))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(1, 64, 16), (13, 1000, 41),
                                   (70, 3001, 130), (64, 4096, 768),
                                   (13, 1000, 1500), (200, 1000, 32),
                                   (200, 3001, 768), (70, 1000, 1500)])
def test_cuda_hamming_kernels_match_plain(b, n, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    v, q = _data(n, d, b, seed=n)
    tb = TBinary(device="cuda").train(v)
    qc, codes = tb.encode(q), tb.encode(v)
    for name, kern, plain in (
            ("hamming_scores", hk.hamming_scores, hk.hamming_scores_plain),
            ("hamming_mxu_scores", hk.hamming_mxu_scores,
             hk.hamming_mxu_scores_plain)):
        n0 = hk.LAUNCHES[name]
        got, want = kern(qc, codes), plain(qc, codes)
        torch.cuda.synchronize()
        assert hk.LAUNCHES[name] == n0 + 1
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_binary_search_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    v, _ = clustered(rng, 2000, D)
    q = v[:16] + 0.01
    out = {}
    for dev in ("cpu", "cuda"):
        c = T.VectorDB(None, device=dev).create_collection("b", dimensions=D)
        c.insert_batch(v, [f"v{i}" for i in range(len(v))])
        c.enable_quantized_scan("binary", tune=False)
        n0 = dict(hk.LAUNCHES)
        out[dev] = (c.search_quantized_arrays(q, k=10, rerank=200),
                    c.search_quantized_arrays(q, k=10, rerank=1))
        if dev == "cuda":
            assert hk.LAUNCHES["hamming_mxu_scores"] > n0["hamming_mxu_scores"]
            assert hk.LAUNCHES["hamming_scores"] > n0["hamming_scores"]
        counts = c._quantized.coarse_distances(q).cpu().numpy()
    # a pool of every row: the same exact re-rank
    _same(out["cpu"][0], out["cuda"][0], rtol=1e-5)
    # rerank=1 serves Hamming counts, which tie at the k-th place
    (_, cd, cr), (_, gd, gr) = out["cpu"][1], out["cuda"][1]
    assert_same_tied_topk(cd, cr, gd, gr, scores=counts)
