"""The port's product quantizer and pq scan kind (fastpyvectordb_tpu_torch:
quant/product.py, quant/kmeans.py:kmeans_fit_batched and the pq kind of
quant/scan.py) against the JAX package on the same seeded inputs.

k-means draws from ``jax.random`` on one side and a ``torch.Generator`` on
the other, so parity is held on codebooks carried across (a JAX-trained
quantizer, a JAX-built snapshot saved and loaded); the port's own training
is held to the JAX tests' quality bounds.  The ADC scan runs no Pallas
kernel in either package."""

import numpy as np
import pytest
import torch

import fastpyvectordb_tpu as J
import fastpyvectordb_tpu_torch as T
from fastpyvectordb_tpu.quant.product import ProductQuantizer as JPQ
from fastpyvectordb_tpu_torch.quant import scan as tscan
from fastpyvectordb_tpu_torch.quant.kmeans import kmeans_fit_batched
from fastpyvectordb_tpu_torch.quant.product import ProductQuantizer as TPQ
from torch_parity import (assert_same_tied_topk, assert_same_topk, clustered,
                          mean_overlap)

N, D = 1500, 32
# ADC sums of the same f32 table entries in another order
ADC_RTOL = 1e-5


def _data(n=N, d=D, b=12, seed=3):
    rng = np.random.default_rng(seed)
    v, centers = clustered(rng, n, d, n_centers=24, normalize=False)
    q = (centers[rng.integers(0, 24, b)]
         + 0.5 * rng.standard_normal((b, d))).astype(np.float32)
    return v, q


def _carried_quantizer(v, m=8, k=16):
    jp = JPQ(m=m, k=k).train(v, iters=6)
    tp = TPQ(dims=v.shape[1], m=m, k=k, device="cpu")
    tp.codebooks = torch.as_tensor(np.array(jp.codebooks))
    return jp, tp


# ---------------------------------------------------------------------------
# (a) the quantizer on carried codebooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k", [(8, 16), (4, 64), (16, 256)])
def test_encode_identical_and_adc_agrees(m, k):
    v, q = _data()
    jp, tp = _carried_quantizer(v, m, k)
    jc, tc = np.asarray(jp.encode(v)), tp.encode(v)
    assert tc.dtype == torch.uint8
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tp.decode(jc), jp.decode(jc))
    jd = np.asarray(jp.distances(q, jc))
    td = tp.distances(q, tc).numpy()
    np.testing.assert_allclose(td, jd, rtol=ADC_RTOL,
                               atol=ADC_RTOL * np.abs(jd).max())
    mask = np.random.default_rng(1).random(N) < 0.7
    jv, ji = jp.search(q, jc, k=10, mask=mask)
    tv, ti = tp.search(q, tc, k=10, mask=mask)
    # rows with equal codes have equal ADC sums: ties at the k-th place
    assert_same_tied_topk(jv, ji, tv, ti, scores=jd, rtol=ADC_RTOL,
                          atol=ADC_RTOL * np.abs(jd).max())
    assert mask[ti].all()
    assert tp.memory_usage(N) == jp.memory_usage(N)


def test_quantizer_save_load_cross_package(tmp_path):
    v, _ = _data()
    jp, _ = _carried_quantizer(v)
    jp.save(tmp_path / "j.fpvt")
    tp = TPQ.load(tmp_path / "j.fpvt", device="cpu")
    np.testing.assert_array_equal(tp.codebooks.numpy(),
                                  np.asarray(jp.codebooks))
    tp.save(tmp_path / "t.fpvt")
    assert (tmp_path / "j.fpvt").read_bytes() == \
        (tmp_path / "t.fpvt").read_bytes()
    back = JPQ.load(tmp_path / "t.fpvt")
    np.testing.assert_array_equal(np.asarray(back.encode(v)),
                                  tp.encode(v).numpy())


def _quant_corpus():
    """tests/test_quant.py's ``corpus`` fixture."""
    rng = np.random.default_rng(7)
    n, d = 2000, 32
    centers = rng.standard_normal((16, d)).astype(np.float32) * 3
    v = centers[rng.integers(0, 16, n)] + rng.standard_normal(
        (n, d)).astype(np.float32)
    q = centers[rng.integers(0, 16, 8)] + rng.standard_normal(
        (8, d)).astype(np.float32)
    return v, q


def test_own_training_quality():
    """The JAX tests' bounds (tests/test_quant.py:TestProduct): decoded
    rows beat the global-mean baseline by 30%, recall@10 >= 0.6."""
    v, q = _quant_corpus()
    tp = TPQ(m=8, device="cpu").train(v, iters=10)
    assert tp.codebooks.shape == (8, 256, 4)  # m=8 over 32 dims
    codes = tp.encode(v)
    back = tp.decode(codes)
    err = np.linalg.norm(back - v, axis=1).mean()
    base = np.linalg.norm(v - v.mean(0), axis=1).mean()
    assert err < base * 0.7
    exact = np.argsort(((q[:, None, :] - v[None]) ** 2).sum(-1),
                       axis=1)[:, :10]
    _, idx = tp.search(q, codes, k=10)
    assert mean_overlap(idx, exact) >= 0.6
    # the training sample is the JAX package's host draw, so the same
    # seed gives the same codebooks again
    again = TPQ(m=8, device="cpu").train(v, iters=10)
    assert torch.equal(again.codebooks, tp.codebooks)
    with pytest.raises(ValueError, match="divisible"):
        TPQ(m=7, device="cpu").train(v)


def test_kmeans_fit_batched_fits_every_subspace():
    rng = np.random.default_rng(6)
    m, k, ds = 5, 8, 3
    centers = 4.0 * rng.standard_normal((m, k, ds)).astype(np.float32)
    pick = rng.integers(0, k, (m, 2000))
    data = (np.take_along_axis(centers, pick[:, :, None], axis=1)
            + 0.05 * rng.standard_normal((m, 2000, ds))).astype(np.float32)
    x = torch.as_tensor(data)
    a = kmeans_fit_batched(x, 2, k=k, iters=10, chunk=300)
    assert torch.equal(a, kmeans_fit_batched(x, 2, k=k, iters=10, chunk=300))
    assert a.shape == (m, k, ds)
    # every subspace is fitted on its own rows: the k-means objective falls
    # far below the subspace's variance (a local minimum may merge two
    # clusters, so no exact recovery is asked)
    for j in range(m):
        inertia = torch.cdist(x[j], a[j]).min(dim=1).values.pow(2).mean()
        var = x[j].var(dim=0).sum()
        assert float(inertia) < 0.2 * float(var), j
    # fewer rows than centroids still fits (initial rows drawn with
    # replacement)
    few = kmeans_fit_batched(x[:, :5], 1, k=k, iters=2)
    assert few.shape == (m, k, ds) and torch.isfinite(few).all()


# ---------------------------------------------------------------------------
# (b) the pq scan kind on a JAX-built snapshot carried across
# ---------------------------------------------------------------------------

def _collection_pair(tmp_path, metric, **build):
    v, q = _data(seed=9)
    ids = [f"v{i}" for i in range(N)]
    metas = [{"cat": i % 4} for i in range(N)]
    jdb = J.VectorDB(tmp_path / "j")
    jc = jdb.create_collection("c", dimensions=D, metric=metric)
    jc.insert_batch(v, ids, metas)
    jc.delete_batch(["v3", "v9"])
    jc.enable_quantized_scan("pq", tune=False, m=8, k=16, iters=4, **build)
    jdb.save()
    tc = T.VectorDB(tmp_path / "j", device="cpu")["c"]
    return jc, tc, v, q


def _same(jres, tres, rtol=ADC_RTOL):
    (jid, jd, jr), (tid, td, tr) = jres, tres
    assert_same_topk(np.where(jr < 0, 3e38, jd), jr,
                     np.where(tr < 0, 3e38, td), tr, rtol=rtol)
    np.testing.assert_array_equal(jid == None, tid == None)  # noqa: E711


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_pq_scan_matches_on_carried_snapshot(tmp_path, metric):
    jc, tc, v, q = _collection_pair(tmp_path, metric)
    js, ts = jc._quantized, tc._quantized
    assert ts.kind == "pq" and ts.default_rerank == js.default_rerank == 16
    np.testing.assert_array_equal(ts.codes[:N].numpy(),
                                  np.asarray(js.codes)[:N])
    # the port's own encoder (on the device, in row blocks; cosine encodes
    # the normalized rows) gives the JAX snapshot's codes
    own = tscan._pq_encode_rows(tc._store.vectors,
                                ts.quantizer.codebooks,
                                normalize=metric == "cosine")
    np.testing.assert_array_equal(own[:N].numpy(), np.asarray(js.codes)[:N])
    np.testing.assert_allclose(ts.coarse_distances(q).numpy()[:, :N],
                               np.asarray(js.coarse_distances(q))[:, :N],
                               rtol=ADC_RTOL, atol=1e-5)
    # a pool covering every row: the same candidates, so the exact re-rank
    # gives the same top-k up to ties
    _same(jc.search_quantized_arrays(q, k=10, rerank=N),
          tc.search_quantized_arrays(q, k=10, rerank=N))
    # cut pools (the default 16 and 4): ADC sums within rounding of each
    # other at the cut may keep other rows on each side
    for rerank in (None, 4):
        _, _, jr = jc.search_quantized_arrays(q, k=10, rerank=rerank)
        _, _, tr = tc.search_quantized_arrays(q, k=10, rerank=rerank)
        assert mean_overlap(jr, tr) >= 0.98
    # rerank=1 serves the ADC sums, which tie for rows with equal codes
    jid, jd, jr = jc.search_quantized_arrays(q, k=10, rerank=1)
    tid, td, tr = tc.search_quantized_arrays(q, k=10, rerank=1)
    assert_same_tied_topk(jd, jr, td, tr, scores=ts.coarse_distances(q),
                          rtol=ADC_RTOL, atol=1e-5)
    flt_j, flt_t = J.Filter.eq("cat", 2), T.Filter.eq("cat", 2)
    _same(jc.search_quantized_arrays(q, k=10, rerank=N, filter=flt_j),
          tc.search_quantized_arrays(q, k=10, rerank=N, filter=flt_t))
    tid, _, _ = tc.search_quantized_arrays(q, k=10, filter=flt_t)
    assert all(int(i[1:]) % 4 == 2 for i in tid.ravel() if i is not None)
    assert not {"v3", "v9"} & set(tid.ravel().tolist())
    assert ts.memory_usage() == js.memory_usage()


def test_pq_tail_merge_and_rerank_tuning(tmp_path):
    jc, tc, v, q = _collection_pair(tmp_path, "l2")
    rng = np.random.default_rng(4)
    new = (q[:5] + 0.1 * rng.standard_normal((5, D))).astype(np.float32)
    for c in (jc, tc):
        c.insert_batch(new, [f"n{i}" for i in range(5)])
    ids, _, _ = tc.search_quantized_arrays(q[:5], k=3)
    assert [r[0] for r in ids.tolist()] == [f"n{i}" for i in range(5)]
    # the tail's exact L2 goes through ||q||^2 + ||x||^2 - 2 q.x in f32,
    # whose absolute error (~1e-6 x ||q||^2 / distance) dominates at the
    # new rows' short distances
    _same(jc.search_quantized_arrays(q, k=10, rerank=N),
          tc.search_quantized_arrays(q, k=10, rerank=N), rtol=1e-4)
    assert (tc._quantized.tune_rerank(q, target_recall=0.9)
            == jc._quantized.tune_rerank(q, target_recall=0.9))


def test_pq_scan_rejects_dot_metric():
    tc = T.VectorDB(None, device="cpu").create_collection(
        "d", dimensions=8, metric="ip")
    tc.insert_batch(np.eye(8, dtype=np.float32), list("abcdefgh"))
    with pytest.raises(ValueError, match="dot"):
        tc.enable_quantized_scan("pq", m=4, k=16)


def test_pq_save_load_both_directions(tmp_path):
    jc, tc, v, q = _collection_pair(tmp_path, "cosine")
    # the carried snapshot is written back byte for byte
    tc.base_path = tmp_path / "t" / "c"
    tc.save()
    assert (tmp_path / "t" / "c" / "collection.fpvt").read_bytes() == \
        (tmp_path / "j" / "c" / "collection.fpvt").read_bytes()
    # the port's own build loads in the JAX package and serves alike
    tdb = T.VectorDB(tmp_path / "p", device="cpu")
    own = tdb.create_collection("c", dimensions=D, metric="cosine")
    own.insert_batch(v, [f"v{i}" for i in range(N)])
    own.enable_quantized_scan("pq", tune=False, m=8, k=16, iters=4)
    tdb.save()
    back = J.VectorDB(tmp_path / "p")["c"]
    assert back._quantized.kind == "pq"
    np.testing.assert_array_equal(np.asarray(back._quantized.codes)[:N],
                                  own._quantized.codes[:N].numpy())
    _same(back.search_quantized_arrays(q, k=10, rerank=N),
          own.search_quantized_arrays(q, k=10, rerank=N))


def test_pq_own_build_recall():
    """tests/test_quant.py:test_pq_two_stage_scan's bound (overlap with the
    exact top-10 >= 0.6 at rerank 8), and the cosine large-norm case of
    test_pq_scan_cosine_normalizes."""
    v, q = _quant_corpus()
    tc = T.VectorDB(None, device="cpu").create_collection(
        "p", dimensions=D, metric="l2")
    tc.insert_batch(v, [f"v{i}" for i in range(len(v))])
    tc.enable_quantized_scan("pq", m=8, iters=6)
    assert tc._quant_kwargs == {"m": 8, "iters": 6}
    _, _, exact = tc.search_arrays(q, k=10)
    _, _, approx = tc.search_quantized_arrays(q, k=10, rerank=8)
    assert mean_overlap(approx, exact) >= 0.6
    rng = np.random.default_rng(0)
    w = rng.standard_normal((1500, D)).astype(np.float32)
    w[:750] *= 20.0
    cc = T.VectorDB(None, device="cpu").create_collection(
        "pc", dimensions=D, metric="cosine")
    cc.insert_batch(w, [f"v{i}" for i in range(1500)])
    cc.enable_quantized_scan("pq", m=8, k=16)
    hits = cc.search_quantized(w[1200:1201] / np.linalg.norm(w[1200]), k=5,
                               rerank=8)[0]
    assert hits[0].id == "v1200"
