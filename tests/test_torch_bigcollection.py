"""The port's BigCollection (fastpyvectordb_tpu_torch/core/bigcollection.py,
host vectors + device codes) on the CPU: the JAX package's own BigCollection
tests run against the port per codec, then parity with the JAX BigCollection
on one seeded corpus per codec, files moved between the packages both ways,
growth across a capacity doubling, the retrain rule, chunked coarse scans
and a filter that matches fewer rows than the candidate pool.

The final scores are exact f32 host scores on both sides (numpy): where the
candidate pool covers every live row the results are held to rtol 1e-5 and
the same ids up to ties; where it cuts, the coarse orders may differ (the
int4 coarse stage scores differently off the TPU; Hamming counts tie
massively and ``torch.topk`` breaks ties in no promised order), so the
top-k is held to a mean overlap of 0.98."""

import numpy as np
import pytest

import fastpyvectordb_tpu as J
import fastpyvectordb_tpu_torch as T
from fastpyvectordb_tpu_torch.core import bigcollection as tbig
from torch_parity import assert_same_topk, mean_overlap

CODECS = ["binary", "int8", "int4"]
RTOL = 1e-5


def BigCollection(*args, **kwargs):
    return T.BigCollection(*args, device="cpu", **kwargs)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((32, 64)).astype(np.float32) * 2
    v = centers[rng.integers(0, 32, 6000)] + 0.3 * rng.standard_normal(
        (6000, 64)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    q = centers[rng.integers(0, 32, 12)] + 0.3 * rng.standard_normal(
        (12, 64)).astype(np.float32)
    return v, q


def exact_topk(v, valid, q, k):
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    s = 1 - qn @ v.T
    s[:, ~valid] = np.inf
    return np.argsort(s, axis=1)[:, :k]


@pytest.fixture(scope="module", params=CODECS)
def built(request, data):
    v, q = data
    col = BigCollection(64, metric="cosine", codec=request.param)
    col.insert_batch(v[:5000], [f"v{i}" for i in range(5000)],
                     [{"g": i % 4} for i in range(5000)])
    return col, v, q


# ---- the JAX package's tests (tests/test_bigcollection.py) on the port ----

def test_recall_vs_exact(built, data):
    col, v, q = built
    gt = exact_topk(v[:5000], np.ones(5000, bool), q, 10)
    hits = col.search_batch(q, k=10, rerank=16)
    rec = np.mean([
        len({int(h.id[1:]) for h in hl} & set(g.tolist())) / 10
        for hl, g in zip(hits, gt)])
    # binary 1-bit coarse + exact re-rank clears 0.8 on clustered data;
    # int8/int4 are near-exact after the re-rank
    assert rec >= (0.8 if col.codec == "binary" else 0.95), rec


def test_incremental_append_served(built, data):
    col, v, q = built
    if col.count() == 5000:
        col.insert_batch(v[5000:6000], [f"v{i}" for i in range(5000, 6000)],
                         [{"g": i % 4} for i in range(5000, 6000)])
    # a query equal to an appended row must find it (no rebuild happened)
    hits = col.search(v[5500], k=3, rerank=16)
    assert hits[0].id == "v5500"


def test_filtered_search(built):
    col, v, q = built
    hits = col.search(q[0], k=8, filter=T.Filter.eq("g", 2), rerank=32)
    assert hits and all(h.metadata["g"] == 2 for h in hits)


def test_delete_tombstones(built, data):
    col, v, q = built
    target = col.search(v[123], k=1)[0]
    assert target.id == "v123"
    assert col.delete("v123")
    hits = col.search(v[123], k=3)
    assert all(h.id != "v123" for h in hits)
    # restore for other tests (unique id, re-insert allowed after delete)
    col.insert(v[123], "v123", {"g": 123 % 4})


def test_dup_and_dims_validation(built):
    col, v, q = built
    with pytest.raises(ValueError):
        col.insert(v[0], "v0")
    with pytest.raises(ValueError):
        col.insert(np.zeros(8, np.float32), "tiny")
    with pytest.raises(ValueError, match="unknown codec"):
        BigCollection(8, codec="pq")


def test_memory_compression(built):
    col, _, _ = built
    m = col.memory_usage()
    want = {"binary": 28, "int4": 7.5}.get(col.codec, 3.5)
    assert m["compression"] >= want, m
    assert col.stats()["kind"] == "bigcollection" and len(col) == col.count()


@pytest.mark.parametrize("codec", CODECS)
def test_persistence_roundtrip(tmp_path, data, codec):
    v, q = data
    col = BigCollection(64, metric="cosine", codec=codec,
                        base_path=tmp_path / "big")
    col.insert_batch(v[:2000], [f"v{i}" for i in range(2000)],
                     [{"g": i % 4} for i in range(2000)])
    col.delete("v7")
    col.save()

    col2 = BigCollection(64, base_path=tmp_path / "big")
    assert col2.codec == codec and col2.count() == 1999
    hits = col2.search(v[42], k=1)
    assert hits[0].id == "v42"
    assert all(h.id != "v7" for h in col2.search(v[7], k=5))
    # reloaded store keeps appending incrementally
    col2.insert(v[3000], "fresh", {"g": 0})
    assert col2.search(v[3000], k=1)[0].id == "fresh"


def test_empty_and_k_gt_count():
    col = BigCollection(16, codec="int8")
    assert col.search(np.zeros(16, np.float32), k=5) == []
    col.insert_batch(np.eye(16, dtype=np.float32)[:3], ["a", "b", "c"])
    hits = col.search(np.eye(16, dtype=np.float32)[0], k=50)
    assert len(hits) == 3 and hits[0].id == "a"
    with pytest.raises(ValueError, match="base_path"):
        col.save()


def test_save_after_load_without_insert(tmp_path):
    """save() right after _load() must not truncate the vectors file that
    self._vectors still memory-maps (load -> delete -> save -> reload)."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((64, 16)).astype(np.float32)
    col = BigCollection(16, codec="binary", base_path=tmp_path / "bc")
    col.insert_batch(v, [f"r{i}" for i in range(64)])
    col.save()
    col2 = BigCollection(16, base_path=tmp_path / "bc")  # memmap-backed
    assert col2.count() == 64
    col2.delete("r3")
    col2.save()
    col3 = BigCollection(16, base_path=tmp_path / "bc")
    assert col3.count() == 63
    got = col3.get("r7", include_vector=True)["vector"]
    np.testing.assert_allclose(got, v[7], rtol=1e-6)


# ---- parity with the JAX package ------------------------------------------

N, D = 3000, 48


def _corpus(metric="cosine", seed=11):
    rng = np.random.default_rng(seed)
    centers = 2 * rng.standard_normal((24, D)).astype(np.float32)
    v = centers[rng.integers(0, 24, N)] + 0.4 * rng.standard_normal(
        (N, D)).astype(np.float32)
    q = centers[rng.integers(0, 24, 16)] + 0.4 * rng.standard_normal(
        (16, D)).astype(np.float32)
    ids = [f"v{i}" for i in range(N)]
    metas = [{"cat": i % 5, "year": 2000 + i % 30} for i in range(N)]
    return v, q, ids, metas


def _pair(codec, metric="cosine", jpath=None, tpath=None, **kw):
    v, q, ids, metas = _corpus(metric)
    jc = J.BigCollection(D, metric=metric, codec=codec, base_path=jpath, **kw)
    tc = BigCollection(D, metric=metric, codec=codec, base_path=tpath, **kw)
    for c in (jc, tc):
        c.insert_batch(v[:2000], ids[:2000], metas[:2000])
        c.insert_batch(v[2000:], ids[2000:], metas[2000:])
        c.delete_batch([f"v{i}" for i in range(0, N, 11)])
    return jc, tc, v, q


def _grids(hits, k):
    """(scores, row numbers) grids of a search_batch result, padded with
    the masked score / -1."""
    d = np.full((len(hits), k), 3e38)
    r = np.full((len(hits), k), -1)
    for b, hl in enumerate(hits):
        d[b, :len(hl)] = [h.score for h in hl]
        r[b, :len(hl)] = [int(h.id[1:]) for h in hl]
    return d, r


def _same_hits(jhits, thits, k):
    jd, jr = _grids(jhits, k)
    td, tr = _grids(thits, k)
    # cosine scores near 0 carry the f32 rounding of 1 - x: absolute 1e-6
    assert_same_topk(jd, jr, td, tr, rtol=RTOL, atol=1e-6)
    for jl, tl in zip(jhits, thits):
        assert {h.id: h.metadata for h in jl if h.id in {x.id for x in tl}} \
            == {h.id: h.metadata for h in tl if h.id in {x.id for x in jl}}


@pytest.mark.parametrize("metric", ["cosine", "l2", "ip"])
@pytest.mark.parametrize("codec", CODECS)
def test_matches_jax_when_the_pool_covers_every_row(codec, metric):
    jc, tc, v, q = _pair(codec, metric)
    assert tc.count() == jc.count() and tc.all_ids() == jc.all_ids()
    # rerank so large that c = every live row: the exact host re-rank sees
    # the whole corpus on both sides
    big = N
    _same_hits(jc.search_batch(q, k=10, rerank=big),
               tc.search_batch(q, k=10, rerank=big), 10)
    flt_j = J.Filter.and_([J.Filter.eq("cat", 2), J.Filter.gt("year", 2010)])
    flt_t = T.Filter.and_([T.Filter.eq("cat", 2), T.Filter.gt("year", 2010)])
    _same_hits(jc.search_batch(q, k=10, filter=flt_j, rerank=big),
               tc.search_batch(q, k=10, filter=flt_t, rerank=big), 10)
    assert tc.get("v5", include_vector=True)["metadata"] == \
        jc.get("v5")["metadata"]
    assert tc.get("v0") is None and jc.get("v0") is None
    assert tc.memory_usage() == jc.memory_usage() and tc.stats() == jc.stats()


@pytest.mark.parametrize("codec", CODECS)
def test_matches_jax_when_the_pool_cuts(codec):
    jc, tc, v, q = _pair(codec)
    jhits = jc.search_batch(q, k=10, rerank=16)
    thits = tc.search_batch(q, k=10, rerank=16)
    _, jr = _grids(jhits, 10)
    td, tr = _grids(thits, 10)
    assert mean_overlap(jr, tr) >= 0.98
    # every hit carries its exact score
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    vn = v / np.linalg.norm(v, axis=1, keepdims=True)
    want = np.take_along_axis(1 - qn @ vn.T, tr, axis=1)
    np.testing.assert_allclose(td, want, rtol=RTOL, atol=2e-6)
    if codec == "int8":
        # identical codes, exact integer products, exact selection
        _same_hits(jhits, thits, 10)
        np.testing.assert_array_equal(tc._codes[:N].numpy(),
                                      np.asarray(jc._codes[:N]))
    if codec == "binary":
        # the port keeps the words row-major, the JAX package word-major
        np.testing.assert_array_equal(
            tc._codes[:N].numpy().view(np.uint32),
            np.asarray(jc._codes)[:, :N].T)


@pytest.mark.parametrize("codec", CODECS)
def test_files_load_in_the_other_package(tmp_path, codec):
    jc, tc, v, q = _pair(codec, jpath=tmp_path / "j", tpath=tmp_path / "t")
    jc.save()
    tc.save()
    for name in (tbig.STORE_FILE, tbig.VECTORS_FILE):
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes(), name
    t_from_j = BigCollection(D, base_path=tmp_path / "j")
    j_from_t = J.BigCollection(D, base_path=tmp_path / "t")
    for col in (t_from_j, j_from_t):
        assert col.codec == codec and col.count() == jc.count()
        assert col.get("v0") is None and col.get("v3")["metadata"] == \
            {"cat": 3, "year": 2003}
    for a, b in ((jc, t_from_j), (j_from_t, tc)):
        _same_hits(a.search_batch(q, k=10, rerank=N),
                   b.search_batch(q, k=10, rerank=N), 10)
    # a loaded collection keeps appending and saving
    t_from_j.insert(v[0] * 0.5 + v[1] * 0.5, "fresh", {"cat": 9})
    t_from_j.save()
    again = J.BigCollection(D, base_path=tmp_path / "j")
    assert again.count() == jc.count() + 1
    assert again.search(v[0] * 0.5 + v[1] * 0.5, k=1)[0].id == "fresh"


@pytest.mark.parametrize("codec", CODECS)
def test_growth_across_a_capacity_doubling(codec):
    v, q, ids, _ = _corpus()
    rng = np.random.default_rng(5)
    extra = rng.standard_normal((tbig.MIN_CAP, D)).astype(np.float32)
    col = BigCollection(D, codec=codec)
    col.insert_batch(v, ids)
    assert col._code_cap == tbig.MIN_CAP
    before = col._codes[:N].clone()
    col.delete("v17")
    col.insert_batch(extra[:tbig.MIN_CAP - N])            # exactly full
    assert col._code_cap == tbig.MIN_CAP
    col.insert_batch(extra[tbig.MIN_CAP - N:])            # doubles
    assert col._code_cap == 2 * tbig.MIN_CAP == col._dvalid.shape[0]
    assert col._vectors.shape[0] == 2 * tbig.MIN_CAP
    # the old rows' codes moved over unchanged, the tombstone survived,
    # padding rows are invalid
    assert (col._codes[:N] == before).all()
    assert not bool(col._dvalid[17]) and not bool(col._dvalid[col._count:].any())
    assert int(col._dvalid.sum()) == col.count() == N + tbig.MIN_CAP - 1
    if codec == "int8":
        vsq, rinv = col._sq_stats
        want = col._qz.corpus_stats(col._codes[:col._count])
        assert (vsq[:col._count] == want[0]).all()
        assert (rinv[:col._count] == want[1]).all()
    assert col.search(v[200], k=1)[0].id == "v200"
    assert col.search(extra[-1], k=1)[0].id == f"big-{col._count - 1}"
    assert all(h.id != "v17" for h in col.search(v[17], k=5))


@pytest.mark.parametrize("codec", CODECS)
def test_retrains_after_a_first_batch_of_one_row(codec):
    v, q, ids, _ = _corpus()
    jc = J.BigCollection(D, codec=codec)
    tc = BigCollection(D, codec=codec)
    for c in (jc, tc):
        c.insert(v[0], "v0")                 # trained on one row: degenerate
        c.insert_batch(v[1:7], ids[1:7])     # 7 rows < 8 x 1: no retrain
    assert tc._trained_rows == jc._trained_rows == 1
    for c in (jc, tc):
        c.insert_batch(v[7:8], ids[7:8])     # 8 rows: retrain + re-encode
    assert tc._trained_rows == jc._trained_rows == 8
    for c in (jc, tc):
        c.insert_batch(v[8:], ids[8:])       # 3000 >= 8 x 8: again
    assert tc._trained_rows == jc._trained_rows == N
    # the codes of the early rows are those of the final codec
    fresh = BigCollection(D, codec=codec)
    fresh._train(v)
    fresh._append_codes(v[:8])
    assert (tc._codes[:8] == fresh._codes[:8]).all()
    _same_hits(jc.search_batch(q, k=10, rerank=N),
               tc.search_batch(q, k=10, rerank=N), 10)
    truth = exact_topk(v / np.linalg.norm(v, axis=1, keepdims=True),
                       np.ones(N, bool), q, 10)
    _, tr = _grids(tc.search_batch(q, k=10, rerank=16), 10)
    assert mean_overlap(tr, truth) >= (0.8 if codec == "binary" else 0.95)


@pytest.mark.parametrize("codec", CODECS)
def test_filter_matching_fewer_rows_than_the_pool(codec):
    jc, tc, v, q = _pair(codec)
    # year == 2029 and cat == 4: rows 29 mod 30 and 4 mod 5 -> ~1/30 of the
    # corpus, fewer than c = 10 x 16; the pool's masked picks never surface
    flt_j = J.Filter.and_([J.Filter.eq("year", 2029), J.Filter.eq("cat", 4)])
    flt_t = T.Filter.and_([T.Filter.eq("year", 2029), T.Filter.eq("cat", 4)])
    n_match = sum(1 for i in range(N) if i % 30 == 29 and i % 5 == 4
                  and i % 11)
    assert 10 < n_match < 160
    jhits = jc.search_batch(q, k=10, filter=flt_j, rerank=16)
    thits = tc.search_batch(q, k=10, filter=flt_t, rerank=16)
    _same_hits(jhits, thits, 10)
    assert all(h.metadata == {"cat": 4, "year": 2029}
               for hl in thits for h in hl)
    # k above the matches: every match once, nothing else
    allhits = tc.search_batch(q[:2], k=200, filter=flt_t, rerank=16)
    assert all(len(hl) == n_match == len({h.id for h in hl})
               for hl in allhits)
    assert tc.search(q[0], k=5, filter=T.Filter.eq("cat", 77)) == []


@pytest.mark.parametrize("codec", CODECS)
def test_chunked_coarse_scan_is_the_same_function(codec, monkeypatch):
    _, tc, v, q = _pair(codec)
    assert tc._code_cap == tbig.MIN_CAP
    whole = tc.search_batch(q, k=10, rerank=16,
                            filter=T.Filter.gt("year", 2004))
    mask = tc._device_mask(None)
    wv, wr = tc._coarse(q, 160, mask)
    # a budget of one MIN_CAP-row block of B=64 queries: at B=16 the scan
    # covers the buffer in one chunk; at B=256 it takes four
    monkeypatch.setattr(tbig.BigCollection, "_score_budget",
                        tbig.MIN_CAP * 64 * 4)
    q256 = np.tile(q, (16, 1))
    cv, cr = tc._coarse(q256, 160, mask)
    np.testing.assert_array_equal(cv[:16], wv)       # the same sorted scores
    if codec != "binary":                            # Hamming counts tie
        np.testing.assert_array_equal(cr[:16], wr)
    got = tc.search_batch(q256, k=10, rerank=16,
                          filter=T.Filter.gt("year", 2004))[:16]
    _, a = _grids(whole, 10)
    _, b = _grids(got, 10)
    assert mean_overlap(a, b) >= (0.98 if codec == "binary" else 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", CODECS)
def test_cuda_bigcollection_matches_cpu(codec):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fastpyvectordb_tpu_torch.kernels import hamming_kernels as hk
    from fastpyvectordb_tpu_torch.kernels import quant_kernels as qk
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    v, q, ids, metas = _corpus()
    cpu = BigCollection(D, codec=codec)
    gpu = T.BigCollection(D, codec=codec)
    assert gpu.device.type == "cuda"
    counter = {"int8": (s8.LAUNCHES, "s8_scores"),
               "int4": (qk.LAUNCHES, "int4_scores"),
               "binary": (hk.LAUNCHES, "hamming_mxu_scores")}[codec]
    for c in (cpu, gpu):
        c.insert_batch(v[:2000], ids[:2000], metas[:2000])
        c.insert_batch(v[2000:], ids[2000:], metas[2000:])
        c.delete_batch([f"v{i}" for i in range(0, N, 11)])
    before = counter[0][counter[1]]
    ghits = gpu.search_batch(q, k=10, rerank=N)
    assert counter[0][counter[1]] == before + 1
    _same_hits(cpu.search_batch(q, k=10, rerank=N), ghits, 10)
    _, a = _grids(cpu.search_batch(q, k=10, rerank=16), 10)
    _, b = _grids(gpu.search_batch(q, k=10, rerank=16), 10)
    assert mean_overlap(a, b) >= 0.98
