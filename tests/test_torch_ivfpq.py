"""The port's IVF-PQ slice (fastpyvectordb_tpu_torch: ann/ivfpq.py, the
``grouped_cell_scores_pq`` kernel of kernels/ivf_kernels.py and the
collection's ``build_ann("ivfpq")``) against the JAX package on the same
seeded inputs.

The JAX Pallas kernel runs in interpret mode, as the JAX package's own
tests run it; on the CPU the port's wrapper runs its plain PyTorch version.
k-means and PQ codebooks draw from ``jax.random`` on one side and a
``torch.Generator`` on the other, so search parity is held on an index the
JAX package built and the port loaded (centroids, codebooks, codes,
reconstruction norms, row table and overflow rows carried across); the
port's own build is held to the JAX tests' recall bounds.  The
``cuda``-marked tests at the end hold the CUDA kernel against its plain
version on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastpyvectordb_tpu as J
import fastpyvectordb_tpu_torch as T
from fastpyvectordb_tpu.ann import ivfpq as jpq
from fastpyvectordb_tpu.kernels.pallas_ivf import (grouped_cell_scores_pq as
                                                   j_b7)
from fastpyvectordb_tpu_torch.ann import ivfpq as tpq
from fastpyvectordb_tpu_torch.ann.ivfpq import IVFPQIndex
from fastpyvectordb_tpu_torch.kernels import ivf_kernels as ik
from torch_parity import (assert_same_tied_topk, assert_same_topk, clustered,
                          mean_overlap)

METRICS = ["cosine", "l2", "ip"]
N, D = 2000, 32
# B7: the same bf16 table entries summed in f32 in another order
B7_RTOL = 1e-5


# ---------------------------------------------------------------------------
# (a) B7: the plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

def _b7_case(seed, nlist, u, n_uniq, qcap, cmax, m, kk, b, loads=None):
    """The port's operands (per-query tables + slot table) and the JAX
    kernel's (the slot-gathered tables).  ``loads``: live slots per compact
    row (a prefix, as ``invert_pairs`` fills them), random in 1..qcap if
    None."""
    rng = np.random.default_rng(seed)
    cells = rng.permutation(nlist)[:u].astype(np.int32)
    cells[n_uniq:] = 0                      # the padding tail aliases cell 0
    cell_ids = np.concatenate([[n_uniq], cells]).astype(np.int32)
    lut = torch.as_tensor(rng.standard_normal((b, m * kk)).astype(
        np.float32)).bfloat16()
    load = rng.integers(1, qcap + 1, (u, 1))
    if loads is not None:
        load = np.resize(np.asarray(loads), u)[:, None]
    qslot = np.where(np.arange(qcap)[None, :] < load,
                     rng.integers(0, b, (u, qcap)), -1).astype(np.int32)
    codes_t = rng.integers(0, kk, (nlist, m, cmax)).astype(np.uint8)
    return cell_ids, lut, qslot, codes_t


def _j_b7(cell_ids, lutq, codes_t):
    """The JAX package's B7: the Pallas kernel in interpret mode at the
    shapes it takes (cmax and M*K multiples of 128, qcap of 8), else its
    XLA reference, the one-hot bf16 product of ``ann/ivfpq.py``'s
    fallback."""
    u, qcap, mk = lutq.shape
    _, m, cmax = codes_t.shape
    if cmax % 128 == 0 and mk % 128 == 0 and qcap % 8 == 0:
        return j_b7(cell_ids, lutq, codes_t, interpret=True)
    kk = mk // m
    cod = jnp.take(codes_t, cell_ids[1:], axis=0).astype(jnp.int32)
    oh = (cod[:, :, None, :] == jnp.arange(kk, dtype=jnp.int32)[
        None, None, :, None]).astype(jnp.bfloat16)       # (U, M, K, cmax)
    return jax.lax.dot_general(
        lutq, oh.reshape(u, mk, cmax),
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)


@pytest.mark.parametrize("shape", [
    # nlist, u, n_uniq, qcap, cmax, m, kk, b  (the JAX tests' shapes)
    (6, 4, 3, 8, 128, 32, 16, 20),
    (6, 4, 3, 8, 256, 8, 16, 5),
    (5, 5, 5, 16, 128, 8, 64, 30),
    # the shapes that decide the CUDA kernel's tiling: loads 0 / 1 / a full
    # 32-slot tile / one past it / saturated; M off the staged chunk; K 16 /
    # 64 / 256 and an odd K; cmax 72 / 768 / 1100
    (8, 6, 5, 72, 768, 7, 256, 50, (0, 1, 32, 33, 72, 17)),
    (8, 6, 6, 40, 72, 40, 16, 20, (0, 1, 32, 33, 40, 9)),
    (8, 6, 5, 344, 1100, 12, 64, 64, (344, 0, 1, 33, 20, 100)),
    (5, 4, 3, 16, 100, 5, 13, 7),
])
def test_grouped_cell_scores_pq_plain_matches_pallas(shape):
    cell_ids, lut, qslot, codes_t = _b7_case(13, *shape)
    n_uniq = shape[2]
    lutq = np.array(lut.float())[np.maximum(qslot, 0)]       # (U, qcap, MK)
    want = np.asarray(_j_b7(jnp.asarray(cell_ids),
                            jnp.asarray(lutq, jnp.bfloat16),
                            jnp.asarray(codes_t)))
    got = ik.grouped_cell_scores_pq(
        torch.as_tensor(cell_ids), lut, torch.as_tensor(qslot),
        torch.as_tensor(codes_t)).numpy()
    assert got.shape == want.shape
    live = np.broadcast_to((qslot >= 0)[:, :, None], got.shape)[:n_uniq]
    g, w = got[:n_uniq][live], want[:n_uniq][live]
    assert g.size > 0
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=B7_RTOL * max(np.abs(w).max(), 1.0))


def test_cpu_tensors_use_plain_version_and_count_nothing():
    cell_ids, lut, qslot, codes_t = _b7_case(2, 4, 3, 2, 8, 72, 4, 16, 6)
    before = dict(ik.LAUNCHES)
    ik.grouped_cell_scores_pq(torch.as_tensor(cell_ids), lut,
                              torch.as_tensor(qslot),
                              torch.as_tensor(codes_t))
    assert ik.LAUNCHES == before


def test_non_cpu_tensor_never_falls_back():
    codes_t = torch.empty((3, 4, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ik.grouped_cell_scores_pq(
            torch.tensor([2, 0, 1], dtype=torch.int32),
            torch.zeros((5, 64), dtype=torch.bfloat16),
            torch.zeros((2, 8), dtype=torch.int32), codes_t)


# ---------------------------------------------------------------------------
# (b) the pieces of the search against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kk", [16, 64])
def test_adc_sum_both_lowerings(kk):
    """kk <= 32: the JAX one-hot contraction over a bf16 LUT; kk > 32: the
    f32 gather.  The port gathers in both, over the bf16-rounded table for
    kk <= 32."""
    rng = np.random.default_rng(kk)
    b, nprobe, cmax, m = 3, 4, 24, 8
    lut = rng.standard_normal((b, m, kk)).astype(np.float32)
    codes_g = rng.integers(0, kk, (b, nprobe, cmax, m)).astype(np.uint8)
    want = np.asarray(jpq._adc_sum(jnp.asarray(lut), jnp.asarray(codes_g),
                                   m, kk, b, nprobe, cmax))
    got = tpq._adc_sum(torch.as_tensor(lut), torch.as_tensor(codes_g), m,
                       kk, b, nprobe, cmax).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_recon_norms():
    rng = np.random.default_rng(4)
    n, m, kk, ds = 300, 4, 16, 8
    codes = rng.integers(0, kk, (n, m)).astype(np.uint8)
    books = rng.standard_normal((m, kk, ds)).astype(np.float32)
    base = rng.standard_normal((n, m * ds)).astype(np.float32)
    want = np.asarray(jpq._recon_norms(jnp.asarray(codes),
                                       jnp.asarray(books),
                                       jnp.asarray(base), chunk=128))
    got = tpq._recon_norms(torch.as_tensor(codes), torch.as_tensor(books),
                           torch.as_tensor(base), chunk=128).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# (c) both dispatches on one carried-over index
# ---------------------------------------------------------------------------

def _corpus(seed=0, n=N, d=D, nq=24):
    rng = np.random.default_rng(seed)
    v, centers = clustered(rng, n, d, n_centers=32, normalize=False)
    q = (centers[rng.integers(0, 32, nq)]
         + 0.5 * rng.standard_normal((nq, d))).astype(np.float32)
    return v, q


def _carried(tmp_path, metric, pq_k=16, **build):
    """A JAX collection with an IVF-PQ index (an overflow block forced by a
    tight cell capacity), saved, and the port's collection loaded from the
    file."""
    v, q = _corpus()
    jdb = J.VectorDB(tmp_path / "j")
    jc = jdb.create_collection("c", dimensions=D, metric=metric)
    jc.insert_batch(v, [f"v{i}" for i in range(N)],
                    [{"cat": i % 5} for i in range(N)])
    kw = dict(nlist=16, nprobe=4, iters=4, m=8, pq_k=pq_k, pq_iters=4,
              max_cell_factor=1.0, spill_choices=2, rerank=16, tune=False)
    kw.update(build)
    jc.build_ann("ivfpq", **kw)
    jdb.save()
    tc = T.VectorDB(tmp_path / "j", device="cpu")["c"]
    return jc, tc, v, q


# rerank 0 serves PQ scores: ADC sums in another order (and, grouped, over
# a bf16 table in both packages) and equal for rows with equal codes
PQ_RTOL = 1e-4


@pytest.mark.parametrize("pq_k", [16, 64])
@pytest.mark.parametrize("metric", METRICS)
def test_ivfpq_dispatches_match_on_carried_index(tmp_path, metric, pq_k):
    jc, tc, _, q = _carried(tmp_path, metric, pq_k=pq_k)
    ja, ta = jc._ann, tc._ann
    assert isinstance(ta, IVFPQIndex)
    assert int((np.asarray(ja.overflow_rows) >= 0).sum()) > 0
    for name in ("codes", "norms", "row_table", "centroids", "codebooks"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                      np.asarray(getattr(ja, name)), name)
    # cell balance is known only to the index that ran the assignment
    assert ({**ta.stats(), "cell_balance": None}
            == {**ja.stats(), "cell_balance": None})
    assert ta.memory_usage() == ja.memory_usage()
    qq = np.concatenate([q, q[:3] + 0.01])     # 27 queries: a padded tail
    for grouped in (False, True):
        jd, jr = ja.search(qq, 10, grouped=grouped, rerank=16, qcap=64)
        td, tr = ta.search(qq, 10, grouped=grouped, rerank=16, qcap=64)
        # the exact f32 re-rank of the same candidates
        assert_same_topk(jd, jr, td, tr, rtol=1e-5)
        jd, jr = ja.search(qq, 10, grouped=grouped, rerank=0, qcap=64)
        td, tr = ta.search(qq, 10, grouped=grouped, rerank=0, qcap=64)
        assert_same_tied_topk(jd, jr, td, tr, rtol=PQ_RTOL, atol=1e-5)
        if grouped:
            assert ta.last_dropped == ja.last_dropped == 0
    # grouped and per-query serve the same ids when nothing is dropped
    # (tests/test_ivfpq.py:test_grouped_matches_perquery)
    d1, r1 = ta.search(q, 10, grouped=False)
    d2, r2 = ta.search(q, 10, grouped=True, qcap=64)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_allclose(d1, d2, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_saturated_qcap_sheds_the_same_pairs(tmp_path, metric):
    jc, tc, _, q = _carried(tmp_path, metric)
    qq = np.repeat(q[:4], 16, axis=0)          # hot cells
    jd, jr = jc._ann.search(qq, 10, grouped=True, qcap=8)
    td, tr = tc._ann.search(qq, 10, grouped=True, qcap=8)
    assert tc._ann.last_dropped == jc._ann.last_dropped > 0
    assert (tr[:, 0] >= 0).all()
    assert_same_topk(jd, jr, td, tr, rtol=1e-5)


def test_filtered_search_on_carried_index(tmp_path):
    jc, tc, _, q = _carried(tmp_path, "l2")
    mask = np.arange(N) % 5 == 2
    for grouped in (False, True):
        jd, jr = jc._ann.search(q, 8, mask=mask, grouped=grouped, qcap=64)
        td, tr = tc._ann.search(q, 8, mask=mask, grouped=grouped, qcap=64)
        assert_same_topk(jd, jr, td, tr, rtol=1e-5)
        assert mask[tr[tr >= 0]].all()


def _same(jres, tres, rtol=1e-5):
    (jid, jd, jr), (tid, td, tr) = jres, tres
    assert_same_topk(np.where(jr < 0, 3e38, jd), jr,
                     np.where(tr < 0, 3e38, td), tr, rtol=rtol)
    np.testing.assert_array_equal(jid == None, tid == None)  # noqa: E711


@pytest.mark.parametrize("metric", METRICS)
def test_jax_saved_ivfpq_collection_serves_alike_in_port(tmp_path, metric):
    jc, tc, _, q = _carried(tmp_path, metric)
    assert tc.config.index == "ivfpq" and tc._ann.rerank == 16
    _same(jc.search_arrays(q, k=10), tc.search_arrays(q, k=10))
    big = np.repeat(q, 4, axis=0)              # b * nprobe >= nlist: grouped
    _same(jc.search_arrays(big, k=10), tc.search_arrays(big, k=10))
    flt_j, flt_t = J.Filter.gt("cat", 0), T.Filter.gt("cat", 0)
    _same(jc.search_arrays(big, k=10, filter=flt_j),
          tc.search_arrays(big, k=10, filter=flt_t))
    ids, _, _ = tc.search_arrays(big, k=10, filter=flt_t)
    assert all(int(i[1:]) % 5 > 0 for i in ids.ravel() if i is not None)
    for c in (jc, tc):
        c.set_search_params(nprobe=8, rerank=4)
    assert (tc._ann.nprobe, tc._ann.rerank) == (8, 4)
    _same(jc.search_arrays(q, k=10), tc.search_arrays(q, k=10))
    # the joint tuner walks the same ladder to the same settings
    assert tc._ann.tune(q[:16]) == pytest.approx(jc._ann.tune(q[:16]))


def test_ivfpq_save_load_both_directions(tmp_path):
    jc, tc, v, q = _carried(tmp_path, "l2")
    # the carried-over index is written back byte for byte
    tc.base_path = tmp_path / "t" / "c"
    tc.save()
    assert (tmp_path / "t" / "c" / "collection.fpvt").read_bytes() == \
        (tmp_path / "j" / "c" / "collection.fpvt").read_bytes()
    # the port's own build, saved, loads in the JAX package and serves alike
    tdb = T.VectorDB(tmp_path / "p", device="cpu")
    own = tdb.create_collection("c", dimensions=D, metric="cosine")
    own.insert_batch(v, [f"v{i}" for i in range(N)])
    own.build_ann("ivfpq", nlist=16, nprobe=4, iters=4, m=8, pq_k=16,
                  pq_iters=4, tune=False)
    tdb.save()
    back = J.VectorDB(tmp_path / "p")["c"]
    assert back.config.index == "ivfpq"
    np.testing.assert_array_equal(np.asarray(back._ann.codes),
                                  own._ann.codes.numpy())
    _same(back.search_arrays(q, k=10), own.search_arrays(q, k=10))
    big = np.repeat(q, 4, axis=0)
    _same(back.search_arrays(big, k=10), own.search_arrays(big, k=10))


def test_append_is_served_by_the_tail_merge_and_stale_rebuild(tmp_path):
    jc, tc, v, q = _carried(tmp_path, "cosine")
    new = (q[:6] + 1e-3).astype(np.float32)
    for c in (jc, tc):
        c.insert_batch(new, [f"n{i}" for i in range(6)])
    assert tc._ann._built_count == N and not tc._ann.stale
    ids, _, _ = tc.search_arrays(q[:6], k=3)
    assert [r[0] for r in ids.tolist()] == [f"n{i}" for i in range(6)]
    _same(jc.search_arrays(q, k=10), tc.search_arrays(q, k=10))
    # a renumbering mutation marks the index stale; the rebuild keeps the
    # layout and the runtime knobs
    tc.compact()
    assert tc._ann.stale
    tc.search_arrays(q, k=10)
    st = tc._ann.stats()
    assert not tc._ann.stale
    assert (st["nlist"], st["m"], st["pq_k"], st["rerank"]) == (16, 8, 16, 16)


# ---------------------------------------------------------------------------
# (d) the port's own build
# ---------------------------------------------------------------------------

def _make_col(metric="l2", n=4000, d=32, seed=11):
    """tests/test_ivfpq.py's ``make_col``."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((32, d)).astype(np.float32) * 2
    v = centers[rng.integers(0, 32, n)] + 0.3 * rng.standard_normal(
        (n, d)).astype(np.float32)
    col = T.Collection(T.CollectionConfig(name="ivfpq", dimensions=d,
                                          metric=metric), device="cpu")
    col.insert_batch(v, [f"v{i}" for i in range(n)],
                     [{"g": i % 4} for i in range(n)])
    q = centers[rng.integers(0, 32, 16)] + 0.3 * rng.standard_normal(
        (16, d)).astype(np.float32)
    return col, v, q


def _recall(col, q, rows):
    _, _, exact = col.search_arrays(q, k=10, exact=True)
    return mean_overlap(rows, exact)


def test_own_build_recall_and_dispatches():
    """tests/test_ivfpq.py's bounds: recall@10 >= 0.9 (rerank 16, nprobe
    8 and 32), grouped == per-query ids, saturated qcap >= 0.5."""
    col, v, q = _make_col()
    col.build_ann(kind="ivfpq", nlist=64, nprobe=8, iters=6, m=8, pq_k=64,
                  pq_iters=8, rerank=16)
    ann = col._ann
    assert col.config.index == "ivfpq" and ann.stats()["cmax"] % 8 == 0
    _, _, approx = col.search_arrays(q, k=10, exact=False)
    assert _recall(col, q, approx) >= 0.9
    _, r_no = ann.search(q, 10, rerank=0)
    _, r_rr = ann.search(q, 10, rerank=16)
    assert _recall(col, q, r_rr) >= max(_recall(col, q, r_no), 0.9)
    _, hi = ann.search(q, 10, nprobe=32, rerank=16)
    assert _recall(col, q, hi) >= 0.9
    d1, r1 = ann.search(q, 10, grouped=False)
    d2, r2 = ann.search(q, 10, grouped=True, qcap=64)
    assert ann.last_dropped == 0
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_allclose(d1, d2, rtol=1e-4, atol=1e-4)
    _, rows = ann.search(q, 10, grouped=True, qcap=8)
    assert ann.last_dropped > 0 and (rows[:, 0] >= 0).all()
    assert _recall(col, q, rows) >= 0.5
    res = col.search_batch(np.repeat(q, 8, axis=0), k=8,
                           filter=T.Filter.eq("g", 2), exact=False)
    assert all(h.metadata["g"] == 2 for hits in res for h in hits)


@pytest.mark.parametrize("metric", ["cosine", "ip"])
def test_own_build_other_metrics(metric):
    col, v, q = _make_col(metric=metric, n=2000, seed=7)
    col.build_ann(kind="ivfpq", nlist=32, nprobe=8, iters=6, m=8, pq_k=64,
                  pq_iters=8)
    _, _, approx = col.search_arrays(q, k=10, exact=False)
    assert _recall(col, q, approx) >= 0.85


@pytest.mark.parametrize("pq_k,m", [(256, 4), (16, 8)])
def test_own_build_default_8bit_and_legacy_4bit(pq_k, m):
    col, v, q = _make_col(n=3000, seed=21)
    kw = {} if pq_k == 256 else {"pq_k": 16, "m": 8}
    col.build_ann(kind="ivfpq", nlist=32, nprobe=8, iters=6, pq_iters=8,
                  **kw)
    st = col._ann.stats()
    assert (st["pq_k"], st["m"]) == (pq_k, m)   # default: m = d/8
    _, rows = col._ann.search(q, 10, rerank=16)
    assert _recall(col, q, rows) >= 0.9


def test_explicit_knobs_turn_auto_tune_off(monkeypatch):
    """The JAX rule: an explicit nprobe or rerank is the caller's decision
    and skips the build-time tune; otherwise corpora >= 4096 rows run the
    joint tune."""
    calls = []
    monkeypatch.setattr(IVFPQIndex, "tune",
                        lambda self, qs, target_recall=0.95: calls.append(
                            len(qs)))
    col, _, _ = _make_col(n=4096)
    kw = dict(nlist=16, iters=2, m=8, pq_k=16, pq_iters=2)
    col.build_ann("ivfpq", **kw)
    assert calls == [32]
    col.build_ann("ivfpq", nprobe=4, **kw)
    col.build_ann("ivfpq", rerank=8, **kw)
    assert calls == [32]
    col.build_ann("ivfpq", rerank=8, tune=True, **kw)
    assert calls == [32, 32]
    assert col._ann._build_kwargs == dict(rerank=8, **kw)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    # nlist, u, n_uniq, qcap, cmax, m, kk, b
    (7, 5, 3, 8, 72, 1, 16, 20), (9, 6, 4, 40, 768, 8, 256, 50),
    (6, 4, 3, 8, 200, 96, 256, 30), (4, 3, 3, 16, 1100, 12, 64, 9),
    (5, 4, 3, 16, 100, 5, 13, 7),            # an odd K: no 4-byte copies
    # loads 0 / 1 / a full 32-slot tile / one past it / saturated, every
    # tail width; M off the staged chunk (2 / 32 / 8 subspaces for K 256 /
    # 16 / 64); cmax 768 / 72 / 1100 (two cmax tiles)
    (8, 6, 5, 72, 768, 7, 256, 50, (0, 1, 32, 33, 72, 17)),
    (8, 6, 6, 40, 72, 40, 16, 20, (0, 1, 32, 33, 40, 9)),
    (8, 6, 5, 344, 1100, 12, 64, 64, (344, 0, 1, 33, 20, 100))])
def test_cuda_grouped_cell_scores_pq_matches_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell_ids, lut, qslot, codes_t = (
        torch.as_tensor(a).cuda() for a in _b7_case(3, *shape))
    n0 = ik.LAUNCHES["grouped_cell_scores_pq"]
    got = ik.grouped_cell_scores_pq(cell_ids, lut, qslot, codes_t)
    want = ik.grouped_cell_scores_pq_plain(cell_ids, lut, qslot, codes_t)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["grouped_cell_scores_pq"] == n0 + 1
    n = shape[2]
    live = (qslot[:n] >= 0)[:, :, None].expand(-1, -1, codes_t.shape[2])
    g, w = got[:n][live], want[:n][live]
    assert g.numel() > 0 and torch.isfinite(g).all()
    assert (g - w).abs().max().item() <= B7_RTOL * max(
        w.abs().max().item(), 1.0)


@pytest.mark.cuda
def test_cuda_grouped_ivfpq_matches_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, cpu, _, q = _carried(tmp_path, "cosine")
    gpu = T.VectorDB(tmp_path / "j", device="cuda")["c"]
    qq = np.repeat(q, 4, axis=0)
    n0 = ik.LAUNCHES["grouped_cell_scores_pq"]
    for rerank in (0, 16):
        cd, cr = cpu._ann.search(qq, 10, grouped=True, rerank=rerank)
        gd, gr = gpu._ann.search(qq, 10, grouped=True, rerank=rerank)
        assert_same_tied_topk(cd, cr, gd, gr, rtol=PQ_RTOL, atol=1e-5)
    assert ik.LAUNCHES["grouped_cell_scores_pq"] == n0 + 2
    d1, r1 = gpu._ann.search(q, 10, grouped=False)
    d2, r2 = gpu._ann.search(q, 10, grouped=True, qcap=64)
    assert gpu._ann.last_dropped == 0
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_allclose(d1, d2, rtol=1e-4, atol=1e-4)
