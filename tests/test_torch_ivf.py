"""The port's IVF slice (fastpyvectordb_tpu_torch: quant/kmeans.py,
kernels/ivf_kernels.py, ann/ivf_grouped.py, ann/ivf.py and the collection's
IVF paths) against the JAX package on the same seeded inputs.

The JAX Pallas kernels run in interpret mode, as the JAX package's own
tests run them; on the CPU the port's wrappers run their plain PyTorch
versions.  k-means draws from ``jax.random`` on one side and a
``torch.Generator`` on the other, so search parity is held on an index the
JAX package built and the port loaded (centroids and row table carried
across); the port's own build is held to recall.  The ``cuda``-marked tests
at the end hold the CUDA kernels against their plain versions on a card."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import fastpyvectordb_tpu as J
import fastpyvectordb_tpu_torch as T
from fastpyvectordb_tpu.ann import ivf as jivf
from fastpyvectordb_tpu.ann import ivf_grouped as jgrp
from fastpyvectordb_tpu.core.types import DistanceMetric as JMetric
from fastpyvectordb_tpu.kernels.pallas_ivf import (grouped_cell_scores as
                                                   j_b2,
                                                   grouped_cell_scores_i8 as
                                                   j_b3)
from fastpyvectordb_tpu.quant.kmeans import kmeans_fit as j_kmeans
from fastpyvectordb_tpu_torch.ann import ivf as tivf
from fastpyvectordb_tpu_torch.ann import ivf_grouped as tgrp
from fastpyvectordb_tpu_torch.kernels import ivf_kernels as ik
from fastpyvectordb_tpu_torch.quant.kmeans import assign_chunked, kmeans_fit
from torch_parity import MASKED, assert_same_topk, clustered, mean_overlap

METRICS = ["cosine", "l2", "ip"]
N, D = 2000, 32


# ---------------------------------------------------------------------------
# (a) B2 / B3: plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def _qstat(metric, q):
    if metric == "cosine":
        return (1.0 / np.maximum(np.linalg.norm(q, axis=2), 1e-30)
                ).astype(np.float32)
    if metric == "l2":
        return np.einsum("uqd,uqd->uq", q, q).astype(np.float32)
    return np.zeros(q.shape[:2], np.float32)


def _kernel_inputs(seed, int8, shape=(6, 4, 8, 128, 128)):
    rng = np.random.default_rng(seed)
    nlist, u, qcap, cmax, d = shape
    if int8:
        qblk = rng.integers(-127, 128, (u, qcap, d)).astype(np.int8)
        cells = rng.integers(-127, 128, (nlist, cmax, d)).astype(np.int8)
        norms = rng.random((nlist, cmax)).astype(np.float32) * 50 + 1
    else:
        qblk = rng.standard_normal((u, qcap, d)).astype(np.float32)
        cells = rng.standard_normal((nlist, cmax, d)).astype(np.float32)
        norms = np.einsum("ncd,ncd->nc", cells, cells).astype(np.float32)
    ok = (rng.random((nlist, cmax)) > 0.2).astype(np.float32)
    sscale = rng.random((u, qcap)).astype(np.float32) * 0.01
    sconst = rng.standard_normal((u, qcap)).astype(np.float32)
    return qblk, cells, norms, ok, sscale, sconst


# a strict subset of the 6 cells, then the same with a padding tail
# (n_uniq < U: the last compact slot aliases cell 0 and is skipped)
CELL_LISTS = [[4, 0, 2, 3, 5], [3, 1, 4, 5, 0]]
# the shapes that decide the CUDA kernels' dispatch and tiling, as
# (nlist, U, n_uniq, qcap, cmax, D): a row pitch of whole 16-byte units and
# not (D 41, and 72 for int8), qcap 8 / 64 / 256 and two non-powers of two
# above 256, cmax off the 128-row tile and the 4-float store unit
KERNEL_CASES = CELL_LISTS + [
    pytest.param(shape, id="x".join(map(str, shape)))
    for shape in [(7, 5, 3, 8, 200, 41), (6, 4, 3, 8, 200, 64),
                  (5, 4, 3, 64, 136, 768), (5, 4, 2, 256, 640, 128),
                  (4, 3, 2, 408, 260, 72), (4, 3, 3, 300, 130, 96)]]


def _case(seed, int8, case):
    """(cell ids, inputs) of a ``KERNEL_CASES`` entry: a cell list over the
    default shape, or a ragged shape with a padding tail."""
    if isinstance(case, list):
        return np.array(case, np.int32), _kernel_inputs(seed, int8)
    nlist, u, n_uniq, qcap, cmax, d = case
    rng = np.random.default_rng(seed + 1)
    ids = rng.permutation(nlist)[:u]
    ids[n_uniq:] = 0
    return (np.concatenate([[n_uniq], ids]).astype(np.int32),
            _kernel_inputs(seed, int8, (nlist, u, qcap, cmax, d)))


@pytest.mark.parametrize("cell_list", KERNEL_CASES)
@pytest.mark.parametrize("metric", METRICS)
def test_grouped_cell_scores_plain_matches_pallas(metric, cell_list):
    ids, (qblk, cells, norms, ok, _, _) = _case(9, False, cell_list)
    qstat = _qstat(metric, qblk)
    want = np.asarray(j_b2(
        jnp.asarray(ids), jnp.asarray(qblk, jnp.bfloat16),
        jnp.asarray(cells, jnp.bfloat16), jnp.asarray(norms),
        jnp.asarray(ok), jnp.asarray(qstat), metric=JMetric.parse(metric),
        interpret=True))
    got = ik.grouped_cell_scores(
        torch.as_tensor(ids), torch.as_tensor(qblk).bfloat16(),
        torch.as_tensor(cells).bfloat16(), torch.as_tensor(norms),
        torch.as_tensor(ok), torch.as_tensor(qstat), metric=metric).numpy()
    n = ids[0]
    assert got.shape == want.shape == (qblk.shape[0], qblk.shape[1],
                                       cells.shape[1])
    got, want = got[:n], want[:n]
    live = want < MASKED / 2
    np.testing.assert_array_equal(got >= MASKED / 2, ~live)
    # the same bf16 operands, exact products, f32 sums in another order
    tol = 1e-4 * max(np.abs(want[live]).max(), 1.0)
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=tol)


@pytest.mark.parametrize("cell_list", KERNEL_CASES)
@pytest.mark.parametrize("metric", METRICS)
def test_grouped_cell_scores_i8_plain_matches_pallas(metric, cell_list):
    ids, (qblk, cells, norms, ok, sscale, sconst) = _case(11, True, cell_list)
    qstat = _qstat(metric, qblk.astype(np.float32))
    want = np.asarray(j_b3(
        jnp.asarray(ids), jnp.asarray(qblk), jnp.asarray(cells),
        jnp.asarray(norms), jnp.asarray(ok), jnp.asarray(sscale),
        jnp.asarray(sconst), jnp.asarray(qstat), metric=JMetric.parse(metric),
        interpret=True))
    got = ik.grouped_cell_scores_i8(
        *(torch.as_tensor(a) for a in (ids, qblk, cells, norms, ok, sscale,
                                       sconst, qstat)),
        metric=metric).numpy()
    n = ids[0]
    # the JAX test's own tolerance: exact integer products, f32 epilogue
    np.testing.assert_allclose(got[:n], want[:n], rtol=1e-4, atol=1e-2)


def test_cpu_tensors_use_plain_version_and_count_nothing():
    qblk, cells, norms, ok, sscale, sconst = _kernel_inputs(3, int8=True)
    before = dict(ik.LAUNCHES)
    ik.grouped_cell_scores_i8(
        torch.tensor([2, 0, 1], dtype=torch.int32),
        torch.as_tensor(qblk[:2]), torch.as_tensor(cells),
        torch.as_tensor(norms), torch.as_tensor(ok),
        torch.as_tensor(sscale[:2]), torch.as_tensor(sconst[:2]),
        torch.as_tensor(sscale[:2]), metric="l2")
    assert ik.LAUNCHES == before


@pytest.mark.parametrize("int8", [False, True])
def test_non_cpu_tensor_never_falls_back(int8):
    dt = torch.int8 if int8 else torch.bfloat16
    cells = torch.empty((3, 16, 8), dtype=dt, device="meta")
    f = torch.zeros((3, 16))
    s = torch.zeros((2, 4))
    args = (torch.tensor([2, 0, 1], dtype=torch.int32),
            torch.zeros((2, 4, 8), dtype=dt), cells, f, f)
    with pytest.raises(ValueError, match="CUDA"):
        if int8:
            ik.grouped_cell_scores_i8(*args, s, s, s, metric="cosine")
        else:
            ik.grouped_cell_scores(*args, s, metric="cosine")


# ---------------------------------------------------------------------------
# (b) invert_pairs: identical integer tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,nprobe,nlist,qcap", [
    (24, 3, 10, 16),   # nothing shed
    (40, 4, 6, 8),     # saturated: popular cells shed their high ranks
    (7, 2, 50, 8),     # U = min(nlist, M) = M: most cells unprobed
    (64, 8, 16, 32),   # every cell probed, the hot ones past one 32-slot tile
    (33, 5, 12, 8),    # saturated, an odd batch
    (128, 2, 4, 16),   # four cells, all saturated
    (16, 4, 64, 8),    # U = M = 64 compact rows, most of them an empty tail
])
def test_invert_pairs_identical(b, nprobe, nlist, qcap):
    rng = np.random.default_rng(b * 100 + nlist)
    # each query probes distinct cells, skewed towards low ids (hot cells)
    w = np.exp(-np.arange(nlist) / 3.0)
    probe = np.stack([rng.choice(nlist, nprobe, replace=False, p=w / w.sum())
                      for _ in range(b)]).astype(np.int32)
    jp = jgrp.invert_pairs(jnp.asarray(probe), nlist, qcap)
    tp = tgrp.invert_pairs(torch.as_tensor(probe), nlist, qcap)
    n_uniq = int(jp["cell_list"][0])
    assert int(tp["cell_list"][0]) == n_uniq
    for key in ("qslot", "slot_q", "pair_rank", "pair_keep", "cid_pair",
                "flat_cell", "flat_q"):
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key]),
                                      err_msg=key)
    assert int(tp["dropped"]) == int(jp["dropped"])
    np.testing.assert_array_equal(tp["cell_list"].numpy()[:n_uniq + 1],
                                  np.asarray(jp["cell_list"])[:n_uniq + 1])
    np.testing.assert_array_equal(tp["qslot_c"].numpy()[:n_uniq],
                                  np.asarray(jp["qslot_c"])[:n_uniq])
    if qcap == 8 and b == 40:
        assert int(jp["dropped"]) > 0
    # what the CUDA kernels rely on: the live slots of every compact row are
    # a prefix, min(the cell's pairs, qcap) long, and the rows past n_uniq
    # are empty
    live = tp["qslot_c"].numpy() >= 0
    load = live.sum(axis=1)
    np.testing.assert_array_equal(live, np.arange(qcap)[None, :]
                                  < load[:, None])
    cells = tp["cell_list"].numpy()[1:1 + n_uniq]
    np.testing.assert_array_equal(
        load[:n_uniq], np.minimum(np.bincount(probe.reshape(-1),
                                              minlength=nlist)[cells], qcap))
    assert not live[n_uniq:].any()


def test_invert_pairs_never_syncs_with_the_host():
    # shedding by boolean mask would call nonzero, a host sync on CUDA, in
    # every grouped batch: the spare-column scatter must not
    from torch.profiler import ProfilerActivity, profile
    probe = torch.as_tensor(np.random.default_rng(1).integers(
        0, 6, (40, 1)).astype(np.int32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tp = tgrp.invert_pairs(probe, 6, 4)
    assert int(tp["dropped"]) > 0
    ops = {e.key for e in prof.key_averages()}
    assert "aten::nonzero" not in ops and "aten::item" not in ops


def test_grouped_qcap_formula():
    for args in [(1024, 8, 2048, 640), (8, 8, 2048, 640), (64, 4, 16, 128),
                 (4096, 32, 64, 16384)]:
        assert tgrp.grouped_qcap(*args) == jgrp.grouped_qcap(*args)
    assert tgrp.grouped_qcap(1024, 8, 2048, 640) == 32


# ---------------------------------------------------------------------------
# (c) assignment: the same row table from the JAX package's centroids
# ---------------------------------------------------------------------------

def test_assign_topm_and_balanced_assignment():
    import jax
    rng = np.random.default_rng(4)
    v, _ = clustered(rng, N, D, n_centers=24)
    nlist, m = 32, 4
    cent = np.array(j_kmeans(jnp.asarray(v), jax.random.PRNGKey(0),
                             k=nlist, iters=3, chunk=1024, n=N))
    jt = np.asarray(jivf._assign_topm(jnp.asarray(v), jnp.asarray(cent),
                                      m=m, chunk=1024, n=N))
    tt = tivf._assign_topm(torch.as_tensor(v), torch.as_tensor(cent), m=m,
                           chunk=1024, n=N).numpy()
    # rows whose choices differ must tie within 1e-5 at the differing rank
    dist = ((cent ** 2).sum(1)[None, :] - 2.0 * v @ cent.T)
    diff = np.nonzero((jt != tt).any(axis=1))[0]
    for r in diff:
        j = np.argmax(jt[r] != tt[r])
        assert abs(dist[r, jt[r, j]] - dist[r, tt[r, j]]) <= 1e-5, r
    cap = int(max(128, -(-int(1.25 * N / nlist) // 128) * 128))
    jtab, jcnt, jov = jivf._balanced_assignment(jt, nlist, cap)
    ttab, tcnt, tov = tivf._balanced_assignment(jt, nlist, cap)
    np.testing.assert_array_equal(ttab, jtab)
    np.testing.assert_array_equal(tcnt, jcnt)
    np.testing.assert_array_equal(tov, jov)
    keep = np.setdiff1d(np.arange(N), diff)
    if diff.size == 0:
        np.testing.assert_array_equal(
            tivf._balanced_assignment(tt, nlist, cap)[0], jtab)
    assert keep.size >= N - 5


def test_kmeans_fit_is_seeded_and_fits():
    rng = np.random.default_rng(2)
    v, centers = clustered(rng, 1500, 16, n_centers=8, normalize=False)
    data = torch.as_tensor(v)
    a = kmeans_fit(data, 3, k=8, iters=8, chunk=512)
    b = kmeans_fit(data, 3, k=8, iters=8, chunk=512)
    assert torch.equal(a, b) and a.shape == (8, 16)
    # every true centre ends up near a fitted one
    d = torch.cdist(torch.as_tensor(centers), a)
    assert float(d.min(dim=1).values.max()) < 0.5
    # a capacity-padded buffer with an n bound ignores the padding rows
    padded = torch.cat([data, torch.full((500, 16), 1e6)])
    torch.testing.assert_close(kmeans_fit(padded, 3, k=8, iters=8,
                                          chunk=512, n=1500), a)
    assign = assign_chunked(data, a, chunk=256)
    assert assign.dtype == torch.int32 and int(assign.max()) < 8


# ---------------------------------------------------------------------------
# (d) both dispatches on one carried-over index
# ---------------------------------------------------------------------------

def _corpus(seed=0, n=N, d=D, nq=24):
    rng = np.random.default_rng(seed)
    v, centers = clustered(rng, n, d, n_centers=32)
    q = (centers[rng.integers(0, 32, nq)]
         + 0.5 * rng.standard_normal((nq, d))).astype(np.float32)
    return v, q


CELLS = {"f32": ({}, {}), "bf16": ({"compute_dtype": "bfloat16"}, {}),
         "int8": ({}, {"cell_dtype": "int8"})}


def _carried(tmp_path, metric, cells, **build):
    """A JAX collection with an IVF index (an overflow block forced by a
    tight cell capacity), saved, and the port's collection loaded from
    the file."""
    cfg, extra = CELLS[cells]
    v, q = _corpus()
    jdb = J.VectorDB(tmp_path / "j")
    jc = jdb.create_collection("c", dimensions=D, metric=metric, **cfg)
    jc.insert_batch(v, [f"v{i}" for i in range(N)],
                    [{"cat": i % 5} for i in range(N)])
    jc.build_ann(nlist=16, nprobe=4, iters=4, max_cell_factor=1.0,
                 spill_choices=2, tune=False, **extra, **build)
    jdb.save()
    tc = T.VectorDB(tmp_path / "j", device="cpu")["c"]
    return jc, tc, v, q


@pytest.mark.parametrize("cells", list(CELLS))
@pytest.mark.parametrize("metric", METRICS)
def test_ivf_dispatches_match_on_carried_index(tmp_path, metric, cells):
    jc, tc, _, q = _carried(tmp_path, metric, cells)
    ja, ta = jc._ann, tc._ann
    assert int((np.asarray(ja.overflow_rows) >= 0).sum()) > 0
    np.testing.assert_array_equal(ta.row_table.numpy(),
                                  np.asarray(ja.row_table))
    if cells == "int8":
        np.testing.assert_array_equal(ta.cells.numpy(), np.asarray(ja.cells))
    qq = np.concatenate([q, q[:3] + 0.01])     # 27 queries: a padded tail
    for grouped in (False, True):
        for rerank in (0, 4):
            jd, jr = ja.search(qq, 10, grouped=grouped, rerank=rerank)
            td, tr = ta.search(qq, 10, grouped=grouped, rerank=rerank)
            assert_same_topk(jd, jr, td, tr, rtol=1e-3, atol=1e-5)
            if grouped:
                assert ta.last_dropped == ja.last_dropped


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_grouped_saturated_qcap_sheds_the_same_pairs(tmp_path, metric):
    jc, tc, _, q = _carried(tmp_path, metric, "int8")
    qq = np.repeat(q[:4], 16, axis=0)          # hot cells
    jd, jr = jc._ann.search(qq, 10, grouped=True, qcap=8, rerank=0)
    td, tr = tc._ann.search(qq, 10, grouped=True, qcap=8, rerank=0)
    assert tc._ann.last_dropped == jc._ann.last_dropped > 0
    assert_same_topk(jd, jr, td, tr, rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# (e) the collection
# ---------------------------------------------------------------------------

def _same(jres, tres, rtol=1e-3):
    (jid, jd, jr), (tid, td, tr) = jres, tres
    assert_same_topk(np.where(jr < 0, 3e38, jd), jr,
                     np.where(tr < 0, 3e38, td), tr, rtol=rtol, atol=1e-5)
    np.testing.assert_array_equal(jid == None, tid == None)  # noqa: E711


@pytest.mark.parametrize("metric", METRICS)
def test_jax_saved_ivf_collection_serves_alike_in_port(tmp_path, metric):
    jc, tc, _, q = _carried(tmp_path, metric, "int8")
    assert tc.config.index == "ivf" and tc._ann.rerank == 4
    # search_arrays routes through the index after build_ann
    _same(jc.search_arrays(q, k=10), tc.search_arrays(q, k=10))
    big = np.repeat(q, 4, axis=0)              # b * nprobe >= nlist: grouped
    _same(jc.search_arrays(big, k=10), tc.search_arrays(big, k=10))
    flt_j, flt_t = J.Filter.gt("cat", 0), T.Filter.gt("cat", 0)
    _same(jc.search_arrays(q, k=10, filter=flt_j),
          tc.search_arrays(q, k=10, filter=flt_t))
    ids, _, _ = tc.search_arrays(q, k=10, filter=flt_t)
    assert all(int(i[1:]) % 5 > 0 for i in ids.ravel() if i is not None)
    # a highly selective filter takes the exact scan, as in the JAX package
    _same(jc.search_arrays(q, k=10, filter=J.Filter.eq("cat", 1)),
          tc.search_arrays(q, k=10, filter=T.Filter.eq("cat", 1)))


def test_port_save_matches_and_loads_in_jax(tmp_path):
    jc, tc, v, q = _carried(tmp_path, "l2", "int8")
    # the carried-over index is written back byte for byte
    tc.base_path = tmp_path / "t" / "c"
    tc.save()
    assert (tmp_path / "t" / "c" / "collection.fpvt").read_bytes() == \
        (tmp_path / "j" / "c" / "collection.fpvt").read_bytes()
    # the port's own build, saved, loads in the JAX package and serves alike
    tdb = T.VectorDB(tmp_path / "p", device="cpu")
    own = tdb.create_collection("c", dimensions=D, metric="cosine")
    own.insert_batch(v, [f"v{i}" for i in range(N)])
    own.build_ann(nlist=16, nprobe=4, iters=4, tune=False)
    tdb.save()
    back = J.VectorDB(tmp_path / "p")["c"]
    assert back.config.index == "ivf"
    np.testing.assert_array_equal(np.asarray(back._ann.row_table),
                                  own._ann.row_table.numpy())
    _same(back.search_arrays(q, k=10), own.search_arrays(q, k=10))


@pytest.mark.parametrize("grouped", [False, True])
def test_delete_after_search_never_returns_the_row(tmp_path, grouped):
    _, tc, v, _ = _carried(tmp_path, "l2", "bf16")
    q = v[[5, 77, 901]]
    flt = T.Filter.gt("cat", -1)   # matches everything: the filtered memo
    for f in (None, flt):
        d, r = tc._ann.search(q, 5, grouped=grouped,
                              mask=tc._filter_mask(f))
        assert (r[:, 0] == [5, 77, 901]).all()
    tc.delete_batch(["v5", "v77", "v901"])
    for f in (None, flt):
        d, r = tc._ann.search(q, 5, grouped=grouped,
                              mask=tc._filter_mask(f))
        assert not np.isin(r, [5, 77, 901]).any()
        ids, _, _ = tc.search_arrays(q, k=5, filter=f)
        assert not {"v5", "v77", "v901"} & set(ids.ravel().tolist())


def test_append_is_served_by_the_tail_merge(tmp_path):
    jc, tc, v, q = _carried(tmp_path, "cosine", "int8")
    new = (q[:6] + 1e-3).astype(np.float32)
    for c in (jc, tc):
        c.insert_batch(new, [f"n{i}" for i in range(6)])
    assert tc._ann._built_count == N and not tc._ann.stale
    ids, _, _ = tc.search_arrays(q[:6], k=3)
    assert [r[0] for r in ids.tolist()] == [f"n{i}" for i in range(6)]
    _same(jc.search_arrays(q, k=10), tc.search_arrays(q, k=10))


@pytest.mark.parametrize("cell_dtype", [None, "int8"])
def test_padding_rows_never_wrap_to_the_last_row(cell_dtype):
    # count == capacity (1024), so torch's -1 would read the last row,
    # which is live: no hit may be row -1 or a second copy of that row
    rng = np.random.default_rng(8)
    v = rng.standard_normal((1024, 16)).astype(np.float32)
    tc = T.VectorDB(None, device="cpu").create_collection(
        "w", dimensions=16, metric="l2")
    tc.insert_batch(v, [f"r{i}" for i in range(1024)])
    assert tc._store.capacity == tc._store.count == 1024
    tc.build_ann(nlist=16, nprobe=16, iters=3, tune=False,
                 cell_dtype=cell_dtype)
    assert (tc._ann.row_table.numpy() < 0).any()
    q = v[[1023, 0, 500]]
    for grouped in (False, True):
        for rerank in (0, 4):
            d, r = tc._ann.search(q, 10, grouped=grouped, rerank=rerank)
            assert (r >= 0).all() and (d < MASKED / 2).all()
            assert all(len(set(row)) == 10 for row in r.tolist())
            assert (r[:, 0] == [1023, 0, 500]).all()


def test_unported_ann_kinds_raise():
    # every ANN kind of the JAX package is ported: the graph kind builds
    # (with the JAX package's warning) and takes its own knobs; an unknown
    # kind, and knobs before any index, still raise
    tc = T.VectorDB(None, device="cpu").create_collection("x", dimensions=4)
    tc.insert_batch(np.eye(4, dtype=np.float32) + 0.5)
    with pytest.raises(ValueError):
        tc.set_search_params(nprobe=4)
    with pytest.raises(ValueError, match="unknown ANN kind"):
        tc.build_ann(kind="hnsw")
    with pytest.warns(UserWarning, match="graph"):
        tc.build_ann(kind="graph", r=4)
    assert type(tc._ann).__name__ == "GraphANN"
    tc.set_search_params(beam=16)
    assert tc._ann.beam == 16
    with pytest.raises(ValueError):
        tc.set_search_params(nprobe=4)


def test_own_build_recall_and_knobs():
    # tests/test_ann.py's fixture and bound: recall@10 >= 0.9 vs exact
    rng = np.random.default_rng(11)
    n, d = 4000, 24
    centers = rng.standard_normal((32, d)).astype(np.float32) * 2
    v = centers[rng.integers(0, 32, n)] + 0.3 * rng.standard_normal(
        (n, d)).astype(np.float32)
    col = T.Collection(T.CollectionConfig(name="ann", dimensions=d,
                                          metric="l2"), device="cpu")
    col.insert_batch(v, [f"v{i}" for i in range(n)],
                     [{"g": i % 4} for i in range(n)])
    col.build_ann(nlist=64, nprobe=8, iters=6)
    assert col.config.index == "ivf" and col.stats()["index"] == "ivf"
    q = centers[rng.integers(0, 32, 16)] + 0.3 * rng.standard_normal(
        (16, d)).astype(np.float32)
    _, _, exact = col.search_arrays(q, k=10, exact=True)
    _, _, approx = col.search_arrays(q, k=10, exact=False)
    assert mean_overlap(approx, exact) >= 0.9
    st = col._ann.stats()
    assert st["nlist"] == 64 and st["cmax"] % 128 == 0
    col.set_search_params(nprobe=2)
    assert col._ann.nprobe == 2
    assert 1 <= col._ann.tune_nprobe(q, target_recall=0.95) <= 64
    res = col.search_batch(np.repeat(q, 8, axis=0), k=8,
                           filter=T.Filter.eq("g", 1), exact=False)
    assert all(h.metadata["g"] == 1 for hits in res for h in hits)
    # a non-append mutation marks the index stale; the next search rebuilds
    col.compact()
    assert col._ann.stale
    col.search_arrays(q, k=10, exact=False)
    assert not col._ann.stale and col._ann.centroids.shape[0] == 64


# ---------------------------------------------------------------------------
# (f) the search path IVF and IVF-PQ share (ann/ivf.py:InvertedFile)
# ---------------------------------------------------------------------------

KINDS = {"ivf": {}, "ivfpq": {"m": 8, "pq_k": 16, "pq_iters": 4}}


def _own(kind, metric="l2"):
    """A port-built index over the IVF corpus with an overflow block, and
    64 queries: 8 grouped sub-batches under a budget that fits 8 slots."""
    v, q = _corpus(nq=64)
    col = T.Collection(T.CollectionConfig(name="d", dimensions=D,
                                          metric=metric), device="cpu")
    col.insert_batch(v, [f"v{i}" for i in range(N)])
    col.build_ann(kind, nlist=16, nprobe=4, iters=4, max_cell_factor=1.0,
                  spill_choices=1, tune=False, **KINDS[kind])
    assert int((col._ann.overflow_rows >= 0).sum()) > 0
    return col, q


def _split(monkeypatch, ann):
    # qcap_hbm = 8 slots, so a grouped sub-batch of 8 * nlist / (4 * nprobe)
    # = 8 queries
    monkeypatch.setattr(ann, "_mem_budget", lambda default: 1 << 12)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_grouped_sub_batches_match_one_dispatch(monkeypatch, kind, metric):
    col, q = _own(kind, metric)
    ann = col._ann
    hot = np.repeat(q[:4], 16, axis=0)          # cells past qcap 4
    one = ann.search(q, 10, grouped=True)
    assert len(ann._dropped) == 1 and ann.last_dropped == 0
    slices = [ann.search(hot[s:s + 8], 10, grouped=True, qcap=4)
              + (ann.last_dropped,) for s in range(0, 64, 8)]
    assert sum(x[2] for x in slices) > 0
    _split(monkeypatch, ann)
    d, r = ann.search(q, 10, grouped=True)
    assert len(ann._dropped) == 8 and ann.last_dropped == 0
    np.testing.assert_array_equal(d, one[0])
    np.testing.assert_array_equal(r, one[1])
    # a saturated batch: each sub-batch sheds what it sheds alone, and
    # last_dropped is their sum
    d, r = ann.search(hot, 10, grouped=True, qcap=4)
    assert len(ann._dropped) == 8 and ann.last_qcap == 4
    np.testing.assert_array_equal(d, np.concatenate([x[0] for x in slices]))
    np.testing.assert_array_equal(r, np.concatenate([x[1] for x in slices]))
    assert ann.last_dropped == sum(x[2] for x in slices)


@pytest.mark.parametrize("kind", list(KINDS))
def test_dropped_counts_stay_on_the_card_until_read(monkeypatch, kind):
    from torch.profiler import ProfilerActivity, profile
    col, q = _own(kind)
    ann = col._ann
    _split(monkeypatch, ann)
    hot = np.repeat(q[:4], 16, axis=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ann.search(hot, 10, grouped=True, qcap=4)
    ops = {e.key for e in prof.key_averages()}
    assert "aten::item" not in ops and "aten::_local_scalar_dense" not in ops
    assert len(ann._dropped) == 8
    assert all(isinstance(x, torch.Tensor) and x.dim() == 0
               for x in ann._dropped)
    assert ann.last_dropped == sum(int(x) for x in ann._dropped) > 0
    # a query-major search leaves the last grouped search's counts alone
    ann.search(q, 10, grouped=False)
    assert len(ann._dropped) == 8


@pytest.mark.parametrize("kind", list(KINDS))
def test_tune_nprobe_sets_the_smallest_that_clears(kind):
    col, q = _own(kind, "cosine")
    ann = col._ann
    _, _, exact = col.search_arrays(q, k=10, exact=True)

    def recall(nprobe):
        _, rows = ann.search(q, 10, nprobe=nprobe)
        return np.mean([len(set(a.tolist()) & set(e.tolist())) / 10
                        for a, e in zip(rows, exact)])

    ladder = [1, 2, 4, 8, 16]                   # nprobe 4 // 4, doubling
    got = [recall(n) for n in ladder]
    target = got[2]
    want = next(n for n, r in zip(ladder, got) if r >= target)
    assert want > 1
    assert ann.tune_nprobe(q, target_recall=target) == want == ann.nprobe
    ann.nprobe = 4                              # the first rung clears
    assert ann.tune_nprobe(q, target_recall=got[0]) == 1 == ann.nprobe
    # no rung clears: the limit
    assert ann.tune_nprobe(q, target_recall=1.01, max_nprobe=8) == 8
    assert ann.nprobe == 8


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _ragged_case(seed, nlist, u, n_uniq, qcap, cmax, d, int8):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randperm(nlist, generator=g)[:u].to(torch.int32)
    ids[n_uniq:] = 0
    cell_ids = torch.cat([torch.tensor([n_uniq], dtype=torch.int32), ids])
    if int8:
        qblk = torch.randint(-127, 128, (u, qcap, d), generator=g,
                             dtype=torch.int8)
        cells = torch.randint(-127, 128, (nlist, cmax, d), generator=g,
                              dtype=torch.int8)
    else:
        qblk = torch.randn((u, qcap, d), generator=g).bfloat16()
        cells = torch.randn((nlist, cmax, d), generator=g).bfloat16()
    cf = cells.float()
    norms = (cf * cf).sum(-1) if not int8 else torch.rand(
        (nlist, cmax), generator=g) * 50 + 1
    okf = (torch.rand((nlist, cmax), generator=g) > 0.2).float()
    sscale = torch.rand((u, qcap), generator=g) * 0.01
    sconst = torch.randn((u, qcap), generator=g)
    qstat = torch.rand((u, qcap), generator=g) + 0.5
    return cell_ids, qblk, cells, norms, okf, sscale, sconst, qstat


# (nlist, U, n_uniq, qcap, cmax, D): both sides of the dispatch (a row pitch
# of whole 16-byte units goes to the TMA / wgmma cell stream, D 41 / 130 and
# int8 D 72 to the first-slice kernel), qcap 8 / 64 / 256 and two
# non-powers of two above 256 (a second pass of slots), cmax off the 128-row
# tile and off the 4-float store unit, n_uniq < U
CUDA_SHAPES = [(7, 5, 3, 8, 200, 41), (9, 6, 6, 16, 128, 130),
               (5, 4, 2, 40, 130, 64), (6, 4, 3, 8, 200, 64),
               (5, 4, 3, 64, 136, 768), (5, 4, 2, 256, 640, 128),
               (4, 3, 2, 408, 260, 72), (4, 3, 3, 300, 130, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_grouped_kernels_match_plain(metric, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    nlist, u, n_uniq, qcap, cmax, d = shape
    for int8 in (False, True):
        c_ids, qblk, cells, norms, okf, ss, sc, qs = (
            t.cuda() for t in _ragged_case(3, nlist, u, n_uniq, qcap, cmax,
                                           d, int8))
        name = "grouped_cell_scores_i8" if int8 else "grouped_cell_scores"
        n0 = ik.LAUNCHES[name]
        aligned = (d * qblk.element_size()) % 16 == 0
        assert ik.grouped_design(qblk, cells) == (
            "tma_wgmma" if aligned else "first_slice")
        if int8:
            got = ik.grouped_cell_scores_i8(c_ids, qblk, cells, norms, okf,
                                            ss, sc, qs, metric=metric)
            want = ik.grouped_cell_scores_i8_plain(
                c_ids, qblk, cells, norms, okf, ss, sc, qs, metric=metric)
            rtol = 1e-5   # exact integer products; the f32 epilogue rounds
        else:
            got = ik.grouped_cell_scores(c_ids, qblk, cells, norms, okf, qs,
                                         metric=metric)
            want = ik.grouped_cell_scores_plain(c_ids, qblk, cells, norms,
                                                okf, qs, metric=metric)
            rtol = 1e-3   # the same bf16 operands; the f32 sum order differs
        torch.cuda.synchronize()
        assert ik.LAUNCHES[name] == n0 + 1
        got, want = got[:n_uniq], want[:n_uniq]
        tol = rtol * max(want[want < MASKED / 2].abs().max().item(), 1.0)
        assert (got >= MASKED / 2).equal(want >= MASKED / 2)
        assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("cells", ["bf16", "int8"])
def test_cuda_grouped_search_matches_cpu(tmp_path, cells):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, cpu, _, q = _carried(tmp_path, "cosine", cells)
    gpu = T.VectorDB(tmp_path / "j", device="cuda")["c"]
    qq = np.repeat(q, 4, axis=0)
    name = "grouped_cell_scores_i8" if cells == "int8" else \
        "grouped_cell_scores"
    n0 = ik.LAUNCHES[name]
    for rerank in (0, 4):
        cd, cr = cpu._ann.search(qq, 10, grouped=True, rerank=rerank)
        gd, gr = gpu._ann.search(qq, 10, grouped=True, rerank=rerank)
        assert_same_topk(cd, cr, gd, gr, rtol=1e-3, atol=1e-5)
    assert ik.LAUNCHES[name] == n0 + 2
