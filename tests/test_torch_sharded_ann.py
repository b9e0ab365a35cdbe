"""The port's sharded IVF, IVF-PQ and int8 / int4 searchers
(fastpyvectordb_tpu_torch/dist/sharded_ann.py): the cases of
tests/test_sharded_ann.py on the port's own builds, then parity with the
JAX package's sharded searchers on one index, built by the JAX package,
saved, and loaded by the port (the files are byte-identical both ways, so
both shard the same cells).  JAX runs on the 8-device CPU mesh of
tests/conftest.py, the port on ``make_mesh(8, device="cpu")``, where the
kernel wrappers run their plain PyTorch versions."""

import numpy as np
import pytest
import torch
import jax

import fastpyvectordb_tpu as J
import fastpyvectordb_tpu_torch as T
from fastpyvectordb_tpu.dist import mesh as jmesh
from fastpyvectordb_tpu.dist import sharded_ann as jsa
from fastpyvectordb_tpu_torch.dist import mesh as tmesh
from fastpyvectordb_tpu_torch.dist import sharded_ann as tsa
from fastpyvectordb_tpu_torch.dist.sharded_ann import (ShardedInt8,
                                                       ShardedIVF,
                                                       ShardedIVFPQ)
from torch_parity import assert_same_topk, clustered, nan_past_extent

D = 16


@pytest.fixture(scope="module")
def mesh():
    return tmesh.make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) == 8
    return jmesh.make_mesh()


def _col(name, metric="l2", d=D, **cfg):
    return T.Collection(T.CollectionConfig(name=name, dimensions=d,
                                           metric=metric, **cfg),
                        device="cpu")


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(5)
    n = 4096
    centers = rng.standard_normal((24, D)).astype(np.float32) * 2
    v = centers[rng.integers(0, 24, n)] + 0.25 * rng.standard_normal(
        (n, D)).astype(np.float32)
    col = _col("sh")
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    q = centers[rng.integers(0, 24, 8)] + 0.25 * rng.standard_normal(
        (8, D)).astype(np.float32)
    exact = [set(r.tolist()) for r in _exact_rows(col, q, 10)]
    return col, v, q, exact


def _exact_rows(col, q, k):
    _, rows = col._store.search(q, k, col.config.metric)
    return rows


def _recall(rows, exact):
    return np.mean([len(set(r.tolist()) & e) / 10
                    for r, e in zip(rows, exact)])


def _agree(a, b):
    return np.mean([len(set(x.tolist()) & set(y.tolist())) / 10
                    for x, y in zip(a, b)])


def _move_to_overflow(col, rows):
    """Take ``rows`` out of the index's cells into its overflow block, so
    that only the overflow path can find them (a build at test scale
    rarely overflows: cells hold at least 128 rows)."""
    ann = col._ann
    rt = ann.row_table.clone()
    for r in rows:
        rt[rt == int(r)] = -1
    ann.row_table = rt
    keep = ann.overflow_rows[ann.overflow_rows >= 0]
    orows = torch.cat([keep, torch.as_tensor(rows, dtype=torch.int32)])
    ann.overflow_rows = orows
    ann.overflow_vecs = col._store.vectors[orows.long()].to(
        ann.overflow_vecs.dtype)


# ---------------------------------------------------------------------------
# the cases of tests/test_sharded_ann.py
# ---------------------------------------------------------------------------

def test_sharded_ivf_recall(built, mesh):
    col, v, q, exact = built
    col.build_ann(kind="ivf", nlist=64, nprobe=12, iters=5)
    sh = ShardedIVF.from_index(mesh, col._ann)
    d, rows = sh.search(q, 10)
    assert rows.shape == (8, 10)
    assert _recall(rows, exact) >= 0.9
    assert all(np.all(np.diff(row) >= -1e-5) for row in d)


def test_sharded_ivf_respects_tombstones(built, mesh):
    col, v, q, exact = built
    if col._ann is None:
        col.build_ann(kind="ivf", nlist=64, nprobe=12, iters=5)
    dead = int(_exact_rows(col, q[:1], 1)[0, 0])
    valid = col._store.valid.clone()
    valid[dead] = False
    sh = ShardedIVF.from_index(mesh, col._ann, validmask=valid)
    _, rows = sh.search(q[:1], 10)
    assert dead not in rows[0].tolist()


def test_sharded_ivf_overflow_rows_reachable(mesh):
    rng = np.random.default_rng(9)
    n = 1024
    v = rng.standard_normal((n, D)).astype(np.float32)
    col = _col("ov")
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    col.build_ann(kind="ivf", nlist=32, nprobe=8, iters=4,
                  max_cell_factor=0.6, spill_choices=2)
    moved = np.arange(0, n, 97)[:8]
    _move_to_overflow(col, moved)
    sh = ShardedIVF.from_index(mesh, col._ann)
    assert sh.cent_boost.full().sum() == 8       # one boost cell a shard
    _, rows = sh.search(v[moved], 5)
    for qi, want in enumerate(moved):
        assert want in rows[qi].tolist()


def test_sharded_int8_matches_single_card(built, mesh):
    col, v, q, exact = built
    scan = col.enable_quantized_scan("int8")
    sh = ShardedInt8.from_scan(mesh, scan)
    d, rows = sh.search(q, 10, rerank=4)
    assert rows.shape == (8, 10)
    assert _recall(rows, exact) >= 0.95
    _, r1 = scan.search(q, 10, rerank=4)
    assert _agree(rows, r1) >= 0.9


def test_sharded_int4_matches_single_card(built, mesh):
    """int4 rides the same sharded scan with half the per-shard coarse
    bytes; a deeper candidate pool covers the coarser ordering."""
    col, v, q, exact = built
    scan = col.enable_quantized_scan("int4")
    assert scan.kind == "int4"
    sh = ShardedInt8.from_scan(mesh, scan)
    assert sh.codec == "int4"
    d, rows = sh.search(q, 10, rerank=8)
    assert rows.shape == (8, 10)
    assert _recall(rows, exact) >= 0.9
    _, r1 = scan.search(q, 10, rerank=8)
    assert _agree(rows, r1) >= 0.9
    col.enable_quantized_scan("int8")  # restore for downstream tests


def test_sharded_int8_respects_tombstones(built, mesh):
    col, v, q, exact = built
    if col._quantized is None:
        col.enable_quantized_scan("int8")
    dead = int(_exact_rows(col, q[:1], 1)[0, 0])
    col.delete(f"v{dead}")
    sh = ShardedInt8.from_scan(mesh, col._quantized)
    _, rows = sh.search(q[:1], 10)
    assert dead not in rows[0].tolist()


def _ivfpq(col):
    if col._ann is None or type(col._ann).__name__ != "IVFPQIndex":
        col.build_ann(kind="ivfpq", nlist=64, nprobe=12, iters=5, m=8,
                      pq_k=64, pq_iters=8, rerank=16)


def test_sharded_ivfpq_recall(built, mesh):
    col, v, q, exact = built
    col.build_ann(kind="ivfpq", nlist=64, nprobe=12, iters=5, m=8, pq_k=64,
                  pq_iters=8, rerank=16)
    sh = ShardedIVFPQ.from_index(mesh, col._ann)
    d, rows = sh.search(q, 10)
    assert rows.shape == (8, 10)
    assert _recall(rows, exact) >= 0.85
    assert all(np.all(np.diff(row) >= -1e-5) for row in d)
    _, r1 = col._ann.search(q, 10, rerank=16)
    assert np.mean(rows[:, 0] == r1[:, 0]) >= 0.75


def test_sharded_ivfpq_tombstones(built, mesh):
    col, v, q, exact = built
    _ivfpq(col)
    dead = int(_exact_rows(col, q[:1], 1)[0, 0])
    vm = col._store.valid[:col._store.count].clone()
    vm[dead] = False
    sh = ShardedIVFPQ.from_index(mesh, col._ann, validmask=vm)
    _, rows = sh.search(q[:1], 10)
    assert dead not in rows[0].tolist()


def test_sharded_ivfpq_grouped_matches_perquery(built, mesh):
    """Cells partition the corpus, so cell-major scoring is a reordering
    of the per-query candidate scan, and phase 2 re-scores both sets
    exactly."""
    col, v, q, exact = built
    _ivfpq(col)
    sh = ShardedIVFPQ.from_index(mesh, col._ann)
    rng = np.random.default_rng(11)
    qb = np.asarray(v[rng.integers(0, v.shape[0], 64)]
                    + 0.1 * rng.standard_normal((64, D)), dtype=np.float32)
    assert qb.shape[0] * sh.nprobe_local >= sh.centroids.shape[0] // 8
    d_g, r_g = sh.search(qb, 10)                # grouped
    sh._allow_grouped = False
    d_p, r_p = sh.search(qb, 10)                # per query
    np.testing.assert_allclose(d_g, d_p, atol=2e-3)
    mism = r_g != r_p
    if mism.any():
        np.testing.assert_allclose(d_g[mism], d_p[mism], atol=2e-3)


def test_sharded_ivfpq_extents_are_each_shards_own(built, mesh,
                                                  monkeypatch):
    """Each shard hands B7 its own cells' extents, and the rows past them,
    which the CUDA kernel leaves unwritten, are never read: NaN written
    there changes no answer."""
    from fastpyvectordb_tpu_torch.ann import ivfpq as tpq
    col, v, q, exact = built
    _ivfpq(col)
    sh = ShardedIVFPQ.from_index(mesh, col._ann)
    g = mesh.local_rows()[0]
    blocks = [sh.extents.block(g, j) for j in mesh.local_data(g)]
    for j, ext in zip(mesh.local_data(g), blocks):
        assert torch.equal(ext, tpq.cell_extents(sh.row_table.block(g, j)))
    ext = torch.cat(blocks)
    assert torch.equal(ext.long(), (col._ann.row_table >= 0).sum(dim=1))
    assert int(ext.min()) < col._ann.row_table.shape[1]
    rng = np.random.default_rng(12)
    qb = np.asarray(v[rng.integers(0, v.shape[0], 64)]
                    + 0.1 * rng.standard_normal((64, D)), dtype=np.float32)
    want = sh.search(qb, 10)
    calls = []
    patched = nan_past_extent(tpq.grouped_cell_scores_pq)
    monkeypatch.setattr(tpq, "grouped_cell_scores_pq",
                        lambda *a: calls.append(1) or patched(*a))
    got = sh.search(qb, 10)
    assert len(calls) == len(blocks)              # the grouped branch ran
    for w, gv in zip(want, got):
        np.testing.assert_array_equal(w, gv)


def test_sharded_ivf_int8_cells(built, mesh):
    col, v, q, exact = built
    col.build_ann(kind="ivf", nlist=64, nprobe=12, iters=5,
                  cell_dtype="int8")
    assert col._ann.cells.dtype == torch.int8
    sh = ShardedIVF.from_index(mesh, col._ann)
    assert sh.rerank == col._ann.rerank == 4  # exact re-rank rides along
    d, rows = sh.search(q, 10)
    assert rows.shape == (8, 10)
    assert _recall(rows, exact) >= 0.85
    assert all(np.all(np.diff(row) >= -1e-4) for row in d)
    _, rows_1c = col._ann.search(q, 10)
    assert _agree(rows, rows_1c) >= 0.85


def _overflow_collection(seed=11, n=1024, shift=6.0):
    """Bimodal corpus far from the origin: a query near an overflow row is
    far from the data-mean centroid that routes the overflow cells."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, D)).astype(np.float32)
    v[: n // 2] += shift
    v[n // 2:] -= shift
    col = _col("ovf")
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    return col, v


def test_sharded_ivf_overflow_far_from_mean(mesh):
    col, v = _overflow_collection()
    col.build_ann(kind="ivf", nlist=32, nprobe=4, iters=4,
                  max_cell_factor=0.6, spill_choices=2)
    moved = np.concatenate([np.arange(0, 512, 131), np.arange(600, 1024,
                                                              107)])
    _move_to_overflow(col, moved)
    sh = ShardedIVF.from_index(mesh, col._ann)
    _, rows = sh.search(v[moved], 5)
    for qi, want in enumerate(moved):
        assert want in rows[qi].tolist(), (qi, want, rows[qi])
    regular = np.setdiff1d(np.arange(v.shape[0]), moved)[:8]
    _, rows = sh.search(v[regular], 5)
    assert sum(int(w in r.tolist()) for w, r in zip(regular, rows)) >= 6


def test_sharded_ivfpq_overflow_far_from_mean(mesh):
    col, v = _overflow_collection(seed=13)
    col.build_ann(kind="ivfpq", nlist=32, nprobe=4, iters=4, m=8, pq_k=16,
                  pq_iters=3, max_cell_factor=0.6, spill_choices=2)
    moved = np.concatenate([np.arange(3, 512, 131), np.arange(601, 1024,
                                                              107)])
    _move_to_overflow(col, moved)
    sh = ShardedIVFPQ.from_index(mesh, col._ann)
    _, rows = sh.search(v[moved], 5, rerank=8)
    for qi, want in enumerate(moved):
        assert want in rows[qi].tolist(), (qi, want, rows[qi])


def test_sharded_ivf_grouped_matches_perquery(mesh):
    """The grouped dispatch selects the same rows as the per-query gather,
    including the always-probed overflow cell, which the grouped branch
    excludes from routing and scans exactly instead."""
    rng = np.random.default_rng(5)
    col, v = _overflow_collection(seed=5)
    col.build_ann(nlist=32, nprobe=8, iters=4)
    # overflow entries that are also in cells: both dispatches see the
    # same candidate multiset
    orows = torch.arange(16, dtype=torch.int32)
    col._ann.overflow_rows = orows
    col._ann.overflow_vecs = col._store.vectors[orows.long()]
    sh = ShardedIVF.from_index(mesh, col._ann)
    assert sh._allow_grouped and sh.has_boost
    q = np.asarray(v[rng.integers(0, v.shape[0], 64)]
                   + 0.1 * rng.standard_normal((64, D)), dtype=np.float32)
    d_g, r_g = sh.search(q, 10)          # b * npl >= local cells: grouped
    sh._allow_grouped = False
    d_p, r_p = sh.search(q, 10)
    np.testing.assert_allclose(d_g, d_p, atol=2e-3)
    mism = r_g != r_p
    if mism.any():
        np.testing.assert_allclose(d_g[mism], d_p[mism], atol=2e-3)


def test_sharded_int8_masks_post_build_tail(mesh):
    """Rows appended after the snapshot build carry garbage codes:
    from_scan masks them as QuantizedScan.search does."""
    rng = np.random.default_rng(11)
    v = rng.standard_normal((256, 16)).astype(np.float32)
    col = _col("tail8")
    col.insert_batch(v, [f"v{i}" for i in range(256)])
    scan = col.enable_quantized_scan("int8", tune=False)
    built_n = scan.built_count
    col.insert_batch(rng.standard_normal((64, 16)).astype(np.float32),
                     [f"w{i}" for i in range(64)])
    sh = ShardedInt8.from_scan(mesh, scan)
    _, rows = sh.search(v[:8], k=10)
    assert (rows < built_n).all(), "tail rows served from garbage codes"


def test_interleave_overflow_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((10, 3)).astype(np.float32)
    e = rng.standard_normal((4, 3)).astype(np.float32)
    t = rng.integers(0, 99, (10, 5)).astype(np.int32)
    te = rng.integers(0, 99, (4, 5)).astype(np.int32)
    (ja, jt), jv, jb = jsa._interleave_overflow(4, [a, t], [e, te], [0, -1])
    (ta, tt), tv, tb = tsa._interleave_overflow(
        4, [torch.as_tensor(a), torch.as_tensor(t)],
        [torch.as_tensor(e), torch.as_tensor(te)], [0, -1])
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tb.numpy(), jb)


# ---------------------------------------------------------------------------
# parity with the JAX package's sharded searchers on one carried index
# ---------------------------------------------------------------------------

N = 2000
CELLS = {"f32": ({}, {}), "bf16": ({"compute_dtype": "bfloat16"}, {}),
         "int8": ({}, {"cell_dtype": "int8"})}


def _corpus(seed=0, n=N, d=D, nq=24):
    rng = np.random.default_rng(seed)
    v, centers = clustered(rng, n, d, n_centers=32)
    q = (centers[rng.integers(0, 32, nq)]
         + 0.5 * rng.standard_normal((nq, d))).astype(np.float32)
    return v, q


def _carried(tmp_path, metric, kind="ivf", cfg=None, **build):
    """A JAX collection with an index (an overflow block forced by a tight
    cell capacity), saved, and the port's collection loaded from the
    file."""
    v, q = _corpus()
    jdb = J.VectorDB(tmp_path / "j")
    jc = jdb.create_collection("c", dimensions=D, metric=metric,
                               **(cfg or {}))
    jc.insert_batch(v, [f"v{i}" for i in range(N)])
    jc.build_ann(kind, nlist=16, nprobe=4, iters=4, max_cell_factor=1.0,
                 spill_choices=2, tune=False, **build)
    jdb.save()
    tc = T.VectorDB(tmp_path / "j", device="cpu")["c"]
    return jc, tc, q


def _bf16_tol(d):
    ok = np.asarray(d) < 1e38
    return 1e-3 * max(np.abs(np.asarray(d)[ok]).max(), 1.0)


@pytest.mark.parametrize("cells,metric", [("f32", "cosine"), ("f32", "l2"),
                                          ("int8", "l2"), ("int8", "ip"),
                                          ("bf16", "cosine")])
def test_sharded_ivf_matches_jax_on_carried_index(tmp_path, mesh, jax_mesh,
                                                  cells, metric):
    cfg, extra = CELLS[cells]
    jc, tc, q = _carried(tmp_path, metric, cfg=cfg, **extra)
    assert int((np.asarray(jc._ann.overflow_rows) >= 0).sum()) > 0
    js = jsa.ShardedIVF.from_index(jax_mesh, jc._ann)
    ts = ShardedIVF.from_index(mesh, tc._ann)
    assert (ts.nprobe_local, ts.rerank, ts._allow_grouped) == \
        (js.nprobe_local, js.rerank, js._allow_grouped)
    boost = np.asarray(js.cent_boost)
    np.testing.assert_array_equal(ts.cent_boost.full().numpy(), boost)
    # the main cells alike; JAX writes each shard's overflow rows into its
    # boost cell, the port keeps them beside the cells, the same rows
    for name in ("row_table", "ok_cells", "cell_norms"):
        got, want = getattr(ts, name).full().numpy(), np.asarray(
            getattr(js, name))
        np.testing.assert_allclose(got[~boost], want[~boost][:, :got.shape[1]],
                                   rtol=1e-5)
    jrows = np.asarray(js.row_table)[boost]
    trows = ts.overflow[2].full().numpy().reshape(8, -1)
    for jr_, tr_ in zip(jrows, trows):
        assert jr_[jr_ >= 0].tolist() == tr_[tr_ >= 0].tolist()
    assert (ts.row_table.full().numpy()[boost] == -1).all()
    # the JAX package's layout (overflow rows inside the boost cells)
    # passed to the port's constructor serves the same results
    lay = None
    if cells != "bf16":
        lay = ShardedIVF(
            mesh, *(np.asarray(getattr(js, n)) for n in
                    ("centroids", "cells", "row_table", "cent_valid")),
            tc._store.valid, vmin=np.asarray(js.vmin),
            scale=np.asarray(js.scale), cell_norms=np.asarray(js.cell_norms),
            cent_boost=boost,
            vectors=tc._store.vectors if ts.rerank else None, metric=metric,
            nprobe=tc._ann.nprobe, compute_dtype=tc.config.compute_dtype,
            rerank=ts.rerank)
    for grouped in (True, False):
        js._fns.clear()
        js._allow_grouped = ts._allow_grouped = grouped
        jd, jr = js.search(q, 10)
        td, tr = ts.search(q, 10)
        assert ts.last_dropped == js.last_dropped
        if cells == "bf16":
            assert_same_topk(jd, jr, td, tr, rtol=0, atol=_bf16_tol(jd))
        else:
            assert_same_topk(jd, jr, td, tr, rtol=1e-5)
            lay._allow_grouped = grouped
            ld, lr = lay.search(q, 10)
            assert_same_topk(ld, lr, td, tr, rtol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_sharded_ivfpq_matches_jax_on_carried_index(tmp_path, mesh,
                                                    jax_mesh, metric):
    jc, tc, q = _carried(tmp_path, metric, kind="ivfpq", m=8, pq_k=64,
                         pq_iters=4, rerank=16)
    assert int((np.asarray(jc._ann.overflow_rows) >= 0).sum()) > 0
    js = jsa.ShardedIVFPQ.from_index(jax_mesh, jc._ann)
    ts = ShardedIVFPQ.from_index(mesh, tc._ann)
    assert ts.nprobe_local == js.nprobe_local
    np.testing.assert_array_equal(ts.orow_ids.full().numpy(),
                                  np.asarray(js.orow_ids))
    qq = np.concatenate([q, q + 0.01])      # 48 queries
    for grouped in (True, False):
        js._fns.clear()
        js._allow_grouped = ts._allow_grouped = grouped
        for rr in (16, 4):
            jd, jr = js.search(qq, 10, rerank=rr)
            td, tr = ts.search(qq, 10, rerank=rr)
            assert ts.last_dropped == js.last_dropped
            # the exact f32 re-rank of the same candidates
            assert_same_topk(jd, jr, td, tr, rtol=1e-5)


@pytest.mark.parametrize("kind,metric", [("int8", "cosine"), ("int8", "ip"),
                                         ("int4", "l2")])
def test_sharded_int8_matches_jax(mesh, jax_mesh, kind, metric):
    v, q = _corpus(seed=2, n=1500)
    jc = J.Collection(J.CollectionConfig(name="q", dimensions=D,
                                         metric=metric))
    tc = _col("q", metric=metric)
    for c in (jc, tc):
        c.insert_batch(v, [f"v{i}" for i in range(1500)])
    js = jsa.ShardedInt8.from_scan(jax_mesh, jc.enable_quantized_scan(
        kind, tune=False))
    ts = ShardedInt8.from_scan(mesh, tc.enable_quantized_scan(kind,
                                                              tune=False))
    # the same codes and row stats (bit-identical quantizers)
    np.testing.assert_array_equal(ts.codes.full().numpy(),
                                  np.asarray(js.codes))
    # (of the real rows: the capacity padding past them is masked)
    np.testing.assert_allclose(ts.vsq.full().numpy()[:1500],
                               np.asarray(js.vsq)[:1500], rtol=1e-5)
    rr = 8 if kind == "int4" else 4
    jd, jr = js.search(q, 10, rerank=rr)
    td, tr = ts.search(q, 10, rerank=rr)
    # exact re-ranks in f32 of (nearly always) the same candidates
    assert_same_topk(jd, jr, td, tr, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ivf_int8", "ivf_bf16", "ivfpq", "int8",
                                  "int4"])
def test_sharded_searchers_on_the_card_match_four_cpu_shards(tmp_path, kind):
    """Four logical shards of the card (the kernels) against four CPU
    shards (their plain versions) on one carried index: one launch a shard,
    the same rows up to ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fastpyvectordb_tpu_torch.kernels import ivf_kernels as ik
    from fastpyvectordb_tpu_torch.kernels import quant_kernels as qk
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    build = {"ivf_int8": ("ivf", {}, {"cell_dtype": "int8"}),
             "ivf_bf16": ("ivf", {"compute_dtype": "bfloat16"}, {}),
             "ivfpq": ("ivfpq", {}, {"m": 8, "pq_k": 64, "pq_iters": 4})}
    ann_kind, cfg, extra = build.get(kind, ("ivf", {}, {}))
    jc, tc, q = _carried(tmp_path, "l2", kind=ann_kind, cfg=cfg, **extra)
    gc = T.VectorDB(tmp_path / "j", device="cuda")["c"]
    cpu, card = (tmesh.make_mesh(4, device="cpu"),
                 tmesh.logical_mesh(4, device="cuda"))
    qq = np.concatenate([q] * 4)          # 96 queries: the grouped branch
    if kind in ("int8", "int4"):
        searchers = [ShardedInt8.from_scan(m, c.enable_quantized_scan(
            kind, tune=False)) for m, c in ((cpu, tc), (card, gc))]
        launches = {"int8": (s8, "s8_topc"), "int4": (qk, "int4_scores")}
    else:
        cls = ShardedIVF if ann_kind == "ivf" else ShardedIVFPQ
        searchers = [cls.from_index(m, c._ann)
                     for m, c in ((cpu, tc), (card, gc))]
        launches = {"ivf_int8": (ik, "grouped_cell_scores_i8"),
                    "ivf_bf16": (ik, "grouped_cell_scores"),
                    "ivfpq": (ik, "grouped_cell_scores_pq")}
    mod, name = launches[kind]
    want_d, want_r = searchers[0].search(qq, 10)
    mod.LAUNCHES[name] = 0
    got_d, got_r = searchers[1].search(qq, 10)
    assert mod.LAUNCHES[name] == 4
    if kind == "ivf_bf16":
        assert_same_topk(want_d, want_r, got_d, got_r, rtol=0,
                         atol=_bf16_tol(want_d))
    else:
        assert_same_topk(want_d, want_r, got_d, got_r, rtol=1e-4,
                         atol=1e-5)
