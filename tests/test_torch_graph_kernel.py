"""The graph beam's hand-written kernel (``csrc/graph_beam.cu``, wrapped by
``kernels/graph_kernels.py:graph_beam``) against its plain rounds
(``graph_beam_plain``).

On the CPU: a numpy copy of the kernel's rounds, with its 64-bit keys (the
value, then the position) and its one-pass dedup, takes the plain rounds'
trajectory bit for bit on tie-heavy integer rows; the shape rule on both
sides of its limits; a search on the CPU launches nothing.

On the card (``cuda`` marker, skipped without one): l2 and dot on
integer-valued rows, where every f32 sum is exact, equal the plain rounds
bit for bit (duplicate entry ids, tombstoned targets, duplicate rows, W up
to the rule's limit, T from 0 to 16, B up to 1,024, bf16 compute, bf16 and
f16 storage, rows with and without 16-byte loads, a query too wide for
shared memory); cosine on random f32 rows at the ``graph-b1`` cell's
knobs; one launch a search, and a ``ValueError`` with no launch past the
rule.
"""

import numpy as np
import pytest
import torch

import fastpyvectordb_tpu_torch as T
from fastpyvectordb_tpu_torch.ann import graph_ann as tg
from fastpyvectordb_tpu_torch.kernels import graph_kernels as gk
from fastpyvectordb_tpu_torch.kernels.distances import MASKED

M32 = np.float32(MASKED)
HALF = np.float32(M32 * np.float32(0.5))
POS_BITS = 13

# (B, W, E, T, R, D, storage, compute, metric): the rule's corners and the
# cell's knobs (W 64, E 8, T 8, R 32); D 50 has no 16-byte loads; at W 4,096
# with D 17,000 the keys fill the block's shared memory and the query is
# read from global memory
CASES = [
    (1, 64, 8, 8, 32, 64, "float32", "float32", "l2"),
    (7, 128, 4, 16, 32, 64, "float32", "float32", "l2"),
    (7, 512, 8, 8, 32, 64, "float32", "float32", "l2"),
    (1024, 64, 8, 8, 32, 64, "float32", "float32", "l2"),
    (7, 64, 8, 0, 32, 64, "float32", "float32", "l2"),
    (7, 64, 8, 1, 32, 64, "float32", "float32", "l2"),
    (7, 64, 4, 8, 16, 50, "float32", "float32", "l2"),
    (7, 64, 8, 8, 32, 64, "float32", "bfloat16", "l2"),
    (7, 64, 8, 8, 32, 64, "bfloat16", "float32", "l2"),
    (7, 64, 8, 8, 32, 64, "bfloat16", "bfloat16", "l2"),
    (7, 64, 8, 8, 32, 50, "bfloat16", "float32", "ip"),
    (5, 768, 8, 4, 32, 64, "float32", "float32", "l2"),   # W + E R = 1024
    (7, 1024, 8, 4, 32, 64, "float32", "float32", "l2"),  # k 1,000 widened
    (7, 64, 8, 8, 32, 64, "float16", "float32", "l2"),
    (7, 64, 8, 8, 32, 50, "float16", "bfloat16", "l2"),
    (2, 4096, 8, 2, 128, 64, "float32", "float32", "l2"),   # W + E R = 5120
    (2, 4096, 8, 2, 128, 17000, "float32", "bfloat16", "l2"),
]
IDS = ["-".join(str(x) for x in c) for c in CASES]


def integer_case(b, w, e, r, d, storage, seed=0, device="cpu"):
    """Integer-valued rows in [-4, 4] (exact in bf16 and f16, every f32 sum
    exact), 200 of them twice (score ties), a random neighbour table with
    5% of its targets tombstoned (-1), and entry points with duplicates
    (the first two of each query the same) and 10% of them dead; 3,000
    rows, 600 where they are wide."""
    rows = 3000 if d < 4096 else 600
    rng = np.random.default_rng(seed)
    v = rng.integers(-4, 5, (rows, d)).astype(np.float32)
    v[rows // 2: rows // 2 + 200] = v[:200]
    nbr = rng.integers(0, rows, (rows, r)).astype(np.int32)
    nbr[rng.random((rows, r)) < 0.05] = -1
    q = rng.integers(-4, 5, (b, d)).astype(np.float32)
    e0 = min(32, w)
    init = rng.integers(0, rows, (b, e0)).astype(np.int32)
    init[:, 1 % e0] = init[:, 0]
    live = rng.random((b, e0)) >= 0.1
    t = {"q": torch.from_numpy(q), "nbr": torch.from_numpy(nbr),
         "init": torch.from_numpy(init), "live": torch.from_numpy(live),
         "vectors": torch.from_numpy(v).to(getattr(torch, storage))}
    return {k: x.to(device) for k, x in t.items()}


def plain(c, w, e, t, metric, compute):
    return gk.graph_beam_plain(c["q"], c["vectors"], c["nbr"], c["init"],
                               c["live"], beam=w, expand=e, iters=t,
                               metric=metric, compute_dtype=compute)


# ---------------------------------------------------------------------------
# the kernel's rounds in numpy
# ---------------------------------------------------------------------------

def ord_keys(s: np.ndarray) -> np.ndarray:
    """The kernel's ``ord``: f32 -> uint64 in float order, NaN after +inf,
    -0 as +0."""
    u = s.astype(np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    k = np.where(u & 0x80000000, ~u, u | np.uint32(0x80000000))
    k = k.astype(np.uint32)
    k[np.isnan(s)] = 0xFFFFFFFF
    return k.astype(np.uint64)


def emulate(c, w, e, t, metric, compute):
    """The kernel's rounds a query at a time (``csrc/graph_beam.cu``):
    every order a sort of unique keys (value << bits | position), the
    dedup on the id-sorted entries.  Scores are exact (integer rows), in
    float64 and then f32, as the kernel's f32 sums are."""
    v = c["vectors"].float().numpy().astype(np.float64)
    q = c["q"].numpy().astype(np.float64)
    if compute == "bfloat16":   # integer rows: the rounding is exact
        q = c["q"].bfloat16().float().numpy().astype(np.float64)
    nbr = c["nbr"].numpy().astype(np.int64)
    n, r = nbr.shape
    mask = (1 << POS_BITS) - 1
    out_ids, out_sc = [], []

    def score(bq, rows):
        x = v[np.maximum(rows, 0)]
        cross = x @ q[bq]
        if metric == "l2":
            s = np.maximum((q[bq] @ q[bq]) + (x * x).sum(1) - 2 * cross, 0)
        else:
            s = -cross
        return np.where(rows >= 0, s, M32).astype(np.float32)

    for bq in range(q.shape[0]):
        init = c["init"][bq].numpy().astype(np.int64)
        e0 = init.size
        b_id = np.full(w, -1, np.int64)
        b_sc = np.full(w, M32, np.float32)
        b_ex = np.zeros(w, bool)
        b_id[:e0] = init
        b_sc[:e0] = np.where(c["live"][bq].numpy(), score(bq, init), M32)
        for _ in range(t):
            sel = np.where(b_ex | (b_id < 0), M32, b_sc).astype(np.float32)
            k = np.sort((ord_keys(sel) << np.uint64(32))
                        | np.arange(w, dtype=np.uint64))
            pos = (k[:e] & np.uint64(mask)).astype(np.int64)
            x = b_id[pos]
            b_ex[pos] = True
            cand = np.where(x[:, None] < 0, -1,
                            nbr[np.maximum(x, 0)]).reshape(-1)
            e_id = np.concatenate([b_id, cand])
            e_sc = np.concatenate([b_sc, score(bq, cand)])
            e_ex = np.concatenate([b_ex, np.zeros(cand.size, bool)])
            m = e_id.size
            real = (e_id >= 0) & (e_sc < HALF)
            ik = np.where(real, 2 * e_id + (~e_ex), 2 * n + 2)
            k1 = np.sort((ik.astype(np.uint64) << np.uint64(POS_BITS))
                         | np.arange(m, dtype=np.uint64))
            o = (k1 & np.uint64(mask)).astype(np.int64)
            sid = e_id[o]
            dup = np.concatenate([[False], sid[1:] == sid[:-1]])
            s = np.where(dup, M32, e_sc[o]).astype(np.float32)
            k2 = np.sort((ord_keys(s) << np.uint64(32))
                         | np.arange(m, dtype=np.uint64))
            j = (k2[:w] & np.uint64(mask)).astype(np.int64)
            b_sc = s[j]
            b_id = np.where(b_sc >= HALF, -1, e_id[o[j]])
            b_ex = e_ex[o[j]]
        out_ids.append(b_id)
        out_sc.append(b_sc)
    return np.stack(out_ids).astype(np.int32), np.stack(out_sc)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_emulated_kernel_rounds_equal_plain(case):
    b, w, e, t, r, d, storage, compute, metric = case
    b = min(b, 24)
    c = integer_case(b, w, e, r, d, storage)
    want_ids, want_sc = plain(c, w, e, t, metric, compute)
    got_ids, got_sc = emulate(c, w, e, t, metric, compute)
    assert np.array_equal(got_ids, want_ids.numpy())
    assert np.array_equal(got_sc.view(np.uint32),
                          want_sc.numpy().view(np.uint32))
    # the case reaches what it is there for: ties, duplicates, tombstones
    if t:
        assert (want_ids.numpy() >= 0).sum() > b * min(w, 40)


def test_the_keys_order_scores_as_torchs_stable_sort():
    s = np.array([0.5, -0.0, np.nan, 0.0, -1.0, np.inf, -np.inf, 0.5,
                  np.nan, 1e-38, -1e-38, M32], np.float32)
    keys = (ord_keys(s) << np.uint64(32)) | np.arange(s.size,
                                                       dtype=np.uint64)
    got = (np.sort(keys) & np.uint64((1 << POS_BITS) - 1)).astype(np.int64)
    want = torch.argsort(torch.from_numpy(s), stable=True).numpy()
    assert got.tolist() == want.tolist()


# ---------------------------------------------------------------------------
# the shape rule, the CPU path
# ---------------------------------------------------------------------------

def test_the_shape_rule_on_both_sides_of_its_limits():
    f32 = torch.empty((4, 768))
    take = gk.kernel_takes
    assert take(f32, 64, 8, 32, "float32")              # graph-b1
    assert take(f32, 512, 8, 32, "float32")             # filter-widened
    assert take(f32, 1024, 8, 32, "bfloat16")           # k 1,000 widened
    assert take(f32, 4096, 8, 128, "float32")           # W + E R = 5120
    assert not take(f32, 4097, 8, 128, "float32")       # 5121
    assert take(f32, 4864, 8, 32, "float32")            # 5120
    assert not take(f32, 8192, 8, 32, "float32")        # k past 4,096
    assert take(f32, 5120, 0, 32, "float32")
    assert not take(f32, 5120, 1, 32, "float32")
    assert take(f32, 8, 8, 32, "float32")
    assert not take(f32, 8, 9, 32, "float32")           # E > W
    assert not take(f32, 0, 0, 32, "float32")
    assert take(f32, 64, 0, 32, "float32")
    assert take(torch.empty((4, 20000)), 64, 8, 32, "float32")   # any D
    assert take(f32.bfloat16(), 64, 8, 32, "bfloat16")
    assert take(f32.half(), 64, 8, 32, "float32")
    assert not take(f32.to(torch.int8), 64, 8, 32, "float32")
    assert not take(f32, 64, 8, 32, "float16")


@pytest.fixture(scope="module")
def small_graph():
    rng = np.random.default_rng(5)
    v = rng.standard_normal((2000, 16)).astype(np.float32)
    col = T.Collection(T.CollectionConfig(name="g", dimensions=16,
                                          metric="cosine"), device="cpu")
    col.insert_batch(v, [f"v{i}" for i in range(2000)],
                     [{"m": i % 3} for i in range(2000)])
    with pytest.warns(UserWarning):
        col.build_ann(kind="graph", r=16, n_entries=32, beam=64, expand=8,
                      iters=4, tune=False)
    return col, v


def test_the_search_routes_its_shapes_by_the_rule(small_graph, monkeypatch):
    """The widths a search hands the beam, and the side of the rule each
    falls on: the built knobs, the filter's widened beam and k past the
    beam widened to 1,024 take the kernel on the card; k past 4,096,
    widened to 8,192, does not (a ``ValueError`` there; the CPU's plain
    rounds take it)."""
    col, v = small_graph
    seen = []
    orig = tg.graph_beam

    def spy(q, vectors, neighbors, *args, **kw):
        seen.append((kw["beam"], gk.kernel_takes(
            vectors, kw["beam"], kw["expand"], neighbors.shape[1],
            kw["compute_dtype"])))
        return orig(q, vectors, neighbors, *args, **kw)

    monkeypatch.setattr(tg, "graph_beam", spy)
    ann = col._ann
    ann.search(v[:3], 10)
    ann.search(v[:3], 10, mask=np.arange(2000) % 3 == 0, overfetch=40)
    ann.search(v[:3], 1000)
    _, r = ann.search(v[:3], 5000)
    assert seen == [(64, True), (512, True), (1024, True), (8192, False)]
    assert r.shape == (3, 5000) and (r[:, 0] == np.arange(3)).all()


def test_a_search_on_the_cpu_launches_nothing(small_graph):
    col, v = small_graph
    before = dict(gk.LAUNCHES)
    d, r = col._ann.search(v[:5], 10)
    assert (r[:, 0] == np.arange(5)).all()
    assert gk.LAUNCHES == before


def test_the_wrapper_takes_the_plain_rounds_on_the_cpu():
    c = integer_case(3, 64, 8, 32, 64, "float32")
    before = dict(gk.LAUNCHES)
    got = gk.graph_beam(c["q"], c["vectors"], c["nbr"], c["init"],
                        c["live"], beam=64, expand=8, iters=8, metric="l2",
                        compute_dtype="float32")
    want = plain(c, 64, 8, 8, "l2", "float32")
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert gk.LAUNCHES == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cuda_integer_rows_equal_plain_bit_for_bit(card, case):
    b, w, e, t, r, d, storage, compute, metric = case
    c = integer_case(b, w, e, r, d, storage, device=card)
    want = plain(c, w, e, t, metric, compute)
    before = gk.LAUNCHES["graph_beam"]
    got = gk.graph_beam(c["q"], c["vectors"], c["nbr"], c["init"],
                        c["live"], beam=w, expand=e, iters=t, metric=metric,
                        compute_dtype=compute)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["graph_beam"] == before + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))


@pytest.mark.cuda
def test_cuda_cosine_random_rows_at_the_cells_knobs(card):
    """f32 rows of 768, cosine, W 64, E 8, T 8, R 32, 32 entry points: the
    kernel's f32 sums run in another order than the product's, so a near
    tie may fall the other way; the top 10 of the beam differ on at most
    5e-4 of the hits, and a row both found scores within 1e-5."""
    g = torch.Generator(device=card).manual_seed(11)
    n, d, b, r = 60_000, 768, 256, 32
    v = torch.randn((n, d), generator=g, device=card)
    nbr = torch.randint(0, n, (n, r), generator=g, device=card,
                        dtype=torch.int32)
    q = v[torch.randint(0, n, (b,), generator=g, device=card)] \
        + 0.7 * torch.randn((b, d), generator=g, device=card)
    init = torch.randint(0, n, (b, 32), generator=g, device=card,
                         dtype=torch.int32)
    live = torch.ones((b, 32), dtype=torch.bool, device=card)
    kw = dict(beam=64, expand=8, iters=8, metric="cosine",
              compute_dtype="float32")
    want = gk.graph_beam_plain(q, v, nbr, init, live, **kw)
    got = gk.graph_beam(q, v, nbr, init, live, **kw)

    def top10(ids, sc):
        pos = tg._ascending(sc, 10)
        return ids.gather(1, pos).cpu().numpy(), sc.gather(1, pos).cpu(
            ).numpy()

    wi, ws = top10(*want)
    gi, gs = top10(*got)
    missed = sum(len(set(a) - set(bb)) for a, bb in zip(wi, gi))
    assert missed <= 5e-4 * wi.size
    for a, sa, bb, sb in zip(wi, ws, gi, gs):
        mine = dict(zip(bb.tolist(), sb.tolist()))
        for row, s in zip(a.tolist(), sa.tolist()):
            if row in mine:
                assert abs(mine[row] - s) <= 1e-5


@pytest.mark.cuda
def test_cuda_one_launch_a_search_and_none_past_the_rule(card, monkeypatch):
    rng = np.random.default_rng(3)
    v = rng.standard_normal((4096, 64)).astype(np.float32)
    col = T.Collection(T.CollectionConfig(name="g", dimensions=64,
                                          metric="cosine"), device="cuda")
    col.insert_batch(v, [f"v{i}" for i in range(4096)],
                     [{"m": i % 3} for i in range(4096)])
    with pytest.warns(UserWarning):
        col.build_ann(kind="graph", r=32, n_entries=64, beam=64, expand=8,
                      iters=8, tune=False)
    ann = col._ann
    q = v[:16] + 0.1 * rng.standard_normal((16, 64)).astype(np.float32)
    gk.LAUNCHES["graph_beam"] = 0
    for i in range(4):
        ann.search(q[i:i + 1], 10)
    ann.search(q, 10)
    ann.search(q, 10, mask=np.arange(4096) % 3 == 0, overfetch=40)
    assert gk.LAUNCHES["graph_beam"] == 6
    # k past the beam widens W to 1,024: the kernel too
    _, r = ann.search(q[:2], 1000)
    assert gk.LAUNCHES["graph_beam"] == 7 and r.shape == (2, 1000)
    # k past 4,096 widens W to 8,192: past the rule, an error, no launch
    with pytest.raises(ValueError, match="W 8192"):
        ann.search(q[:2], 5000)
    assert gk.LAUNCHES["graph_beam"] == 7
    # at the rule's limit (W 4,864 + E R 256 = 5,120) the kernel, and the
    # plain rounds' hits
    got = ann.search(q, 10, beam=4864, iters=4)
    assert gk.LAUNCHES["graph_beam"] == 8
    monkeypatch.setattr(tg, "graph_beam", gk.graph_beam_plain)
    want = ann.search(q, 10, beam=4864, iters=4)
    assert gk.LAUNCHES["graph_beam"] == 8
    assert (got[1] == want[1]).mean() >= 0.99
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_a_float16_collection_takes_the_kernel(card):
    """f16 rows: one launch a search, the plain rounds' hits."""
    rng = np.random.default_rng(4)
    v = rng.standard_normal((4096, 64)).astype(np.float32)
    col = T.Collection(T.CollectionConfig(
        name="g16", dimensions=64, metric="cosine", storage_dtype="float16"),
        device="cuda")
    col.insert_batch(v, [f"v{i}" for i in range(4096)])
    with pytest.warns(UserWarning):
        col.build_ann(kind="graph", r=32, n_entries=64, beam=64, expand=8,
                      iters=8, tune=False)
    ann = col._ann
    assert col._store.vectors.dtype == torch.float16
    q = v[:16] + 0.1 * rng.standard_normal((16, 64)).astype(np.float32)
    before = gk.LAUNCHES["graph_beam"]
    got = ann.search(q, 10)
    assert gk.LAUNCHES["graph_beam"] == before + 1
    store, cfg = col._store, col.config
    nbr, init_ok = ann._nav_tables(store)
    qt = torch.as_tensor(q, device="cuda")
    init_ids, live = tg._route(qt, ann.centroids, ann.medoids, init_ok,
                               cfg.metric, 32)
    kw = dict(beam=64, expand=8, iters=8, metric=cfg.metric,
              compute_dtype="float32")
    ids, sc = gk.graph_beam_plain(qt, store.vectors, nbr, init_ids, live,
                                  **kw)
    pos = tg._ascending(sc, 10)
    assert (got[1] == ids.gather(1, pos).cpu().numpy()).mean() >= 0.99


@pytest.mark.cuda
def test_cuda_current_stream_is_torchs(card):
    """The wrappers' stream pointer is torch's current stream: the default
    one, a side stream, and for a device named without its index."""
    from fastpyvectordb_tpu_torch.kernels.cuda_build import current_stream
    dev = torch.device("cuda", torch.cuda.current_device())
    assert current_stream(dev) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert current_stream(dev) == side.cuda_stream
        assert current_stream(torch.device("cuda")) == side.cuda_stream
