"""The fused int8 coarse scan ``s8_topc`` (fastpyvectordb_tpu_torch/kernels/
s8_kernels.py; kernel in csrc/s8_scores.cu with csrc/topc_epilogue.cuh).

  * its plain version against the JAX package's ``_int8_coarse_topk`` and
    ``_int8_two_stage`` (exact selection) on the same seeded inputs;
  * a CPU emulation of the kernel's selection (the tile walk, per-query
    thresholds, radix-select compactions, the partial lists and the merge)
    on integer-valued data full of ties, whose sorted values must equal the
    plain version's bit for bit;
  * a mirror of the kernel's prefilter floor (``_floor``): no product
    below it lets any of the tile's rows enter, over random and adversarial
    values, and the emulated selection with the floors equals the plain
    version on the tied, NaN and masked cases;
  * the wrapper's routing (no fallback off the CPU);
  * ``cuda``-marked tests of the kernel against its plain version, which
    run only where a card is present."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastpyvectordb_tpu.core.types import DistanceMetric
from fastpyvectordb_tpu.quant import scan as jscan
from fastpyvectordb_tpu.quant.scalar import ScalarQuantizer as JScalar
from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
from fastpyvectordb_tpu_torch.quant import scan as tscan
from fastpyvectordb_tpu_torch.quant.scalar import fold_queries
from torch_parity import assert_same_topk, clustered

METRICS = list(DistanceMetric)
MASKED = np.float32(3.0e38)
KEY_NAN, KEY_EMPTY = np.uint32(0xFFFFFFFE), np.uint32(0xFFFFFFFF)


def t(x):
    return torch.as_tensor(np.array(x))


def _inputs(n=900, d=40, b=7, seed=5):
    rng = np.random.default_rng(seed)
    v, centers = clustered(rng, n, d)
    q = (centers[rng.integers(0, len(centers), b)]
         + 0.5 * rng.standard_normal((b, d))).astype(np.float32)
    return v, q, rng


@pytest.mark.parametrize("valid", ["all", "some", "few"])
@pytest.mark.parametrize("metric", METRICS)
def test_plain_matches_jax_coarse_topk(metric, valid):
    """``_int8_coarse_topk`` (exact) of both packages: the port's runs
    ``s8_topc``'s plain version on the CPU.  "few": fewer valid rows than
    c, the tail is MASKED in both."""
    v, q, rng = _inputs()
    mask = {"all": None, "some": rng.random(len(v)) < 0.3,
            "few": np.isin(np.arange(len(v)), [3, 77, 400])}[valid]
    jq = JScalar().train(v)
    codes = jq.encode(v)
    vsq, rinv = jq.corpus_stats(codes)
    k = 10
    jd, jr = jscan._int8_coarse_topk(
        jnp.asarray(q), codes, jq.vmin, jq.scale, vsq, rinv,
        None if mask is None else jnp.asarray(mask), metric=metric, k=k,
        approx=False)
    td, tr = tscan._int8_coarse_topk(
        t(q), t(codes), t(jq.vmin), t(jq.scale), t(vsq), t(rinv),
        None if mask is None else t(mask), metric=metric.value, k=k)
    # XLA's CPU order of operations: values within 1e-6 relative
    assert_same_topk(np.asarray(jd), np.asarray(jr), td.numpy(), tr.numpy(),
                     rtol=1e-6)
    if valid == "few":
        assert (td.numpy()[:, 3:] == MASKED).all()


@pytest.mark.parametrize("metric", METRICS)
def test_plain_matches_jax_two_stage(metric):
    v, q, rng = _inputs(seed=8)
    mask = rng.random(len(v)) < 0.6
    jq = JScalar().train(v)
    codes = jq.encode(v)
    vsq, rinv = jq.corpus_stats(codes)
    jd, jr = jscan._int8_two_stage(
        jnp.asarray(q), codes, jq.vmin, jq.scale, vsq, rinv, jnp.asarray(v),
        jnp.asarray(mask), metric=metric, k=10, c=40, approx=False,
        rerank_dtype="float32")
    td, tr = tscan._int8_two_stage(
        t(q), t(codes), t(jq.vmin), t(jq.scale), t(vsq), t(rinv), t(v),
        t(mask), metric=metric.value, k=10, c=40, rerank_dtype="float32")
    assert_same_topk(np.asarray(jd), np.asarray(jr), td.numpy(), tr.numpy(),
                     rtol=1e-6)
    assert mask[tr.numpy()].all()


# -- the kernel's selection, emulated ----------------------------------------

def _keys(s):
    """csrc/topc_epilogue.cuh ``score_key``: unsigned order = float order,
    NaN after +inf."""
    u = s.astype(np.float32).view(np.uint32)
    k = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    return np.where(np.isnan(s), KEY_NAN, k).astype(np.uint32)


def _floats(k):
    u = np.where(k & 0x80000000, k ^ 0x80000000, ~k).astype(np.uint32)
    return u.view(np.float32)


def _radix_select(keys, rank):
    """``warp_select``: the rank-th smallest key (1-based) by four passes
    of an 8-bit digit histogram, and the count of keys below it."""
    prefix, high, below = 0, 0, 0
    for shift in (24, 16, 8, 0):
        live = keys[(keys & high) == prefix]
        hist = np.bincount((live >> shift) & 255, minlength=256)
        cum = np.cumsum(hist)
        digit = int(np.searchsorted(cum, rank))     # first cum >= rank
        before = int(cum[digit - 1]) if digit else 0
        rank -= before
        below += before
        prefix |= digit << shift
        high |= 0xFF << shift
    kth = np.uint32(prefix)
    srt = np.sort(keys)
    assert kth == srt[below] and (srt[:below] < kth).all()
    return kth, below


def _keep(keys, rows, c):
    """``topc_compact`` / the merge's selection: every key below the c-th
    smallest and the first ties at it, in list order."""
    kth, below = _radix_select(keys, c)
    tie = np.cumsum(keys == kth) <= c - below
    keep = (keys < kth) | ((keys == kth) & tie)
    assert keep.sum() == c
    return keys[keep], rows[keep], kth


def _emulate_topc(s, mask, c, sms, rng, floors=None):
    """The fused kernel's selection on the (B, N) f32 scores (as the
    epilogue computes them): blocks of one query tile walk the corpus tiles
    j, j + G, ...; a row enters its query's list below the threshold, in an
    arbitrary order (the atomics'); a list past c + 128 is compacted to c
    and the threshold set to the c-th key; the block's last compaction pads
    the list to c; the merge selects c of the G lists and sorts.  With
    ``floors(q, rows, mask, tau)`` (the prefilter: the rows of a tile that
    pass their floor) only those rows are tested, and every row that enters
    must be one of them."""
    b, n = s.shape
    keys = _keys(np.where(mask[None, :], s, MASKED))
    qtiles, ctiles = -(-b // 256), -(-n // 128)
    g = sms // qtiles
    g = 1 if g < 1 else min(g, ctiles)
    width = c + s8.TOPC_SLACK
    lk = np.full((b, g, c), KEY_EMPTY, dtype=np.uint32)
    lr = np.full((b, g, c), -1, dtype=np.int64)
    for q in range(b):
        for j in range(g):
            tau = KEY_EMPTY
            k_in = np.zeros(0, np.uint32)
            r_in = np.zeros(0, np.int64)
            for ct in range(j, ctiles, g):
                rows = np.arange(ct * 128, min(n, ct * 128 + 128))
                sel = rows[keys[q, rows] < tau]
                if floors is not None:
                    passed = floors(q, rows, mask, tau)
                    assert np.isin(sel, passed).all()
                    sel = passed[keys[q, passed] < tau]
                sel = sel[rng.permutation(len(sel))]
                k_in = np.concatenate([k_in, keys[q, sel]])
                r_in = np.concatenate([r_in, sel])
                assert len(k_in) <= width
                if len(k_in) > width - 128:
                    k_in, r_in, tau = _keep(k_in, r_in, c)
            if len(k_in) > c:
                k_in, r_in, _ = _keep(k_in, r_in, c)
            lk[q, j, :len(k_in)] = k_in
            lr[q, j, :len(k_in)] = r_in
    vals = np.empty((b, c), np.float32)
    out = np.empty((b, c), np.int64)
    for q in range(b):
        k_m, r_m, _ = _keep(lk[q].reshape(-1), lr[q].reshape(-1), c)
        order = np.argsort(k_m, kind="stable")
        vals[q], out[q] = _floats(k_m[order]), r_m[order]
    return vals, out


def _same_sorted(got, want):
    """Sorted values equal (-0 == +0, NaN where NaN)."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    return (np.isnan(got) == nan).all() and np.array_equal(got[~nan],
                                                           want[~nan])


def _check_rows(vals, rows, scores, n):
    """Rows valid and distinct per query, each carrying its own score."""
    assert (rows >= 0).all() and (rows < n).all()
    assert all(len(set(r.tolist())) == len(r) for r in rows)
    own = np.take_along_axis(scores, rows, axis=1)
    assert _same_sorted(own, vals)


def _tied_case(b, n, d, metric, seed):
    """Integer-valued data in a narrow range (products tie at every cut),
    folded as the int8 scan folds it; rinv / vsq with repeated values."""
    rng = np.random.default_rng(seed)
    qi = torch.as_tensor(rng.integers(-3, 4, (b, d), dtype=np.int8))
    codes = torch.as_tensor(rng.integers(-2, 3, (n, d), dtype=np.int8))
    qscale = torch.as_tensor(rng.choice([0.5, 1.0, 0.25], b).astype(
        np.float32))
    const = torch.as_tensor(rng.integers(-4, 5, b).astype(np.float32))
    qstat = torch.as_tensor(rng.choice([1.0, 2.0, 3.0], b).astype(
        np.float32))
    rstat = torch.as_tensor(rng.choice([0.5, 1.0], n).astype(np.float32))
    if metric == "dot":
        qstat = rstat = None
    return qi, codes, qscale, const, qstat, rstat, rng


# (B, N, c): one and two query tiles, ragged N, c of 1 / k / 40 / N, and
# corpora of many tiles a block (the thresholds at work)
EMULATED = [(5, 1000, 1), (5, 1000, 10), (3, 300, 40), (260, 130, 40),
            (4, 100, 100), (2, 129, 129), (6, 2000, 40), (3, 6000, 1),
            (3, 6000, 40)]


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
@pytest.mark.parametrize("b,n,c", EMULATED)
def test_emulated_kernel_selection_equals_plain(b, n, c, metric):
    qi, codes, qscale, const, qstat, rstat, rng = _tied_case(
        b, n, 24, metric, seed=b + n + c)
    mask = torch.as_tensor(rng.random(n) < 0.9)
    scores = s8.folded_epilogue(s8.s8_scores_plain(qi, codes), qscale,
                                const, qstat, rstat, metric).numpy()
    want_v, _ = s8.s8_topc_plain(qi, codes, qscale, const, qstat, rstat,
                                 mask, c=c, metric=metric)
    # a few blocks a query tile, as on a card with 7 SMs
    got_v, got_r = _emulate_topc(scores, mask.numpy(), c, sms=7, rng=rng)
    assert _same_sorted(got_v, want_v.numpy())
    _check_rows(got_v, got_r, np.where(mask.numpy()[None, :], scores,
                                       MASKED), n)


def test_emulated_selection_keeps_nan_rows_last():
    """NaN scores (rows whose norms are NaN) sort after everything, as in
    torch.topk: with c = N they fill the tail, and never enter earlier."""
    qi, codes, qscale, const, qstat, rstat, rng = _tied_case(
        3, 200, 16, "cosine", seed=1)
    rstat[[5, 50, 150]] = float("nan")
    mask = torch.ones(200, dtype=torch.bool)
    scores = s8.folded_epilogue(s8.s8_scores_plain(qi, codes), qscale,
                                const, qstat, rstat, "cosine").numpy()
    for c in (10, 200):
        want_v, _ = s8.s8_topc_plain(qi, codes, qscale, const, qstat, rstat,
                                     mask, c=c, metric="cosine")
        got_v, got_r = _emulate_topc(scores, mask.numpy(), c, sms=3,
                                     rng=rng)
        assert _same_sorted(got_v, want_v.numpy())
        assert np.isnan(got_v).sum() == (9 if c == 200 else 0)
        _check_rows(got_v, got_r, scores, 200)


def test_fold_queries_feeds_the_same_scores():
    """``fold_queries`` + ``folded_epilogue`` is ``folded_int_scores``,
    whose blocks ``s8_topc_plain`` selects from."""
    from fastpyvectordb_tpu_torch.quant.scalar import (
        ScalarQuantizer, _distances_int8_matmul)
    v, q, _ = _inputs(n=300)
    sq = ScalarQuantizer(device="cpu").train(v)
    codes = sq.encode(v)
    vsq, rinv = sq.corpus_stats(codes)
    rs = (sq.scale / 255.0).float()
    for metric in ("cosine", "l2", "ip"):
        m = DistanceMetric(metric)
        want = _distances_int8_matmul(torch.as_tensor(q), codes, sq.vmin,
                                      sq.scale, vsq, rinv, metric=m.value)
        qi, qscale, const, qstat = fold_queries(
            torch.as_tensor(q), rs, 128.0 * rs + sq.vmin, m.value)
        got = s8.folded_epilogue(s8.s8_scores_plain(qi, codes), qscale,
                                 const, qstat,
                                 rinv if metric == "cosine" else vsq,
                                 m.value)
        assert torch.equal(got, want)


def _rn32(x):
    """An exact rational rounded to the nearest float32 (ties to even),
    normal range: the result of one FMA."""
    from fractions import Fraction
    if x == 0:
        return np.float32(0.0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    while Fraction(2) ** e > x:
        e -= 1
    while Fraction(2) ** (e + 1) <= x:
        e += 1
    m = x / Fraction(2) ** (e - 23)
    fl, rem = divmod(m.numerator, m.denominator)
    if 2 * rem > m.denominator or (2 * rem == m.denominator and fl % 2):
        fl += 1
    return np.float32(sign * fl * 2.0 ** (e - 23))


def _div_rn(a, b, rb):
    """csrc/topc_epilogue.cuh ``div_rn``: a * rb corrected twice by its
    exact FMA residual."""
    from fractions import Fraction as F

    def fma(x, y, z):
        return _rn32(F(float(x)) * F(float(y)) + F(float(z)))
    q = np.float32(a * rb)
    r = fma(-q, b, a)
    q = fma(r, rb, q)
    r = fma(-q, b, a)
    return fma(r, rb, q)


def test_kernel_division_rounds_as_ieee_division():
    """The kernel divides x by qn with FMAs from RN(1 / qn) (div.rn would
    put a call in the kernel); the quotient must be IEEE's, bit for bit,
    or the fused scores would leave the plain version's."""
    rng = np.random.default_rng(11)
    a = np.concatenate([
        (rng.standard_normal(600) * 10.0 ** rng.uniform(-6, 6, 600)),
        rng.integers(-2**24, 2**24, 600) * 2.0 ** rng.integers(-30, 0, 600),
        rng.standard_normal(300) * 40.0]).astype(np.float32)
    b = np.concatenate([
        rng.uniform(1e-3, 1e3, 600),
        rng.integers(1, 2**12, 600).astype(np.float64),
        1.0 + rng.integers(0, 2**23, 300) / 2**23]).astype(np.float32)
    rb = (np.float32(1.0) / b).astype(np.float32)
    want = (a / b).astype(np.float32)
    got = np.array([_div_rn(x, y, r) for x, y, r in zip(a, b, rb)],
                   dtype=np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# -- the prefilter's floor ---------------------------------------------------

I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1
KEY_MASKED = _keys(np.array([MASKED]))[0]
f32 = np.float32


def _score1(metric, dots, v, rv):
    """``S8TopcOp::topc_score`` of int products ``dots`` at row values
    ``rv`` (arrays that broadcast), float32 rounding after every operation
    (the division IEEE's, which ``div_rn`` is on normal quotients)."""
    a, c, z, _ = (f32(t) for t in v)
    rv = np.asarray(rv, np.float32)
    with np.errstate(all="ignore"):
        x = (np.asarray(dots, np.int64).astype(np.float32) * a) + c
        if metric == "cosine":
            return f32(1.0) - (x / z) * rv
        if metric == "l2":
            t = (z + rv) - f32(2.0) * x
            return np.where(t < 0, f32(0.0), t)
        return -x + f32(0.0) * rv


def _floor(metric, v, tau, lo, hi):
    """The prefilter's floor T_q as the kernel computes it
    (``topc_epilogue.cuh`` ``topc_floor``, ``S8TopcOp::topc_floor``); the
    estimate's approximate divisions are exact ones here, which moves only
    the estimate: the check at T - 1 is the kernel's own arithmetic."""
    if tau > KEY_MASKED:
        return I32_MIN
    if not lo <= hi:
        return I32_MAX
    s = _floats(np.array([tau], np.uint32))[0]
    a, c, z, _ = (f32(t) for t in v)
    lo, hi = f32(lo), f32(hi)
    if not (0 < a <= 2.0 ** 60 and abs(c) <= 2.0 ** 90
            and abs(s) <= 2.0 ** 100):
        return I32_MIN
    with np.errstate(all="ignore"):
        if metric == "cosine":
            if not (s < 1 and lo >= 0 and hi <= 2.0 ** 20
                    and 2.0 ** -20 <= z <= 2.0 ** 20):
                return I32_MIN
            qr = z / hi
            x, size, rv = (f32(1) - s) * qr, (f32(2) - s) * qr, hi
        elif metric == "l2":
            if not (abs(z) <= 2.0 ** 100 and abs(lo) <= 2.0 ** 100):
                return I32_MIN
            x = f32(0.5) * ((z + lo) - s)
            size, rv = (abs(z) + abs(lo)) + abs(s), lo
        else:
            x, size, rv = -s, abs(s), f32(0)
        t = ((x - c) - f32(2.0 ** -16) * ((size + abs(x)) + abs(c))) \
            * (f32(1) / a) - f32(2)
    if not t > -2.0 ** 31:
        return I32_MIN
    f = I32_MAX if t >= 2.0 ** 31 else int(np.floor(t))
    if f == I32_MIN:
        return I32_MIN
    return f if _score1(metric, [f - 1], v, rv)[0] > s else I32_MIN


def _enters(metric, dots, v, rvs, tau):
    """(len(dots), len(rvs)) bool: which (product, row value) pairs would
    enter a list whose threshold is ``tau``."""
    return _keys(_score1(metric, np.asarray(dots)[:, None], v,
                         np.asarray(rvs, np.float32)[None, :])) < tau


def _probe_dots(t, rng):
    """Products below a floor: the ones just under it, and far ones."""
    near = t - 1 - np.arange(64)
    far = rng.integers(I32_MIN, max(t, I32_MIN + 1), 64)
    return np.concatenate([near[near >= I32_MIN], far, [I32_MIN]])


def _floor_case(metric, rng):
    """Random query values, a tile's live row values and a threshold: the
    score of a product at one of the rows, moved a few ulps."""
    a = f32(10.0 ** rng.uniform(-7, 1))
    c = f32(rng.normal() * 10.0 ** rng.uniform(-3, 2))
    z = f32(10.0 ** rng.uniform(-2, 3))
    if metric == "cosine":
        rvs = (10.0 ** rng.uniform(-1, 1)) * (1 + 0.05 * rng.random(128))
        x = rng.uniform(0.02, 0.98) * z / rvs.max()
    elif metric == "l2":
        z = f32(z * z)
        # a wide spread of squared norms in one tile
        rvs = 10.0 ** rng.uniform(-3, 4, 128)
        x = rng.uniform(0, 0.5) * (z + rvs.min())
    else:
        rvs = np.zeros(128)
        x = rng.normal() * 10.0 ** rng.uniform(-2, 3)
    v = (a, c, z, f32(1) / z)
    rvs = rvs.astype(np.float32)
    d0 = int(np.clip(round((x - c) / a), -2 ** 30, 2 ** 30))
    s = _score1(metric, [d0], v, rvs[rng.integers(0, 128)])[0]
    for _ in range(int(rng.integers(0, 4))):
        s = np.nextafter(s, f32(np.inf if rng.random() < 0.5 else -np.inf),
                         dtype=np.float32)
    return v, rvs, _keys(np.array([s], np.float32))[0]


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_floor_never_drops_a_row_that_enters(metric):
    """No product below the floor enters at any of the tile's row values,
    over random queries and thresholds a few ulps from real scores; and
    the floor is tight: within a hair of the least entering product at
    the lowest-scoring row value."""
    rng = np.random.default_rng(19)
    usable = 0
    for _ in range(300):
        v, rvs, tau = _floor_case(metric, rng)
        lo, hi = float(np.nanmin(rvs)), float(np.nanmax(rvs))
        t = _floor(metric, v, tau, lo, hi)
        assert t != I32_MAX
        if t == I32_MIN:
            continue
        usable += 1
        assert not _enters(metric, _probe_dots(t, rng), v, rvs, tau).any()
        # the least product that enters at the extreme row value
        ext = hi if metric == "cosine" else lo
        lo_d, hi_d = t, I32_MAX
        if not _enters(metric, [hi_d], v, [ext], tau).any():
            continue
        while hi_d - lo_d > 1:
            mid = (lo_d + hi_d) // 2
            if _enters(metric, [mid], v, [ext], tau).any():
                hi_d = mid
            else:
                lo_d = mid
        # the kernel's margin is 2^-16 of the terms' size (in x) and 3
        a, c, z = float(v[0]), float(v[1]), float(v[2])
        s = float(_floats(np.array([tau], np.uint32))[0])
        size = ((2 - s) * z / hi if metric == "cosine" else
                abs(z) + abs(lo) + abs(s) if metric == "l2" else abs(s))
        assert hi_d - t <= 2.0 ** -12 * (abs(hi_d * a) + 2 * abs(c)
                                          + size) / a + 8
    assert usable >= 250


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
def test_floor_falls_back_where_the_proof_does_not_reach(metric):
    """INT_MIN (every score tested) for a scale <= 0 or not finite, a
    threshold above MASKED's key (none yet, or masked rows may enter), any
    value not finite, a cosine threshold >= 1; INT_MAX where the tile has
    no live row with a number."""
    v = (f32(1e-4), f32(0.5), f32(2.0), f32(0.5))
    tau = _keys(np.array([0.25], np.float32))[0]
    assert _floor(metric, v, tau, 1.0, 1.0) not in (I32_MIN, I32_MAX)
    for scale in (0.0, -1e-4, np.nan, np.inf):
        assert _floor(metric, (f32(scale),) + v[1:], tau, 1.0, 1.0) == I32_MIN
    for big in (KEY_EMPTY, KEY_NAN, _keys(np.array([np.inf], np.float32))[0],
                KEY_MASKED + 1):
        assert _floor(metric, v, big, 1.0, 1.0) == I32_MIN
    assert _floor(metric, (v[0], f32(np.nan)) + v[2:], tau, 1.0, 1.0) \
        == I32_MIN
    # NaN row values are left out of [lo, hi]; none left: no row can enter
    assert _floor(metric, v, tau, np.inf, -np.inf) == I32_MAX
    if metric == "cosine":
        one = _keys(np.array([1.0, 1.5], np.float32))
        assert _floor(metric, v, one[0], 1.0, 1.0) == I32_MIN
        assert _floor(metric, v, one[1], 1.0, 1.0) == I32_MIN
        assert _floor(metric, v, tau, -1.0, 1.0) == I32_MIN
        assert _floor(metric, v, tau, 1.0, np.inf) == I32_MIN
    if metric == "l2":
        assert _floor(metric, v, tau, -np.inf, 1.0) == I32_MIN


def _emulate_prefilter(dots, qparams, rstat, metric):
    """The floor of every (query, tile) in ``_emulate_topc``'s walk, from
    the query's values, its threshold and the tile's live row values."""
    def floors(q, rows, live, tau):
        rv = (np.zeros(len(rows), np.float32) if metric == "dot"
              else rstat[rows])
        vals = rv[live[rows] & ~np.isnan(rv)]
        lo, hi = (vals.min(), vals.max()) if len(vals) else (np.inf, -np.inf)
        t = _floor(metric, qparams[q], tau, lo, hi)
        ok = np.where(live[rows], dots[q, rows] >= t, t == I32_MIN)
        return rows[ok]
    return floors


def _qparams(qscale, const, qstat):
    qstat = (torch.zeros_like(qscale) if qstat is None else qstat).numpy()
    with np.errstate(divide="ignore"):
        return [(f32(a), f32(c), f32(z), f32(1) / f32(z))
                for a, c, z in zip(qscale.numpy(), const.numpy(), qstat)]


@pytest.mark.parametrize("metric", ["cosine", "l2", "dot"])
@pytest.mark.parametrize("b,n,c", EMULATED)
def test_emulated_prefilter_selection_equals_plain(b, n, c, metric):
    """The kernel's selection with the prefilter: no row that enters a
    list fails its floor, and the result is the plain top-c, on the tied
    and masked data of ``test_emulated_kernel_selection_equals_plain``."""
    qi, codes, qscale, const, qstat, rstat, rng = _tied_case(
        b, n, 24, metric, seed=b + n + c)
    mask = torch.as_tensor(rng.random(n) < 0.9)
    dots = s8.s8_scores_plain(qi, codes)
    scores = s8.folded_epilogue(dots.clone(), qscale, const, qstat, rstat,
                                metric).numpy()
    want_v, _ = s8.s8_topc_plain(qi, codes, qscale, const, qstat, rstat,
                                 mask, c=c, metric=metric)
    floors = _emulate_prefilter(dots.numpy(), _qparams(qscale, const, qstat),
                                None if rstat is None else rstat.numpy(),
                                metric)
    got_v, got_r = _emulate_topc(scores, mask.numpy(), c, sms=7, rng=rng,
                                 floors=floors)
    assert _same_sorted(got_v, want_v.numpy())
    _check_rows(got_v, got_r, np.where(mask.numpy()[None, :], scores,
                                       MASKED), n)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_emulated_prefilter_keeps_nan_rows_last(metric):
    """NaN row values score NaN whatever the product: the floors leave
    them out of the tile's range, and with c = N they still fill the
    tail."""
    qi, codes, qscale, const, qstat, rstat, rng = _tied_case(
        3, 600, 16, metric, seed=4)
    rstat[[5, 50, 150, 400]] = float("nan")
    rstat[256:384] = float("nan")          # a tile of NaNs only
    mask = torch.ones(600, dtype=torch.bool)
    mask[[7, 300]] = False                 # 131 live NaN rows
    dots = s8.s8_scores_plain(qi, codes)
    scores = s8.folded_epilogue(dots.clone(), qscale, const, qstat, rstat,
                                metric).numpy()
    floors = _emulate_prefilter(dots.numpy(), _qparams(qscale, const, qstat),
                                rstat.numpy(), metric)
    for c in (10, 600):
        want_v, _ = s8.s8_topc_plain(qi, codes, qscale, const, qstat, rstat,
                                     mask, c=c, metric=metric)
        got_v, got_r = _emulate_topc(scores, mask.numpy(), c, sms=3,
                                     rng=rng, floors=floors)
        assert _same_sorted(got_v, want_v.numpy())
        assert np.isnan(got_v).sum() == (3 * 131 if c == 600 else 0)
        _check_rows(got_v, got_r, np.where(mask.numpy()[None, :], scores,
                                           MASKED), 600)


def test_cpu_tensors_use_plain_version_and_count_nothing():
    qi, codes, qscale, const, qstat, rstat, _ = _tied_case(3, 50, 8, "l2", 2)
    before = dict(s8.LAUNCHES)
    got = s8.s8_topc(qi, codes, qscale, const, qstat, rstat, None, c=5,
                     metric="l2")
    want = s8.s8_topc_plain(qi, codes, qscale, const, qstat, rstat, None,
                            c=5, metric="l2")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert s8.LAUNCHES == before


def test_non_cpu_tensor_never_falls_back():
    # a tensor that is not on the CPU reaches the kernel path, which
    # refuses what is not a CUDA tensor instead of computing elsewhere
    codes = torch.empty((8, 8), dtype=torch.int8, device="meta")
    z = torch.zeros(2)
    with pytest.raises(ValueError, match="CUDA"):
        s8.s8_topc(torch.zeros((2, 8), dtype=torch.int8), codes, z, z, z,
                   torch.zeros(8), None, c=3, metric="cosine")


# -- on the card -------------------------------------------------------------

def _cuda_case(b, n, d, metric, valid, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qi = torch.randint(-127, 128, (b, d), generator=g, device="cuda",
                       dtype=torch.int8)
    codes = torch.randint(-128, 128, (n, d), generator=g, device="cuda",
                          dtype=torch.int8)
    qscale = torch.rand(b, generator=g, device="cuda") * 1e-3 + 1e-4
    const = torch.randn(b, generator=g, device="cuda")
    qstat = torch.rand(b, generator=g, device="cuda") * 10 + 1
    rstat = torch.rand(n, generator=g, device="cuda") + 0.5
    mask = {"all": torch.ones(n, dtype=torch.bool, device="cuda"),
            "some": torch.rand(n, generator=g, device="cuda") < 0.1,
            "few": torch.arange(n, device="cuda") % max(n // 3, 1) == 0
            }[valid]
    return qi, codes, qscale, const, qstat, rstat, mask


@pytest.mark.cuda
@pytest.mark.parametrize("valid", ["all", "some", "few"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "ip"])
@pytest.mark.parametrize("b,n,d,c", [(1, 100, 64, 10), (19, 1000, 100, 40),
                                     (256, 4099, 768, 160),
                                     (300, 777, 100, 1), (7, 3000, 64, 1024)])
def test_cuda_s8_topc_matches_plain(b, n, d, c, metric, valid):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _cuda_case(b, n, d, metric, valid, seed=b + n + c)
    c = min(c, n)
    before = s8.LAUNCHES["s8_topc"]
    gv, gr = s8.s8_topc(*args, c=c, metric=metric)
    wv, _ = s8.s8_topc_plain(*args, c=c, metric=metric)
    torch.cuda.synchronize()
    assert s8.LAUNCHES["s8_topc"] == before + 1
    assert torch.equal(gv, wv), (b, n, d, c, metric, valid)
    qi, codes, qscale, const, qstat, rstat, mask = args
    scores = s8.folded_epilogue(s8.s8_scores_plain(qi, codes), qscale,
                                const, qstat, rstat, metric)
    scores.masked_fill_(~mask[None, :], float(MASKED))
    _check_rows(gv.cpu().numpy(), gr.cpu().numpy(), scores.cpu().numpy(), n)


def _near_case(b, metric, valid, seed, n=65_536, d=768, hot=2048):
    """Every query's c-th score among near-ties: ``hot`` rows at random
    places are copies of one code vector close to the queries (which are
    one vector plus noise), half of them exact, half with one of 16 (dim,
    +-1) moves, so every product among them is shared by ~64 rows or more;
    cosine's copies have rinv one ulp up or down or unchanged, so the c-th
    score of each query (c <= 1024 < hot) has rows tied with it and, for
    cosine, rows one ulp to either side.  l2's other rows have squared
    norms spread over eight decades."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.randint(-100, 101, (d,), generator=g, device="cuda")
    qi = (base[None, :] + torch.randint(-3, 4, (b, d), generator=g,
                                        device="cuda")).to(torch.int8)
    codes = torch.randint(-128, 128, (n, d), generator=g, device="cuda",
                          dtype=torch.int8)
    where = torch.randperm(n, generator=g, device="cuda")[:hot]
    near = base[None, :].repeat(hot, 1)
    dims = torch.randint(0, d, (16,), generator=g, device="cuda")
    signs = torch.randint(0, 2, (16,), generator=g, device="cuda") * 2 - 1
    moved = torch.arange(hot, device="cuda")[1::2]
    near[moved, dims[moved % 16]] += signs[moved % 16]
    codes[where] = near.clamp(-128, 127).to(torch.int8)
    qscale = torch.rand(b, generator=g, device="cuda") * 1e-3 + 1e-4
    const = torch.randn(b, generator=g, device="cuda")
    if metric == "cosine":
        qstat = torch.rand(b, generator=g, device="cuda") * 10 + 1
        rstat = torch.rand(n, generator=g, device="cuda") + 0.5
        one = 0.75
    else:
        # the copies' scores stay positive, below every other row's
        qstat = torch.rand(b, generator=g, device="cuda") * 1e3 + 1e4
        rstat = 10.0 ** (torch.rand(n, generator=g, device="cuda") * 8 - 2)
        one = 1.0
    step = torch.randint(-1, 2, (hot,), generator=g, device="cuda")
    r0 = torch.full((hot,), one, device="cuda")
    rstat[where] = torch.where(step > 0, torch.nextafter(r0, r0 * 2),
                               torch.where(step < 0,
                                           torch.nextafter(r0, r0 * 0), r0))
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    if valid == "some":
        mask[where[torch.rand(hot, generator=g, device="cuda") < 0.2]] = False
        mask &= torch.rand(n, generator=g, device="cuda") < 0.9
    return qi, codes, qscale, const, qstat, rstat, mask


@pytest.mark.cuda
@pytest.mark.parametrize("valid", ["all", "some"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "ip"])
@pytest.mark.parametrize("b,c", [(1, 40), (1, 1024), (1024, 40),
                                 (1024, 1024)])
def test_cuda_s8_topc_matches_plain_near_the_threshold(b, c, metric, valid):
    """The prefilter keeps every row the plain test keeps where the c-th
    score has many ties and neighbours one ulp away: values equal bit for
    bit, rows valid, distinct and each with its own score."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _near_case(b, metric, valid, seed=b + c)
    gv, gr = s8.s8_topc(*args, c=c, metric=metric)
    wv, _ = s8.s8_topc_plain(*args, c=c, metric=metric)
    torch.cuda.synchronize()
    assert torch.equal(gv, wv), (b, c, metric, valid)
    qi, codes, qscale, const, qstat, rstat, mask = args
    scores = s8.folded_epilogue(s8.s8_scores_plain(qi, codes), qscale,
                                const, qstat, rstat, metric)
    scores.masked_fill_(~mask[None, :], float(MASKED))
    # the c-th score has company: ties or a neighbour one ulp away
    kth = wv[:, -1:]
    close = ((scores == kth) | (scores == torch.nextafter(kth, kth + 1))
             | (scores == torch.nextafter(kth, kth - 1))).sum(dim=1)
    assert (close >= 2).all()
    _check_rows(gv.cpu().numpy(), gr.cpu().numpy(), scores.cpu().numpy(),
                codes.shape[0])


@pytest.mark.cuda
def test_cuda_s8_topc_takes_the_scores_route_past_its_cap():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _cuda_case(3, 3000, 64, "l2", "all", seed=2)
    before = dict(s8.LAUNCHES)
    gv, _ = s8.s8_topc(*args, c=s8.TOPC_MAX + 1, metric="l2")
    wv, _ = s8.s8_topc_plain(*args, c=s8.TOPC_MAX + 1, metric="l2")
    assert torch.equal(gv, wv)
    assert s8.LAUNCHES["s8_topc_wide"] == before["s8_topc_wide"] + 1
    assert s8.LAUNCHES["s8_scores"] == before["s8_scores"] + 1
    assert s8.LAUNCHES["s8_topc"] == before["s8_topc"]


@pytest.mark.cuda
def test_cuda_int8_two_stage_writes_no_score_block():
    """One B=1024 search over 1,048,576 rows: the device memory the search
    allocates stays under 1 GB (a (B, N) f32 block alone is 4.3 GB)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n, d, b = 1 << 20, 768, 1024
    g = torch.Generator(device="cuda").manual_seed(0)
    vectors = torch.randn((n, d), generator=g, device="cuda")
    sq = tscan.ScalarQuantizer(device="cuda").train(vectors[:65536])
    codes = sq.encode(vectors)
    vsq, rinv = sq.corpus_stats(codes)
    q = torch.randn((b, d), generator=g, device="cuda")
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(s8.LAUNCHES)
    dist, rows = tscan._int8_two_stage(q, codes, sq.vmin, sq.scale, vsq,
                                       rinv, vectors, mask, metric="cosine",
                                       k=10, c=40, rerank_dtype="float32")
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 1 << 30
    assert s8.LAUNCHES["s8_topc"] == before["s8_topc"] + 1
    assert s8.LAUNCHES["s8_scores"] == before["s8_scores"]
    assert dist.shape == (b, 10) and torch.isfinite(dist).all()
