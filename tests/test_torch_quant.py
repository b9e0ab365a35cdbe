"""The port's int8 / int4 quantizers and two-stage scans
(fastpyvectordb_tpu_torch/quant/) against the JAX package's on the same
seeded inputs: bit-identical codes, every distance mode, and the whole
two-stage functions."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastpyvectordb_tpu.core.types import DistanceMetric
from fastpyvectordb_tpu.kernels import pallas_quant
from fastpyvectordb_tpu.quant import scan as jscan
from fastpyvectordb_tpu.quant.int4 import Int4Quantizer as JInt4
from fastpyvectordb_tpu.quant.scalar import ScalarQuantizer as JScalar
from fastpyvectordb_tpu_torch.quant import scan as tscan
from fastpyvectordb_tpu_torch.quant.int4 import Int4Quantizer as TInt4
from fastpyvectordb_tpu_torch.quant.scalar import ScalarQuantizer as TScalar
from torch_parity import assert_same_topk, clustered

METRICS = list(DistanceMetric)
# distances: the same f32 arithmetic in another summation order; modes with
# a bf16 cross term round the same operands.  Measured gap <= 6e-7 of
# max(|d|, 1), except int8 "pallas" at 6.2e-6: XLA may fuse the dequantize
# into one multiply-add, which moves a few bf16 roundings of v.  Held at
# 3e-5 (the JAX tests hold these modes to 2e-2).
DIST_RTOL = 3e-5


def t(x):
    """A tensor over a writable copy (jax hands out read-only buffers)."""
    return torch.as_tensor(np.array(x))


def _pair(kind, d=41, n=700, seed=3):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((n, d)) * rng.uniform(0.5, 2.0, d)
         + rng.uniform(-1, 1, d)).astype(np.float32)
    q = rng.standard_normal((9, d)).astype(np.float32)
    jq = (JScalar if kind == "int8" else JInt4)().train(v)
    tq = (TScalar if kind == "int8" else TInt4)(device="cpu").train(v)
    return v, q, jq, tq


@pytest.mark.parametrize("d", [40, 41])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_train_encode_decode_bit_identical(kind, d):
    v, _, jq, tq = _pair(kind, d=d)
    np.testing.assert_array_equal(tq.vmin.numpy(), np.asarray(jq.vmin))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    jc, tc = np.array(jq.encode(v)), tq.encode(v).numpy()
    assert jc.dtype == tc.dtype and jc.shape == tc.shape
    np.testing.assert_array_equal(tc, jc)   # codes are a file format
    np.testing.assert_allclose(tq.decode(tc), jq.decode(jc), rtol=1e-6,
                               atol=1e-6)
    jvsq, jrinv = jq.corpus_stats(jc)
    tvsq, trinv = tq.corpus_stats(tc)
    np.testing.assert_allclose(tvsq.numpy(), np.asarray(jvsq), rtol=1e-5)
    np.testing.assert_allclose(trinv.numpy(), np.asarray(jrinv), rtol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("kind,mode", [
    ("int8", "int8mm"), ("int8", "pallas"), ("int8", "chunked"),
    ("int4", "int4mm"), ("int4", "pallas"), ("int4", "chunked")])
def test_distances_every_mode(kind, mode, metric):
    v, q, jq, tq = _pair(kind)
    codes = np.array(jq.encode(v))
    want = np.asarray(jq.distances(q, codes, metric, mode=mode))
    got = tq.distances(q, torch.as_tensor(codes), metric, mode=mode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=DIST_RTOL * max(np.abs(want).max(), 1))


def _two_stage_inputs(n=1500, d=40, seed=21):
    rng = np.random.default_rng(seed)
    v, centers = clustered(rng, n, d)
    q = (centers[rng.integers(0, len(centers), 12)]
         + 0.5 * rng.standard_normal((12, d))).astype(np.float32)
    mask = rng.random(n) < 0.8
    return v, q, mask


@pytest.mark.parametrize("rerank_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_int8_two_stage_matches(metric, rerank_dtype):
    v, q, mask = _two_stage_inputs()
    jq = JScalar().train(v)
    codes = jq.encode(v)
    vsq, rinv = jq.corpus_stats(codes)
    jd, jr = jscan._int8_two_stage(
        jnp.asarray(q), codes, jq.vmin, jq.scale, vsq, rinv, jnp.asarray(v),
        jnp.asarray(mask), metric=metric, k=10, c=40, approx=False,
        rerank_dtype=rerank_dtype)
    tvsq, trinv = t(np.asarray(vsq)), t(np.asarray(rinv))
    td, tr = tscan._int8_two_stage(
        t(q), t(np.asarray(codes)), t(np.asarray(jq.vmin)),
        t(np.asarray(jq.scale)), tvsq, trinv, t(v), t(mask), metric=metric,
        k=10, c=40, rerank_dtype=rerank_dtype)
    # same candidates (exact top-c of the same integer products), then
    # the same exact re-rank: ids up to ties, scores to f32 rounding
    assert_same_topk(np.asarray(jd), np.asarray(jr), td.numpy(), tr.numpy(),
                     rtol=1e-5)
    assert mask[tr.numpy()].all()


@pytest.mark.parametrize("metric", METRICS)
def test_int4_two_stage_matches_pallas_path(metric, monkeypatch):
    """The JAX int4 two-stage with its Pallas coarse stage (interpret
    mode), against the port's, whose coarse stage is the plain
    ``int4_scores`` on the CPU.  Odd D exercises the phantom dim."""
    v, q, mask = _two_stage_inputs(d=41)
    jq = JInt4().train(v)
    packed = jq.encode(v)
    vsq, rinv = jq.corpus_stats(packed)
    codes_p, vmin_p, scale_p = jq.pallas_layout(packed)
    q_lay = jq.pallas_query(jnp.asarray(q), packed.shape[1])
    monkeypatch.setattr(pallas_quant, "int4_scores", functools.partial(
        pallas_quant.int4_scores, interpret=True))
    jscan._int4_two_stage.clear_cache()
    try:
        jd, jr = jscan._int4_two_stage(
            jnp.asarray(q), q_lay, codes_p, vmin_p, scale_p, vsq, rinv,
            jnp.asarray(v), jnp.asarray(mask), metric=metric, k=10, c=80,
            approx=False, rerank_dtype="float32", use_pallas=True)
        jd, jr = np.asarray(jd), np.asarray(jr)
    finally:
        jscan._int4_two_stage.clear_cache()
    td, tr = tscan._int4_two_stage(
        t(q), t(np.asarray(packed)), t(np.asarray(jq.vmin)),
        t(np.asarray(jq.scale)), t(v), t(mask), metric=metric, k=10, c=80,
        rerank_dtype="float32")
    assert_same_topk(jd, jr, td.numpy(), tr.numpy(), rtol=1e-5)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_coarse_topk_matches(kind):
    """The rerank<=1 coarse selections (JAX ``_int8_coarse_topk`` and the
    int4 Pallas path) against the port's."""
    v, q, mask = _two_stage_inputs()
    if kind == "int8":
        jq = JScalar().train(v)
        codes = jq.encode(v)
        vsq, rinv = jq.corpus_stats(codes)
        jd, jr = jscan._int8_coarse_topk(
            jnp.asarray(q), codes, jq.vmin, jq.scale, vsq, rinv,
            jnp.asarray(mask), metric=DistanceMetric.L2, k=10, approx=False)
        td, tr = tscan._int8_coarse_topk(
            t(q), t(np.asarray(codes)), t(np.asarray(jq.vmin)),
            t(np.asarray(jq.scale)), t(np.asarray(vsq)),
            t(np.asarray(rinv)), t(mask), metric=DistanceMetric.L2, k=10)
    else:
        jq = JInt4().train(v)
        packed = np.array(jq.encode(v))
        s = np.asarray(jq.distances(q, packed, "l2", mode="pallas"))
        s = np.where(mask[None, :], s, 3e38)
        jr = np.argsort(s, axis=1, kind="stable")[:, :10]
        jd = np.take_along_axis(s, jr, axis=1)
        td, tr = tscan._int4_coarse_topk(
            t(q), t(packed), t(np.asarray(jq.vmin)), t(np.asarray(jq.scale)),
            t(mask), metric=DistanceMetric.L2, k=10)
    assert_same_topk(np.asarray(jd), np.asarray(jr), td.numpy(), tr.numpy(),
                     rtol=1e-5)


def test_quantizer_save_load_cross_package(tmp_path):
    v, _, jq, _ = _pair("int8")
    jq.save(tmp_path / "j.fpvt")
    tq = TScalar.load(tmp_path / "j.fpvt", device="cpu")
    np.testing.assert_array_equal(tq.vmin.numpy(), np.asarray(jq.vmin))
    tq.save(tmp_path / "t.fpvt")
    back = JScalar.load(tmp_path / "t.fpvt")
    np.testing.assert_array_equal(np.asarray(back.scale),
                                  np.asarray(jq.scale))
    assert (tmp_path / "j.fpvt").read_bytes() == \
        (tmp_path / "t.fpvt").read_bytes()
