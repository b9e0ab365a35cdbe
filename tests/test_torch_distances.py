"""The port's exact-scan kernels (fastpyvectordb_tpu_torch/kernels/
distances.py, topk.py) against the JAX package's on the same seeded
inputs: 3 metrics x {float32, bfloat16} compute, with masks, k above the
live count, and every row masked."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastpyvectordb_tpu.core.types import DistanceMetric
from fastpyvectordb_tpu.kernels import distances as JK
from fastpyvectordb_tpu.kernels import topk as JT
from fastpyvectordb_tpu_torch.kernels import distances as TK
from fastpyvectordb_tpu_torch.kernels import topk as TT
from torch_parity import assert_same_topk

METRICS = list(DistanceMetric)
DTYPES = ["float32", "bfloat16"]
# f32: same products, sums in another order.  bf16: both sides round the
# same operands to bf16 and sum exactly-representable products in f32.
# Measured gap <= 2.1e-7 of max(|score|, 1) for both.
RTOL = 1e-5


def _data(n=500, d=40, b=7, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32), rng)


def _scale(x):
    return max(np.abs(x).max(), 1.0)


def test_corpus_stats_match():
    v, _, _ = _data()
    v[3] = 0.0  # a zero row: rinv 0
    want = JK.corpus_stats(jnp.asarray(v))
    got = TK.corpus_stats(torch.as_tensor(v))
    for key in ("sq", "rinv"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6)
    assert got["rinv"][3] == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", METRICS)
def test_scores_match(metric, dtype):
    v, q, _ = _data()
    want = np.asarray(JK.scores(jnp.asarray(q), jnp.asarray(v), metric,
                                compute_dtype=jnp.dtype(dtype)))
    got = TK.scores(torch.as_tensor(q), torch.as_tensor(v), metric,
                    compute_dtype=dtype)
    assert got.dtype == torch.float32     # never bf16-rounded scores
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=RTOL * _scale(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", METRICS)
def test_search_kernel_with_mask(metric, dtype):
    v, q, rng = _data()
    mask = rng.random(v.shape[0]) < 0.3
    stats = JK.corpus_stats(jnp.asarray(v))
    jd, jr = JK.search_kernel(jnp.asarray(q), jnp.asarray(v), stats["sq"],
                              stats["rinv"], jnp.asarray(mask),
                              metric=metric, k=10, compute_dtype=dtype)
    ts = TK.corpus_stats(torch.as_tensor(v))
    td, tr = TK.search_kernel(torch.as_tensor(q), torch.as_tensor(v),
                              ts["sq"], ts["rinv"], torch.as_tensor(mask),
                              metric=metric, k=10, compute_dtype=dtype)
    assert mask[tr.numpy()].all()
    assert_same_topk(np.asarray(jd), np.asarray(jr), td.numpy(), tr.numpy(),
                     rtol=RTOL)


@pytest.mark.parametrize("metric", METRICS)
def test_search_kernel_k_above_live_count_and_all_masked(metric):
    v, q, _ = _data(n=64)
    stats = TK.corpus_stats(torch.as_tensor(v))
    jstats = JK.corpus_stats(jnp.asarray(v))
    few = np.zeros(64, dtype=bool)
    few[[5, 9, 40]] = True
    for mask in (few, np.zeros(64, dtype=bool)):
        jd, jr = JK.search_kernel(jnp.asarray(q), jnp.asarray(v),
                                  jstats["sq"], jstats["rinv"],
                                  jnp.asarray(mask), metric=metric, k=10)
        td, tr = TK.search_kernel(torch.as_tensor(q), torch.as_tensor(v),
                                  stats["sq"], stats["rinv"],
                                  torch.as_tensor(mask), metric=metric, k=10)
        assert_same_topk(np.asarray(jd), np.asarray(jr), td.numpy(),
                         tr.numpy(), rtol=RTOL)
        assert TT.valid_hits(td).sum(1).tolist() == [mask.sum()] * len(q)
        # masked slots carry the sentinel, never a finite score
        assert (td.numpy()[~TT.valid_hits(td).numpy()] >= TK.MASKED).all()


@pytest.mark.parametrize("masked", [False, True])
def test_masked_top_k_matches(masked):
    _, _, rng = _data()
    s = rng.standard_normal((6, 300)).astype(np.float32)
    mask = rng.random((6, 300)) < 0.5 if masked else None
    jd, jr = JT.masked_top_k(jnp.asarray(s), 12,
                             None if mask is None else jnp.asarray(mask))
    td, tr = TT.masked_top_k(torch.as_tensor(s), 12,
                             None if mask is None else torch.as_tensor(mask))
    assert_same_topk(np.asarray(jd), np.asarray(jr), td.numpy(), tr.numpy(),
                     rtol=0, atol=0)


def test_merge_top_k_matches():
    _, _, rng = _data()
    vals = np.sort(rng.standard_normal((3, 4, 5)).astype(np.float32), -1)
    idx = rng.permutation(3 * 4 * 5).reshape(3, 4, 5).astype(np.int32)
    jd, jr = JT.merge_top_k(jnp.asarray(vals), jnp.asarray(idx), 6)
    td, tr = TT.merge_top_k(torch.as_tensor(vals), torch.as_tensor(idx), 6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_merge_topk_host_and_valid_hits():
    d1 = np.array([[0.1, 0.5, float(TK.MASKED)]], np.float32)
    d2 = np.array([[0.2, 0.3, 0.9]], np.float32)
    r1, r2 = np.array([[1, 2, 3]]), np.array([[7, 8, 9]])
    want = JT.merge_topk_host(d1, r1, d2, r2, 4)
    got = TT.merge_topk_host(d1, r1, d2, r2, 4)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TT.valid_hits(d1), JT.valid_hits(d1))
    assert TT.valid_hits(torch.as_tensor(d1)).tolist() == [[True, True,
                                                            False]]


def test_host_exact_scores_match():
    v, q, _ = _data(n=30, b=3)
    cand = v.reshape(3, 10, -1)
    for metric in METRICS:
        np.testing.assert_allclose(TK.host_exact_scores(q, cand, metric),
                                   JK.host_exact_scores(q, cand, metric),
                                   rtol=1e-6)
