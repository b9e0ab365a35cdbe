"""Shared helpers for the tests that hold the PyTorch port
(fastpyvectordb_tpu_torch) against the JAX package on the same seeded
numpy inputs."""

from __future__ import annotations

import time

import numpy as np

MASKED = 3.0e38


def jax_native(graph: bool = False, wait: float = 60.0):
    """The JAX package's ``native`` module with its BM25 (or, with
    ``graph``, its CSR graph) library loaded, or None where the port's own
    library does not load either (no C++ toolchain: both packages then run
    their pure-Python engines).

    The JAX loader compiles straight onto its output file and keeps a
    failed load (``_build_failed`` / ``_graph_build_failed``) for the life
    of the process, so a worker that loaded the file while another
    worker's g++ was rewriting it treats the library as missing from then
    on.  This clears that flag (by assignment: the JAX package is not
    edited, and the failed state is not put back) and loads again, polling
    for up to ``wait`` seconds while the other compiler finishes.  If the
    port's library loads but the JAX one still does not, the test fails:
    a parity test against a Python engine on one side only would compare
    different engines."""
    import pytest

    from fastpyvectordb_tpu import native as jnative
    from fastpyvectordb_tpu_torch import native as tnative
    load = jnative.graph_available if graph else jnative.available
    deadline = time.monotonic() + wait
    while not load():
        if graph:
            jnative._graph_lib, jnative._graph_build_failed = None, False
        else:
            jnative._lib, jnative._build_failed = None, False
        if time.monotonic() > deadline:
            break
        time.sleep(0.5)
    else:
        return jnative
    if (tnative.graph_available() if graph else tnative.available()):
        pytest.fail(f"the port's native library loads but the JAX "
                    f"package's {'graph' if graph else 'BM25'} library did "
                    f"not within {wait:.0f} s")
    return None


def clustered(rng, n: int, d: int, n_centers: int = 16,
              noise: float = 1.0, normalize: bool = True):
    """bench.py's clustered construction in numpy: centers at 2x scale,
    unit noise, rows normalized."""
    centers = 2.0 * rng.standard_normal((n_centers, d)).astype(np.float32)
    v = centers[rng.integers(0, n_centers, n)] + noise * rng.standard_normal(
        (n, d)).astype(np.float32)
    if normalize:
        v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32), centers


def valid(vals) -> np.ndarray:
    return np.asarray(vals) < MASKED * 0.5


def assert_same_topk(want_d, want_r, got_d, got_r, rtol: float,
                     atol: float = 1e-6) -> None:
    """Two (B, k) top-k results agree: the same number of valid hits, the
    same sorted scores within ``rtol``, and the same ids wherever a score
    is not tied (within the tolerance) with another hit of its row —
    ``lax.top_k`` orders ties by index, ``torch.topk`` promises no order."""
    want_d, got_d = np.asarray(want_d, np.float64), np.asarray(got_d,
                                                             np.float64)
    want_r, got_r = np.asarray(want_r), np.asarray(got_r)
    assert want_d.shape == got_d.shape
    for b in range(want_d.shape[0]):
        wv, gv = valid(want_d[b]), valid(got_d[b])
        assert wv.sum() == gv.sum(), (b, wv.sum(), gv.sum())
        wd, gd = want_d[b][wv], got_d[b][gv]
        np.testing.assert_allclose(gd, wd, rtol=rtol, atol=atol)
        tol = rtol * np.abs(wd) + atol
        for i in range(wd.size):
            near = np.abs(wd - wd[i]) <= 2 * tol[i] + 2 * tol
            near[i] = False
            if not near.any():
                assert want_r[b][wv][i] == got_r[b][gv][i], (b, i)
        # tied or not, the winners form the same set once the boundary
        # value is excluded
        if wd.size:
            inner = wd < wd.max() - 2 * tol.max()
            assert set(want_r[b][wv][inner].tolist()) <= set(
                got_r[b][gv].tolist()), b


def assert_same_tied_topk(want_d, want_r, got_d, got_r, scores=None,
                          rtol: float = 0.0, atol: float = 0.0) -> None:
    """Two (B, k) top-k results over scores that tie massively (Hamming
    counts; ADC sums, equal for rows with equal codes): the same sorted
    scores within the tolerance (bit for bit at the default 0); the same
    rows wherever the score is clear of the row's last one (rows at that
    score tie with rows past k, and either package may keep any of them);
    and, given the full (B, N) score matrix, every returned row's own
    score."""
    want_d, got_d = np.asarray(want_d), np.asarray(got_d)
    want_r, got_r = np.asarray(want_r), np.asarray(got_r)
    np.testing.assert_allclose(got_d, want_d, rtol=rtol, atol=atol)
    for b in range(want_d.shape[0]):
        ok = valid(want_d[b])
        if ok.any():
            edge = want_d[b][ok].max()
            inner = ok & (want_d[b] < edge - 2 * (rtol * abs(edge) + atol))
            assert set(want_r[b][inner].tolist()) <= set(
                got_r[b].tolist()), b
    if scores is not None:
        ok = valid(got_d)
        own = np.take_along_axis(np.asarray(scores), np.maximum(got_r, 0),
                                 axis=1)
        np.testing.assert_allclose(own[ok], got_d[ok], rtol=rtol, atol=atol)


def mean_overlap(a_rows, b_rows) -> float:
    """Mean |a ∩ b| / k over the rows of two (B, k) id grids."""
    a_rows, b_rows = np.asarray(a_rows), np.asarray(b_rows)
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / a.size
                          for a, b in zip(a_rows, b_rows)]))
