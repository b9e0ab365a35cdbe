"""The cases of tests/test_store.py on the port's DeviceVectorStore
(device="cpu").

DeviceVectorStore regression tests.

Covers the capacity-boundary corruption found in round-1 review: append()
writes a block padded to a power of two, so growth must account for the
*padded* size — otherwise a clamped block write would silently overwrite
earlier live rows.
"""

import numpy as np

from fastpyvectordb_tpu_torch.core.store import DeviceVectorStore, MIN_CAPACITY


def _row(i, d=16):
    v = np.zeros((d,), dtype=np.float32)
    v[0] = float(i + 1)
    return v


def test_append_across_capacity_boundary_preserves_rows():
    """Fill to near capacity, then append a small ragged batch: the padded
    write must trigger growth instead of clamping onto live rows."""
    d = 16
    store = DeviceVectorStore(d, capacity=MIN_CAPACITY, device="cpu")
    n0 = MIN_CAPACITY - 4  # 1020 of 1024
    base = np.stack([_row(i, d) for i in range(n0)])
    store.append(base)
    extra = np.stack([_row(n0 + i, d) for i in range(4)])  # n=4, pads to 8
    rows = store.append(extra)

    assert store.count == n0 + 4
    assert store.n_valid == n0 + 4
    assert store.capacity >= n0 + 8  # grew to fit the padded block

    # Earlier rows intact (the bug overwrote rows 1016-1019).
    got = store.get_rows(np.arange(n0 - 8, n0))
    np.testing.assert_allclose(got, base[n0 - 8:], rtol=0, atol=0)
    # New rows present and valid.
    got_new = store.get_rows(rows)
    np.testing.assert_allclose(got_new, extra, rtol=0, atol=0)
    valid = np.asarray(store.valid)
    assert valid[: n0 + 4].all()
    assert not valid[n0 + 4:].any()


def test_ragged_appends_across_many_boundaries():
    """Many small ragged appends walking across several pow2 boundaries."""
    d = 8
    store = DeviceVectorStore(d, capacity=MIN_CAPACITY, device="cpu")
    rng = np.random.default_rng(0)
    all_vecs = []
    i = 0
    while store.count < 5000:
        n = int(rng.integers(1, 13))
        batch = np.stack([_row(i + j, d) for j in range(n)])
        i += n
        rows = store.append(batch)
        assert rows.shape == (n,)
        all_vecs.append(batch)
    expect = np.concatenate(all_vecs)[: store.count]
    got = store.get_rows(np.arange(store.count))
    np.testing.assert_allclose(got, expect, rtol=0, atol=0)
    assert store.n_valid == store.count
    assert np.asarray(store.valid)[: store.count].all()


def test_search_after_boundary_append_finds_new_rows():
    d = 16
    store = DeviceVectorStore(d, capacity=MIN_CAPACITY, device="cpu")
    store.append(np.stack([_row(i, d) for i in range(MIN_CAPACITY - 2)]))
    q = np.zeros((1, d), dtype=np.float32)
    q[0, 1] = 1.0  # orthogonal to all existing rows
    tail = np.tile(q, (3, 1)) * 5.0
    rows = store.append(tail)
    from fastpyvectordb_tpu_torch.core.types import DistanceMetric
    dists, hit_rows = store.search(q, k=3, metric=DistanceMetric.COSINE)
    assert set(hit_rows[0].tolist()) == set(rows.tolist())


def test_capacity_bucket_ladder():
    """Capacities walk the {2^k, 3*2^(k-1)} ladder: a corpus slightly
    over a pow2 lands in the 1.5x half-step, not the next pow2 (a 5M-row
    bf16 corpus must not allocate an 8.4M-row buffer)."""
    from fastpyvectordb_tpu_torch.core.store import _next_bucket
    assert _next_bucket(1000) == 1024
    assert _next_bucket(1024) == 1024
    assert _next_bucket(1025) == 1536
    assert _next_bucket(1536) == 1536
    assert _next_bucket(1537) == 2048
    assert _next_bucket(5_000_000) == 6_291_456      # 1.5 * 2^22
    rng = np.random.default_rng(0)
    store = DeviceVectorStore(4, capacity=MIN_CAPACITY, device="cpu")
    store.append(rng.standard_normal((1100, 4)).astype(np.float32))
    assert store.capacity == 1536
    store.append(rng.standard_normal((500, 4)).astype(np.float32))
    assert store.capacity == 2048
    # rows survive growth across the half-step
    got = store.get_rows(np.array([0, 1099, 1100, 1599], dtype=np.int64))
    assert np.isfinite(got).all()
