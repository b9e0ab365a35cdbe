"""The non-graph cases of tests/test_incremental.py on the port
(device="cpu"); its graph cases are in tests/test_torch_graph_ann.py.

Incremental index maintenance: inserts/deletes must not force rebuilds.

Reference bar: hnswlib inserts into the live served index
(vectordb_optimized.py:337-416) and tombstones deletes (ibid:467-501).
Here appended rows are served by an exact scan over the tail merged with
the index snapshot's hits; deletes ride the validity mask; a threshold
triggers amortized rebuilds.
"""

import numpy as np
import pytest

from fastpyvectordb_tpu_torch import Collection, CollectionConfig, Filter

D = 20


def _mk(n, seed=3, index=None, **ann_kwargs):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, D)).astype(np.float32)
    col = Collection(CollectionConfig(name="inc", dimensions=D, metric="l2"),
                     device="cpu")
    col.insert_batch(v, [f"v{i}" for i in range(n)],
                     [{"g": i % 4} for i in range(n)])
    if index:
        col.build_ann(kind=index, **ann_kwargs)
    return col, v, rng


@pytest.mark.parametrize("kind,kwargs", [
    ("ivf", {"nlist": 32, "nprobe": 8, "iters": 4}),
])
def test_insert_after_build_no_rebuild(kind, kwargs):
    col, v, rng = _mk(1200, index=kind, **kwargs)
    built = col._ann._built_count
    # plant a distinctive tail vector and query for it
    target = np.full((D,), 7.5, dtype=np.float32)
    col.insert(target, id="tail-hit")
    assert not col._ann.stale
    hits = col.search(target, k=3, exact=False)
    assert hits[0].id == "tail-hit"
    assert col._ann._built_count == built  # merge path, not rebuild


@pytest.mark.parametrize("kind,kwargs", [
    ("ivf", {"nlist": 32, "nprobe": 8, "iters": 4}),
])
def test_delete_after_build_no_rebuild(kind, kwargs):
    col, v, rng = _mk(1200, index=kind, **kwargs)
    built = col._ann._built_count
    # delete the exact nearest neighbor of v[5]; it must vanish from results
    assert col.delete("v5")
    assert not col._ann.stale
    hits = col.search(v[5], k=5, exact=False)
    assert "v5" not in [h.id for h in hits]
    assert col._ann._built_count == built


def test_tail_growth_triggers_threshold_rebuild():
    col, v, rng = _mk(64, index="ivf", nlist=8, nprobe=4, iters=3)
    built = col._ann._built_count
    # grow the tail far past the 25% threshold floor is 4096... use a big
    # relative tail with a small floor by growing past max(built//4, 4096)
    extra = rng.standard_normal((4200, D)).astype(np.float32)
    col.insert_batch(extra, [f"x{i}" for i in range(4200)])
    col.search(v[0], k=3, exact=False)   # spawns the background rebuild
    assert col.wait_for_rebuild(timeout=120)
    assert col._ann._built_count == 64 + 4200  # rebuilt over everything


def test_background_rebuild_is_nonblocking_and_correct():
    """The triggering search must NOT pay the rebuild (it serves stale +
    tail merge); the swapped-in index covers everything afterwards."""
    col, v, rng = _mk(64, index="ivf", nlist=8, nprobe=8, iters=3)
    assert col.config.rebuild == "background"
    extra = rng.standard_normal((4200, D)).astype(np.float32)
    col.insert_batch(extra, [f"x{i}" for i in range(4200)])
    old = col._ann
    hits = col.search(extra[7], k=3, exact=False)   # tail row: merge path
    assert hits[0].id == "x7"
    assert col._ann is old and not old.stale  # served WITHOUT rebuilding
    assert col.wait_for_rebuild(timeout=120)
    assert col._ann is not old
    assert col._ann._built_count == 64 + 4200
    hits = col.search(extra[7], k=3, exact=False)   # now via the index
    assert hits[0].id == "x7"


def test_background_rebuild_fenced_by_compact():
    """compact() renumbers rows mid-build: the stale build must NOT swap
    in (its row_table references the old numbering)."""
    col, v, rng = _mk(64, index="ivf", nlist=8, nprobe=8, iters=3)
    extra = rng.standard_normal((4200, D)).astype(np.float32)
    col.insert_batch(extra, [f"x{i}" for i in range(4200)])
    col.delete_batch([f"v{i}" for i in range(32)])
    col.search(extra[0], k=3, exact=False)  # spawn over old numbering
    col.compact()                           # renumber + mark stale
    col.wait_for_rebuild(timeout=120)
    # whatever landed, searches must be correct post-compact
    hits = col.search(extra[9], k=3, exact=False)
    assert hits[0].id == "x9"


def test_quantized_insert_and_delete_served_incrementally():
    col, v, rng = _mk(900)
    col.enable_quantized_scan(kind="int8")
    built = col._quantized.built_count
    target = np.full((D,), -6.25, dtype=np.float32)
    col.insert(target, id="q-tail")
    res = col.search_quantized(target, k=3, rerank=4)
    assert res[0][0].id == "q-tail"
    assert col._quantized is not None and col._quantized.built_count == built

    # deletes ride the validity mask without dropping the snapshot
    col.delete("v7")
    assert col._quantized is not None
    res = col.search_quantized(v[7], k=5, rerank=4)
    assert "v7" not in [h.id for h in res[0]]


def test_quantized_filter_plus_tail_merge():
    col, v, rng = _mk(600)
    col.enable_quantized_scan(kind="int8")
    col.insert(np.full((D,), 4.0, np.float32), id="t0", metadata={"g": 1})
    col.insert(np.full((D,), 4.1, np.float32), id="t1", metadata={"g": 2})
    res = col.search_quantized(np.full((D,), 4.0, np.float32), k=2,
                               filter=Filter.eq("g", 2))
    got = [h.id for h in res[0]]
    assert got[0] == "t1" and "t0" not in got


def test_metadata_update_keeps_indexes():
    col, v, rng = _mk(1200, index="ivf", nlist=32, nprobe=8, iters=4)
    col.enable_quantized_scan(kind="int8")
    col.update_metadata("v3", {"g": 99})
    assert not col._ann.stale and col._quantized is not None
    # and the filter sees the new value
    res = col.search_batch(v[3][None], k=5, filter=Filter.eq("g", 99))
    assert any(h.id == "v3" for h in res[0])


def test_compact_still_invalidates():
    col, v, rng = _mk(800, index="ivf", nlist=16, nprobe=8, iters=3)
    col.delete_batch([f"v{i}" for i in range(100)])
    assert not col._ann.stale
    col.compact()
    assert col._ann.stale  # rows were remapped: rebuild required
    hits = col.search(v[500], k=1, exact=False)
    assert hits[0].id == "v500"


def test_mass_delete_rebuilds_once_not_every_search(rng):
    """After a >50% mass delete, the drift trigger must fire ONE rebuild;
    comparing against built_count (which includes tombstones) kept the
    condition true forever and every query paid a full rebuild."""
    from fastpyvectordb_tpu_torch.core.collection import Collection
    from fastpyvectordb_tpu_torch.core.types import CollectionConfig
    n, d = 600, 16
    v = rng.standard_normal((n, d)).astype(np.float32)
    col = Collection(CollectionConfig(name="md", dimensions=d, metric="l2"),
                     device="cpu")
    col.insert_batch(v, [f"v{i}" for i in range(n)])
    col.build_ann(nlist=16, nprobe=8, iters=3)
    col.delete_batch([f"v{i}" for i in range(400)])  # 66% tombstones
    col.search(v[500], k=3, exact=False)             # triggers the rebuild
    assert col.wait_for_rebuild(timeout=120)
    assert not col._ann.stale
    built_table = col._ann.row_table
    col.search(v[501], k=3, exact=False)
    col.search(v[502], k=3, exact=False)
    assert col.wait_for_rebuild(timeout=120)
    assert col._ann.row_table is built_table  # no second rebuild
