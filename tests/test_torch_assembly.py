"""Result assembly in the port's ``Collection``: how a search path's
(scores, rows) pair becomes the ``(ids, scores, rows)`` triple of
``search_arrays`` and the ``SearchResult`` lists of ``search``.

Both go through ``Collection._hits``.  Each case holds it to a plain
restatement of the rules, one slot at a time: a slot is a hit when its
score is below half of ``MASKED``, its row lies in
``[0, len(_row_to_id))`` and that row still holds an id; every other slot
reads ``None`` / ``+inf`` / ``-1``, and the lists keep the first k hits of
a row in column order."""

import numpy as np
import pytest

import fastpyvectordb_tpu_torch as T
from fastpyvectordb_tpu_torch.core import collection as collection_mod
from fastpyvectordb_tpu_torch.kernels.distances import MASKED

N, D = 40, 8
DEAD = (3, 17, 29)


def _collection(path=None, n=N, dead=DEAD):
    rng = np.random.default_rng(7)
    db = T.VectorDB(path, device="cpu")
    c = db.create_collection("c", dimensions=D, metric="l2")
    v = rng.standard_normal((n, D)).astype(np.float32)
    c.insert_batch(v, [f"v{i}" for i in range(n)],
                   [{"i": i} for i in range(n)])
    c.delete_batch([f"v{r}" for r in dead])
    return db, c


def _rule_ok(row_to_id, dists, rows):
    n = len(row_to_id)
    ok = np.zeros(rows.shape, dtype=bool)
    for (b, j), r in np.ndenumerate(rows):
        r = int(r)
        ok[b, j] = (bool(dists[b, j] < float(MASKED) * 0.5)
                    and 0 <= r < n and row_to_id[r] is not None)
    return ok


def _rule_arrays(row_to_id, dists, rows, k):
    dists = np.asarray(dists)[:, :k].astype(np.float32)
    rows = np.asarray(rows)[:, :k]
    ok = _rule_ok(row_to_id, dists, rows)
    ids = np.full(rows.shape, None, dtype=object)
    scores = np.full(rows.shape, np.inf, dtype=np.float32)
    out_rows = np.full(rows.shape, -1, dtype=np.int32)
    for (b, j), hit in np.ndenumerate(ok):
        if hit:
            ids[b, j] = row_to_id[int(rows[b, j])]
            scores[b, j] = dists[b, j]
            out_rows[b, j] = rows[b, j]
    return ids, scores, out_rows


def _rule_lists(row_to_id, metadata, dists, rows, k):
    ok = _rule_ok(row_to_id, dists, rows)
    out = []
    for b in range(rows.shape[0]):
        cols = [j for j in range(rows.shape[1]) if ok[b, j]][:k]
        out.append([(row_to_id[int(rows[b, j])], float(dists[b, j]),
                     dict(metadata[int(rows[b, j])] or {}),
                     int(rows[b, j])) for j in cols])
    return out


def _grid(case, n):
    """A crafted (dists, rows, k) pair of a search path's shape."""
    rng = np.random.default_rng(11)
    b, w = 6, 12
    dists = np.sort(rng.random((b, w), dtype=np.float32), axis=1)
    live = [r for r in range(n) if r not in DEAD]
    rows = np.stack([rng.choice(live, w, replace=False)
                     for _ in range(b)]).astype(np.int32)
    k = w
    if case == "all_valid":
        return dists, rows, k
    if case == "wider_than_k":
        rows[1, 2] = -1
        rows[4, 0] = DEAD[0]
        return dists, rows, 8
    if case == "int64_rows":
        rows = rows.astype(np.int64)
        rows[0, 1] = 2 ** 32 + 5   # wraps to a live row in 32 bits
        rows[2, 3] = -(2 ** 33)
        return dists, rows, k
    # "mixed": every kind of invalid slot, in a grid wider than k
    dists[0, 4:] = MASKED
    dists[1, 0] = MASKED
    rows[2, 3] = -1
    rows[2, 5] = n
    rows[3, 0] = n + 1000
    rows[3, 7] = DEAD[1]
    rows[4, 1] = DEAD[2]
    dists[5, :] = np.nan
    return dists, rows, 9


CASES = ["mixed", "all_valid", "wider_than_k", "int64_rows"]


@pytest.mark.parametrize("case", CASES)
def test_arrays_of_follows_the_rules(case):
    _, c = _collection()
    dists, rows, k = _grid(case, N)
    got = c._arrays_of(dists, rows, k)
    want = _rule_arrays(c._row_to_id, dists, rows, k)
    assert got[0].dtype == object and got[0].tolist() == want[0].tolist()
    assert got[1].dtype == np.float32 and got[2].dtype == np.int32
    np.testing.assert_array_equal(got[1].view(np.uint32),
                                  want[1].view(np.uint32))
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("include_vectors", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_assemble_follows_the_rules(case, include_vectors):
    _, c = _collection()
    dists, rows, k = _grid(case, N)
    got = c._assemble(None, dists, rows, k, include_vectors)
    want = _rule_lists(c._row_to_id, c._metadata, dists, rows, k)
    assert len(got) == len(want)
    vectors = c._store.get_rows(np.arange(N, dtype=np.int64))
    for g_row, w_row in zip(got, want):
        assert [(h.id, h.score, h.metadata) for h in g_row] == \
            [(i, s, m) for i, s, m, _ in w_row]
        for h, (_, _, _, r) in zip(g_row, w_row):
            if include_vectors:
                np.testing.assert_array_equal(h.vector, vectors[r])
            else:
                assert h.vector is None


def test_an_empty_row_space_yields_no_hits():
    _, c = _collection(n=0, dead=())
    dists = np.zeros((2, 3), dtype=np.float32)
    rows = np.array([[0, 1, -1], [2, 0, 5]], dtype=np.int32)
    ids, scores, out_rows = c._arrays_of(dists, rows, 3)
    assert ids.tolist() == [[None] * 3] * 2
    assert np.isinf(scores).all() and (out_rows == -1).all()
    assert c._assemble(None, dists, rows, 3, False) == [[], []]
    # and through the public paths
    q = np.zeros((2, D), dtype=np.float32)
    ids, scores, out_rows = c.search_arrays(q, k=4)
    assert ids.shape == (2, 4) and (out_rows == -1).all()
    assert c.search_batch(q, k=4) == [[], []]


@pytest.mark.parametrize("case", ["mixed", "all_valid"])
def test_outputs_are_fresh_arrays(case):
    _, c = _collection()
    dists, rows, k = _grid(case, N)
    dists, rows = dists[:, :k].copy(), rows[:, :k].copy()
    ids, scores, out_rows = c._arrays_of(dists, rows, k)
    kept = (ids.tolist(), scores.copy(), out_rows.copy())
    for out in (scores, out_rows):
        assert out.flags.c_contiguous and out.flags.owndata
        assert not np.shares_memory(out, dists)
        assert not np.shares_memory(out, rows)
    dists[:] = 123.0
    rows[:] = 0
    assert ids.tolist() == kept[0]
    np.testing.assert_array_equal(scores, kept[1])
    np.testing.assert_array_equal(out_rows, kept[2])
    # a later call does not write into an earlier call's arrays
    c._arrays_of(dists, rows, k)
    np.testing.assert_array_equal(scores, kept[1])
    np.testing.assert_array_equal(out_rows, kept[2])


def _count(fn):
    before = dict(collection_mod.ASSEMBLIES)
    fn()
    after = collection_mod.ASSEMBLIES
    return (after["clean"] - before["clean"],
            after["patched"] - before["patched"])


@pytest.mark.parametrize("case,path", [
    ("all_valid", (1, 0)), ("mixed", (0, 1)), ("wider_than_k", (0, 1)),
    ("int64_rows", (0, 1))])
def test_counter_counts_one_path_a_call(case, path):
    _, c = _collection()
    dists, rows, k = _grid(case, N)
    assert _count(lambda: c._arrays_of(dists, rows, k)) == path
    assert _count(lambda: c._assemble(None, dists, rows, k, False)) == path


def test_counter_on_the_public_paths():
    _, c = _collection()
    rng = np.random.default_rng(3)
    q = rng.standard_normal((4, D)).astype(np.float32)
    assert _count(lambda: c.search_arrays(q, k=5)) == (1, 0)
    assert _count(lambda: c.search_batch(q, k=5)) == (1, 0)
    # k > count
    assert _count(lambda: c.search_arrays(q, k=N)) == (0, 1)
    # a filter that leaves fewer than k rows
    flt = T.Filter.eq("i", 5)
    assert _count(lambda: c.search_arrays(q, k=3, filter=flt)) == (0, 1)
    assert _count(lambda: c.search(q[0], k=3, filter=flt)) == (0, 1)
    ids, _, _ = c.search_arrays(q, k=3, filter=flt)
    assert ids.tolist() == [["v5", None, None]] * 4
    # tombstones past the count
    c.delete_batch([f"v{i}" for i in range(N) if i % 4])
    assert _count(lambda: c.search_arrays(q, k=12)) == (0, 1)


def _raw_paths(c, q, k, flt):
    """Each public path's raw (dists, rows) and the triple it returns."""
    with c._lock:
        raw = c._search_rows(q, k, flt, None)
    yield raw, c.search_arrays(q, k=k, filter=flt)
    with c._lock:
        raw = c._quantized_rows(q, k, None, flt)
    yield raw, c.search_quantized_arrays(q, k=k, filter=flt)


@pytest.mark.parametrize("k", [5, N + 3])
@pytest.mark.parametrize("filtered", [False, True])
def test_public_paths_follow_the_rules(k, filtered):
    _, c = _collection()
    c.enable_quantized_scan("int8")
    rng = np.random.default_rng(5)
    q = rng.standard_normal((3, D)).astype(np.float32)
    flt = T.Filter.lt("i", 20) if filtered else None
    for (dists, rows), got in _raw_paths(c, q, k, flt):
        want = _rule_arrays(c._row_to_id, dists, rows, k)
        assert got[0].tolist() == want[0].tolist()
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    lists = c.search_batch(q, k=k, filter=flt)
    triple = c.search_arrays(q, k=k, filter=flt)
    for hits, ids, scores in zip(lists, triple[0], triple[1]):
        assert [h.id for h in hits] == [i for i in ids if i is not None]
        assert [h.score for h in hits] == \
            [float(s) for s in scores if np.isfinite(s)]


def _live_is_the_ids(c):
    ids, live = c._id_columns()
    assert ids.tolist() == c._row_to_id
    np.testing.assert_array_equal(
        live, [i is not None for i in c._row_to_id])


def test_live_rows_follow_delete_insert_and_compact():
    _, c = _collection()
    _live_is_the_ids(c)
    dists = np.zeros((1, N), dtype=np.float32)
    rows = np.arange(N, dtype=np.int32)[None, :]
    c.delete("v8")
    _live_is_the_ids(c)
    assert c._arrays_of(dists, rows, N)[0][0, 8] is None
    c.insert(np.ones(D, dtype=np.float32), "new", {"i": -1})
    _live_is_the_ids(c)
    row = c._id_to_row["new"]
    assert c._arrays_of(dists, np.array([[row]]), 1)[0][0, 0] == "new"
    c.compact()
    _live_is_the_ids(c)
    assert None not in c._row_to_id
    ids, _, out_rows = c._arrays_of(dists[:, :len(c._row_to_id)],
                                    rows[:, :len(c._row_to_id)],
                                    len(c._row_to_id))
    assert ids[0].tolist() == c._row_to_id
    assert (out_rows >= 0).all()


def test_live_rows_survive_save_and_load(tmp_path):
    db, c = _collection(tmp_path / "db")
    db.save()
    back = T.VectorDB(tmp_path / "db", device="cpu").get_collection("c")
    _live_is_the_ids(back)
    assert back._row_to_id == c._row_to_id
    dists, rows, k = _grid("mixed", N)
    got, want = back._arrays_of(dists, rows, k), c._arrays_of(dists, rows, k)
    assert got[0].tolist() == want[0].tolist()
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
