"""The cases of tests/test_filters.py on the port's filters
(core/filters.py) and a collection on device="cpu".

Filter engine tests: 10 ops, composition, dict form, vectorized masks.
"""

import numpy as np
import pytest

from fastpyvectordb_tpu_torch.core.filters import (
    ColumnView,
    Filter,
    filter_from_tree,
)

ROWS = [
    {"price": 10, "cat": "book", "title": "Deep Learning"},
    {"price": 25.5, "cat": "toy", "title": "Robot Kit"},
    {"price": 3, "cat": "book", "title": "ML Basics"},
    {"cat": "misc"},  # missing price/title
    None,             # tombstoned row
]


def mask_of(f):
    return f.mask(ColumnView(ROWS)).tolist()


def test_eq_ne():
    assert mask_of(Filter.eq("cat", "book")) == [True, False, True, False, False]
    # NE still requires the field to exist (reference semantics,
    # vectordb_optimized.py:88-90)
    assert mask_of(Filter.ne("price", 10)) == [False, True, True, False, False]


def test_numeric_comparisons():
    assert mask_of(Filter.gt("price", 5)) == [True, True, False, False, False]
    assert mask_of(Filter.gte("price", 10)) == [True, True, False, False, False]
    assert mask_of(Filter.lt("price", 10)) == [False, False, True, False, False]
    assert mask_of(Filter.lte("price", 10)) == [True, False, True, False, False]


def test_in_nin():
    assert mask_of(Filter.in_("cat", ["book", "toy"])) == [True, True, True, False, False]
    assert mask_of(Filter.nin("cat", ["book"])) == [False, True, False, True, False]


def test_contains_regex():
    assert mask_of(Filter.contains("title", "Learn")) == [True, False, False, False, False]
    assert mask_of(Filter.regex("title", r"^ML")) == [False, False, True, False, False]


def test_contains_regex_mixed_type_column_falls_back():
    # a non-str value in the column disables the typed fast path; the
    # object-row fallback must still match only the str rows
    rows = [{"t": "alpha beta"}, {"t": 42}, {"t": "beta"}, {}, None]
    cols = ColumnView(rows)
    assert Filter.contains("t", "beta").mask(cols).tolist() == \
        [True, False, True, False, False]
    assert Filter.regex("t", r"^beta").mask(cols).tolist() == \
        [False, False, True, False, False]
    for f in (Filter.contains("t", "beta"), Filter.regex("t", r"^beta")):
        assert f.mask(cols).tolist() == [f.evaluate(r) for r in rows]


def test_contains_regex_vectorized_matches_rowwise():
    # larger homogeneous-str column exercises the np.char.find / unique
    # scatter paths; must agree with per-row evaluate exactly
    rows = [{"s": f"item-{i % 7}-{'even' if i % 2 == 0 else 'odd'}"}
            for i in range(500)]
    rows[100] = {}  # missing field
    cols = ColumnView(rows)
    for f in (Filter.contains("s", "even"), Filter.contains("s", "item-3"),
              Filter.regex("s", r"item-[12]-"), Filter.regex("s", r"odd$")):
        assert f.mask(cols).tolist() == [f.evaluate(r) for r in rows]


def test_composition():
    f = Filter.and_([Filter.eq("cat", "book"), Filter.gt("price", 5)])
    assert mask_of(f) == [True, False, False, False, False]
    f = Filter.or_([Filter.eq("cat", "toy"), Filter.lt("price", 5)])
    assert mask_of(f) == [False, True, True, False, False]
    f = Filter.not_(Filter.eq("cat", "book"))
    assert mask_of(f) == [False, True, False, True, True]


def test_from_dict_and_mongo_ops():
    f = Filter.from_dict({"cat": "book", "price": {"$gte": 5}})
    assert mask_of(f) == [True, False, False, False, False]
    assert Filter.from_dict(None) is None
    assert Filter.from_dict({}) is None


def test_evaluate_matches_mask():
    filters = [
        Filter.eq("cat", "book"),
        Filter.gt("price", 5),
        Filter.contains("title", "o"),
        Filter.not_(Filter.in_("cat", ["misc"])),
        Filter.or_([Filter.lte("price", 3), Filter.regex("title", "Kit")]),
    ]
    cols = ColumnView(ROWS)
    for f in filters:
        assert f.mask(cols).tolist() == [f.evaluate(r) for r in ROWS]


def test_tree_roundtrip():
    f = Filter.and_([Filter.eq("a", 1),
                     Filter.or_([Filter.gt("b", 2), Filter.not_(Filter.in_("c", [1, 2]))])])
    f2 = filter_from_tree(f.to_dict())
    assert f2.fingerprint() == f.fingerprint()


def test_type_mismatch_is_false_not_error():
    rows = [{"price": "not-a-number"}, {"price": 7}]
    m = Filter.gt("price", 5).mask(ColumnView(rows))
    assert m.tolist() == [False, True]
    assert Filter.gt("price", 5).evaluate(rows[0]) is False


def test_column_sync_appended():
    rows = [{"g": 1}, {"g": 2}]
    cv = ColumnView(rows)
    m = Filter.eq("g", 1).mask(cv)
    assert m.tolist() == [True, False]
    rows.extend([{"g": 1}, None, {"g": 3, "extra": "x"}])
    cv.sync_appended()
    assert Filter.eq("g", 1).mask(cv).tolist() == [True, False, True, False,
                                                   False]
    assert Filter.gt("g", 1).mask(cv).tolist() == [False, True, False, False,
                                                   True]
    assert Filter.eq("extra", "x").mask(cv).tolist() == [False] * 4 + [True]


def test_collection_append_sync_path(tmp_path):
    import numpy as np
    from fastpyvectordb_tpu_torch import Collection, CollectionConfig
    rng = np.random.default_rng(0)
    col = Collection(CollectionConfig(name="c", dimensions=8), device="cpu")
    col.insert_batch(rng.standard_normal((10, 8)).astype(np.float32),
                     [f"a{i}" for i in range(10)],
                     [{"g": i % 2} for i in range(10)])
    f = Filter.eq("g", 1)
    assert len(col.search(np.zeros(8, np.float32), k=20, filter=f)) == 5
    # append more rows: the column cache must sync, not miss the new rows
    col.insert_batch(rng.standard_normal((6, 8)).astype(np.float32),
                     [f"b{i}" for i in range(6)],
                     [{"g": 1}] * 6)
    assert col._columns_dirty == "sync"
    assert len(col.search(np.zeros(8, np.float32), k=30, filter=f)) == 11
    # a delete point-patches the mutated row instead of an O(N) rebuild
    deleted_row = col._id_to_row["b0"]
    col.delete("b0")
    assert col._columns_dirty == "sync"
    assert deleted_row in col._columns_patchset
    assert len(col.search(np.zeros(8, np.float32), k=30, filter=f)) == 10
    # a metadata update patches too and the mask reflects the new value
    col.update_metadata("b1", {"g": 0}, merge=True)
    assert col._columns_dirty == "sync"
    assert len(col.search(np.zeros(8, np.float32), k=30, filter=f)) == 9


def _mask_eq_eval(rows, filt):
    """mask() and evaluate() must agree row-by-row."""
    from fastpyvectordb_tpu_torch.core.filters import ColumnView
    import numpy as np
    cv = ColumnView(rows)
    m = filt.mask(cv)
    e = np.asarray([filt.evaluate(r) for r in rows], dtype=bool)
    np.testing.assert_array_equal(m, e)


def test_mask_matches_evaluate_mixed_in_list():
    from fastpyvectordb_tpu_torch import Filter
    rows = [{"f": "1"}, {"f": "2"}, {"f": "a"}]
    _mask_eq_eval(rows, Filter.in_("f", [1, "a"]))  # '1' must NOT match 1
    _mask_eq_eval(rows, Filter.nin("f", [1, "a"]))


def test_mask_matches_evaluate_str_in_target():
    from fastpyvectordb_tpu_torch import Filter
    rows = [{"f": "ab"}, {"f": "zz"}]
    # evaluate uses substring semantics for a plain-str target
    _mask_eq_eval(rows, Filter.in_("f", "abc"))


def test_mask_matches_evaluate_unhashable_elems():
    from fastpyvectordb_tpu_torch import Filter
    rows = [{"f": [1, 2]}, {"f": [3]}, {"f": "x"}]
    _mask_eq_eval(rows, Filter.in_("f", [[1, 2], [3]]))


def test_mask_matches_evaluate_none_values():
    from fastpyvectordb_tpu_torch import Filter
    rows = [{"f": "x"}, {"f": None}, {"f": "y"}, {}]
    _mask_eq_eval(rows, Filter.eq("f", ""))
    _mask_eq_eval(rows, Filter.ne("f", "x"))
    _mask_eq_eval(rows, Filter.contains("f", ""))
    _mask_eq_eval(rows, Filter.regex("f", "^$"))


def test_mask_matches_evaluate_big_ints():
    from fastpyvectordb_tpu_torch import Filter
    big = 2**63
    rows = [{"n": big}, {"n": 5}]
    _mask_eq_eval(rows, Filter.gt("n", big - 512))
    _mask_eq_eval(rows, Filter.eq("n", big))


def test_from_dict_logical_combinators():
    from fastpyvectordb_tpu_torch import Filter
    f = Filter.from_dict({"$or": [{"category": "food"},
                                  {"category": "finance"}]})
    assert f.evaluate({"category": "food"})
    assert f.evaluate({"category": "finance"})
    assert not f.evaluate({"category": "tech"})
    f = Filter.from_dict({"$and": [{"a": 1}, {"b": {"$gt": 5}}]})
    assert f.evaluate({"a": 1, "b": 9}) and not f.evaluate({"a": 1, "b": 2})
    f = Filter.from_dict({"$not": {"lang": "en"}})
    assert f.evaluate({"lang": "fr"}) and not f.evaluate({"lang": "en"})


def test_mask_matches_evaluate_numpy_scalars_and_lossy_ints():
    """mask() fast paths must agree with evaluate() for numpy-scalar
    metadata values and for ints beyond float64's exact range."""
    import numpy as np
    from fastpyvectordb_tpu_torch.core.filters import ColumnView, Filter
    rows = [{"score": np.int64(7)}, {"score": 3}, {"score": np.float32(9.5)},
            {"x": 2**53}, {"x": 2**53 + 1}, {"price": 9.5}]
    cols = ColumnView(rows)
    for f in (Filter.gt("score", 5), Filter.lte("score", 3),
              Filter.eq("x", 2**53), Filter.gt("x", 2**53),
              Filter.contains("price", "9"), Filter.regex("price", "9.*")):
        want = np.array([f.evaluate(r) for r in rows])
        got = f.mask(cols)
        np.testing.assert_array_equal(got, want, err_msg=f.to_dict())
