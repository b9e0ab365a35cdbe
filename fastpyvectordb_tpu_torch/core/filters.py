"""Metadata filter engine.

Capability parity with the reference's 10-op closure-based filter DSL
(vectordb_optimized.py:59-184): EQ NE GT GTE LT LTE IN NIN CONTAINS REGEX
plus AND / OR / NOT composition and ``from_dict`` (a plain dict means AND of
equality checks).  Missing fields never match (including under NE), matching
the reference's ``evaluate`` semantics (vectordb_optimized.py:79-105).

The architecture differs deliberately: filters here are *expression trees*,
not opaque closures, so one filter supports two execution modes:

  1. ``evaluate(metadata) -> bool`` — per-row, for host-side paths.
  2. ``mask(columns, n) -> np.ndarray[bool]`` — vectorized over a columnar
     view of all row metadata.  This mask is shipped to the device and fused
     into the top-k (kernels/distances.py:search_kernel), replacing the
     reference's over-fetch-then-post-filter Python loop
     (vectordb_optimized.py:531, 550-573).

``fingerprint()`` gives a stable hash so collections can cache device masks
across repeated queries with the same filter.

Copied unchanged from ``fastpyvectordb_tpu/core/filters.py`` (jax-free, but
not importable without jax through its package).  Masks stay host numpy;
the store moves them to the device as ``torch.bool`` (core/store.py).
"""

from __future__ import annotations

import enum
import json
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class FilterOp(str, enum.Enum):
    EQ = "eq"
    NE = "ne"
    GT = "gt"
    GTE = "gte"
    LT = "lt"
    LTE = "lte"
    IN = "in"
    NIN = "nin"
    CONTAINS = "contains"
    REGEX = "regex"


_MISSING = object()


def _cmp_scalar(op: FilterOp, value: Any, target: Any) -> bool:
    try:
        if op == FilterOp.EQ:
            return bool(value == target)
        if op == FilterOp.NE:
            return bool(value != target)
        if op == FilterOp.GT:
            return bool(value > target)
        if op == FilterOp.GTE:
            return bool(value >= target)
        if op == FilterOp.LT:
            return bool(value < target)
        if op == FilterOp.LTE:
            return bool(value <= target)
        if op == FilterOp.IN:
            return value in target
        if op == FilterOp.NIN:
            return value not in target
        if op == FilterOp.CONTAINS:
            return isinstance(value, str) and str(target) in value
        if op == FilterOp.REGEX:
            return isinstance(value, str) and re.search(str(target), value) is not None
    except TypeError:
        return False
    raise ValueError(f"unknown op {op}")


class ColumnView:
    """Columnar cache over a list of per-row metadata dicts.

    Built lazily per metadata key; invalidated wholesale by the collection on
    mutation (cheap — rebuilding a column is a single O(N) pass).
    """

    def __init__(self, rows: Sequence[Optional[dict]]):
        self._rows = rows
        self._built_len = len(rows)
        self._obj: Dict[str, np.ndarray] = {}
        self._num: Dict[str, np.ndarray] = {}
        self._num_lossy: Dict[str, bool] = {}
        self._nonnull: Dict[str, np.ndarray] = {}
        self._present: Dict[str, np.ndarray] = {}
        # typed (non-object) column cache: enables vectorized ==/isin for
        # homogeneous str/int/float columns instead of per-row Python
        self._typed: Dict[str, Optional[np.ndarray]] = {}

    def sync_appended(self) -> None:
        """Extend cached columns to cover rows appended since they were
        built — avoids a full O(N) rebuild on the append-heavy path.
        Only valid when existing rows were not mutated."""
        n = len(self._rows)
        if n == self._built_len:
            return
        tail = self._rows[self._built_len:]
        for key in list(self._present):
            ext = np.fromiter(((r is not None and key in r) for r in tail),
                              dtype=bool, count=len(tail))
            self._present[key] = np.concatenate([self._present[key], ext])
        for key in list(self._obj):
            ext = np.empty(len(tail), dtype=object)
            for i, r in enumerate(tail):
                ext[i] = r.get(key, _MISSING) if r is not None else _MISSING
            self._obj[key] = np.concatenate([self._obj[key], ext])
        for key in list(self._num):
            ext = np.full(len(tail), np.nan, dtype=np.float64)
            for i, r in enumerate(tail):
                if r is None:
                    continue
                v = r.get(key, _MISSING)
                if isinstance(v, (bool, np.bool_)):
                    ext[i] = float(v)
                elif isinstance(v, (int, np.integer)):
                    if abs(int(v)) > 2**53:
                        self._num_lossy[key] = True
                    ext[i] = float(v)
                elif isinstance(v, (float, np.floating)):
                    ext[i] = float(v)
            self._num[key] = np.concatenate([self._num[key], ext])
        # typed arrays can be invalidated by new value types; recompute
        # lazily rather than risk silent coercion
        self._typed.clear()
        self._nonnull.clear()
        self._built_len = n

    def patch_rows(self, rows_idx) -> None:
        """Point-update cached columns for specific mutated rows (deletes
        tombstoning metadata to None, in-place metadata updates) instead of
        the wholesale O(N x columns) rebuild — a delete's stale column
        values are screened by the store validity mask anyway, so this
        keeps mutation cost O(mutated rows)."""
        for i in rows_idx:
            if i >= self._built_len:
                continue  # not yet covered; sync_appended will read it fresh
            r = self._rows[i]
            for key, col in self._present.items():
                col[i] = r is not None and key in r
            for key, col in self._obj.items():
                col[i] = r.get(key, _MISSING) if r is not None else _MISSING
            for key, col in self._num.items():
                v = r.get(key, _MISSING) if r is not None else _MISSING
                if isinstance(v, (bool, np.bool_)):
                    col[i] = float(v)
                elif isinstance(v, (int, np.integer)):
                    if abs(int(v)) > 2**53:
                        self._num_lossy[key] = True
                    col[i] = float(v)
                elif isinstance(v, (float, np.floating)):
                    col[i] = float(v)
                else:
                    col[i] = np.nan
            for key in list(self._typed):
                arr = self._typed[key]
                if arr is None:
                    continue
                v = r.get(key) if r is not None else None
                nn = self._nonnull.get(key)
                if v is None:
                    arr[i] = "" if arr.dtype.kind == "U" else np.nan
                    if nn is not None:
                        nn[i] = False
                elif arr.dtype.kind == "U" and isinstance(v, str) \
                        and len(v) <= arr.dtype.itemsize // 4:
                    arr[i] = v
                    if nn is not None:
                        nn[i] = True
                elif arr.dtype.kind == "f" and isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    arr[i] = v
                    if nn is not None:
                        nn[i] = True
                else:
                    # value no longer fits the typed layout: drop the cache
                    # for this key (it rebuilds lazily on next use)
                    del self._typed[key]
                    self._nonnull.pop(key, None)

    def __len__(self) -> int:
        return len(self._rows)

    def present(self, key: str) -> np.ndarray:
        if key not in self._present:
            self._present[key] = np.fromiter(
                ((r is not None and key in r) for r in self._rows),
                dtype=bool,
                count=len(self._rows),
            )
        return self._present[key]

    def objects(self, key: str) -> np.ndarray:
        if key not in self._obj:
            col = np.empty(len(self._rows), dtype=object)
            for i, r in enumerate(self._rows):
                col[i] = r.get(key, _MISSING) if r is not None else _MISSING
            self._obj[key] = col
        return self._obj[key]

    def typed(self, key: str) -> Optional[np.ndarray]:
        """Homogeneously-typed view of a column (None if mixed-type).
        Missing entries hold a sentinel and are screened by present();
        explicit None VALUES (key present, value None) get the same
        sentinel and are screened by nonnull() — without that, a row with
        {'f': None} would match Filter.eq('f', '') on the vectorized path
        while evaluate() correctly rejects it."""
        if key not in self._typed:
            values = [r.get(key) if r is not None else None
                      for r in self._rows]
            kinds = {type(v) for v in values if v is not None}
            arr: Optional[np.ndarray] = None
            try:
                if kinds == {str}:
                    arr = np.asarray([v if v is not None else "" for v in
                                      values], dtype=np.str_)
                elif kinds and kinds <= {int, float} and bool not in kinds:
                    # float64 rounds ints past 2**53: a lossy column makes
                    # EQ/IN match neighbors evaluate() rejects — exact
                    # object path instead
                    if not any(isinstance(v, int) and abs(v) > 2**53
                               for v in values):
                        arr = np.asarray([v if v is not None else np.nan
                                          for v in values],
                                         dtype=np.float64)
            except (TypeError, ValueError):
                arr = None
            self._typed[key] = arr
            self._nonnull[key] = np.fromiter(
                (v is not None for v in values), dtype=bool,
                count=len(values))
        return self._typed[key]

    def nonnull(self, key: str) -> np.ndarray:
        """True where the column value is not None (see typed())."""
        if key not in self._nonnull:
            self.typed(key)
        return self._nonnull[key]

    def numeric(self, key: str) -> np.ndarray:
        """float64 view of a column; non-numeric / missing entries are NaN.
        Accepts numpy scalars (np.int64 metadata is common when values
        come from arrays); ints beyond 2**53 mark the column lossy so
        comparisons fall back to the exact object path."""
        if key not in self._num:
            out = np.full(len(self._rows), np.nan, dtype=np.float64)
            lossy = False
            for i, r in enumerate(self._rows):
                if r is None:
                    continue
                v = r.get(key, _MISSING)
                if isinstance(v, (bool, np.bool_)):
                    out[i] = float(v)
                elif isinstance(v, (int, np.integer)):
                    if abs(int(v)) > 2**53:
                        lossy = True
                    out[i] = float(v)
                elif isinstance(v, (float, np.floating)):
                    out[i] = float(v)
            self._num[key] = out
            self._num_lossy[key] = lossy
        return self._num[key]

    def numeric_lossy(self, key: str) -> bool:
        """True when the float64 column rounded an int value (>2**53) —
        mask() must not trust its comparisons then."""
        self.numeric(key)
        return self._num_lossy.get(key, False)


class Filter:
    """Base filter node. Use the static constructors (Filter.eq, ...)."""

    def evaluate(self, metadata: Optional[dict]) -> bool:
        raise NotImplementedError

    def mask(self, cols: ColumnView) -> np.ndarray:
        raise NotImplementedError

    def to_dict(self) -> dict:
        raise NotImplementedError

    def fingerprint(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, default=str)

    # -- composition -------------------------------------------------------
    @staticmethod
    def eq(field: str, value: Any) -> "Filter":
        return Condition(FilterOp.EQ, field, value)

    @staticmethod
    def ne(field: str, value: Any) -> "Filter":
        return Condition(FilterOp.NE, field, value)

    @staticmethod
    def gt(field: str, value: Any) -> "Filter":
        return Condition(FilterOp.GT, field, value)

    @staticmethod
    def gte(field: str, value: Any) -> "Filter":
        return Condition(FilterOp.GTE, field, value)

    @staticmethod
    def lt(field: str, value: Any) -> "Filter":
        return Condition(FilterOp.LT, field, value)

    @staticmethod
    def lte(field: str, value: Any) -> "Filter":
        return Condition(FilterOp.LTE, field, value)

    @staticmethod
    def in_(field: str, values: Sequence[Any]) -> "Filter":
        return Condition(FilterOp.IN, field, list(values))

    @staticmethod
    def nin(field: str, values: Sequence[Any]) -> "Filter":
        return Condition(FilterOp.NIN, field, list(values))

    @staticmethod
    def contains(field: str, substring: str) -> "Filter":
        return Condition(FilterOp.CONTAINS, field, substring)

    @staticmethod
    def regex(field: str, pattern: str) -> "Filter":
        return Condition(FilterOp.REGEX, field, pattern)

    @staticmethod
    def and_(filters: Sequence["Filter"]) -> "Filter":
        return And(list(filters))

    @staticmethod
    def or_(filters: Sequence["Filter"]) -> "Filter":
        return Or(list(filters))

    @staticmethod
    def not_(f: "Filter") -> "Filter":
        return Not(f)

    @staticmethod
    def from_dict(d: Optional[dict]) -> Optional["Filter"]:
        """A plain dict means AND-of-equalities, with optional Mongo-style
        operator objects: ``{"price": {"$gt": 5}, "tag": "x"}``.
        (Reference accepts only the equality form, vectordb_optimized.py:180.)
        """
        if d is None:
            return None
        ops = {
            "$eq": FilterOp.EQ, "$ne": FilterOp.NE, "$gt": FilterOp.GT,
            "$gte": FilterOp.GTE, "$lt": FilterOp.LT, "$lte": FilterOp.LTE,
            "$in": FilterOp.IN, "$nin": FilterOp.NIN,
            "$contains": FilterOp.CONTAINS, "$regex": FilterOp.REGEX,
        }
        parts: List[Filter] = []
        for key, val in d.items():
            # Chroma/Mongo-style logical combinators: {"$or": [...]},
            # {"$and": [...]}, {"$not": {...}} — without these a top-level
            # "$or" silently became Condition(EQ, "$or", [...]) and
            # matched nothing
            if key == "$and" and isinstance(val, (list, tuple)):
                sub = [Filter.from_dict(x) for x in val]
                parts.extend(x for x in sub if x is not None)
            elif key == "$or" and isinstance(val, (list, tuple)):
                sub = [f for f in (Filter.from_dict(x) for x in val)
                       if f is not None]
                if sub:
                    parts.append(Or(sub))
            elif key == "$not" and isinstance(val, dict):
                inner = Filter.from_dict(val)
                if inner is not None:
                    parts.append(Not(inner))
            elif isinstance(val, dict) and val and all(k in ops for k in val):
                for opk, opv in val.items():
                    parts.append(Condition(ops[opk], key, opv))
            else:
                parts.append(Condition(FilterOp.EQ, key, val))
        if not parts:
            return None
        return parts[0] if len(parts) == 1 else And(parts)


class Condition(Filter):
    def __init__(self, op: FilterOp, field: str, value: Any):
        self.op = FilterOp(op)
        self.field = field
        self.value = value

    def evaluate(self, metadata: Optional[dict]) -> bool:
        if metadata is None or self.field not in metadata:
            return False
        return _cmp_scalar(self.op, metadata[self.field], self.value)

    def mask(self, cols: ColumnView) -> np.ndarray:
        present = cols.present(self.field)
        op, val = self.op, self.value
        if op in (FilterOp.GT, FilterOp.GTE, FilterOp.LT, FilterOp.LTE) and isinstance(
            val, (int, float)
        ) and not isinstance(val, bool) and not (
            isinstance(val, int) and abs(val) > 2**53
        ) and not cols.numeric_lossy(self.field):
            # giant ints (in the value OR the stored column) are lossy in
            # the float64 column; exact object path below handles those
            col = cols.numeric(self.field)
            with np.errstate(invalid="ignore"):
                if op == FilterOp.GT:
                    m = col > val
                elif op == FilterOp.GTE:
                    m = col >= val
                elif op == FilterOp.LT:
                    m = col < val
                else:
                    m = col <= val
            return m & present
        # vectorized fast path for homogeneous str / numeric columns.
        # Guards keep mask() semantics identical to evaluate(): val must
        # be typed-compatible or we fall through to the exact object path
        # (a mixed-type $in list stringifies under np.asarray; a plain-str
        # $in target has SUBSTRING semantics in evaluate; explicit None
        # values hide behind ''/NaN sentinels).
        if op in (FilterOp.EQ, FilterOp.NE, FilterOp.IN, FilterOp.NIN) \
                and val is not None:
            typed = cols.typed(self.field)
            elems = None
            if op in (FilterOp.IN, FilterOp.NIN):
                if isinstance(val, (list, tuple, set, frozenset)):
                    elems = list(val)
            if typed is not None and (
                op in (FilterOp.EQ, FilterOp.NE) or elems is not None
            ):
                homogeneous = True
                if elems is not None:
                    if typed.dtype.kind == "U":
                        homogeneous = all(isinstance(e, str) for e in elems)
                    else:
                        homogeneous = all(
                            isinstance(e, (int, float))
                            and not isinstance(e, bool)
                            and not (isinstance(e, int) and abs(e) > 2**53)
                            for e in elems)
                elif isinstance(val, int) and abs(val) > 2**53:
                    homogeneous = False
                if homogeneous:
                    try:
                        nonnull = cols.nonnull(self.field)
                        if op == FilterOp.EQ:
                            m = (typed == val) & nonnull
                        elif op == FilterOp.NE:
                            # a present None value satisfies != (evaluate:
                            # None != val is True)
                            m = (typed != val) | ~nonnull
                        elif op == FilterOp.IN:
                            m = np.isin(typed, np.asarray(elems)) & nonnull
                        else:
                            m = (~np.isin(typed, np.asarray(elems))
                                 | ~nonnull)
                        return np.asarray(m, dtype=bool) & present
                    except (TypeError, ValueError):
                        pass  # incomparable literal: object path below
        if op in (FilterOp.CONTAINS, FilterOp.REGEX):
            typed = cols.typed(self.field)
            # the C-speed paths are string kernels: a homogeneous NUMERIC
            # column must fall through to the object path (evaluate()
            # returns False row-wise there), not TypeError
            if typed is not None and typed.dtype.kind == "U":
                if op == FilterOp.CONTAINS:
                    m = np.char.find(typed, str(val)) >= 0
                else:
                    # numpy has no regex kernel; evaluate once per unique
                    # value (categorical columns have few) and scatter back
                    pat = re.compile(str(val))
                    uniq, inv = np.unique(typed, return_inverse=True)
                    hit = np.fromiter(
                        (pat.search(u) is not None for u in uniq),
                        bool, uniq.size)
                    m = hit[inv]
                m = np.asarray(m, dtype=bool) & cols.nonnull(self.field)
                return m & present
        col = cols.objects(self.field)
        if op == FilterOp.EQ:
            return present & np.fromiter(
                (c is not _MISSING and c == val for c in col), bool, len(col)
            )
        if op == FilterOp.NE:
            return present & np.fromiter(
                (c is not _MISSING and c != val for c in col), bool, len(col)
            )
        if op in (FilterOp.IN, FilterOp.NIN):
            # _cmp_scalar mirrors evaluate() exactly: `in` keeps substring
            # semantics for str targets and handles unhashable elements
            # (set(val) raised on lists and per-char'd strings)
            return present & np.fromiter(
                (c is not _MISSING and _cmp_scalar(op, c, val)
                 for c in col), bool, len(col))
        if op == FilterOp.CONTAINS:
            sub = str(val)
            return present & np.fromiter(
                (isinstance(c, str) and sub in c for c in col), bool, len(col)
            )
        if op == FilterOp.REGEX:
            pat = re.compile(str(val))
            return present & np.fromiter(
                (isinstance(c, str) and pat.search(c) is not None for c in col),
                bool, len(col),
            )
        # generic comparison ops on non-numeric targets: row-wise fallback
        return present & np.fromiter(
            (c is not _MISSING and _cmp_scalar(op, c, val) for c in col),
            bool, len(col),
        )

    def to_dict(self) -> dict:
        return {"type": "cond", "op": self.op.value, "field": self.field,
                "value": self.value}


class And(Filter):
    def __init__(self, filters: List[Filter]):
        self.filters = filters

    def evaluate(self, metadata: Optional[dict]) -> bool:
        return all(f.evaluate(metadata) for f in self.filters)

    def mask(self, cols: ColumnView) -> np.ndarray:
        m = np.ones(len(cols), dtype=bool)
        for f in self.filters:
            m &= f.mask(cols)
        return m

    def to_dict(self) -> dict:
        return {"type": "and", "filters": [f.to_dict() for f in self.filters]}


class Or(Filter):
    def __init__(self, filters: List[Filter]):
        self.filters = filters

    def evaluate(self, metadata: Optional[dict]) -> bool:
        return any(f.evaluate(metadata) for f in self.filters)

    def mask(self, cols: ColumnView) -> np.ndarray:
        m = np.zeros(len(cols), dtype=bool)
        for f in self.filters:
            m |= f.mask(cols)
        return m

    def to_dict(self) -> dict:
        return {"type": "or", "filters": [f.to_dict() for f in self.filters]}


class Not(Filter):
    def __init__(self, f: Filter):
        self.f = f

    def evaluate(self, metadata: Optional[dict]) -> bool:
        return not self.f.evaluate(metadata)

    def mask(self, cols: ColumnView) -> np.ndarray:
        return ~self.f.mask(cols)

    def to_dict(self) -> dict:
        return {"type": "not", "filter": self.f.to_dict()}


def filter_from_tree(d: Optional[dict]) -> Optional[Filter]:
    """Inverse of Filter.to_dict (used by the REST server)."""
    if d is None:
        return None
    t = d.get("type")
    if t == "cond":
        return Condition(FilterOp(d["op"]), d["field"], d["value"])
    if t == "and":
        return And([filter_from_tree(x) for x in d["filters"]])
    if t == "or":
        return Or([filter_from_tree(x) for x in d["filters"]])
    if t == "not":
        return Not(filter_from_tree(d["filter"]))
    raise ValueError(f"bad filter tree: {d!r}")
