"""The comparison that decides ``correct``, and recall.

Answers are ``(ids, scores, rows)`` as ``search_arrays`` returns them,
stacked over the checked queries.  Two numbers are compared, each against
the cell's limit (``limits/<workload>.json``):

- ``bad_hits``: slots that break a guarantee the configuration states (a
  row out of range or missing, an id that is not the one inserted with its
  row, a row twice in one answer, a score that is not finite or that sorts
  before its predecessor).  An exact comparison: its limit is 0.
- ``score_gap``: the widest gap between a hit's score and the float64
  distance of its row to its query.  The exact re-rank makes each score
  its row's float32 distance; a lower precision anywhere in it shows here.
- ``missed_share``: the share of the true k nearest rows (the reference's
  exact top k) that the answers leave out, over every checked query.  The
  two numbers above pass whatever rows the candidate stage hands to the
  re-rank; this one holds the candidate stage (the scan, the routing, the
  cell scores, the re-rank's depth) to the truth.
- ``missed_reachable`` (IVF): the same share against the exact top k of
  the rows each query's probed cells and the overflow block hold
  (``reference.reachable_topk``).  IVF leaves out ~2.5% of the true top k
  by design (its routing), which no fault of the later stages moves far;
  against what the partition lets it reach, a sound run leaves out almost
  nothing.
- ``partition_faults`` (IVF): rows that the partition holds other than
  once (in no cell and not in the overflow block, or twice), or that are
  out of range: the start that ``missed_reachable`` follows, checked by
  itself.  Exact: limit 0.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from . import reference


def stack(answers) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    ids, scores, rows = zip(*answers)
    return (np.concatenate(ids), np.concatenate(scores),
            np.concatenate(rows))


def compare(answers, queries: np.ndarray, corpus: np.ndarray,
            metric: str, names: np.ndarray, truth: np.ndarray
            ) -> Dict[str, float]:
    """``names`` the id inserted with each row; ``truth`` the reference's
    exact top-k rows of each query."""
    ids, scores, rows = answers
    n = corpus.shape[0]
    rows = np.asarray(rows, np.int64)
    scores = np.asarray(scores, np.float32)
    in_range = (rows >= 0) & (rows < n)
    expected = names[np.where(in_range, rows, 0)]
    bad = ~in_range | (ids != expected) | ~np.isfinite(scores)
    bad[:, 1:] |= scores[:, 1:] < scores[:, :-1]
    srt = np.sort(rows, axis=1)
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0) & (srt[:, 1:] < n)
    ref = reference.distances(corpus, queries, np.where(in_range, rows, 0),
                              metric)
    gap = np.abs(scores.astype(np.float64) - ref)[in_range & np.isfinite(
        scores)]
    return {"bad_hits": int(bad.sum() + dup.sum()),
            "score_gap": float(gap.max()) if gap.size else float("inf"),
            "missed_share": 1.0 - recall(rows, truth)}


def partition_faults(row_table: np.ndarray, overflow_rows: np.ndarray,
                     n: int) -> int:
    rows = np.concatenate([np.asarray(row_table).reshape(-1),
                           np.asarray(overflow_rows).reshape(-1)])
    rows = rows[rows >= 0].astype(np.int64)
    counts = np.bincount(rows[rows < n], minlength=n)
    return int((counts != 1).sum() + (rows >= n).sum())


def recall(rows: np.ndarray, truth: np.ndarray) -> float:
    """Mean share of each query's true k nearest rows among its hits."""
    k = truth.shape[1]
    hits = [len(set(a.tolist()) & set(t.tolist()))
            for a, t in zip(np.asarray(rows), np.asarray(truth))]
    return float(np.mean(hits)) / k


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[name] <= limits[name] for name in limits)
