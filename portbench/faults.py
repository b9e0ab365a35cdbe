"""Faults planted in the program's timed path, each a context manager:
what the comparison that decides ``correct`` has to catch.  Used by
``calibrate`` (the readings that the limits are set from, on the card)
and by the tests (on the CPU).  Never used by a benchmark run.

    half_codes       the int8 scan (``s8_topc``) reads the first half of the
                     codes only
    shallow_coarse   the int8 scan keeps a quarter of the candidates (c / 4:
                     k, a re-rank depth of 1 in place of 4) for the re-rank
    half_probes      IVF probes half of ``nprobe`` cells
    shallow_rerank   IVF re-ranks a quarter of its candidates (depth 1 in
                     place of 4)

``FOR_INDEX`` names those that apply to a configuration, by its index's
build method.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Tuple


def _int8_topc(change: Callable) -> Tuple[object, str, Callable]:
    from fastpyvectordb_tpu_torch.quant import scan

    def wrap(orig):
        def int8_topc(q, codes, vmin, scale, vsq, rinv, mask, *, c, metric):
            args, c = change(codes, vsq, rinv, mask, c)
            return orig(q, args[0], vmin, scale, *args[1:], c=c,
                        metric=metric)
        return int8_topc
    return scan, "int8_topc", wrap


def _ivf_search(change: Callable) -> Tuple[object, str, Callable]:
    from fastpyvectordb_tpu_torch.ann.ivf import IVFIndex

    def wrap(orig):
        def search(self, queries, k, *args, **kw):
            return orig(self, queries, k, *args, **change(self, kw))
        return search
    return IVFIndex, "search", wrap


def _half(codes, vsq, rinv, mask, c):
    h = codes.shape[0] // 2
    return (codes[:h], vsq[:h], rinv[:h],
            None if mask is None else mask[:h]), c


FAULTS: Dict[str, Callable[[], Tuple[object, str, Callable]]] = {
    "half_codes": lambda: _int8_topc(_half),
    "shallow_coarse": lambda: _int8_topc(
        lambda codes, vsq, rinv, mask, c: ((codes, vsq, rinv, mask),
                                           max(1, c // 4))),
    "half_probes": lambda: _ivf_search(lambda index, kw: {
        **kw, "nprobe": max(1, (kw.get("nprobe") or index.nprobe) // 2)}),
    "shallow_rerank": lambda: _ivf_search(lambda index, kw: {
        **kw, "rerank": max(1, (kw.get("rerank") or index.rerank) // 4)}),
}

FOR_INDEX = {"enable_quantized_scan": ("half_codes", "shallow_coarse"),
             "build_ann": ("half_probes", "shallow_rerank")}


@contextlib.contextmanager
def planted(name: str) -> Iterator[None]:
    """The program with fault ``name`` in its timed path, inside the
    block."""
    owner, attr, wrap = FAULTS[name]()
    orig = getattr(owner, attr)
    setattr(owner, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)
