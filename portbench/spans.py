"""The card's idle time in the traced window, split by the program layer
the host was in: what the ``idle_ms.<layer>.<mix>`` readers read.

The program records a ``record_function`` range named
``fpv.<layer>.<stage>`` at each layer boundary of its search path (its
``profiling.annotate``), so the ranges sit in the same profiler trace as
the card's kernels, on the same clock.  Each instant of the window in which
the card runs no kernel and no copy goes to the innermost ``fpv.*`` range
open at that instant, on the thread that ran the calls (the thread that
holds the most ``fpv.*`` time); that range's layer word gets it, and time
under no range goes to ``outside``.  So the layers and ``outside`` sum to
the window's idle time.  A trace with no such range (a program that records
none) gives None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from portbench.tracing import Context, Trace

PREFIX = "fpv."
OUTSIDE = "outside"


def _spans(trace: Trace) -> List[Tuple[float, float, str]]:
    """The window's ``fpv.*`` host ranges of the calls' thread, clipped to
    the window: (start, end, layer word), by start."""
    by_thread: Dict[tuple, list] = {}
    for e in trace.host:
        name = e.get("name", "")
        if e.get("cat") != "user_annotation" or not name.startswith(PREFIX):
            continue
        s = max(float(e["ts"]), trace.start)
        t = min(float(e["ts"]) + float(e["dur"]), trace.end)
        if t > s:
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(
                (s, t, name.split(".")[1]))
    if not by_thread:
        return []
    calls = max(by_thread.values(), key=lambda v: sum(t - s for s, t, _ in v))
    return sorted(calls)


def _idle(trace: Trace) -> List[Tuple[float, float]]:
    """The window's idle intervals: the complement of the busy ones."""
    out, cursor = [], trace.start
    for a, b in trace.busy_intervals() + [(trace.end, trace.end)]:
        if a > cursor:
            out.append((cursor, a))
        cursor = max(cursor, b)
    return out


def idle_us(trace: Trace) -> Optional[Dict[str, float]]:
    """Idle microseconds of the window by layer word, and ``outside``
    (None without ``fpv.*`` ranges)."""
    spans = _spans(trace)
    if not spans:
        return None
    idle = _idle(trace)
    cuts = sorted({x for s, t, _ in spans for x in (s, t)}
                  | {x for a, b in idle for x in (a, b)})
    out: Dict[str, float] = {OUTSIDE: 0.0}
    active: list = []
    nxt = gap = 0
    for x0, x1 in zip(cuts, cuts[1:]):
        while gap < len(idle) and idle[gap][1] <= x0:
            gap += 1
        if gap == len(idle):
            break
        while nxt < len(spans) and spans[nxt][0] <= x0:
            active.append(spans[nxt])
            nxt += 1
        active = [sp for sp in active if sp[1] > x0]
        if idle[gap][0] > x0:     # the card is busy in [x0, x1]
            continue
        # innermost: the latest to open, the shorter at equal starts
        layer = max(active, key=lambda sp: (sp[0], -sp[1]))[2] \
            if active else OUTSIDE
        out[layer] = out.get(layer, 0.0) + (x1 - x0)
    return out


def idle_ms_per_call(ctx: Context, layer: str) -> Optional[float]:
    """The window's idle milliseconds under ``fpv.<layer>.*`` ranges, per
    traced call (None when the trace holds no ``fpv.*`` range)."""
    split = idle_us(ctx.trace)
    if split is None or not ctx.trace.calls:
        return None
    return split.get(layer, 0.0) / 1e3 / ctx.trace.calls


def reader(layer: str):
    """A ``read(ctx)`` for one layer word."""
    return lambda ctx: idle_ms_per_call(ctx, layer)
