"""The traced stretch of a ``--trace 1`` run and what the per-layer readers
read from it.

``capture`` follows the pattern of the program's ``profiling.trace``
(copied, not called): ``torch.profiler`` with CPU and CUDA activity, the
card synchronised before the profiler stops, the Chrome trace exported
(here into a temporary directory, read back and deleted).  Each traced
call is wrapped in a ``portbench.call`` range; the traced window runs from
the first call's start to the last call's end on the trace's own clock.
"""

from __future__ import annotations

import contextlib
import json
import re
import tempfile
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

CALL = "portbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
UNTRACED = "host code outside torch ops (Python, numpy)"
NAME_CHARS = 160


class Trace:
    """Complete events of one traced stretch (Chrome trace, microseconds)."""

    def __init__(self, events: List[dict]):
        x = [e for e in events if e.get("ph") == "X" and "dur" in e]
        calls = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in x if e.get("cat") == "user_annotation"
                       and e.get("name") == CALL)
        self.calls = len(calls)
        self.start = calls[0][0] if calls else 0.0
        self.end = max(c[1] for c in calls) if calls else 0.0
        self.device = [e for e in x if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.device if e.get("cat") == "kernel"]
        self.host = [e for e in x if e.get("cat") in HOST_CATS
                     and e.get("name") != CALL]

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The device's busy time in the window, as disjoint intervals."""
        spans = sorted((max(float(e["ts"]), self.start),
                        min(float(e["ts"]) + float(e["dur"]), self.end))
                       for e in self.device)
        out: List[Tuple[float, float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_us(self, match: Callable[[str], bool]) -> float:
        return sum(float(e["dur"]) for e in self.kernels if match(e["name"]))

    def launches(self) -> int:
        return len(self.kernels)

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time: [name, seconds]."""
        tot: Dict[str, float] = {}
        for e in self.device:
            name = e["name"][:NAME_CHARS]
            tot[name] = tot.get(name, 0.0) + float(e["dur"])
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[name, us / 1e6] for name, us in best]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle time of the device by what the host was doing: each gap goes
        to the innermost host event that covers half of it or more."""
        tot: Dict[str, float] = {}
        cursor = self.start
        gaps = []
        for a, b in self.busy_intervals() + [(self.end, self.end)]:
            if a > cursor:
                gaps.append((cursor, a))
            cursor = max(cursor, b)
        host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"][:NAME_CHARS]) for e in self.host)
        nxt, active = 0, []
        for a, b in gaps:   # in time order: sweep the host events once
            while nxt < len(host) and host[nxt][0] < b:
                active.append(host[nxt])
                nxt += 1
            active = [h for h in active if h[1] > a]
            label, best = UNTRACED, None
            for s, t, name in active:
                cover = min(b, t) - max(a, s)
                if cover >= 0.5 * (b - a) and (best is None
                                               or t - s < best):
                    label, best = name, t - s
            tot[label] = tot.get(label, 0.0) + (b - a)
        ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[name, us / 1e6] for name, us in ranked]


class Capture:
    trace: Optional[Trace] = None


@contextlib.contextmanager
def capture(device) -> Iterator[Capture]:
    """Trace the enclosed calls; ``.trace`` is set on exit."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Capture()
    with profile(activities=acts) as prof:
        try:
            yield out
        finally:
            if cuda:
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="portbench_trace_") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    out.trace = Trace(events)


def call_range():
    return torch.profiler.record_function(CALL)


def matcher(pattern: str) -> Callable[[str], bool]:
    rx = re.compile(pattern)
    return lambda name: rx.search(name) is not None


class Context:
    """What a per-layer reader gets: the traced stretch, the calls' shapes
    and queries, the cell's files, the program under test (for the
    geometry a kernel's work depends on), and the latencies of the window's
    calls outside the traced stretch (host clock, seconds)."""

    def __init__(self, trace: Trace, queries: list, answers: list,
                 config: dict, traffic: dict, collection,
                 latency_s: Optional[List[float]] = None):
        self.trace = trace
        self.latency_s = list(latency_s or [])
        self.queries = queries          # the traced calls' query batches
        self.answers = answers          # and their (ids, scores, rows)
        self.config = config
        self.traffic = traffic
        self.collection = collection
        self.rows = int(config["rows"])
        self.dims = int(config["dims"])
        self.k = int(traffic["k"])


def idle_share(ctx: Context) -> Optional[float]:
    """Percent of the traced window in which the device ran no kernel and
    no copy."""
    if not ctx.trace.device or ctx.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / ctx.trace.window_us)


def launches_per_call(ctx: Context) -> Optional[float]:
    if not ctx.trace.kernels or not ctx.trace.calls:
        return None
    return ctx.trace.launches() / ctx.trace.calls
