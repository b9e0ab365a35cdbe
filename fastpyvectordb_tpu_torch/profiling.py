"""Tracing / profiling utilities (port of ``fastpyvectordb_tpu/profiling.py``).

  * ``QueryTimer`` — reservoir-sampled latency recorder with p50/p95/p99
    and JSON export (the JAX package's, unchanged: the same reservoir and
    the same ``random.Random(seed)``).
  * ``trace`` — context manager around ``torch.profiler`` (CPU activity,
    plus CUDA activity when a card is present) writing a Chrome trace
    (Perfetto / chrome://tracing) into ``log_dir``.
  * ``annotate`` — named region inside a trace (``record_function``, plus
    an NVTX range when a card is present).
"""

from __future__ import annotations

import contextlib
import json
import random
import time
from pathlib import Path
from typing import Iterator

import numpy as np


class QueryTimer:
    """Thread-compatible latency recorder with reservoir sampling."""

    def __init__(self, capacity: int = 10_000, seed: int = 0):
        self.capacity = capacity
        self.samples: list = []
        self.count = 0
        self.total = 0.0
        self._rng = random.Random(seed)

    @contextlib.contextmanager
    def measure(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(time.perf_counter() - t0)

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total += seconds
        if len(self.samples) < self.capacity:
            self.samples.append(seconds)
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self.samples[j] = seconds

    def summary(self) -> dict:
        if not self.samples:
            return {"count": 0}
        arr = np.asarray(self.samples)
        return {
            "count": self.count,
            # exact running mean — the reservoir is for percentiles only
            "mean_ms": float(self.total / self.count * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "p99_ms": float(np.percentile(arr, 99) * 1e3),
            "qps": self.count / self.total if self.total else 0.0,
        }

    def export(self, path) -> None:
        Path(path).write_text(json.dumps(self.summary(), indent=2))

    def reset(self) -> None:
        self.samples.clear()
        self.count = 0
        self.total = 0.0


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str = "fvdb_trace", device=None) -> Iterator[str]:
    """Capture a trace of the enclosed code into ``log_dir/trace.json``:
    host activity, and the card's kernels unless ``device="cpu"``
    (``device=None`` means the card and raises without one, as every
    entry point of the package).  On exit the card is synchronized and
    the trace exported."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .utils import resolve_device
    cuda = resolve_device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        try:
            yield str(out)
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside an active trace (host timeline; an NVTX range
    on the card's timeline too when a card is present)."""
    import torch
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
