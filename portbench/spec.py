"""The benchmark's manifest (``BENCHMARK.json`` at the checkout's root) and
the files it names: a configuration, a traffic mix, a cell's limits and a
per-layer metric's reader are each found by name, so a cell or a metric
is added with files and entries alone.

    configs/<config>.json      sizes, data, collection, index build and search
    traffic/<traffic>.json     batch, k, query pool, warm-up, sample sizes
    limits/<workload>.json     the limits of the numbers that decide ``correct``
    metrics/<metric>.py        ``read(ctx)`` -> a number, or None

``checked_config`` and ``checked_traffic`` refuse a file with a key this
harness does not read, or a value it does not implement (an open loop,
several callers, a filter): such a cell fails at once rather than
measuring something other than what its file says.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _named(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(man: dict, name: str) -> dict:
    return _named(man["workloads"], name, "workload")


def config(man: dict, name: str) -> dict:
    """The configuration's file, as run."""
    entry = _named(man["configs"], name, "config")
    return json.loads((ROOT / entry["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def limits(workload_name: str) -> dict:
    return json.loads((HERE / "limits" / f"{workload_name}.json").read_text())


CONFIG_KEYS = {
    "": {"name", "source", "case", "rows", "dims", "metric", "dtype", "data",
         "fill", "collection", "index", "guarantees", "reduced", "assumed"},
    "data": {"generator", "centers", "center_scale", "row_noise",
             "normalize", "query_noise"},
    "fill": {"batch", "ids", "capacity_rows", "why"},
    "index": {"build", "search", "expect"},
}
TRAFFIC_KEYS = {"loop", "clients", "batch", "k", "filter", "pool_queries",
                "warmup_calls", "eval_queries", "sample_answers",
                "trace_calls", "why"}
# the one value of each of these that the harness implements
TRAFFIC_ONLY = {"loop": "closed", "clients": 1, "filter": None}
CONFIG_ONLY = {("data", "generator"): "clustered", ("fill", "ids"): "v<row>"}


def _keys(what: str, got: dict, allowed: set, required: set) -> None:
    extra, missing = set(got) - allowed, required - set(got)
    if extra or missing:
        raise ValueError(f"{what}: keys {sorted(extra)} are not read by the "
                         f"harness; {sorted(missing)} are missing")


def checked_config(c: dict) -> dict:
    """``c`` if every key is one the harness reads, with the generator and
    ids it implements, and its collection is of the metric and float type
    the file states."""
    for part, allowed in CONFIG_KEYS.items():
        got = c if not part else c[part]
        _keys(f"config {c.get('name')!r} {part or 'top level'}", got,
              allowed, allowed - {"expect", "why", "case"})
    for (part, key), only in CONFIG_ONLY.items():
        if c[part][key] != only:
            raise ValueError(f"config {c['name']!r} {part}.{key} = "
                             f"{c[part][key]!r}: the harness implements "
                             f"only {only!r}")
    coll = c["collection"]
    if coll.get("metric") != c["metric"] or \
            coll.get("storage_dtype") != c["dtype"]:
        raise ValueError(f"config {c['name']!r}: the collection is not the "
                         f"stated {c['metric']} {c['dtype']}")
    return c


def checked_traffic(t: dict) -> dict:
    """``t`` if every key is one the harness reads, with values it
    implements."""
    _keys("traffic", t, TRAFFIC_KEYS, TRAFFIC_KEYS)
    for key, only in TRAFFIC_ONLY.items():
        if t[key] != only:
            raise ValueError(f"traffic {key} = {t[key]!r}: the harness "
                             f"implements only {only!r}")
    return t


def applies(metric: dict, workload_name: str) -> bool:
    return workload_name in metric.get("workloads", [workload_name])


def metrics(man: dict, workload_name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` False) or its per-layer
    metrics (``trace`` True), in manifest order."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in man[kind] if applies(m, workload_name)]


def reader(name: str) -> ModuleType:
    """``metrics/<name>.py`` as a module (its name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def merged(base: dict, over: Optional[dict]) -> dict:
    """``base`` with ``over``'s keys put in, nested dicts merged (the tests'
    small sizes)."""
    out = dict(base)
    for key, value in (over or {}).items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merged(out[key], value)
        else:
            out[key] = value
    return out
