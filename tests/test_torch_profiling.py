"""The port's profiling module (fastpyvectordb_tpu_torch/profiling.py):
``QueryTimer`` against the JAX package's on the same samples and seed,
and ``trace`` / ``annotate`` writing a Chrome trace on the CPU."""

import json

import numpy as np
import pytest
import torch

from fastpyvectordb_tpu import profiling as jprof
from fastpyvectordb_tpu_torch import profiling as tprof


@pytest.mark.parametrize("capacity,n", [(8, 20), (64, 1000), (10_000, 50)])
def test_query_timer_summary_matches_jax(capacity, n):
    samples = np.random.default_rng(capacity).exponential(0.003, n)
    jt = jprof.QueryTimer(capacity=capacity, seed=7)
    tt = tprof.QueryTimer(capacity=capacity, seed=7)
    for s in samples:
        jt.add(float(s))
        tt.add(float(s))
    # the same reservoir: the same kept samples, so the same percentiles
    assert tt.samples == jt.samples
    assert tt.summary() == jt.summary()


def test_query_timer_measure_export_reset(tmp_path):
    t = tprof.QueryTimer(capacity=8)
    for _ in range(20):
        with t.measure():
            pass
    s = t.summary()
    assert s["count"] == 20 and s["qps"] > 0
    assert 0 <= s["p50_ms"] <= s["p99_ms"]
    t.export(tmp_path / "s.json")
    assert json.loads((tmp_path / "s.json").read_text())["count"] == 20
    t.reset()
    assert t.summary() == {"count": 0}


def test_trace_writes_chrome_trace_with_annotation(tmp_path):
    from fastpyvectordb_tpu_torch import Collection, CollectionConfig
    col = Collection(CollectionConfig(name="p", dimensions=8), device="cpu")
    col.insert_batch(np.eye(8, dtype=np.float32), list("abcdefgh"))
    with tprof.trace(str(tmp_path / "tr"), device="cpu") as d:
        with tprof.annotate("fvdb_search_region"):
            col.search_arrays(np.eye(8, dtype=np.float32), k=2)
    path = tmp_path / "tr" / tprof.TRACE_FILE
    assert d == str(tmp_path / "tr") and path.exists()
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "fvdb_search_region" in names
    assert any(n and n.startswith("aten::") for n in names)


def test_trace_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        with tprof.trace(str(tmp_path)):
            torch.ones(4, device="cuda").sum()
        assert (tmp_path / tprof.TRACE_FILE).exists()
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            with tprof.trace(str(tmp_path)):
                pass


# ---------------------------------------------------------------------------
# The search path's spans: ``fpv.<layer>.<stage>`` through ``annotate``,
# recorded only while a profiler records
# ---------------------------------------------------------------------------
SPAN_ROWS, SPAN_DIMS = 3000, 16


@pytest.fixture(scope="module")
def span_collections():
    from fastpyvectordb_tpu_torch import Collection, CollectionConfig
    v = np.random.default_rng(5).standard_normal(
        (SPAN_ROWS, SPAN_DIMS)).astype(np.float32)
    ids = [f"v{i}" for i in range(SPAN_ROWS)]
    int8 = Collection(CollectionConfig(name="i", dimensions=SPAN_DIMS),
                      device="cpu")
    int8.insert_batch(v, ids)
    int8.enable_quantized_scan("int8", tune=False)
    ivf = Collection(CollectionConfig(name="f", dimensions=SPAN_DIMS),
                     device="cpu")
    ivf.insert_batch(v, ids)
    ivf.build_ann("ivf", nlist=16, nprobe=4, cell_dtype="int8", tune=False)
    pq = Collection(CollectionConfig(name="p", dimensions=SPAN_DIMS),
                    device="cpu")
    pq.insert_batch(v, ids)
    # one spill choice and a tight cell cap leave rows in the overflow block
    pq.build_ann("ivfpq", nlist=32, nprobe=4, tune=False,
                 max_cell_factor=1.05, spill_choices=1)
    assert pq._ann.stats()["overflow_rows"] > 0
    return {"int8": int8, "ivf": ivf, "ivfpq": pq, "queries": v[:64] + 0.01}


# the search (one request), and the spans it records besides its root
SEARCHES = {
    "int8": (lambda c: c["int8"].search_quantized_arrays(c["queries"], k=5),
             {"fpv.api.assemble", "fpv.scan.search", "fpv.scan.upload",
              "fpv.scan.coarse", "fpv.scan.rerank", "fpv.scan.fetch"}),
    # 64 queries x nprobe 4 >= nlist 16: cell-major
    "ivf_grouped": (
        lambda c: c["ivf"].search_arrays(c["queries"], k=5, exact=False),
        {"fpv.api.assemble", "fpv.ann.search", "fpv.ann.upload",
         "fpv.ann.route", "fpv.ann.invert", "fpv.ann.score",
         "fpv.ann.regroup", "fpv.ann.finish", "fpv.ann.fetch"}),
    # one query x nprobe 4 < nlist 16: query-major
    "ivf_query_major": (
        lambda c: c["ivf"].search_arrays(c["queries"][:1], k=5, exact=False),
        {"fpv.api.assemble", "fpv.ann.search", "fpv.ann.upload",
         "fpv.ann.route", "fpv.ann.gather_score", "fpv.ann.finish",
         "fpv.ann.fetch"}),
    "ivfpq_grouped": (
        lambda c: c["ivfpq"].search_arrays(c["queries"], k=5, exact=False),
        {"fpv.api.assemble", "fpv.ann.search", "fpv.ann.upload",
         "fpv.ann.route", "fpv.ann.invert", "fpv.ann.lut", "fpv.ann.score",
         "fpv.ann.regroup", "fpv.ann.overflow", "fpv.ann.finish",
         "fpv.ann.fetch"}),
    "ivfpq_query_major": (
        lambda c: c["ivfpq"].search_arrays(c["queries"][:1], k=5,
                                           exact=False),
        {"fpv.api.assemble", "fpv.ann.search", "fpv.ann.upload",
         "fpv.ann.route", "fpv.ann.lut", "fpv.ann.score", "fpv.ann.overflow",
         "fpv.ann.finish", "fpv.ann.fetch"}),
}


def _fpv_events(path):
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("name", "").startswith("fpv.")]


@pytest.mark.parametrize("search", sorted(SEARCHES))
def test_search_records_its_spans_nested_in_one_root(tmp_path, search,
                                                     span_collections):
    run, children = SEARCHES[search]
    with tprof.trace(str(tmp_path), device="cpu"):
        run(span_collections)
    events = _fpv_events(tmp_path / tprof.TRACE_FILE)
    roots = [e for e in events if e["name"] == "fpv.api.search"]
    assert len(roots) == 1
    root = roots[0]
    rest = [e for e in events if e is not root]
    # the plain versions run on the CPU: no kernel wrapper span
    assert {e["name"] for e in rest} == children
    for e in rest:
        assert e["tid"] == root["tid"]
        assert root["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= root["ts"] + root["dur"]


@pytest.mark.parametrize("search", sorted(SEARCHES))
def test_spans_cost_no_record_function_while_no_profiler_records(
        tmp_path, monkeypatch, search, span_collections):
    run, children = SEARCHES[search]
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    plain = run(span_collections)
    assert entered == []
    with tprof.trace(str(tmp_path), device="cpu"):
        traced = run(span_collections)
    assert set(entered) == children | {"fpv.api.search"}
    # a recording profiler changes no answer, bit for bit
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)


def test_annotate_is_a_shared_no_op_outside_a_profiler(tmp_path):
    assert not torch._C._autograd._profiler_enabled()
    off = tprof.annotate("fvdb_outside")
    assert off is tprof.annotate("another") and off.__enter__() is None
    with tprof.trace(str(tmp_path), device="cpu"):
        on = tprof.annotate("fvdb_inside")
        assert off is not on
        with on:
            torch.ones(2).sum()
    names = {e.get("name") for e in json.loads(
        (tmp_path / tprof.TRACE_FILE).read_text())["traceEvents"]}
    assert "fvdb_inside" in names and "fvdb_outside" not in names
