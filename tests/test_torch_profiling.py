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
