"""The 10M IVF-PQ cell and the k = 100 cell at small sizes on the CPU: the
program is correct, the TF32 control and broken timed paths are not, the
readers of ``b7_roofline`` and ``idle_ms.ann.ivfpq`` read what they say."""

import time

import numpy as np
import pytest

from fastpyvectordb_tpu_torch.ann import ivf_grouped, ivfpq
from fastpyvectordb_tpu_torch.core.collection import Collection
from portbench import checks, harness, spec
from portbench.tracing import Context, Trace

MAN = spec.manifest()
PQ, K100 = "ivfpq10m-b1024", "int8-b1024-k100"
SMALL = {"config": {"rows": 20000, "dims": 64, "data": {"centers": 64},
                    "fill": {"batch": 5000, "capacity_rows": 24576},
                    # 4-dim subspaces, as the cell's 768 dims in 192
                    "index": {"build": {"kwargs": {"m": 16}},
                              "expect": {"nlist": 282, "cmax": 256,
                                         "m": 16}}},
         "traffic": {"pool_queries": 4096, "eval_queries": 256,
                     "sample_answers": 64, "trace_calls": 4}}
SEED = 2 ** 31 + 101


def system(seed=SEED):
    wl = spec.workload(MAN, PQ)
    config = spec.merged(spec.config(MAN, wl["config"]), SMALL["config"])
    return harness.System(config, seed, "cpu")


def run(cell=PQ, seed=SEED):
    over = SMALL if cell == PQ else {"config": {
        k: v for k, v in SMALL["config"].items() if k != "index"},
        "traffic": SMALL["traffic"]}
    result, _ = harness.run(cell, seed, 0.3, False,
                            t_start=time.perf_counter(), device="cpu",
                            overrides=over)
    return result


def test_the_ivfpq_cell_states_the_index_it_builds():
    s = system()
    assert s.report["kind"] == "ivfpq" and s.report["nprobe"] == 32
    assert s.report["rerank"] == 32 and s.report["pq_k"] == 256


@pytest.mark.parametrize("cell", [PQ, K100])
def test_the_program_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0


def test_the_control_is_not_correct():
    wl = spec.workload(MAN, PQ)
    config = spec.merged(spec.config(MAN, wl["config"]), SMALL["config"])
    traffic = spec.merged(spec.traffic(wl["traffic"]), SMALL["traffic"])
    s = harness.System(config, SEED, "cpu")
    m = harness.measure(s, traffic, 0.3, False, [], time.perf_counter())
    s.close()
    out = harness.judge(s, m, traffic, SEED, control=True)
    assert checks.verdict(out["numbers"], spec.limits(PQ))
    assert not checks.verdict(out["control"], spec.limits(PQ))


def stale(monkeypatch):
    orig = Collection.search_arrays
    last = {}

    def search(self, queries, **kw):
        out = orig(self, queries, **kw)
        prev = last.get("out", out)
        last["out"] = out
        return prev if len(prev[0]) == len(out[0]) else out
    monkeypatch.setattr(Collection, "search_arrays", search)


def altered(monkeypatch):
    orig = ivf_grouped.gather_rerank

    def gather_rerank(*args, **kw):
        d, r = orig(*args, **kw)
        r = r.clone()
        r[:, 0] += 1
        return d, r
    for module in (ivf_grouped, ivfpq):
        monkeypatch.setattr(module, "gather_rerank", gather_rerank)


@pytest.mark.parametrize("fault", [stale, altered])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not run()["correct"]


def test_the_k100_traffic_is_b1024_at_k_100():
    base, k100 = spec.traffic("b1024"), spec.traffic("b1024-k100")
    assert k100.pop("k") == 100 and base.pop("k") == 10
    assert {**k100, "why": ""} == {**base, "why": ""}
    assert spec.checked_traffic(spec.traffic("b1024-k100"))


def test_b7_cost_counts_each_probed_cell_once():
    b7 = spec.reader("b7_roofline")
    adds, nbytes = b7.b7_cost(96, 256, 1024, [100, 200], [100, 100, 200])
    assert adds == 96 * 400
    assert nbytes == 300 * 96 + 2 * 1024 * 96 * 256 + 4 * 400


def test_b7_readers_routing_holds_the_programs_answers():
    s = system()
    b7 = spec.reader("b7_roofline")
    b3 = spec.reader("b3_roofline")
    sections, _ = s.collection._ann.export_sections()
    q = s.queries(1024, 1)
    rows = s.entry(10)(q)[2]
    import torch
    _, wide = b7.reference_ivfpq.probed(
        torch.as_tensor(sections["ann_centroids"]), torch.as_tensor(q),
        32, "cosine")
    table, overflow = sections["ann_row_table"], sections[
        "ann_overflow_rows"]
    assert b3.outside(wide.numpy(), rows, table, overflow) == 0
    assert b3.outside(np.roll(wide.numpy(), 1, axis=0), rows, table,
                      overflow) > 0


def test_the_ivfpq_idle_reader_needs_the_ann_ranges():
    idle = spec.reader("idle_ms.ann.ivfpq")

    def ctx(name):
        events = [{"ph": "X", "cat": "user_annotation",
                   "name": "portbench.call", "ts": 0, "dur": 100,
                   "pid": 1, "tid": 1},
                  {"ph": "X", "cat": "user_annotation", "name": name,
                   "ts": 10, "dur": 50, "pid": 1, "tid": 1},
                  {"ph": "X", "cat": "kernel", "name": "k", "ts": 70,
                   "dur": 30, "pid": 0, "tid": 7}]
        return Context(Trace(events), [], [], {"rows": 1, "dims": 1},
                       {"k": 10}, None)
    assert idle.read(ctx("fpv.api.search")) is None
    assert idle.read(ctx("fpv.ann.search")) == pytest.approx(0.05)
