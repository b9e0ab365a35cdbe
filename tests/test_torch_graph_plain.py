"""The port's graph index against the benchmark's plain beam-search
reference (``portbench/reference_graph.py``), on the CPU at a small size:
the benchmark's clustered rows from a seed, 20,000 x 64, degree 16, 64
medoid entries, float32 compute, cosine and l2.  The comparison holds the
answers to the reference's beam (``missed_vs_beam``) and each score to its
row's float64 distance (``score_gap``); bf16 scores, half the rounds, half
the expansion and one entry point fail it.  Also the graph search's spans
and its ``last_scored`` counter, and the two per-layer readers of the
``graph-b1`` cell on a profiler trace of it."""

import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fastpyvectordb_tpu_torch import Collection, CollectionConfig
from portbench import data, reference, spec, tracing
from portbench import reference_graph as ref
from tools.graph_check import fault as planted

ROWS, DIMS, QUERIES, K = 20_000, 64, 128, 10
BUILD = {"r": 16, "n_entries": 64, "beam": 32, "expand": 4, "iters": 8,
         "n_init": 16, "tune": False}
DATA = {"generator": "clustered", "centers": 64, "center_scale": 2.0,
        "row_noise": 1.0, "normalize": True, "query_noise": 0.5}
SEED = 2 ** 31 + 7
ROOT = Path(__file__).resolve().parents[1]
SPANS = ("fpv.ann.upload", "fpv.ann.route", "fpv.ann.beam",
         "fpv.ann.finish", "fpv.ann.fetch")
READERS = ("idle_ms.ann.graph", "launches_per_call.graph_beam")


def scale_tol(scores: np.ndarray) -> np.ndarray:
    """A score's float32 rounding: 1e-5 of its size, and 1e-5 below 1 (the
    benchmark's score_gap limit); l2 distances of these rows run to ~20,
    where the norm expansion's rounding of ||q||^2 + ||v||^2 - 2 q.v shows
    in the fifth digit of the root."""
    return 1e-5 * np.maximum(np.abs(scores), 1.0)


@pytest.fixture(scope="module", params=["cosine", "l2"])
def built(request):
    x, centres = data.clustered(DATA, ROWS, DIMS, SEED, "cpu")
    x = x.numpy()
    q = data.queries(DATA, centres, QUERIES, SEED, data.POOL)
    col = Collection(CollectionConfig(name="g", dimensions=DIMS,
                                      metric=request.param,
                                      compute_dtype="float32"),
                     device="cpu")
    col.insert_batch(x, [f"v{i}" for i in range(ROWS)])
    with pytest.warns(UserWarning, match="graph"):
        col.build_ann("graph", **BUILD)
    sections, meta = col._ann.export_sections()
    return {"metric": request.param, "col": col, "ann": col._ann,
            "corpus": x, "queries": q, "index": ref.Index(sections, meta)}


@pytest.mark.parametrize("k,beam", [(K, None), (40, 16)],
                         ids=["k-below-beam", "k-above-beam"])
def test_the_port_keeps_to_the_plain_reference(built, k, beam):
    b = built
    scores, rows = b["ann"].search(b["queries"], k, beam=beam)
    want_s, want_r = ref.search(b["index"], b["corpus"], b["queries"], k,
                                b["metric"], beam=beam)
    assert rows.shape == want_r.shape == (QUERIES, k)
    got = ref.compare(scores, rows, want_r, b["corpus"], b["queries"],
                      b["metric"])
    assert ref.passes(got), got
    # two rows whose scores lie within float32 rounding of each other can
    # swap (the reference's direct scores against the port's norm
    # expansion): in order, or across the k-th place, which changes the
    # hit set, at most one query in a hundred here; the scores, sorted,
    # agree within rounding wherever the sets are the same
    same = np.array([set(a) == set(w) for a, w in zip(rows, want_r)])
    assert same.mean() >= 0.99, same.mean()
    gap = np.abs(np.sort(scores[same], axis=1).astype(np.float64)
                 - np.sort(want_s[same], axis=1))
    assert (gap <= scale_tol(want_s[same])).all(), gap.max()


@pytest.mark.parametrize("name", ["bf16_scores", "half_iters",
                                  "half_expand", "n_init=1"])
def test_a_coarser_or_shorter_beam_fails_the_comparison(built, name):
    b = built
    _, want_r = ref.search(b["index"], b["corpus"], b["queries"], K,
                           b["metric"])
    with planted(name):
        scores, rows = b["ann"].search(b["queries"], K)
    got = ref.compare(scores, rows, want_r, b["corpus"], b["queries"],
                      b["metric"])
    assert not ref.passes(got), got
    if name == "bf16_scores":
        assert got["score_gap"] > 10 * ref.SCORE_GAP


def test_the_reference_beam_finds_what_the_exact_search_finds(built):
    """A beam as wide as a hundredth of the corpus with enough rounds: the
    reference's answers are (nearly) the exact top k."""
    b = built
    q = b["queries"][:32]
    _, got = ref.search(b["index"], b["corpus"], q, K, b["metric"],
                        beam=256, iters=32)
    _, want = reference.exact_topk(b["corpus"], q, K, b["metric"], "cpu")
    hits = sum(len(set(a) & set(w)) for a, w in zip(got, want))
    assert hits / want.size >= 0.99


def test_the_reference_imports_neither_jax_nor_the_port():
    path = ROOT / "portbench" / "reference_graph.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add("." * node.level + node.module.split(".")[0])
        elif isinstance(node, ast.ImportFrom):   # from . import <module>
            names |= {"." * node.level + a.name for a in node.names}
    # the benchmark's modules it takes: the exact reference's float64
    # distances, the IVF-PQ reference's TF32 switch
    assert names <= {"__future__", "typing", "numpy", "torch", ".reference",
                     ".reference_ivfpq"}
    code = ("import sys\n"
            "for name in ('jax', 'fastpyvectordb_tpu', "
            "'fastpyvectordb_tpu_torch'):\n"
            "    sys.modules[name] = None\n"
            "import portbench.reference_graph\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'fastpyvectordb_tpu', "
            "'fastpyvectordb_tpu_torch') and sys.modules[m] is not None))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# ---------------------------------------------------------------------------
# spans, the counter, and the cell's readers
# ---------------------------------------------------------------------------

def traced(b, tmp_path, calls=3):
    """``calls`` single-query searches through the cell's entry under a CPU
    profiler, each in the benchmark's call range: (the trace's complete
    events, the answers)."""
    from torch.profiler import ProfilerActivity, profile
    out = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for qv in b["queries"][:calls]:
            with tracing.call_range():
                out.append(b["col"].search_arrays(qv[None], k=K))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"], out


def context(trace):
    return tracing.Context(trace, [], [], {"rows": ROWS, "dims": DIMS},
                           {"batch": 1, "k": K}, None)


def test_a_search_records_its_stages_inside_its_root(built, tmp_path):
    b = built
    events, got = traced(b, tmp_path)
    ann = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"]) for e in events
                 if e.get("cat") == "user_annotation"
                 and e["name"].startswith("fpv.ann."))
    roots = [(s, t) for s, t, name in ann if name == "fpv.ann.search"]
    assert len(roots) == 3
    for s, t in roots:
        inside = [name for a, z, name in ann
                  if s <= a and z <= t and name != "fpv.ann.search"]
        assert tuple(inside) == SPANS
    # the profiled calls answer as unprofiled ones do
    for qv, (ids, scores, rows) in zip(b["queries"], got):
        want = b["col"].search_arrays(qv[None], k=K)
        assert np.array_equal(rows, want[2]) and np.array_equal(ids, want[0])
        assert np.array_equal(scores, want[1])


@pytest.mark.parametrize("batch,knobs", [(1, {}), (7, {}),
                                         (3, {"iters": 3, "expand": 2}),
                                         (2, {"n_init": 5, "beam": 4})])
def test_last_scored_counts_the_rows_the_beam_scored(built, batch, knobs):
    b = built
    ann = b["ann"]
    ann.search(b["queries"][:batch], K, **knobs)
    beam = max(knobs.get("beam", ann.beam), 16)   # k = 10 widens it to 16
    e0 = min(knobs.get("n_init", ann.n_init), beam, ann.medoids.shape[0])
    per_query = e0 + (knobs.get("iters", ann.iters)
                      * knobs.get("expand", ann.expand)
                      * ann.neighbors.shape[1])
    assert ann.last_scored == batch * per_query


def test_the_cells_readers_read_the_trace(built, tmp_path):
    events, _ = traced(built, tmp_path)
    trace = tracing.Trace(events)
    assert trace.calls == 3
    for name in READERS:
        got = spec.reader(name).read(context(trace))
        assert got is not None and got >= 0.0, name
    # no kernels on the CPU: the whole window is idle, most of it under
    # the ann ranges, and the beam launches nothing
    assert spec.reader("idle_ms.ann.graph").read(context(trace)) > 0.0
    assert spec.reader("launches_per_call.graph_beam").read(
        context(trace)) == 0.0
    bare = tracing.Trace([e for e in events
                          if not e["name"].startswith("fpv.ann.")])
    assert bare.calls == 3
    for name in READERS:
        assert spec.reader(name).read(context(bare)) is None, name


def ev(cat, name, ts, dur=1, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_the_launch_reader_counts_launches_inside_the_beam_alone():
    events = [
        ev("user_annotation", tracing.CALL, 0, 100),
        ev("user_annotation", tracing.CALL, 100, 100),
        ev("user_annotation", "fpv.ann.search", 0, 90),
        ev("user_annotation", "fpv.ann.beam", 20, 50),
        ev("user_annotation", "fpv.ann.search", 100, 90),
        ev("user_annotation", "fpv.ann.beam", 120, 50),
        ev("cuda_runtime", "cudaLaunchKernel", 10, corr=1),     # route
        ev("cuda_runtime", "cudaLaunchKernel", 25, corr=2),
        ev("cuda_runtime", "cudaLaunchKernelExC", 30, corr=3),
        ev("cuda_driver", "cuLaunchKernel", 40, corr=4),
        ev("cuda_driver", "cuLaunchKernel", 41, corr=4),        # the same
        ev("cuda_runtime", "cudaMemcpyAsync", 50, corr=5),      # no kernel
        ev("cuda_runtime", "cudaLaunchKernel", 130, corr=6),
        ev("cuda_runtime", "cudaLaunchKernel", 175, corr=7),    # finish
        # another thread, inside a beam's time: not the calls' launches
        ev("cuda_runtime", "cudaLaunchKernel", 30, tid=2, corr=8),
        ev("user_annotation", "fpv.api.search", 0, 20, tid=2),
        ev("kernel", "k", 60, 5, tid=9, corr=2),
    ]
    got = spec.reader("launches_per_call.graph_beam").read(
        context(tracing.Trace(events)))
    assert got == pytest.approx(4 / 2)


@pytest.mark.parametrize("name", READERS)
def test_the_readers_manifest_entries(name):
    man = spec.manifest()
    entry = [m for m in man["per_layer"] if m["name"] == name][0]
    assert entry == {"name": name, "better": "lower", "source":
                     "device_trace", "layer": "ANN", "moves": "qps",
                     "workloads": ["graph-b1"],
                     "unit": "ms" if name.startswith("idle") else "launches"}
    cell = spec.workload(man, "graph-b1")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "cohere768-1m-graph", "b1", 1)
    config = spec.checked_config(spec.config(man, cell["config"]))
    expect = config["index"]["expect"]
    kwargs = config["index"]["build"]["kwargs"]
    assert expect["kind"] == "graph" and expect["degree"] == kwargs["r"]
    for key in ("beam", "expand", "iters", "n_init"):
        assert expect[key] == kwargs[key], key
    assert set(spec.limits("graph-b1")) == {"bad_hits", "score_gap",
                                            "missed_share"}


def test_a_small_graph_cell_is_correct_on_the_cpu():
    """The cell at a small size: the configuration's build as it stands
    (degree 32, beam 64, 8 rounds), whose entry points the build caps at
    rows / 8."""
    over = {"config": {"rows": ROWS, "dims": DIMS, "data": {"centers": 64},
                       "fill": {"batch": 5000, "capacity_rows": 24576},
                       "index": {"expect": {"nodes": ROWS,
                                            "entries": ROWS // 8}}},
            "traffic": {"pool_queries": 512, "eval_queries": 64,
                        "sample_answers": 32, "trace_calls": 4}}
    from portbench import harness
    result, _ = harness.run("graph-b1", SEED, 0.3, False,
                            t_start=time.perf_counter(), device="cpu",
                            overrides=over)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) >= {"qps", "recall_at_10", "setup_s"}
