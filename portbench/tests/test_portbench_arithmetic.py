"""The metric arithmetic on synthetic numbers: rates, tails, roofline
bounds at the cells' shapes, the trace reductions and the comparison."""

import numpy as np
import pytest

from portbench import checks, harness, roofline, spec, tracing


def test_rate_is_work_over_time_and_the_tail_is_over_all_calls():
    m = harness.Measurement()
    lat = np.arange(1, 201) / 1e3                 # 200 calls, 1..200 ms
    m.answers = [None] * 200
    m.latency_s = list(lat)
    m.window_s = 4.0
    m.window_peak = 5_000_000
    m.setup_s = 12.5
    out = harness.end_to_end(m, {"batch": 1024}, 1000, 0.97)
    assert out["qps"] == pytest.approx(200 * 1024 / 4.0)
    assert out["p95_ms"] == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert out["p95_ms"] == pytest.approx(190.05)
    assert out["device_bytes_per_vector"] == 5000.0
    assert out["recall_at_10"] == 0.97 and out["setup_s"] == 12.5


def test_s8_topc_bound_at_the_cells_shapes():
    ops, nbytes = roofline.s8_topc_cost(1024, 1_000_000, 768, 40)
    assert ops == 2 * 1024 * 1_000_000 * 768
    assert nbytes == 768e6 + 4e6 + 1024 * 768 + 8 * 1024 * 40
    bound = roofline.bound_s(ops, nbytes, roofline.INT8_OPS_PER_S)
    assert bound == pytest.approx(7.9474e-4, rel=1e-4)   # operations
    one = roofline.bound_s(*roofline.s8_topc_cost(1, 1_000_000, 768, 40),
                           roofline.INT8_OPS_PER_S)
    assert one == pytest.approx(772.0e6 / 3.35e12, rel=1e-3)   # bytes


def test_b3_bound_counts_each_probed_cell_once():
    cell_rows = [500, 400]                 # two distinct probed cells
    pair_rows = [500, 500, 400]            # three (query, cell) pairs
    ops, nbytes = roofline.b3_cost(768, cell_rows, pair_rows)
    assert ops == 2 * 768 * 1400
    assert nbytes == 900 * (768 + 4) + 3 * 768 + 4 * 1400
    assert roofline.bound_s(ops, nbytes, roofline.INT8_OPS_PER_S) == \
        pytest.approx(nbytes / roofline.HBM_BYTES_PER_S)


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


TRACE = tracing.Trace([
    ev("user_annotation", tracing.CALL, 0, 100),
    ev("user_annotation", tracing.CALL, 100, 100),
    ev("cpu_op", "aten::topk", 10, 30),
    ev("cpu_op", "aten::to", 150, 40),
    ev("cuda_runtime", "cudaMemcpyAsync", 160, 20),
    ev("kernel", "void fpv::scan_kernel<S8TopcOp<0> >", 40, 20),
    ev("kernel", "void fpv::topc_merge_kernel<4>", 55, 10),
    ev("kernel", "gemm", 120, 10),
    ev("gpu_memcpy", "Memcpy DtoH", 180, 10),
    {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
])


def test_trace_busy_idle_and_launches():
    assert TRACE.calls == 2 and TRACE.window_us == 200
    assert TRACE.busy_intervals() == [(40, 65), (120, 130), (180, 190)]
    assert TRACE.busy_us == 45
    ctx = tracing.Context(TRACE, [np.zeros((4, 8))] * 2, [None] * 2,
                          {"rows": 10, "dims": 8}, {"batch": 4, "k": 2},
                          None)
    assert tracing.idle_share(ctx) == pytest.approx(100 * (1 - 45 / 200))
    assert tracing.launches_per_call(ctx) == 1.5
    assert TRACE.kernel_us(tracing.matcher(r"S8TopcOp|topc_merge")) == 30
    assert TRACE.device_ops()[0] == [
        "void fpv::scan_kernel<S8TopcOp<0> >", 20e-6]


def test_idle_gaps_go_to_the_innermost_host_op_covering_them():
    gaps = dict((name, s) for name, s in TRACE.idle_gaps())
    # gaps: 0-40 (topk covers 30 of 40), 65-120, 130-180 (aten::to
    # covers 40 of 50; the runtime call inside it 20), 190-200
    assert gaps["aten::topk"] == pytest.approx(40e-6)
    assert gaps["aten::to"] == pytest.approx(50e-6)
    assert gaps[tracing.UNTRACED] == pytest.approx(65e-6)
    assert sum(gaps.values()) == pytest.approx((200 - 45) * 1e-6)


def test_no_device_events_read_nothing():
    empty = tracing.Trace([ev("user_annotation", tracing.CALL, 0, 10)])
    ctx = tracing.Context(empty, [], [], {"rows": 1, "dims": 1},
                          {"batch": 1, "k": 1}, None)
    assert tracing.idle_share(ctx) is None
    assert tracing.launches_per_call(ctx) is None


def answers_of(corpus, q, k):
    d = 1 - (q @ corpus.T) / np.linalg.norm(q, axis=1)[:, None]
    rows = np.argsort(d, axis=1)[:, :k].astype(np.int32)
    ids = np.array([[f"v{r}" for r in row] for row in rows], dtype=object)
    return ids, np.take_along_axis(d, rows, 1).astype(np.float32), rows


def test_the_comparison_counts_each_broken_guarantee():
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((300, 16)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    ids, s, r = answers_of(corpus, q, 4)
    names = np.array([f"v{i}" for i in range(300)], dtype=object)

    def compare(i, s, r):
        return checks.compare((i, s, r), q, corpus, "cosine", names, r)
    good = compare(ids, s, r)
    assert good["bad_hits"] == 0 and good["score_gap"] < 1e-6
    assert good["missed_share"] == 0.0
    assert checks.recall(r, r.astype(np.int64)) == 1.0
    for broken in ("id", "dup", "order", "missing"):
        i2, s2, r2 = ids.copy(), s.copy(), r.copy()
        if broken == "id":
            i2[0, 1] = "v999"
        elif broken == "dup":
            r2[1, 2], i2[1, 2], s2[1, 2] = r2[1, 1], i2[1, 1], s2[1, 1]
        elif broken == "order":
            s2[2, 0], s2[2, 3] = s2[2, 3], s2[2, 0]
        else:
            r2[3, 3], i2[3, 3], s2[3, 3] = -1, None, np.inf
        out = compare(i2, s2, r2)
        assert out["bad_hits"] >= 1, broken
    s3 = s.copy()
    s3[4, 0] += 1e-3
    assert compare(ids, s3, r)["score_gap"] == pytest.approx(1e-3, rel=1e-2)
    assert checks.verdict({"bad_hits": 0, "score_gap": 1e-7},
                          {"bad_hits": 0, "score_gap": 1e-6})
    assert not checks.verdict({"bad_hits": 1, "score_gap": 1e-7},
                              {"bad_hits": 0, "score_gap": 1e-6})


def test_missed_share_counts_true_neighbours_left_out():
    """Rows that score exactly (each its own distance, in order) still
    miss when they are not the true nearest: the candidate stage's fault."""
    rng = np.random.default_rng(1)
    corpus = rng.standard_normal((300, 16)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    names = np.array([f"v{i}" for i in range(300)], dtype=object)
    _, _, truth = answers_of(corpus, q, 4)
    # the candidate stage saw only the second half of the rows
    ids, s, r = answers_of(corpus[150:], q, 4)
    r = r + 150
    ids = names[r]
    out = checks.compare((ids, s, r), q, corpus, "cosine", names, truth)
    assert out["bad_hits"] == 0 and out["score_gap"] < 1e-6
    expect = 1 - np.mean([len(set(a) & set(t)) for a, t in zip(r, truth)]) / 4
    assert out["missed_share"] == pytest.approx(expect) and expect > 0.2
    assert not checks.verdict(out, {"bad_hits": 0, "score_gap": 1e-5,
                                    "missed_share": 0.1})


def test_partition_faults_count_rows_held_other_than_once():
    table = np.array([[0, 1, -1], [2, 3, -1]], np.int32)
    assert checks.partition_faults(table, np.array([4, -1]), 5) == 0
    assert checks.partition_faults(table, np.array([-1, -1]), 5) == 1
    assert checks.partition_faults(table, np.array([3, 4]), 5) == 1
    assert checks.partition_faults(table, np.array([4, 7]), 5) == 1


def test_reachable_top_k_is_the_exact_top_k_of_the_probed_rows():
    from portbench import reference
    rng = np.random.default_rng(2)
    corpus = rng.standard_normal((40, 8)).astype(np.float32)
    cent = np.eye(4, 8, dtype=np.float32)
    table = np.arange(40, dtype=np.int32)[:36].reshape(4, 9)
    part = {"centroids": cent, "row_table": table,
            "overflow_rows": np.array([36, 37, 38, 39, -1], np.int32),
            "nprobe": 2}
    q = rng.standard_normal((6, 8)).astype(np.float32)
    got = reference.reachable_topk(corpus, q, 3, "cosine", "cpu", part,
                                   block=4)
    probe = reference.probed_cells(cent, q, 2)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    vn = corpus / np.linalg.norm(corpus, axis=1, keepdims=True)
    for i in range(6):
        rows = np.concatenate([table[probe[i]].ravel(), [36, 37, 38, 39]])
        best = rows[np.argsort(-(vn[rows] @ qn[i]), kind="stable")[:3]]
        assert got[i].tolist() == best.tolist()
    cos = qn @ (cent / np.linalg.norm(cent, axis=1, keepdims=True)).T
    assert (np.sort(-cos, axis=1)[:, :2] == -np.take_along_axis(
        cos, probe, 1)).all()


def test_the_roofline_readers_on_a_synthetic_trace():
    from types import SimpleNamespace

    import torch

    from portbench import spec
    q = [np.ones((1024, 768), np.float32)] * 2
    cfg = {"rows": 1_000_000, "dims": 768,
           "index": {"search": {"kwargs": {"rerank": 4}}}}
    bound_us = 1e6 * roofline.bound_s(
        *roofline.s8_topc_cost(1024, 1_000_000, 768, 40),
        roofline.INT8_OPS_PER_S)
    trace = tracing.Trace([
        ev("user_annotation", tracing.CALL, 0, 20_000),
        ev("user_annotation", tracing.CALL, 20_000, 20_000),
        ev("kernel", "void fpv::scan_kernel<(anonymous namespace)::"
           "S8TopcOp<0> >(...)", 100, 9 * bound_us),
        ev("kernel", "void fpv::topc_merge_kernel<4>(...)", 20_100,
           bound_us),
    ])
    ctx = tracing.Context(trace, q, [None] * 2, cfg,
                          {"batch": 1024, "k": 10}, None)
    assert spec.reader("s8_topc_roofline").read(ctx) == \
        pytest.approx(2 * 100 / 10)
    assert spec.reader("b3_roofline").read(ctx) is None
    # B3: 4 cells of 3 live rows, queries closest to cells 0 and 1
    table = np.array([[0, 1, 2, -1], [3, 4, 5, -1], [6, 7, 8, -1],
                      [9, 10, 11, -1]], np.int32)
    sections = {"ann_centroids": torch.eye(4, 768).numpy(),
                "ann_row_table": table,
                "ann_overflow_rows": np.array([12, -1], np.int32)}
    ann = SimpleNamespace(export_sections=lambda: (sections, {}),
                          stats=lambda: {"nprobe": 2})
    qb = np.zeros((2, 768), np.float32)
    qb[:, 0], qb[:, 1] = 1.0, 0.5
    # rows of cells 0 and 1 and of the overflow block
    rows = np.array([[0, 4, 12], [3, 5, 1]], np.int32)
    ops, nbytes = roofline.b3_cost(768, [3, 3], [3, 3, 3, 3])
    t = 1e6 * roofline.bound_s(ops, nbytes, roofline.INT8_OPS_PER_S)
    trace = tracing.Trace([
        ev("user_annotation", tracing.CALL, 0, 100),
        ev("kernel", "void (anonymous namespace)::cell_stream::"
           "stream_kernel<signed char, 128>(...)", 10, 4 * t),
    ])
    ctx = tracing.Context(trace, [qb], [(None, None, rows)],
                          {"rows": 12, "dims": 768}, {"batch": 2, "k": 10},
                          SimpleNamespace(_ann=ann))
    assert spec.reader("b3_roofline").read(ctx) == pytest.approx(25.0)
    # a row of a cell that the recomputed routing does not reach (SLACK
    # wider than the 4 cells here, so shrink the table's reach instead)
    sections["ann_centroids"] = np.concatenate(
        [torch.eye(4, 768).numpy(), np.zeros((8, 768), np.float32)])
    sections["ann_centroids"][4:, 2:10] = np.eye(8, 8)
    sections["ann_row_table"] = np.concatenate(
        [table, np.full((8, 4), -1, np.int32)])
    sections["ann_row_table"][11, 0] = 13
    stray = np.array([[0, 4, 13], [3, 5, 1]], np.int32)
    ctx.answers = [(None, None, stray)]
    assert spec.reader("b3_roofline").read(ctx) is None


def test_the_per_layer_tail_is_over_the_untraced_calls():
    reader = spec.reader("call_p95_ms.batch")
    lat = list(np.arange(1, 101) / 1e3)          # 100 calls, 1..100 ms
    ctx = tracing.Context(TRACE, [], [], {"rows": 1, "dims": 1},
                          {"k": 10}, None, lat)
    assert reader.read(ctx) == pytest.approx(harness.p95_ms(lat))
    assert reader.read(ctx) == pytest.approx(95.05)
    empty = tracing.Context(TRACE, [], [], {"rows": 1, "dims": 1},
                            {"k": 10}, None)
    assert reader.read(empty) is None
