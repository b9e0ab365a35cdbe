"""The split of the card's idle time by the program layer the host was in
(``portbench/spans.py`` and the ``idle_ms.*`` readers), on synthetic
Chrome-trace events."""

import pytest

from portbench import spans, spec, tracing


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 7, "tid": tid}


def ctx_of(trace):
    return tracing.Context(trace, [], [], {"rows": 10, "dims": 8},
                           {"batch": 1, "k": 1}, None)


# call 1 (0-100): card busy 30-50 and 60-70; call 2 (100-200): card idle
EVENTS = [
    ev("user_annotation", tracing.CALL, 0, 100),
    ev("user_annotation", tracing.CALL, 100, 100),
    ev("user_annotation", "fpv.api.search", 0, 95),
    ev("user_annotation", "fpv.scan.search", 10, 70),
    ev("user_annotation", "fpv.scan.coarse", 20, 20),
    ev("user_annotation", "fpv.kernel.s8_topc", 25, 10),
    ev("cpu_op", "aten::mul", 26, 2),
    ev("user_annotation", "fpv.api.assemble", 85, 10),
    ev("kernel", "void fpv::scan_kernel<S8TopcOp<0> >", 30, 20),
    ev("gpu_memcpy", "Memcpy DtoH", 60, 10),
    ev("user_annotation", "fpv.api.search", 100, 100),
    ev("user_annotation", "fpv.ann.search", 120, 60),
    # the profiler's projection of a range onto the card's timeline: not
    # host time, and not the card at work
    ev("gpu_user_annotation", "fpv.api.search", 0, 200, tid=9),
    # another thread's ranges (less fpv time than the calls' thread)
    ev("user_annotation", "fpv.ann.search", 0, 50, tid=2),
]
TRACE = tracing.Trace(EVENTS)


def test_idle_goes_to_the_innermost_range():
    split = spans.idle_us(TRACE)
    # idle 0-30: api 0-10, scan 10-25 (search, then coarse), kernel 25-30;
    # 50-60 scan; 70-100: scan 70-80, api 80-95, outside 95-100;
    # call 2: api 100-120 and 180-200, ann 120-180
    assert split == pytest.approx({"api": 10 + 15 + 40, "scan": 15 + 10 + 10,
                                   "kernel": 5, "ann": 60, "outside": 5})


def test_nested_ranges_of_two_layers_split_one_gap():
    trace = tracing.Trace([
        ev("user_annotation", tracing.CALL, 0, 100),
        ev("user_annotation", "fpv.ann.search", 0, 100),
        ev("user_annotation", "fpv.ann.score", 20, 40),
        ev("user_annotation", "fpv.kernel.grouped_cell_scores_i8", 30, 10),
        ev("kernel", "k", 90, 10),
    ])
    # one gap, 0-90: ann 0-30, kernel 30-40, ann 40-90
    assert spans.idle_us(trace) == pytest.approx(
        {"ann": 80, "kernel": 10, "outside": 0})


def test_layers_and_outside_sum_to_the_windows_idle_time():
    split = spans.idle_us(TRACE)
    assert TRACE.busy_us == 30        # the projection is not busy time
    assert sum(split.values()) == pytest.approx(TRACE.window_us
                                                - TRACE.busy_us)
    per_call = {layer: spans.idle_ms_per_call(ctx_of(TRACE), layer)
                for layer in split}
    assert sum(per_call.values()) == pytest.approx(
        (TRACE.window_us - TRACE.busy_us) / 1e3 / TRACE.calls)
    assert per_call["ann"] == pytest.approx(60 / 1e3 / 2)


def test_device_projections_and_other_threads_are_ignored():
    only_projection = tracing.Trace([
        ev("user_annotation", tracing.CALL, 0, 100),
        ev("gpu_user_annotation", "fpv.api.search", 0, 100, tid=9),
        ev("kernel", "k", 40, 10),
    ])
    assert spans.idle_us(only_projection) is None
    without_thread_2 = tracing.Trace(EVENTS[:-1])
    assert spans.idle_us(TRACE) == spans.idle_us(without_thread_2)


NEW = {  # name: (layer, moves, cells)
    "idle_ms.api.batch": ("API", "qps", ["int8-b1024", "ivf-b1024"]),
    "idle_ms.api.single": ("API", "p95_ms", ["int8-b1", "ivf-b1"]),
    "idle_ms.scan.batch": ("Quantized scan", "qps", ["int8-b1024"]),
    "idle_ms.scan.single": ("Quantized scan", "p95_ms", ["int8-b1"]),
    "idle_ms.ann.batch": ("ANN", "qps", ["ivf-b1024"]),
    "idle_ms.ann.single": ("ANN", "p95_ms", ["ivf-b1"]),
    "idle_ms.kernels.batch": ("Hand kernels", "qps",
                              ["int8-b1024", "ivf-b1024"]),
    "idle_ms.kernels.single": ("Hand kernels", "p95_ms", ["int8-b1"]),
}


def test_a_trace_without_program_ranges_reads_nothing():
    bare = tracing.Trace([e for e in EVENTS
                          if not e["name"].startswith("fpv.")])
    assert bare.busy_us == 30
    for name in NEW:
        assert spec.reader(name).read(ctx_of(bare)) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_the_readers_and_their_manifest_entries(name):
    entry = [m for m in spec.manifest()["per_layer"] if m["name"] == name][0]
    layer, moves, cells = NEW[name]
    assert entry == {"name": name, "unit": "ms", "better": "lower",
                     "source": "device_trace", "layer": layer,
                     "moves": moves, "workloads": cells}
    word = {"kernels": "kernel"}.get(name.split(".")[1], name.split(".")[1])
    got = spec.reader(name).read(ctx_of(TRACE))
    assert got == pytest.approx(spans.idle_us(TRACE)[word] / 1e3 / 2)
