"""``correct`` comes out true for the program, and false for the control
(the reference in TF32 in the program's place) and for each fault a cell
can have, planted in the timed path.  Small sizes on the CPU; the control
also on the card (marked ``cuda``).  A system other than the one its file
states stops the run in set-up."""

import time

import numpy as np
import pytest
import torch

from fastpyvectordb_tpu_torch.ann import ivf, ivf_grouped
from fastpyvectordb_tpu_torch.core.collection import Collection
from fastpyvectordb_tpu_torch.quant import scan
from portbench import checks, faults, harness, spec

MAN = spec.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
BATCHED = [w["name"] for w in MAN["workloads"]
           if spec.traffic(w["traffic"])["batch"] > 1]
SMALL = {"config": {"rows": 20000, "dims": 64, "data": {"centers": 64},
                    "fill": {"batch": 5000, "capacity_rows": 24576}},
         "traffic": {"pool_queries": 4096, "eval_queries": 256,
                     "sample_answers": 64, "trace_calls": 4}}
# what the IVF index states at the small size: nlist 2 x sqrt(20000)
SMALL_IVF = {"config": {"index": {"expect": {"nlist": 282, "cmax": 128}}}}
# the store's capacity after 200,000 rows in two chunks (the card's test)
CARD_CAPACITY = 262_144
SEED = 2 ** 31 + 101


def is_ivf(cell):
    wl = spec.workload(MAN, cell)
    return spec.config(MAN, wl["config"])["index"]["build"][
        "method"] == "build_ann"


def small(cell):
    """The overrides of the small size, with what the index states
    there."""
    return spec.merged(SMALL, SMALL_IVF) if is_ivf(cell) else SMALL


def entry_method(cell):
    wl = spec.workload(MAN, cell)
    return spec.config(MAN, wl["config"])["index"]["search"]["method"]


def run(cell, seed=SEED):
    result, _ = harness.run(cell, seed, 0.3, False,
                            t_start=time.perf_counter(), device="cpu",
                            overrides=small(cell))
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


def control_numbers(cell, device, over, seed):
    wl = spec.workload(MAN, cell)
    config = spec.merged(spec.config(MAN, wl["config"]), over["config"])
    traffic = spec.merged(spec.traffic(wl["traffic"]), over["traffic"])
    system = harness.System(config, seed, device)
    m = harness.measure(system, traffic, 0.3, False, [], time.perf_counter())
    system.close()
    return harness.judge(system, m, traffic, seed, control=True)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    out = control_numbers(cell, "cpu", small(cell), SEED)
    limits = spec.limits(cell)
    assert checks.verdict(out["numbers"], limits)
    assert not checks.verdict(out["control"], limits), out["control"]
    assert out["control"]["score_gap"] > 3 * limits["score_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    over = spec.merged(small(cell), {"config": {
        "rows": 200_000, "dims": 768, "data": {"centers": 1024},
        "fill": {"batch": 100_000, "capacity_rows": CARD_CAPACITY}}})
    if is_ivf(cell):
        over = spec.merged(over, {"config": {"index": {"expect": {
            "nlist": 894, "cmax": 384}}}})
    for seed in (SEED, SEED + 1, SEED + 2):
        out = control_numbers(cell, "cuda", over, seed)
        limits = spec.limits(cell)
        assert checks.verdict(out["numbers"], limits), out["numbers"]
        assert not checks.verdict(out["control"], limits), out["control"]


def stale(monkeypatch, cell):
    """A search that answers with its previous call's answer."""
    name = entry_method(cell)
    orig = getattr(Collection, name)
    last = {}

    def search(self, queries, **kw):
        out = orig(self, queries, **kw)
        prev = last.get("out", out)
        last["out"] = out
        return prev if len(prev[0]) == len(out[0]) else out
    monkeypatch.setattr(Collection, name, search)


def half_batch(monkeypatch, cell):
    """The batch's second half left out and answered from the first."""
    name = entry_method(cell)
    orig = getattr(Collection, name)

    def search(self, queries, **kw):
        h = max(1, len(queries) // 2)
        out = orig(self, queries[:h], **kw)
        return tuple(np.concatenate([a] * 2)[:len(queries)] for a in out)
    monkeypatch.setattr(Collection, name, search)


def altered(monkeypatch, cell):
    """Each answer's first hit moved to the next row where the re-rank
    produces it."""
    orig = scan.gather_rerank

    def gather_rerank(*args, **kw):
        d, r = orig(*args, **kw)
        r = r.clone()
        r[:, 0] += 1
        return d, r
    for module in (scan, ivf, ivf_grouped):
        monkeypatch.setattr(module, "gather_rerank", gather_rerank)


def planted(name):
    """A fault of ``faults``, planted for the test's length."""
    def fault(monkeypatch, cell):
        owner, attr, wrap = faults.FAULTS[name]()
        monkeypatch.setattr(owner, attr, wrap(getattr(owner, attr)))
    fault.__name__ = name
    return fault


def planted_faults(cell):
    wl = spec.workload(MAN, cell)
    build = spec.config(MAN, wl["config"])["index"]["build"]["method"]
    return [planted(name) for name in faults.FOR_INDEX[build]]


FAULTS = [(c, f) for c in CELLS for f in (stale, altered)] + \
    [(c, half_batch) for c in BATCHED] + \
    [(c, f) for c in CELLS for f in planted_faults(c)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    result = run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", sorted(faults.FAULTS))
def test_each_planted_fault_moves_what_it_breaks(name):
    """Each fault of ``faults`` changes the answers of a configuration it
    applies to, and the program is itself again once it is lifted."""
    cell = next(w["name"] for w in MAN["workloads"]
                if name in faults.FOR_INDEX[spec.config(
                    MAN, w["config"])["index"]["build"]["method"]]
                and spec.traffic(w["traffic"])["batch"] > 1)
    wl = spec.workload(MAN, cell)
    over = small(cell)
    config = spec.merged(spec.config(MAN, wl["config"]), over["config"])
    system = harness.System(config, SEED, "cpu")
    q = system.queries(64, 1)
    search = system.entry(10)
    before = search(q)[2]
    with faults.planted(name):
        broken = search(q)[2]
    after = search(q)[2]
    assert np.array_equal(before, after)
    assert not np.array_equal(before, broken)


def test_a_system_other_than_the_stated_one_stops_in_set_up():
    cell = next(c for c in CELLS if "expect" in spec.config(
        MAN, spec.workload(MAN, c)["config"])["index"])
    wl = spec.workload(MAN, cell)
    over = spec.merged(small(cell), {"config": {"index": {"expect": {
        "nprobe": 8}}}})
    config = spec.merged(spec.config(MAN, wl["config"]), over["config"])
    with pytest.raises(RuntimeError, match="nprobe"):
        harness.System(config, SEED, "cpu")
    over = spec.merged(small(cell), {"config": {"fill": {
        "capacity_rows": 20000}}})
    config = spec.merged(spec.config(MAN, wl["config"]), over["config"])
    with pytest.raises(RuntimeError, match="capacity_rows"):
        harness.System(config, SEED, "cpu")


@pytest.mark.parametrize("batch", [1, 1024])
def test_b3_readers_routing_holds_the_programs_answers(batch):
    """Every row the IVF path returns lies in a cell that ``b3_roofline``
    works out as probed, or in the overflow block, on both the grouped
    (B x nprobe >= nlist) and the per-query path."""
    cell = next(c for c in CELLS if is_ivf(c))
    wl = spec.workload(MAN, cell)
    config = spec.merged(spec.config(MAN, wl["config"]),
                         small(cell)["config"])
    system = harness.System(config, SEED, "cpu")
    b3 = spec.reader("b3_roofline")
    sections, _ = system.collection._ann.export_sections()
    nprobe = system.collection._ann.stats()["nprobe"]
    q = system.queries(batch, 1)
    rows = system.entry(10)(q)[2]
    wide = b3.probed_cells(sections["ann_centroids"], q, nprobe + b3.SLACK)
    table = sections["ann_row_table"]
    overflow = sections["ann_overflow_rows"]
    assert b3.outside(wide, rows, table, overflow) == 0
    assert b3.outside(wide[:, :nprobe], rows, table, overflow) == 0
    # the same rows against probes of other queries fall outside
    assert b3.outside(np.roll(wide, 1, axis=0)[:, :nprobe], rows, table,
                      overflow) > 0 or batch == 1
