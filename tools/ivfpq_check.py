#!/usr/bin/env python3
"""The 10M IVF-PQ configuration on one CUDA card, held to the plain IVF-PQ
reference (``portbench/reference_ivfpq.py``) on its own index.

    python3 tools/ivfpq_check.py --seed 2718281828 [--calls 2] [--small]

1. Builds the system as the benchmark does (``portbench.harness.System``
   with ``portbench/configs/cohere768-10m-ivfpq.json``): set-up seconds by
   phase, what the index states, the card's memory.
2. Warms up as the ``b1024`` traffic does, then makes ``--calls`` timed
   calls of the cell's entry (``search_arrays``, B = 1,024, k = 10) on the
   traffic's query pool, recording the candidates each hands to its exact
   re-rank; then the same calls with a fault planted (the ADC tables in fp8
   (e4m3), half the subspaces left out, half of ``nprobe``, a quarter of
   the re-rank depth) and with each ``--knobs`` setting (``rerank=64``,
   ``nprobe=64``: a search knob the entry passes to the index).
3. Frees the program's state, then compares the sound calls and the
   table faults with the reference on the index's saved sections
   (``reference_ivfpq.compare``: the candidates' ADC scores, the
   c-th-score boundary, the answers), and gives for every run the numbers
   the cell's ``correct`` reads (``missed_reachable``) and recall@10
   against the exact top 10.

``--build m=96 max_cell_factor=1.5`` builds with other ``build_ann``
keywords than the file's (what set-up expects follows), and ``--sweep``
runs only the sound calls and ``--knobs`` and gives their quality: how the
configuration's knobs were chosen.  One JSON line a step on stdout.
``--small`` runs the same steps at the benchmark tests' small size on the
CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CONFIG, TRAFFIC = "cohere768-10m-ivfpq", "b1024"
SMALL = {"rows": 20000, "dims": 64, "data": {"centers": 64},
         "fill": {"batch": 5000, "capacity_rows": 24576},
         "index": {"build": {"kwargs": {"m": 16}},
                   "expect": {"nlist": 282, "cmax": 256, "m": 16}}}


@contextlib.contextmanager
def candidates(out: list):
    """Record (scores, rows) of the candidates each search re-ranks."""
    from fastpyvectordb_tpu_torch.ann import ivf_grouped, ivfpq
    orig = ivf_grouped.gather_rerank

    def gather_rerank(q, cvals, crows, *args, **kw):
        out.append((cvals.cpu().numpy(), crows.cpu().numpy()))
        return orig(q, cvals, crows, *args, **kw)
    ivf_grouped.gather_rerank = ivfpq.gather_rerank = gather_rerank
    try:
        yield
    finally:
        ivf_grouped.gather_rerank = ivfpq.gather_rerank = orig


@contextlib.contextmanager
def fault(name: str):
    """One fault planted in the timed path (None: none)."""
    import torch
    from fastpyvectordb_tpu_torch.ann import ivfpq
    if name is None:
        yield
        return
    if name in ("fp8_tables", "half_subspaces"):
        owner, attr = ivfpq, "_query_luts"
        orig = ivfpq._query_luts

        def patched(qf, codebooks):
            t = orig(qf, codebooks)
            if name == "fp8_tables":
                return t.to(torch.float8_e4m3fn).float()
            h = t.shape[1] // 2
            return torch.cat([t[:, :h], torch.zeros_like(t[:, h:])], dim=1)
    else:   # "<knob>=<n>[,<knob>=<n>]": search knobs (nprobe, rerank, qcap)
        owner, attr = ivfpq.IVFPQIndex, "search"
        orig = ivfpq.IVFPQIndex.search
        knobs = {kv.split("=")[0]: int(kv.split("=")[1])
                 for kv in name.split(",")}

        def patched(self, queries, k, **kw):
            return orig(self, queries, k, **{**kw, **knobs})
    setattr(owner, attr, patched)
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--calls", type=int, default=2)
    p.add_argument("--small", action="store_true")
    p.add_argument("--knobs", nargs="*", default=[])
    p.add_argument("--build", nargs="*", default=[],
                   help="build_ann keywords (m=192) in place of the file's")
    p.add_argument("--sweep", action="store_true",
                   help="the sound calls and --knobs only, quality only")
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    import numpy as np
    import torch
    from portbench import checks, data, harness, reference, spec
    from portbench import reference_ivfpq as plain
    from fastpyvectordb_tpu_torch.kernels import ivf_kernels as ik
    device = "cpu" if args.small else "cuda"

    def emit(**kw):
        print(json.dumps(kw, default=float), flush=True)

    def memory():
        if device != "cuda":
            return {}
        free, total = torch.cuda.mem_get_info()
        return {"allocated": torch.cuda.memory_allocated(),
                "max_allocated": torch.cuda.max_memory_allocated(),
                "reserved": torch.cuda.memory_reserved(), "free": free,
                "total": total}

    man = spec.manifest()
    config = spec.config(man, CONFIG)
    if args.small:
        config = spec.merged(config, SMALL)
    build = {key: float(v) if "." in v else int(v)
             for key, v in (kv.split("=") for kv in args.build)}
    expect = {key: v for key, v in build.items() if key in ("m", "rerank")}
    if "max_cell_factor" in build:   # the index's capacity rule
        raw = int(build["max_cell_factor"] * config["rows"]
                  / config["index"]["expect"]["nlist"])
        expect["cmax"] = (-(-raw // 128) * 128 if raw >= 128
                          else max(8, (raw + 7) // 8 * 8))
    config = spec.merged(config, {"index": {"build": {"kwargs": build},
                                            "expect": expect}})
    traffic = spec.traffic(TRAFFIC)
    b, k = int(traffic["batch"]), int(traffic["k"])
    emit(step="card", card=harness.power_limit() if device == "cuda"
         else "cpu")
    system = harness.System(config, args.seed, device)
    ann = system.collection._ann
    emit(step="built", phases=system.phases, report=system.report,
         stats=ann.stats(), memory=memory())
    search = system.entry(k)
    warm = system.queries(int(traffic["warmup_calls"]) * b, data.WARMUP)
    for s in range(0, warm.shape[0], b):
        search(warm[s:s + b])
    pool = system.queries(b * max(args.calls, 1), data.POOL)
    runs = {}
    nprobe, rerank = int(ann.nprobe), int(ann.rerank)
    planted = [] if args.sweep else ["fp8_tables", "half_subspaces",
                                     f"nprobe={nprobe // 2}",
                                     f"rerank={rerank // 4}"]
    for name in [None, *planted, *args.knobs]:
        calls = args.calls
        seen, answers, ms = [], [], []
        with fault(name), candidates(seen):
            for i in range(calls):
                if device == "cuda":
                    torch.cuda.synchronize()
                t = time.perf_counter()
                answers.append(search(pool[i * b:(i + 1) * b]))
                ms.append((time.perf_counter() - t) * 1e3)
        runs[name or "sound"] = (pool[:calls * b], checks.stack(answers),
                                 seen)
        # B7's row tiles in its last call beside those over all of cmax
        # (None on the CPU)
        emit(step="calls", fault=name, ms=ms, dropped=ann.last_dropped,
             qcap=ann.last_qcap, row_tiles=ik.last_pq_tiles(),
             handed_to_rerank=len(seen),
             free_at_first_search=ann._free_bytes, memory=memory())
    sections, _ = ann.export_sections()
    del ann, search    # both hold the collection
    system.close()
    emit(step="closed", memory=memory())
    metric = config["metric"]
    t = time.perf_counter()
    index = plain.Index(sections, device)
    part = {"centroids": sections["ann_centroids"],
            "row_table": sections["ann_row_table"],
            "overflow_rows": sections["ann_overflow_rows"], "nprobe": nprobe}
    q = pool[:args.calls * b]
    reach = reference.reachable_topk(system.corpus, q, k, metric, device,
                                     part)
    _, truth = reference.exact_topk(system.corpus, q, k, metric, device)
    for name, (q, (ids, scores, rows), seen) in runs.items():
        quality = {"missed_reachable": 1.0 - checks.recall(rows, reach),
                   "recall_at_10": checks.recall(rows, truth)}
        if args.sweep or name not in ("sound", "fp8_tables",
                                      "half_subspaces"):
            emit(step="quality", fault=name, **quality)
            continue
        program = {"rows": rows,
                   "cand_scores": np.concatenate([s for s, _ in seen]),
                   "cand_rows": np.concatenate([r for _, r in seen])}
        numbers = plain.compare(index, system.corpus, q, metric, k, nprobe,
                                rerank, program)
        # the candidates' ADC errors by the 768-row tile of their cell
        got = plain.candidate_scores(index, system.corpus, q,
                                     program["cand_rows"], metric, nprobe)
        err = np.abs(program["cand_scores"] - got["score"]) / got["bound"]
        slot = index.slot_of[torch.as_tensor(np.clip(
            program["cand_rows"], 0, None))].cpu().numpy()
        tile = np.where(slot >= 0, slot % index.cmax // 768, -1)
        by_tile = {int(t): float(np.nanmax(np.where(np.isfinite(err[
            tile == t]), err[tile == t], np.nan), initial=0.0))
            for t in np.unique(tile)}
        emit(step="compare", fault=None if name == "sound" else name,
             passes=plain.passes(numbers), numbers=numbers,
             adc_excess_by_tile=by_tile, **quality,
             seconds=time.perf_counter() - t)
    emit(step="done", seconds=time.perf_counter() - t_start)
    return 0


if __name__ == "__main__":
    sys.exit(main())
