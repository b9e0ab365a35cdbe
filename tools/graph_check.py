#!/usr/bin/env python3
"""The 1M graph configuration on one CUDA card, held to the plain
beam-search reference (``portbench/reference_graph.py``) on its own index.

    python3 tools/graph_check.py --seed 2718281828 [--calls 256] [--small]
    python3 tools/graph_check.py --seed 2718281828 --sweep

1. Builds the system as the benchmark does (``portbench.harness.System``
   with ``portbench/configs/cohere768-1m-graph.json``): set-up seconds by
   phase and the build's by stage, what the index states, the card's
   memory.
2. Warms up as the ``b1`` traffic does, then makes ``--calls`` timed single
   calls of the cell's entry (``search_arrays``, B = 1, k = 10) on the
   traffic's query pool; then the same calls with a fault planted: the
   beam's scores from bf16 operands, half the rounds, half the expansion,
   one entry point.
3. Frees the program's state, runs the reference beam on the index's
   saved sections over the same queries, and gives for every run the two
   numbers it is held to (``missed_vs_beam``, ``score_gap``) beside their
   tolerances, and ``missed_share`` and recall@10 against the exact top 10.

``--sweep`` runs, in place of the faults, the sound calls at each (beam,
iters) of the configuration's sweep (beam 64 and 128, iters 8, 16 and 32):
their latencies, and recall@10 of the traffic's 1,024 evaluation queries
against the exact top 10: how ``iters`` was chosen.  ``--small`` runs the
same steps at the tests' small size on the CPU.  One JSON line a step on
stdout.
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
CONFIG, TRAFFIC = "cohere768-1m-graph", "b1"
SMALL = {"rows": 20000, "dims": 64, "data": {"centers": 64},
         "fill": {"batch": 5000, "capacity_rows": 24576},
         "index": {"build": {"kwargs": {"r": 16, "n_entries": 64}},
                   "expect": {"nodes": 20000, "degree": 16,
                              "entries": 64}}}
FAULTS = ("bf16_scores", "half_iters", "half_expand", "n_init=1")
SWEEP = tuple(f"beam={b},iters={t}" for b in (64, 128) for t in (8, 16, 32))


@contextlib.contextmanager
def fault(name):
    """One fault planted in the timed path (None: none): ``bf16_scores``
    (the beam's products of bf16 operands), ``half_iters`` /
    ``half_expand`` (half the index's rounds / expansion), or search knobs
    ``<knob>=<n>[,<knob>=<n>]`` (beam, iters, expand, n_init)."""
    from fastpyvectordb_tpu_torch.ann import graph_ann
    if name is None:
        yield
        return
    if name == "bf16_scores":
        owner, attr = graph_ann, "_beam_search_kernel"
        orig = graph_ann._beam_search_kernel

        def patched(*args, **kw):
            return orig(*args, **{**kw, "compute_dtype": "bfloat16"})
    else:
        owner, attr = graph_ann.GraphANN, "search"
        orig = graph_ann.GraphANN.search

        def knobs(index):
            if name == "half_iters":
                return {"iters": index.iters // 2}
            if name == "half_expand":
                return {"expand": index.expand // 2}
            return {kv.split("=")[0]: int(kv.split("=")[1])
                    for kv in name.split(",")}

        def patched(self, queries, k, **kw):
            return orig(self, queries, k, **{**kw, **knobs(self)})
    setattr(owner, attr, patched)
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--calls", type=int, default=256)
    p.add_argument("--small", action="store_true")
    p.add_argument("--sweep", action="store_true",
                   help="the (beam, iters) sweep in place of the faults")
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    import numpy as np
    import torch
    from portbench import checks, data, harness, reference, spec
    from portbench import reference_graph as plain
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

    config = spec.config(spec.manifest(), CONFIG)
    if args.small:
        config = spec.merged(config, SMALL)
    traffic = spec.traffic(TRAFFIC)
    k = int(traffic["k"])
    metric = config["metric"]
    emit(step="card", card=harness.power_limit() if device == "cuda"
         else "cpu")
    system = harness.System(config, args.seed, device)
    ann = system.collection._ann
    emit(step="built", phases=system.phases, stages=ann.build_seconds,
         report=system.report, stats=ann.stats(), memory=memory())
    search = system.entry(k)
    warm = system.queries(int(traffic["warmup_calls"]), data.WARMUP)
    for qv in warm:
        search(qv[None])
    pool = system.queries(args.calls, data.POOL)
    evalq = system.queries(int(traffic["eval_queries"]), data.EVAL)
    runs, swept = {}, {}
    for name in [None, *(SWEEP if args.sweep else FAULTS)]:
        answers, ms = [], []
        with fault(name):
            for qv in pool:
                t = time.perf_counter()
                answers.append(search(qv[None]))
                ms.append((time.perf_counter() - t) * 1e3)
            scored = ann.last_scored
            if args.sweep:
                swept[name] = search(evalq)[2]
        runs[name] = checks.stack(answers)
        emit(step="calls", fault=name, calls=len(ms),
             ms_p50=float(np.percentile(ms, 50)),
             ms_p95=float(np.percentile(ms, 95)), ms_max=max(ms),
             last_scored=scored, memory=memory())
    sections, meta = ann.export_sections()
    del ann, search    # both hold the collection
    system.close()
    emit(step="closed", memory=memory())
    t = time.perf_counter()
    _, truth = reference.exact_topk(system.corpus, pool, k, metric, device)
    if args.sweep:
        _, etruth = reference.exact_topk(system.corpus, evalq, k, metric,
                                         device)
        for name, rows in swept.items():
            emit(step="quality", knobs=name,
                 recall_at_10=checks.recall(rows, etruth),
                 pool_recall_at_10=checks.recall(runs[name][2], truth))
        emit(step="done", seconds=time.perf_counter() - t_start)
        return 0
    index = plain.Index(sections, meta)
    _, beam_rows = plain.search(index, system.corpus, pool, k, metric)
    emit(step="reference", seconds=time.perf_counter() - t,
         meta={key: meta[key] for key in ("beam", "expand", "iters",
                                          "n_init")})
    tolerances = {"missed_vs_beam": plain.MISSED_VS_BEAM,
                  "score_gap": plain.SCORE_GAP}
    for name, (ids, scores, rows) in runs.items():
        numbers = plain.compare(scores, rows, beam_rows, system.corpus, pool,
                                metric)
        emit(step="compare", fault=name,
             passes=plain.passes(numbers), numbers=numbers,
             tolerances=tolerances,
             missed_share=1.0 - checks.recall(rows, truth),
             recall_at_10=checks.recall(rows, truth))
    emit(step="done", seconds=time.perf_counter() - t_start)
    return 0


if __name__ == "__main__":
    sys.exit(main())
