"""Readings that the limits of ``limits/<workload>.json`` are set from:
for each seed, one configuration's system built once, each of its cells'
traffic run for a short window, then the compared numbers of the program
and of the control (the TF32 reference in the program's place) on the same
queries; on the first ``--fault-seeds`` seeds also each of the
configuration's planted faults (``faults.FOR_INDEX``), a short window each
on the same system.  Not run by the benchmark's own runs.

    python3 -m portbench.calibrate --config cohere768-1m-int8 \\
        --seeds 11 12 13 --seconds 2 --fault-seeds 3

One JSON line a (cell, seed); the card's name and power limit last.
"""

import argparse
import json
import time

from . import faults, harness, spec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault-seeds", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    man = spec.manifest()
    config = spec.config(man, args.config)
    cells = [w for w in man["workloads"] if w["config"] == args.config]
    planted = faults.FOR_INDEX[config["index"]["build"]["method"]]
    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        system = harness.System(config, seed, args.device)
        runs = [(w, spec.traffic(w["traffic"])) for w in cells]
        ms = [harness.measure(system, tr, args.seconds, False, [], t0)
              for _, tr in runs]
        broken = [{}] * len(runs)
        if n < args.fault_seeds:
            broken = []
            for _, tr in runs:
                at = {}
                for name in planted:
                    with faults.planted(name):
                        at[name] = harness.measure(system, tr, args.seconds,
                                                   False, [], t0)
                broken.append(at)
        system.close()
        for (w, tr), m, at in zip(runs, ms, broken):
            v = harness.judge(system, m, tr, seed, control=True)
            e2e = harness.end_to_end(m, tr, int(config["rows"]), v["recall"])
            print(json.dumps({"workload": w["name"], "seed": seed,
                              "built": system.report,
                              "program": v["numbers"],
                              "control": v["control"],
                              "faults": {name: harness.judge(
                                  system, fm, tr, seed)["numbers"]
                                  for name, fm in at.items()},
                              "limits": spec.limits(w["name"]),
                              "recall_at_10": v["recall"],
                              "qps": e2e["qps"], "p95_ms": e2e["p95_ms"],
                              "setup_s": m.setup_s}), flush=True)
    print(json.dumps({"card": harness.power_limit()}), flush=True)


if __name__ == "__main__":
    main()
