"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m portbench.run --workload int8-b1024 --seed 7 --seconds 10 --trace 0

Needs a CUDA card (exits 2 without one, printing no result).  The last
lines on stderr are the compared numbers beside their limits; the last
line on stdout is the result object.  Compiled libraries go under
``build/`` in the checkout, so only a checkout's first run compiles.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from .spec import ROOT, manifest, workload  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    build = ROOT / "build"
    os.environ["FPV_TORCH_BUILD_ROOT"] = str(build)
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    import torch
    chips = int(workload(manifest(), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    from . import harness
    result, lines = harness.run(args.workload, args.seed, args.seconds,
                                bool(args.trace), t_start=T_START)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"portbench: the run loaded {', '.join(foreign)}",
              file=sys.stderr)
        return 3
    print(f"card: {result['device'].get('power_limit')}", file=sys.stderr)
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
