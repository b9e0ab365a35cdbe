"""Cold-start primer for fresh machines (the port of the JAX package's
``prime.py``).

What a fresh machine pays before its first query is, on the card, the
``nvcc`` build of every hand-written kernel (``csrc/*.cu``), the g++ build
of the native libraries (``native/*.cpp``) and the first run of each
serving shape (the caching allocator's blocks, the libraries' handles).
This tool builds them all into one build root and then runs every
power-of-two query-batch bucket the engine pads to (8, 16, ... up to
``--max-batch``) at the real corpus size, for each k and scan mode, so the
first production query runs warm.  A serving process started with
``FPV_TORCH_BUILD_ROOT`` set to the same directory loads those libraries
instead of building them again (``buildroot.py``).

Usage (on the serving machine, before traffic):

    python -m fastpyvectordb_tpu_torch.prime --dims 768 --rows 1000000 \\
        --metric cosine --cache /srv/fpv-build --modes exact,int8

The corpus is filled to the real row count with zero rows, as the JAX
primer does (the quantized scans' codes are sized by the live count), and
the int8 and binary scans run at their default re-rank depths.
Prints JSON lines: ``built`` (the sources compiled by this run and those
loaded), ``filled_rows``, one ``primed`` line per (rows, batch bucket) and
last ``{"cache": ..., "done": true}``.  ``--device cuda`` (the default)
raises without a card or without ``nvcc``; it never runs on the CPU
instead.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List


def _bucket_batches(max_batch: int) -> List[int]:
    out, b = [], 8
    while b <= max_batch:
        out.append(b)
        b <<= 1
    return out


def build(device) -> dict:
    """Compile (unless present) and load every library a search on
    ``device`` may launch: on the card each ``csrc/*.cu`` (one ``nvcc``
    each, all at once), on any device the native BM25 and graph libraries
    where g++ exists.  Returns {"built": [sources compiled now], "loaded":
    [sources loaded]}."""
    from . import native
    built, loaded = [], []
    if device.type == "cuda":
        from .kernels import cuda_build
        sources = cuda_build.all_sources()
        built += [s.source.name for s in sources if not s._so().exists()]
        cuda_build.build_all(*sources)
        loaded += [s.source.name for s in sources]
    for src, load in ((native._SRC, native.load_library),
                      (native._GRAPH_SRC, native.load_graph_library)):
        fresh = not native._so_path(src).exists()
        if load() is not None:
            loaded.append(src.name)
            if fresh:
                built.append(src.name)
    return {"built": built, "loaded": loaded}


def filled_collection(rows: int, dims: int, metric: str, compute_dtype: str,
                      device):
    """A collection of ``rows`` zero rows, inserted in chunks of 250,000:
    the real row count sizes the quantized scans' codes and the score
    blocks."""
    import numpy as np

    from .core.collection import Collection
    from .core.types import CollectionConfig
    col = Collection(CollectionConfig(
        name="prime", dimensions=dims, metric=metric,
        compute_dtype=compute_dtype, topk="auto"), device=device)
    filled = 0
    while filled < rows:
        nchunk = int(min(250_000, rows - filled))
        col.insert_batch(np.zeros((nchunk, dims), np.float32),
                         [f"p{filled + i}" for i in range(nchunk)])
        filled += nchunk
    return col


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="prime a machine for serving: "
                                 "build every kernel and library, run "
                                 "every batch bucket")
    ap.add_argument("--dims", type=int, default=768)
    ap.add_argument("--rows", type=int, action="append", default=None,
                    help="corpus size(s) to prime (repeatable)")
    ap.add_argument("--metric", default="cosine")
    ap.add_argument("--max-batch", type=int, default=1024)
    ap.add_argument("--k", type=int, action="append", default=None,
                    help="top-k value(s) to prime (repeatable, default 10)")
    ap.add_argument("--modes", default="exact,int8,binary",
                    help="comma list: exact | int8 | binary")
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--cache", default=None,
                    help="build root for the kernels and native libraries "
                    "(default <repo>/build or $FPV_TORCH_BUILD_ROOT); give "
                    "a server the same one")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from . import buildroot
    from .utils import resolve_device

    if args.cache is not None:
        buildroot.set_root(args.cache)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    libs = build(device)
    print(json.dumps({**libs, "s": round(time.perf_counter() - t0, 4)}),
          flush=True)

    rows_list = args.rows or [1 << 20]
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    batches = _bucket_batches(args.max_batch)
    rng = np.random.default_rng(0)

    for rows in rows_list:
        cap = 1
        while cap < rows:
            cap <<= 1
        t0 = time.perf_counter()
        col = filled_collection(rows, args.dims, args.metric,
                                args.compute_dtype, device)
        print(json.dumps({"filled_rows": rows,
                          "s": round(time.perf_counter() - t0, 4)}),
              flush=True)
        # at the scans' default re-rank depths, which a served collection
        # starts from: a tune on zero rows (every score tied) measures only
        # how ties fall, and ended at 128 on an H100 (256, its cap, on the
        # CPU), an int8 candidate pool (c = 1,280 at k = 10) past the
        # fused scan's c cap of 1,024 that would prime the unfused route
        # instead (the JAX primer tunes here)
        scans = {}
        if "int8" in modes:
            scans["int8"] = col.enable_quantized_scan("int8", tune=False)
        if "binary" in modes:
            scans["binary"] = col.enable_quantized_scan("binary", tune=False)
        ks = args.k or [10]
        for b in batches:
            q = rng.standard_normal((b, args.dims)).astype(np.float32)
            t0 = time.perf_counter()
            for k in ks:
                if "exact" in modes:
                    # what Collection.prewarm runs; returns host arrays
                    col.search_arrays(q, k=k, exact=True)
                for scan in scans.values():
                    scan.search(q, k)
            print(json.dumps({
                "primed": {"rows_bucket": cap, "batch_bucket": b,
                           "k": ks, "modes": modes},
                "s": round(time.perf_counter() - t0, 4)}), flush=True)
        del col, scans
    print(json.dumps({"cache": str(buildroot.root()), "done": True}))


if __name__ == "__main__":
    main()
