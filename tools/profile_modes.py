#!/usr/bin/env python3
"""Where a batch's time goes in the int8, int4 and binary two-stage modes,
IVF-PQ and bf16 IVF, on one CUDA card.

    python3 tools/profile_modes.py

Builds ``chip_smoke.py``'s corpus (1M x 768 cosine, clustered, fixed seed),
enables each quantized scan with its re-rank depth tuned on held-out
queries as ``chip_smoke.py`` does, builds IVF-PQ at its defaults (nprobe and
re-rank tuned jointly, the limits ``chip_smoke.py`` gives the tuner) and, on
a bf16 collection of the same rows, IVF with ``chip_smoke.py``'s recipe
(at the nprobe that mode tunes to there); then for each mode: one warm B=1024
batch, host wall time of 3 more distinct batches (each ends in a host copy,
so it has synced), and ``torch.profiler`` over the same 3 batches.  Prints per
mode the wall and busy milliseconds a batch (busy: the sum of device kernel
and memcpy times), the idle share (1 - busy / wall) and the largest device
items, then the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
BATCHES = 3


def profile_mode(label, fn, batches) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for qb in batches[1:]:
        fn(qb)
    wall = (time.perf_counter() - t0) / len(batches[1:]) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for qb in batches[1:]:
            fn(qb)
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3 / len(batches[1:]))
            for e in prof.key_averages() if e.device_time_total > 0]
    # device totals of the aten ops include their kernels: keep kernels and
    # copies only (no "aten::" rows), which sum to the busy time
    kernels = sorted(((k, t) for k, t in rows if not k.startswith("aten::")),
                     key=lambda kt: -kt[1])
    busy = sum(t for _, t in kernels)
    print(f"[{label}] wall {wall:.3f} ms/batch, busy {busy:.3f} ms/batch, "
          f"idle share {1 - busy / wall:.3f}", flush=True)
    for name, t in kernels[:10]:
        print(f"[{label}]   {t:8.3f} ms  {name[:110]}", flush=True)


def main() -> None:
    import torch
    import chip_smoke as cs
    from fastpyvectordb_tpu_torch import VectorDB
    from kernel_ab import MAIN_PATH_NPROBE
    if not torch.cuda.is_available():
        raise SystemExit("profile_modes: needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    centers = 2.0 * torch.randn((cs.N_CENTERS, cs.DIMS), generator=gen,
                                device="cuda")
    corpus = cs.clustered(gen, cs.N_ROWS, centers, 1.0)
    corpus /= torch.linalg.norm(corpus, dim=1, keepdim=True)
    # held-out tuning queries, a warm-up batch, then the timed batches
    qsets = [cs.clustered(gen, cs.BATCH, centers, 0.5).cpu().numpy()
             for _ in range(BATCHES + 2)]
    host = corpus.cpu().numpy()
    del corpus
    with tempfile.TemporaryDirectory(prefix="profile_modes_") as tmp:
        db = VectorDB(tmp, device="cuda")
        col = db.create_collection("p", dimensions=cs.DIMS, metric="cosine")
        col.insert_batch(host, [f"v{i}" for i in range(cs.N_ROWS)])
        for kind, target in (("int8", cs.RECALL_GATE),
                             ("int4", cs.RECALL_GATE),
                             ("binary", cs.TUNE_TARGET)):
            scan = col.enable_quantized_scan(kind, tune=False)
            scan.tune_rerank(qsets[0][:256], target_recall=target)
            profile_mode(f"{kind} two-stage, rerank {scan.default_rerank}",
                         lambda qb: col.search_quantized_arrays(qb, k=cs.K),
                         qsets[1:])
        col.build_ann("ivfpq", tune=False)
        ann = col._ann
        ann.tune(qsets[0][:256], target_recall=cs.TUNE_TARGET,
                 max_nprobe=2 * ann.nprobe, max_rerank=256)
        profile_mode(f"IVF-PQ grouped, nprobe {ann.nprobe}, rerank "
                     f"{ann.rerank}",
                     lambda qb: col.search_arrays(qb, k=cs.K), qsets[1:])
        db.delete_collection("p")
        del col, ann
        torch.cuda.empty_cache()
        bf = db.create_collection("bf16", dimensions=cs.DIMS, metric="cosine",
                                  compute_dtype="bfloat16",
                                  storage_dtype="bfloat16")
        bf.insert_batch(host, [f"v{i}" for i in range(cs.N_ROWS)])
        bf.build_ann("ivf", tune=False, **cs.IVF_BUILD)
        # the nprobe chip_smoke.py's bf16 IVF mode tunes to on its held-out
        # queries (this script's tuning set is another draw)
        bf.set_search_params(nprobe=MAIN_PATH_NPROBE["b2"])
        profile_mode(f"IVF bf16 grouped, nprobe {bf._ann.nprobe}",
                     lambda qb: bf.search_arrays(qb, k=cs.K), qsets[1:])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
