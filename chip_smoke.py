#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fastpyvectordb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``fastpyvectordb_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, then drives the
main path through the public API at the size ``bench.py`` uses: a clustered
1M x 768 cosine corpus made from a fixed seed, B=1024 query batches, k=10.
Modes: exact f32 (the ground truth), filtered exact, exact bf16, int8
two-stage and int4 two-stage ``search_quantized``, the int8 ``pallas`` mode
of ``ScalarQuantizer.distances``, then save -> reload -> re-search.

Every phase raises on failure, so the exit code is non-zero unless all
passed.  The last lines are a JSON object of per-kernel numbers, the card's
``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ROWS, DIMS, BATCH, K = 1_000_000, 768, 1024, 10
N_CENTERS = 1024
BLOCK_ROWS = 65_536           # the main-path kernel block (B=1024 x 65,536)
KERNEL_RTOL = 1e-3            # same bf16 operands; only the f32 sum order
RECALL_GATE = 0.95            # bench.py's gate
QPS_BATCHES = 4               # distinct query batches per timed mode


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, warmed)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def clustered(gen, n: int, centers, noise: float):
    """bench.py's construction: centers[assign] + noise * N(0, 1)."""
    import torch
    assign = torch.randint(0, centers.shape[0], (n,), generator=gen,
                           device="cuda")
    return centers[assign] + noise * torch.randn(
        (n, centers.shape[1]), generator=gen, device="cuda")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    # a reference states its matmul precision: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {nvidia_smi_line()}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} count {torch.cuda.device_count()}")


def phase_build():
    from fastpyvectordb_tpu_torch.kernels import quant_kernels as qk
    t0 = time.perf_counter()
    qk.build()
    log(f"[build] quant_scores.cu built in {time.perf_counter() - t0:.2f} s")
    for line in qk.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def _kernel_pairs():
    from fastpyvectordb_tpu_torch.kernels import quant_kernels as qk
    return (("sq_scores", qk.sq_scores, qk.sq_scores_plain),
            ("int4_scores", qk.int4_scores, qk.int4_scores_plain))


def _codes_for(name, gen, n, d, vecs=None):
    """(codes, vmin, scale, dims of the query) for one kernel."""
    import torch
    from fastpyvectordb_tpu_torch.quant.int4 import Int4Quantizer
    from fastpyvectordb_tpu_torch.quant.scalar import ScalarQuantizer
    if vecs is None:
        vecs = torch.randn((n, d), generator=gen, device="cuda")
    qz = (ScalarQuantizer() if name == "sq_scores" else Int4Quantizer())
    qz.train(vecs)
    de = d if name == "sq_scores" else qz._de
    return qz.encode(vecs), qz.vmin, qz.scale, de


def check_kernel(name, kern, plain, q, codes, vmin, scale, metric):
    import torch
    got = kern(q, codes, vmin, scale, metric=metric)
    want = plain(q, codes, vmin, scale, metric=metric)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}/{metric}: bad output {got.shape}")
    err = (got - want).abs().max().item()
    tol = KERNEL_RTOL * max(want.abs().max().item(), 1.0)
    if err > tol:
        raise AssertionError(f"{name}/{metric}: max|kernel-plain| {err:.3g} "
                             f"> {tol:.3g}")
    top_ok = (got.argmin(1) == want.argmin(1)).float().mean().item()
    return err, tol, top_ok


def phase_kernels(queries=None, block=None):
    """Kernel vs plain on the card: ragged small shapes for 3 metrics, and
    the main-path block.  Returns per-kernel {max_abs_err, ms, plain_ms}."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import quant_kernels as qk
    gen = torch.Generator(device="cuda").manual_seed(7)
    metrics = ("cosine", "l2", "ip")
    for name, kern, plain in _kernel_pairs():
        for (b, n, d) in ((13, 1000, 41), (70, 3001, 130), (1, 64, 16)):
            codes, vmin, scale, de = _codes_for(name, gen, n, d)
            q = torch.randn((b, de), generator=gen, device="cuda")
            for metric in metrics:
                err, tol, top = check_kernel(name, kern, plain, q, codes,
                                             vmin, scale, metric)
                log(f"[kernels] {name} B={b} N={n} D={d} {metric}: "
                    f"max_abs_err {err:.3g} (tol {tol:.3g}) top1-agree "
                    f"{top:.3f}")
    if queries is None:
        queries = torch.randn((BATCH, DIMS), generator=gen, device="cuda")
    out = {}
    for name, kern, plain in _kernel_pairs():
        codes, vmin, scale, _ = _codes_for(name, gen, BLOCK_ROWS, DIMS,
                                           vecs=block)
        worst = 0.0
        for metric in metrics:
            err, tol, top = check_kernel(name, kern, plain, queries, codes,
                                         vmin, scale, metric)
            worst = max(worst, err)
            log(f"[kernels] {name} B={BATCH} N={BLOCK_ROWS} D={DIMS} "
                f"{metric}: max_abs_err {err:.3g} (tol {tol:.3g}) "
                f"top1-agree {top:.3f}")
        ms = cuda_ms(lambda: kern(queries, codes, vmin, scale,
                                  metric="cosine"))
        plain_ms = cuda_ms(lambda: plain(queries, codes, vmin, scale,
                                         metric="cosine"))
        log(f"[kernels] {name} B={BATCH} N={BLOCK_ROWS} D={DIMS} cosine: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        out[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}
    qk.LAUNCHES.update({key: 0 for key in qk.LAUNCHES})
    return out


def host_scores(q, vecs, chunk: int = 100_000):
    """Cosine distances in float64 on the host: an independent reference."""
    import numpy as np
    qn = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float64)
    out = np.empty((q.shape[0], vecs.shape[0]))
    for s in range(0, vecs.shape[0], chunk):
        v = vecs[s:s + chunk].astype(np.float64)
        out[:, s:s + chunk] = 1.0 - (qn @ v.T) / np.linalg.norm(v, axis=1)
    return out


def recall_at_k(rows, truth) -> float:
    return float(sum(len(set(a) & set(t)) for a, t in
                     zip(rows.tolist(), truth.tolist())) / truth.size)


def timed_qps(fn, batches) -> float:
    """Queries per second of ``fn(batch)`` over distinct batches, timed
    with CUDA events (each call returns host arrays, so it has synced)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for qb in batches:
        fn(qb)
    end.record()
    torch.cuda.synchronize()
    return sum(len(qb) for qb in batches) / (start.elapsed_time(end) / 1e3)


def phase_main_path(tmpdir: Path):
    import numpy as np
    import torch
    from fastpyvectordb_tpu_torch import Filter, VectorDB
    from fastpyvectordb_tpu_torch.kernels import quant_kernels as qk

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    centers = 2.0 * torch.randn((N_CENTERS, DIMS), generator=gen,
                                device="cuda")
    corpus = clustered(gen, N_ROWS, centers, 1.0)
    corpus /= torch.linalg.norm(corpus, dim=1, keepdim=True)
    qsets = [clustered(gen, BATCH, centers, 0.5).cpu().numpy()
             for _ in range(QPS_BATCHES + 2)]
    queries, tune_queries, timing_batches = qsets[0], qsets[1], qsets[2:]
    block = corpus[:BLOCK_ROWS].clone()
    host = corpus.cpu().numpy()
    del corpus
    ids = [f"v{i}" for i in range(N_ROWS)]
    metas = [{"cat": i % 10} for i in range(N_ROWS)]
    log(f"[main] corpus {N_ROWS}x{DIMS} made in "
        f"{time.perf_counter() - t0:.1f} s")

    kernels = phase_kernels(torch.as_tensor(queries, device="cuda"), block)
    del block

    # -- the counted main path ------------------------------------------
    qk.LAUNCHES.update({key: 0 for key in qk.LAUNCHES})
    results = {}
    db = VectorDB(str(tmpdir), device="cuda")
    col = db.create_collection("main", dimensions=DIMS, metric="cosine")
    t0 = time.perf_counter()
    col.insert_batch(host, ids, metas)
    torch.cuda.synchronize()
    log(f"[main] insert_batch {N_ROWS} rows: "
        f"{time.perf_counter() - t0:.1f} s, count {col.count()}")

    _, scores, truth = col.search_arrays(queries, k=K)
    if truth.shape != (BATCH, K) or not np.isfinite(scores).all():
        raise AssertionError(f"exact: bad result {truth.shape}")
    if not (np.diff(scores, axis=1) >= 0).all():
        raise AssertionError("exact: scores not ascending")
    # the f32 exact scan is the ground truth; hold its sorted scores
    # against a float64 numpy scan on a few queries (sorted scores, so
    # near-ties in the order do not matter)
    ref = host_scores(queries[:4], host)
    gap = np.abs(scores[:4] - np.sort(ref, axis=1)[:, :K]).max()
    if gap > 1e-5:
        raise AssertionError(f"exact: f32 scan vs f64 host, gap {gap:.3g}")
    qps = timed_qps(lambda qb: col.search_arrays(qb, k=K), timing_batches)
    results["exact_f32"] = {"recall": 1.0, "qps": qps}
    log(f"[main] exact f32: max score gap to a f64 host scan {gap:.3g}, "
        f"QPS {qps:.1f}")

    flt = Filter.eq("cat", 3)
    fids, fscores, frows = col.search_arrays(queries[:64], k=K, filter=flt)
    if not (frows % 10 == 3).all():
        raise AssertionError("filtered: a hit does not match the filter")
    sub = np.arange(3, N_ROWS, 10)
    fref = np.sort(host_scores(queries[:64], host[sub]), axis=1)[:, :K]
    fgap = np.abs(fscores - fref).max()
    if fgap > 1e-5:
        raise AssertionError(f"filtered: gap {fgap:.3g} to a host scan")
    log(f"[main] filtered exact (cat == 3): max score gap to a f64 host "
        f"scan of the matching rows {fgap:.3g}")

    bf = db.create_collection("bf16", dimensions=DIMS, metric="cosine",
                              compute_dtype="bfloat16",
                              storage_dtype="bfloat16")
    bf.insert_batch(host, ids)
    _, _, rows = bf.search_arrays(queries, k=K)
    rec = recall_at_k(rows, truth)
    qps = timed_qps(lambda qb: bf.search_arrays(qb, k=K), timing_batches)
    results["exact_bf16"] = {"recall": rec, "qps": qps}
    log(f"[main] exact bf16: recall@10 {rec:.4f}, QPS {qps:.1f}")
    db.delete_collection("bf16")
    del bf
    torch.cuda.empty_cache()

    scans = {}
    for kind in ("int8", "int4"):
        t0 = time.perf_counter()
        # the build-time auto-tune samples corpus rows as queries, which
        # find themselves and under-size the re-rank (int4: rerank 4,
        # recall@10 0.916 on held-out queries); tune on held-out queries
        scans[kind] = col.enable_quantized_scan(kind, tune=False)
        scans[kind].tune_rerank(tune_queries[:256], target_recall=RECALL_GATE)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        hits = col.search_quantized(queries, k=K)
        rows = np.array([[int(h.id[1:]) for h in r] for r in hits])
        rec = recall_at_k(rows, truth)
        qps = timed_qps(lambda qb: col.search_quantized_arrays(qb, k=K),
                        timing_batches)
        # a batch below the 17 rows torch._int_mm takes is padded (int8)
        _, _, few = col.search_quantized_arrays(queries[:3], k=K)
        if recall_at_k(few, rows[:3]) < 0.9:
            raise AssertionError(f"{kind}: a 3-query batch disagrees with "
                                 "the same queries in the full batch")
        results[f"{kind}_2stage"] = {
            "recall": rec, "qps": qps,
            "rerank": scans[kind].default_rerank}
        log(f"[main] {kind} two-stage: build+tune {build_s:.1f} s, "
            f"rerank {scans[kind].default_rerank}, recall@10 {rec:.4f}, "
            f"QPS {qps:.1f}")
    if qk.LAUNCHES["int4_scores"] == 0:
        raise AssertionError("int4 two-stage ran without int4_scores")

    scan8 = scans["int8"]
    qd = torch.as_tensor(queries, device="cuda")
    codes = scan8.codes[:BLOCK_ROWS]
    d_kern = scan8.quantizer.distances(qd, codes, "cosine", mode="pallas")
    d_mm = scan8.quantizer.distances(qd, codes, "cosine", mode="int8mm")
    torch.cuda.synchronize()
    if qk.LAUNCHES["sq_scores"] == 0:
        raise AssertionError("mode='pallas' ran without sq_scores")
    gap = (d_kern - d_mm).abs().max().item()
    if gap > 2e-2 * max(d_mm.abs().max().item(), 1.0):
        raise AssertionError(f"pallas vs int8mm modes differ by {gap:.3g}")
    log(f"[main] ScalarQuantizer.distances(mode='pallas') on "
        f"{BATCH}x{BLOCK_ROWS}: max gap to int8mm {gap:.3g}")
    launches = dict(qk.LAUNCHES)
    log(f"[main] kernel launches on the main path: {launches}")

    for mode, r in results.items():
        if r["recall"] < RECALL_GATE:
            raise AssertionError(f"{mode}: recall@10 {r['recall']:.4f} < "
                                 f"{RECALL_GATE}")

    # -- persistence ----------------------------------------------------
    t0 = time.perf_counter()
    db.save()
    _, _, rows_before = col.search_quantized_arrays(queries, k=K)
    del col, db, scans, scan8, d_kern, d_mm
    torch.cuda.empty_cache()
    db2 = VectorDB(str(tmpdir), device="cuda")
    col2 = db2["main"]
    _, _, rows_exact = col2.search_arrays(queries, k=K)
    _, _, rows_q = col2.search_quantized_arrays(queries, k=K)
    rec_e, rec_q = recall_at_k(rows_exact, truth), \
        recall_at_k(rows_q, rows_before)
    if rec_e < 0.999 or rec_q < 0.999 or col2.count() != N_ROWS:
        raise AssertionError(f"reload: exact {rec_e:.4f} int4 {rec_q:.4f}")
    log(f"[persist] save + reload in {time.perf_counter() - t0:.1f} s: "
        f"exact ids {rec_e:.4f}, int4 ids {rec_q:.4f} of before")
    return kernels, launches, results


def main() -> int:
    import torch  # noqa: F401 - a missing torch fails here, with no result
    if not (ROOT / "fastpyvectordb_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: fastpyvectordb_tpu_torch/ is not "
                         f"beside this script in {ROOT}")
    sys.path.insert(0, str(ROOT))
    phase_device()
    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        kernels, launches, results = phase_main_path(Path(tmp))
    replaces = {"sq_scores": "fastpyvectordb_tpu/kernels/pallas_quant.py:81",
                "int4_scores":
                    "fastpyvectordb_tpu/kernels/pallas_quant.py:163"}
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "fastpyvectordb_tpu_torch/csrc/quant_scores.cu",
         "replaces": replaces[name], "launches": launches[name],
         **kernels[name]} for name in ("sq_scores", "int4_scores")],
        "modes": results}
    print(json.dumps(line), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
