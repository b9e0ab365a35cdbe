#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fastpyvectordb_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``fastpyvectordb_tpu_torch/csrc``
(one ``nvcc`` per source, started together), holds each against its plain
PyTorch version on the card, then drives the main paths through the public
API at the size ``bench.py`` uses: a clustered 1M x 768 cosine corpus made
from a fixed seed, B=1024 query batches, k=10.  Modes: exact f32 (the
ground truth), filtered exact, exact bf16, int8 two-stage (whose coarse
scan is the fused ``s8_topc`` kernel, B8's redesign) and int4 two-stage
``search_quantized``, the int8 ``pallas`` mode of
``ScalarQuantizer.distances``; then the IVF path: ``build_ann("ivf")`` with
int8 cells (``bench.py``'s ``ivf_grouped_int8_rr4``) and with bf16 cells,
grouped and per-query dispatch, filtered IVF; then, on a third collection of
the same rows, the binary two-stage scan (``enable_quantized_scan("binary")``
and its ``rerank=1`` coarse path) and IVF-PQ (``build_ann("ivfpq")`` at its
defaults, grouped and per-query, filtered); the pq scan kind once on a
65,536-row collection; then save -> reload -> re-search; then
``BigCollection`` (host vectors, device codes): the int8 codec on all 1M
rows, inserted in batches so that its buffers grow, searched, filtered,
tombstoned, saved and reloaded, and the int4 and binary codecs on the first
262,144 rows.  The serving phase starts the port's REST / WebSocket server
(``create_app(device="cuda")``) over the saved 1M collection and drives it
over HTTP as ``benchmarks/server_load.py`` drives the JAX server:
sequential and concurrent singles (JSON exact; msgpack quantized, which the
batcher coalesces into waves of one ``s8_topc`` launch each), /search/batch
at B=1024, writes with a WebSocket change feed, 10,000 texts through the
transformer embedder on the card, a graph past the native traversal
threshold, and two shard servers behind the router; every served result is
held against the direct ``Collection`` call.  The sharded phase runs the
multi-shard searchers of ``dist/`` on four logical shards of the card over
the collections, snapshots and indexes built before (exact, int8 and int4
two-stage, IVF with int8 and bf16 cells, IVF-PQ), each beside its
single-card route, with one kernel launch a shard counted and a traced
batch; the distributed k-means step; the dry run; a one-rank NCCL job in a
child process.  The hybrid phase drives a ``HybridCollection`` (BM25 +
vector fusion) of 262,144 rows with texts.  The graph phase builds the
graph ANN (``build_ann("graph")``, the JAX package's defaults) over the 1M
rows, tunes it on held-out queries, gates its recall@10, times it at
B=1024 and B=1, traces a batch, runs a search under
``torch.cuda.set_sync_debug_mode("error")`` and saves / reopens it;
every graph search must make one ``fpv_graph_beam`` launch (the beam's
rounds in one kernel, which replaces no Pallas kernel) and no other hand
kernel, and the kernel is timed against the plain rounds at B=1 (the
``graph-b1`` cell's knobs) and at B=1024 (the JAX defaults), with equal
answers.  The prime phase
runs the cold-start primer (``python -m fastpyvectordb_tpu_torch.prime``)
at 1,048,576 rows: cold in a child process into a fresh ``--cache`` (every
source built by ``nvcc`` there), warm in a second child on that cache
(nothing built), and in process with its ``s8_topc`` and
``hamming_mxu_scores`` launches counted.  The examples phase runs
``examples_torch/quickstart.py``, ``production_ops.py`` and the news
demo on the card in child processes and checks their output.  Each
path's kernel launch counts are zeroed just before it and read just
after.

Every phase raises on failure, so the exit code is non-zero unless all
passed.  The last lines are a JSON object of per-kernel numbers (launches
on the path, kernel, plain-version and nearest-library-call times, the
bound computed from the timed shape and what sets it), the card's
``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``.  The entries of B2, B3 and B7 also say
which design ran at the timed shape (the run fails unless the main path's
operands went to the TMA / wgmma cell stream).  Without a CUDA card, or without the
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
I8_RTOL = 1e-5                # exact integer products; the f32 epilogue rounds
PQ_RTOL = 1e-5                # B7: the same bf16 entries summed in another order
RECALL_GATE = 0.95            # bench.py's gate
# the binary and IVF-PQ tuners aim a point above the gate: a depth that just
# clears it on the tuning queries can miss it on the evaluation batch
TUNE_TARGET = 0.96
QPS_BATCHES = 4               # distinct query batches per timed mode
# bench.py's ivf_grouped_int8_rr4 recipe (bench.py:263-316)
IVF_BUILD = {"nlist": 2048, "nprobe": 8, "iters": 6, "max_cell_factor": 1.25}
# the card's rates (one H100 SXM at its 700 W limit, NVIDIA's data sheet,
# dense) come from the cost model, their one source in the package:
# core/costmodel.py HBM_BW and TENSOR_RATE
_RATE_NAME = {"bf16": "bfloat16", "int8": "int8", "f32": "float32"}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float, op_type: str) -> dict:
    """The least time the card could take: each input byte read once and
    each output byte written once at the memory rate, or the operations at
    the peak rate of their type, whichever is larger."""
    from fastpyvectordb_tpu_torch.core import costmodel as cm
    by_bytes = nbytes / cm.HBM_BW * 1e3
    by_ops = ops / cm.TENSOR_RATE[_RATE_NAME[op_type]] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": nbytes, "bound_ops": ops, "bound_op_type": op_type}


def quant_bound(b: int, n: int, de: int, code_bytes: int) -> dict:
    """B1 / B4: f32 queries, codes, two (de,) tables and qsq in, (b, n) f32
    out; 2 b n de bf16 operations."""
    return bound(4 * b * de + n * code_bytes + 8 * de + 4 * b + 4 * b * n,
                 2.0 * b * n * de, "bf16")


def hamming_bound(b: int, n: int, w: int) -> dict:
    """B5 / B6: packed words in, (b, n) 4-byte counts out; the +-1 int8
    product is 2 b n 32w operations."""
    return bound(4 * b * w + 4 * n * w + 4 * b * n, 2.0 * b * n * 32 * w,
                 "int8")


def s8_bound(b: int, n: int, d: int) -> dict:
    """B8 / B9: int8 queries and codes in, (b, n) int32 out; 2 b n d int8
    operations."""
    return bound(b * d + n * d + 4 * b * n, 2.0 * b * n * d, "int8")


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
    from fastpyvectordb_tpu_torch.kernels import cuda_build
    sources = cuda_build.all_sources()
    t0 = time.perf_counter()
    cuda_build.build_all(*sources)
    log(f"[build] {', '.join(src.name + '.cu' for src in sources)} built "
        f"in {time.perf_counter() - t0:.2f} s (one nvcc each, concurrently)")
    for src in sources:
        for line in src.build_log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Performance Loss" in line):
                log(f"[build] {src.name}: {line.strip()}")


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


def quant_library(name, queries, codes, vmin, scale):
    """The nearest library call to B1 / B4 (cosine): one f32-output bf16
    product of the normalised queries and the rows dequantised beforehand
    (the exact bf16 mode's GEMM, ``kernels/distances.py:mm_f32``)."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import quant_kernels as qk
    if name == "sq_scores":
        v = (codes.float() + 128.0) * (scale / 255.0)[None, :] + vmin[None, :]
    else:
        v = qk.unpack_int4(codes).float() * (scale / 15.0)[None, :] \
            + vmin[None, :]
    qb = torch.nn.functional.normalize(queries.float(), dim=1).bfloat16()
    vb = v.bfloat16()
    del v
    return lambda: torch.mm(qb, vb.T, out_dtype=torch.float32)


def hamming_library(qcodes, codes):
    """The nearest library call to B5 / B6: ``torch._int_mm`` of the +-1
    int8 operands expanded beforehand (the counts are (32W - product)/2)."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import hamming_kernels as hk
    qpm, cpm = hk.pm1_queries(qcodes), hk.pm1_queries(codes)
    return lambda: torch._int_mm(qpm, cpm.T)


QUANT_LIBRARY = ("torch.mm(q_bf16, v_bf16.T, out_dtype=torch.float32) of "
                 "rows dequantised beforehand")
HAMMING_LIBRARY = "torch._int_mm(q_pm1, c_pm1.T) of +-1 int8 expanded beforehand"


def phase_kernels(queries=None, block=None):
    """Kernel vs plain on the card: ragged small shapes for 3 metrics, and
    the main-path block.  Returns per-kernel {max_abs_err, ms, plain_ms,
    library_ms, bound_ms, ...} at B=1024 x 65,536 rows (B4's are replaced
    by its numbers at the int4 path's own 1M rows in phase_main_path)."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import quant_kernels as qk
    gen = torch.Generator(device="cuda").manual_seed(7)
    metrics = ("cosine", "l2", "ip")
    for name, kern, plain in _kernel_pairs():
        # B 1 / 13 / 70 / 200, N off the 128-row tile, D 41 / 130 / 1500
        # (int4: odd W = 21, 65)
        for (b, n, d) in ((13, 1000, 41), (70, 3001, 130), (1, 64, 16),
                          (200, 1000, 1500)):
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
        library_ms = cuda_ms(quant_library(name, queries, codes, vmin,
                                           scale))
        bnd = quant_bound(BATCH, BLOCK_ROWS, DIMS, codes.shape[1])
        log(f"[kernels] {name} B={BATCH} N={BLOCK_ROWS} D={DIMS} cosine: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{library_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']})")
        out[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "library": QUANT_LIBRARY,
                     "shape": [BATCH, BLOCK_ROWS, DIMS], **bnd}
    qk.LAUNCHES.update({key: 0 for key in qk.LAUNCHES})
    return out


def check_hamming(name, kern, plain, qc, codes):
    import torch
    got, want = kern(qc, codes), plain(qc, codes)
    torch.cuda.synchronize()
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain at B={qc.shape[0]} "
                             f"N={codes.shape[0]} W={codes.shape[1]}")


def phase_hamming_kernels(queries, block):
    """B5 / B6 against their plain versions, bit for bit (integer counts):
    ragged shapes, then the main path's block (codes encoded from the
    corpus block).  Returns per-kernel {max_abs_err, ms, plain_ms}."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import hamming_kernels as hk
    from fastpyvectordb_tpu_torch.quant.binary import BinaryQuantizer
    gen = torch.Generator(device="cuda").manual_seed(5)
    pairs = (("hamming_mxu_scores", hk.hamming_mxu_scores,
              hk.hamming_mxu_scores_plain),
             ("hamming_scores", hk.hamming_scores, hk.hamming_scores_plain))
    for b in (1, 13, 70, 200):
        for n in (64, 1000, 3001):
            # W = 1 / 2 / 3 / 5 / 24 / 47: odd widths, a partial last K step
            for d in (16, 41, 70, 130, 768, 1500):
                rows = torch.randn((n, d), generator=gen, device="cuda")
                bq = BinaryQuantizer(device="cuda").train(rows)
                qc = bq.encode(torch.randn((b, d), generator=gen,
                                           device="cuda"))
                for name, kern, plain in pairs:
                    check_hamming(name, kern, plain, qc, bq.encode(rows))
    log("[kernels] hamming_mxu_scores, hamming_scores at 72 ragged shapes "
        "(B 1/13/70/200 x N 64/1000/3001 x D 16/41/70/130/768/1500): equal "
        "to plain")
    bq = BinaryQuantizer(device="cuda").train(block)
    codes, qc = bq.encode(block), bq.encode(queries)
    out = {}
    library_ms = cuda_ms(hamming_library(qc, codes))
    bnd = hamming_bound(BATCH, BLOCK_ROWS, codes.shape[1])
    for name, kern, plain in pairs:
        check_hamming(name, kern, plain, qc, codes)
        ms = cuda_ms(lambda: kern(qc, codes))
        plain_ms = cuda_ms(lambda: plain(qc, codes))
        log(f"[kernels] {name} B={BATCH} N={BLOCK_ROWS} D={DIMS} "
            f"(W={codes.shape[1]}): equal to plain; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        out[name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "library": HAMMING_LIBRARY,
                     "shape": [BATCH, BLOCK_ROWS, codes.shape[1]], **bnd}
    hk.LAUNCHES.update({key: 0 for key in hk.LAUNCHES})
    return out


# B8 / B9 (B, N, D): B of one to five query tiles; N off the multiples of 4,
# 8 and 128; D 48 / 100 / 768 (a partial K step, rows that 16-byte copies
# cannot take); the main path's block
S8_SHAPES = ((1, 64, 48), (17, 1001, 100), (1024, 4096, 768), (1025, 130, 48),
             (33, 2050, 100), (70, 3004, 768), (5, 515, 129), (1024, 515, 768),
             (BATCH, BLOCK_ROWS, DIMS))


def check_s8(qi, codes, codes_t=None, label=""):
    """B8 on (N, D) codes and B9 on their transpose against the plain
    versions, each other and, where it takes the shape, the library call
    on B8's and on B9's operands: all bit for bit.  Returns B8's result."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    b, d = qi.shape
    n = codes.shape[0]
    if codes_t is None:
        codes_t = codes.T.contiguous()
    got = s8.s8_scores(qi, codes)
    torch.cuda.synchronize()
    if got.dtype != torch.int32 or got.shape != (b, n):
        raise AssertionError(f"s8_scores{label}: bad output {got.shape}")
    others = [("s8_scores_tn", lambda: s8.s8_scores_tn(qi, codes_t)),
              ("s8_scores_plain", lambda: s8.s8_scores_plain(qi, codes)),
              ("s8_scores_tn_plain",
               lambda: s8.s8_scores_tn_plain(qi, codes_t))]
    if b > 16 and d % 8 == 0 and n % 8 == 0:
        others.append(("torch._int_mm", lambda: torch._int_mm(qi, codes.T)))
        tn_call, tn_label, refusal = s8.s8_tn_library(qi, codes_t)
        if refusal:
            log(f"[kernels] torch._int_mm refuses (D, N) codes at B={b} "
                f"N={n} D={d}{label}: {refusal}")
        others.append((tn_label, tn_call))
    for name, fn in others:
        other = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, other):
            raise AssertionError(f"s8_scores != {name} at B={b} N={n} "
                                 f"D={d}{label}")
        del other
    return got


def phase_s8_kernels():
    """B8 / B9 at ragged shapes and at the main path's block, then on codes
    whose base is off the 16- and the 4-byte boundary."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    gen = torch.Generator(device="cuda").manual_seed(9)

    def rand8(shape, lo):
        return torch.randint(lo, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    for b, n, d in S8_SHAPES:
        check_s8(rand8((b, d), -127), rand8((n, d), -128))
    log(f"[kernels] s8_scores, s8_scores_tn at {len(S8_SHAPES)} shapes "
        f"{S8_SHAPES}: equal to their plain versions, to each other and "
        "(where it takes the shape) to torch._int_mm on B8's and on B9's "
        "operands, bit for bit")
    b, n, d = 19, 777, 64
    qi, c = rand8((b, d), -127), rand8((n, d), -128)
    for off in (1, 4):
        buf = torch.zeros(n * d + 16, dtype=torch.int8, device="cuda")
        codes = buf[off:off + n * d].view(n, d).copy_(c)
        want = check_s8(qi, c)
        if not torch.equal(s8.s8_scores(qi, codes), want):
            raise AssertionError(f"s8_scores: codes at base + {off} differ")
        codes_t = buf[off:off + n * d].view(d, n).copy_(c.T)
        if not torch.equal(s8.s8_scores_tn(qi, codes_t), want):
            raise AssertionError(f"s8_scores_tn: codes at base + {off} "
                                 "differ")
    log("[kernels] s8_scores, s8_scores_tn on codes at base + 1 and + 4 "
        "bytes: equal to the aligned result")
    s8.LAUNCHES.update({key: 0 for key in s8.LAUNCHES})


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


def int4_main_path(scan, queries):
    """B4 at the int4 path's own shape, as ``_int4_two_stage`` calls it: the
    B=1024 batch against the whole snapshot.  Checked against the plain
    version, then kernel, plain and library times."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import quant_kernels as qk
    from fastpyvectordb_tpu_torch.quant.int4 import _pad_queries
    qz, codes = scan.quantizer, scan.codes
    q = _pad_queries(torch.as_tensor(queries, device="cuda"),
                     2 * codes.shape[1])
    args = (q, codes, qz.vmin, qz.scale)
    err, tol, top = check_kernel("int4_scores", qk.int4_scores,
                                 qk.int4_scores_plain, *args, "cosine")
    ms = cuda_ms(lambda: qk.int4_scores(*args, metric="cosine"), reps=5)
    plain_ms = cuda_ms(lambda: qk.int4_scores_plain(*args, metric="cosine"),
                       reps=2)
    library_ms = cuda_ms(quant_library("int4_scores", *args), reps=5)
    n, w = codes.shape
    bnd = quant_bound(BATCH, n, 2 * w, w)
    log(f"[kernels] int4_scores main path B={BATCH} N={n} D={2 * w} cosine: "
        f"max_abs_err {err:.3g} (tol {tol:.3g}) top1-agree {top:.3f}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": QUANT_LIBRARY,
            "shape": [BATCH, n, 2 * w], **bnd}


def s8_main_path(scan, queries):
    """B8 at the int8 path's own shape, as ``folded_int_scores`` calls it:
    the B=1024 batch's folded int8 queries against the whole snapshot; B9 on
    a transposed copy of the same codes.  Checked against the plain
    versions, each other and the library call, then timed."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    qz, codes = scan.quantizer, scan.codes
    # the query the int8 mode folds (quant/scalar.py:folded_int_scores)
    qs = torch.as_tensor(queries, device="cuda") * (qz.scale / 255.0)[None, :]
    qscale = qs.abs().max(dim=1, keepdim=True).values.clamp(min=1e-30) / 127.0
    qi = torch.clamp(torch.round(qs / qscale), -127, 127).to(torch.int8)
    codes_t = codes.T.contiguous()
    check_s8(qi, codes, codes_t, " (int8 snapshot)")
    n, d = codes.shape
    tn_library, tn_label, _ = s8.s8_tn_library(qi, codes_t)
    out = {}
    for name, fn, reps in (
            ("s8_scores", lambda: s8.s8_scores(qi, codes), 5),
            ("s8_scores_tn", lambda: s8.s8_scores_tn(qi, codes_t), 5),
            ("plain", lambda: s8.s8_scores_plain(qi, codes), 1),
            ("plain_tn", lambda: s8.s8_scores_tn_plain(qi, codes_t), 1),
            ("library", lambda: torch._int_mm(qi, codes.T), 5),
            ("library_tn", tn_library, 5),
            ("two_pass",
             lambda: s8.s8_scores(qi, codes_t.t().contiguous()), 5)):
        out[name] = cuda_ms(fn, reps=reps)
    del codes_t
    torch.cuda.empty_cache()
    bnd = s8_bound(BATCH, n, d)
    log(f"[kernels] s8_scores / s8_scores_tn main path B={BATCH} N={n} "
        f"D={d}: equal to plain, to each other and to the library calls; "
        f"kernels {out['s8_scores']:.4f} / {out['s8_scores_tn']:.4f} ms, "
        f"plain {out['plain']:.4f} / {out['plain_tn']:.4f} ms, library "
        f"{out['library']:.4f} ms ({s8.S8_LIBRARY}) / "
        f"{out['library_tn']:.4f} ms ({tn_label}), B9's two-pass yardstick "
        f"{out['two_pass']:.4f} ms "
        f"({s8.S8_TWO_PASS}), bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']})")
    s8.LAUNCHES.update({key: 0 for key in s8.LAUNCHES})
    common = {"max_abs_err": 0.0, "shape": [BATCH, n, d], **bnd}
    return {"s8_scores": {"ms": out["s8_scores"], "plain_ms": out["plain"],
                          "library_ms": out["library"],
                          "library": s8.S8_LIBRARY, **common},
            "s8_scores_tn": {"ms": out["s8_scores_tn"],
                             "plain_ms": out["plain_tn"],
                             "library_ms": out["library_tn"],
                             "library": tn_label,
                             "two_pass_ms": out["two_pass"],
                             "two_pass": s8.S8_TWO_PASS, **common}}


def same_sorted(got, want) -> bool:
    """Sorted top-c values equal bit for bit (NaN where NaN)."""
    import torch
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.equal(got[~nan], want[~nan]))


def check_topc_rows(vals, rows, scores, label):
    """Rows valid and distinct per query, each carrying its own score."""
    import torch
    n = scores.shape[1]
    if not ((rows >= 0) & (rows < n)).all():
        raise AssertionError(f"s8_topc{label}: a row outside 0..{n - 1}")
    srt = rows.sort(dim=1).values
    if (srt[:, 1:] == srt[:, :-1]).any():
        raise AssertionError(f"s8_topc{label}: a row repeats")
    if not same_sorted(torch.take_along_dim(scores, rows, dim=1), vals):
        raise AssertionError(f"s8_topc{label}: a row does not carry its "
                             "value")


def topc_case(gen, b, n, d, valid):
    """Random operands of ``s8_topc``: folded int8 queries and codes, the
    per-query (qscale, const, qn / qsq) and per-row (rinv / vsq) values,
    and a mask: all rows, 10% of them, or fewer rows than any c."""
    import torch
    rnd = dict(generator=gen, device="cuda")
    qi = torch.randint(-127, 128, (b, d), dtype=torch.int8, **rnd)
    codes = torch.randint(-128, 128, (n, d), dtype=torch.int8, **rnd)
    qscale = torch.rand(b, **rnd) * 1e-3 + 1e-4
    const = torch.randn(b, **rnd)
    qstat = torch.rand(b, **rnd) * 10 + 1
    rstat = torch.rand(n, **rnd) + 0.5
    mask = {"all": torch.ones(n, dtype=torch.bool, device="cuda"),
            "10%": torch.rand(n, **rnd) < 0.1,
            "few": torch.arange(n, device="cuda") % max(n // 3, 1) == 0
            }[valid]
    return qi, codes, qscale, const, qstat, rstat, mask


def check_topc(args, c, metric, label=""):
    """``s8_topc`` against ``s8_topc_plain``: sorted values bit for bit,
    rows valid, distinct and carrying their values."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    from fastpyvectordb_tpu_torch.kernels.distances import MASKED
    gv, gr = s8.s8_topc(*args, c=c, metric=metric)
    wv, _ = s8.s8_topc_plain(*args, c=c, metric=metric)
    torch.cuda.synchronize()
    b = args[0].shape[0]
    if gv.shape != (b, c) or gr.shape != (b, c) or not same_sorted(gv, wv):
        raise AssertionError(f"s8_topc{label}: values differ from plain")
    qi, codes, qscale, const, qstat, rstat, mask = args
    scores = s8.folded_epilogue(s8.s8_scores_plain(qi, codes), qscale,
                                const, qstat, rstat, metric)
    scores.masked_fill_(~mask[None, :], float(MASKED))
    check_topc_rows(gv, gr, scores, label)
    del scores


# s8_topc (B, N, D, c): B of one to five query tiles; N under one tile, off
# the 128-row tile and the main path's 1M; D 64 / 100 / 768; c of 1, 10,
# 40, 160 and the cap (where N allows)
TOPC_SHAPES = ((1, 100, 64, (1, 10, 40, 100)),
               (19, 3001, 100, (1, 10, 40, 160, 1024)),
               (256, 3001, 768, (10, 40, 160, 1024)),
               (1100, 4097, 64, (1, 40, 160)),
               (19, 1 << 20, 768, (1, 40, 160, 1024)),
               (1100, 1 << 20, 100, (40,)))


def phase_topc_kernels():
    """The fused int8 coarse scan against its plain version at every shape
    of ``TOPC_SHAPES``, for the three metrics and three masks; then the
    route past the cap (``s8_scores`` + PyTorch passes) once."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    gen = torch.Generator(device="cuda").manual_seed(17)
    checks = 0
    for b, n, d, cs in TOPC_SHAPES:
        for metric in ("cosine", "l2", "ip"):
            for valid in ("all", "10%", "few"):
                args = topc_case(gen, b, n, d, valid)
                for c in cs:
                    check_topc(args, c, metric,
                               f" B={b} N={n} D={d} c={c} {metric} {valid}")
                    checks += 1
                del args
        torch.cuda.empty_cache()
    log(f"[kernels] s8_topc at {checks} cases {TOPC_SHAPES} x cosine / l2 / "
        "ip x masks all / 10% / fewer rows than c: sorted values equal to "
        "plain bit for bit; rows valid, distinct, each with its value")
    before = dict(s8.LAUNCHES)
    args = topc_case(gen, 19, 3001, 100, "10%")
    check_topc(args, s8.TOPC_MAX + 1, "l2", " past the cap")
    if (s8.LAUNCHES["s8_topc_wide"] != before["s8_topc_wide"] + 1
            or s8.LAUNCHES["s8_topc"] != before["s8_topc"]):
        raise AssertionError("s8_topc past its cap: not the scores route")
    log(f"[kernels] s8_topc at c = {s8.TOPC_MAX + 1} (past the cap): the "
        "scores route (s8_scores + PyTorch passes), equal to plain")
    s8.LAUNCHES.update({key: 0 for key in s8.LAUNCHES})


def topc_bound(b: int, n: int, d: int, c: int) -> dict:
    """s8_topc: int8 queries and codes, the (B, 4) query values, rinv, the
    mask in; (B, c) f32 values and int64 rows out; 2 b n d int8
    operations."""
    return bound(b * d + n * d + 16 * b + 4 * n + n + 12 * b * c,
                 2.0 * b * n * d, "int8")


def topc_main_path(scan, queries, c: int):
    """The fused scan at the int8 two-stage path's own shape, as
    ``folded_int_topc`` calls it (the B=1024 batch against the whole
    snapshot, cosine, its validity mask, the path's c): checked against the
    plain version, then timed beside the route it replaced (``s8_scores``
    + the folded epilogue's passes + ``masked_fill`` + ``torch.topk``) and
    the plain version."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    from fastpyvectordb_tpu_torch.quant.scalar import _int8_rs_bias, \
        fold_queries
    qz, codes = scan.quantizer, scan.codes
    vsq, rinv = scan._stats()
    mask = scan._valid(codes.shape[0])
    qi, qscale, const, qn = fold_queries(
        torch.as_tensor(queries, device="cuda"),
        *_int8_rs_bias(qz.vmin, qz.scale), "cosine")
    args = (qi, codes, qscale, const, qn, rinv, mask)
    check_topc(args, c, "cosine", " (int8 snapshot)")

    def replaced():
        return s8._topc_from_scores(s8.folded_epilogue(
            s8.s8_scores(qi, codes), qscale, const, qn, rinv, "cosine"),
            mask, c)

    def fused():
        return s8.s8_topc(*args, c=c, metric="cosine")

    # in turns: replaced, fused, fused, replaced
    t = [cuda_ms(fn, reps=5) for fn in (replaced, fused, fused, replaced)]
    plain_ms = cuda_ms(lambda: s8.s8_topc_plain(*args, c=c,
                                                metric="cosine"), reps=1)
    n, d = codes.shape
    bnd = topc_bound(BATCH, n, d, c)
    ms, old_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    log(f"[kernels] s8_topc main path B={BATCH} N={n} D={d} c={c} cosine: "
        f"equal to plain; fused {t[1]:.4f} / {t[2]:.4f} ms, replaced route "
        f"(s8_scores + passes + topk) {t[0]:.4f} / {t[3]:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}), share {bnd['bound_ms'] / ms:.3f}")
    s8.LAUNCHES.update({key: 0 for key in s8.LAUNCHES})
    return {"s8_topc": {
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "library_ms": None, "replaced_route_ms": old_ms,
        "library": "none: no single PyTorch call computes a masked top-c of "
                   "folded int8 scores; the replaced route is timed instead",
        "redesign_of": "s8_scores (B8)", "c": c,
        "shape": [BATCH, n, d], **bnd}}


def int8_vs_replaced(scan, queries):
    """The int8 two-stage search through the fused scan on the smoke's
    B=1024 batch: the device memory one search allocates (a (B, N) f32
    block would be 4.3 GB), and its results against the route it replaced
    (``s8_scores`` + the folded epilogue's passes + ``torch.topk``, then the
    same gather and re-rank): candidates' sorted scores bit for bit, final
    hits equal up to ties."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    from fastpyvectordb_tpu_torch.quant.scalar import _int8_rs_bias, \
        fold_queries
    from fastpyvectordb_tpu_torch.quant.scan import gather_rerank
    window = dict(s8.LAUNCHES)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    d_new, r_new = scan.search(queries, K)
    grow = torch.cuda.max_memory_allocated() - base
    if grow >= 1 << 30:
        raise AssertionError(f"int8 two-stage: one search allocated "
                             f"{grow / 2**30:.2f} GiB")
    qz, codes = scan.quantizer, scan.codes
    _, rinv = scan._stats()
    mask = scan._valid(codes.shape[0])
    c = min(K * scan.default_rerank, codes.shape[0])
    qd = torch.as_tensor(queries, device="cuda")
    qi, qscale, const, qn = fold_queries(
        qd, *_int8_rs_bias(qz.vmin, qz.scale), "cosine")
    ov, orow = s8._topc_from_scores(s8.folded_epilogue(
        s8.s8_scores(qi, codes), qscale, const, qn, rinv, "cosine"), mask, c)
    nv, _ = s8.s8_topc(qi, codes, qscale, const, qn, rinv, mask, c=c,
                       metric="cosine")
    if not same_sorted(nv, ov):
        raise AssertionError("int8 candidates differ from the replaced route")
    d_old, r_old = gather_rerank(qd, ov, orow, scan._store.vectors,
                                 scan.metric, K, scan.compute_dtype)
    if not same_up_to_ties(d_new, r_new, d_old.cpu().numpy(),
                           r_old.cpu().numpy()):
        raise AssertionError("int8 two-stage hits differ from the replaced "
                             "route beyond ties")
    s8.LAUNCHES.update(window)
    log(f"[main] int8 two-stage: one B={BATCH} search over "
        f"{codes.shape[0]} rows allocated {grow / 2**20:.1f} MiB of device "
        f"memory; c={c} candidates equal to the replaced route's bit for "
        "bit, hits equal up to ties")


def phase_main_path(tmpdir: Path):
    import numpy as np
    import torch
    from fastpyvectordb_tpu_torch import Filter, VectorDB
    from fastpyvectordb_tpu_torch.kernels import quant_kernels as qk
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    centers = 2.0 * torch.randn((N_CENTERS, DIMS), generator=gen,
                                device="cuda")
    corpus = clustered(gen, N_ROWS, centers, 1.0)
    corpus /= torch.linalg.norm(corpus, dim=1, keepdim=True)
    qsets = [clustered(gen, BATCH, centers, 0.5).cpu().numpy()
             for _ in range(QPS_BATCHES + 2)]
    queries, tune_queries, timing_batches = qsets[0], qsets[1], qsets[2:]
    stream_batches = [clustered(gen, BATCH, centers, 0.5).cpu().numpy()
                      for _ in range(STREAM_BATCHES)]
    server_queries = clustered(gen, SRV_QUERIES, centers, 0.5).cpu().numpy()
    block = corpus[:BLOCK_ROWS].clone()
    host = corpus.cpu().numpy()
    del corpus
    ids = [f"v{i}" for i in range(N_ROWS)]
    metas = [{"cat": i % 10} for i in range(N_ROWS)]
    log(f"[main] corpus {N_ROWS}x{DIMS} made in "
        f"{time.perf_counter() - t0:.1f} s")

    kernels = phase_kernels(torch.as_tensor(queries, device="cuda"), block)
    kernels.update(phase_hamming_kernels(
        torch.as_tensor(queries, device="cuda"), block))
    del block
    phase_s8_kernels()
    phase_topc_kernels()

    # -- the counted main path ------------------------------------------
    qk.LAUNCHES.update({key: 0 for key in qk.LAUNCHES})
    s8.LAUNCHES.update({key: 0 for key in s8.LAUNCHES})
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
    _, _, bf_truth = bf.search_arrays(queries, k=K)
    rec = recall_at_k(bf_truth, truth)
    qps = timed_qps(lambda qb: bf.search_arrays(qb, k=K), timing_batches)
    results["exact_bf16"] = {"recall": rec, "qps": qps}
    log(f"[main] exact bf16: recall@10 {rec:.4f}, QPS {qps:.1f}")

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
        # a batch of a few rows takes the same kernels
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
    # the int8 two-stage scan goes through the fused kernel alone: no
    # (B, N) block, no raw s8 scan
    if s8.LAUNCHES["s8_topc"] == 0 or s8.LAUNCHES["s8_scores"] != 0:
        raise AssertionError(f"int8 two-stage launches {s8.LAUNCHES}: "
                             "expected s8_topc only")
    log(f"[main] int8 two-stage kernel launches: {dict(s8.LAUNCHES)}")
    int8_vs_replaced(scans["int8"], queries)

    scan8 = scans["int8"]
    qd = torch.as_tensor(queries, device="cuda")
    codes = scan8.codes[:BLOCK_ROWS]
    d_kern = scan8.quantizer.distances(qd, codes, "cosine", mode="pallas")
    d_mm = scan8.quantizer.distances(qd, codes, "cosine", mode="int8mm")
    torch.cuda.synchronize()
    if qk.LAUNCHES["sq_scores"] == 0:
        raise AssertionError("mode='pallas' ran without sq_scores")
    if s8.LAUNCHES["s8_scores"] == 0:
        raise AssertionError("mode='int8mm' ran without s8_scores")
    gap = (d_kern - d_mm).abs().max().item()
    if gap > 2e-2 * max(d_mm.abs().max().item(), 1.0):
        raise AssertionError(f"pallas vs int8mm modes differ by {gap:.3g}")
    log(f"[main] ScalarQuantizer.distances(mode='pallas') on "
        f"{BATCH}x{BLOCK_ROWS}: max gap to int8mm {gap:.3g}")
    launches = {**qk.LAUNCHES, **s8.LAUNCHES}
    log(f"[main] kernel launches on the main path: {launches}")
    kernels["int4_scores"] = int4_main_path(scans["int4"], queries)
    kernels.update(s8_main_path(scan8, queries))
    kernels.update(topc_main_path(scan8, queries,
                                  K * scan8.default_rerank))
    phase_stream(col, stream_batches, results)

    ivf_kernels, ivf_launches = phase_ivf(col, bf, queries, tune_queries,
                                          timing_batches, truth, bf_truth,
                                          results)
    kernels.update(ivf_kernels)
    launches.update(ivf_launches)

    # -- the compressed tiers, on a third collection of the same rows ------
    cc = db.create_collection("compressed", dimensions=DIMS, metric="cosine")
    cc.insert_batch(host, ids, metas)
    bin_kernel, bin_launches = phase_binary(cc, queries, tune_queries,
                                            timing_batches, truth, results)
    kernels.update(bin_kernel)
    launches.update(bin_launches)
    pq_kernel, pq_launches = phase_ivfpq(cc, queries, tune_queries,
                                         timing_batches, truth, results)
    kernels.update(pq_kernel)
    launches.update(pq_launches)
    phase_pq_scan(db, host, queries, timing_batches, results)
    phase_sharded(col, bf, cc, scans, queries, timing_batches, truth,
                  bf_truth, scores, tmpdir, results)
    db.delete_collection("bf16")
    del bf
    torch.cuda.empty_cache()
    phase_hybrid(host, queries, results)
    phase_graph(host, ids, metas, queries, tune_queries, timing_batches,
                truth, tmpdir, results)

    for mode, r in results.items():
        if r.get("gated", True) and r["recall"] < RECALL_GATE:
            raise AssertionError(f"{mode}: recall@10 {r['recall']:.4f} < "
                                 f"{RECALL_GATE}")

    # -- persistence ----------------------------------------------------
    t0 = time.perf_counter()
    db.save()
    _, _, rows_before = col.search_quantized_arrays(queries, k=K)
    _, _, ivf_before = col.search_arrays(queries, k=K)   # the IVF index
    _, _, bin_before = cc.search_quantized_arrays(queries, k=K)
    _, _, pq_before = cc.search_arrays(queries, k=K)     # the IVF-PQ index
    del col, cc, db, scans, scan8, d_kern, d_mm
    torch.cuda.empty_cache()
    db2 = VectorDB(str(tmpdir), device="cuda")
    col2, cc2 = db2["main"], db2["compressed"]
    # build_ann made IVF the default route: the exact check asks for exact
    _, _, rows_exact = col2.search_arrays(queries, k=K, exact=True)
    _, _, rows_q = col2.search_quantized_arrays(queries, k=K)
    _, _, ivf_after = col2.search_arrays(queries, k=K)
    rec_e, rec_q = recall_at_k(rows_exact, truth), \
        recall_at_k(rows_q, rows_before)
    if rec_e < 0.999 or rec_q < 0.999 or col2.count() != N_ROWS:
        raise AssertionError(f"reload: exact {rec_e:.4f} int4 {rec_q:.4f}")
    if col2.config.index != "ivf" or not np.array_equal(ivf_after,
                                                        ivf_before):
        raise AssertionError("reload: IVF ids differ from before the save")
    _, _, bin_after = cc2.search_quantized_arrays(queries, k=K)
    _, _, pq_after = cc2.search_arrays(queries, k=K)
    rec_b = recall_at_k(bin_after, bin_before)
    if cc2._quantized.kind != "binary" or rec_b < 0.999:
        raise AssertionError(f"reload: binary ids {rec_b:.4f} of before")
    if cc2.config.index != "ivfpq" or not np.array_equal(pq_after,
                                                         pq_before):
        raise AssertionError("reload: IVF-PQ ids differ from before the save")
    log(f"[persist] save + reload in {time.perf_counter() - t0:.1f} s: "
        f"exact ids {rec_e:.4f}, int4 ids {rec_q:.4f} of before, IVF ids "
        f"identical ({col2._ann.stats()['cell_dtype']} cells, nprobe "
        f"{col2._ann.nprobe}); compressed: binary ids {rec_b:.4f} of "
        f"before (rerank {cc2._quantized.default_rerank}), IVF-PQ ids "
        f"identical (nprobe {cc2._ann.nprobe}, rerank {cc2._ann.rerank})")
    phase_optimize(col2, tune_queries, results)
    col2.save()   # with the int8 scan tuned on held-out queries
    del col2, cc2, db2
    torch.cuda.empty_cache()
    phase_server(tmpdir, host, server_queries, results)
    torch.cuda.empty_cache()
    phase_bigcollection(tmpdir, host, ids, metas, queries, tune_queries,
                        timing_batches, truth, results)
    phase_wal(tmpdir, queries, results)
    phase_outofcore(tmpdir, host, queries, tune_queries, timing_batches,
                    truth, scores, results)
    return kernels, launches, results


def same_up_to_ties(d1, r1, d2, r2, tol: float = 1e-4) -> bool:
    """Two (B, k) top-k results agree: the same sorted scores within
    ``tol`` and the same ids, except among scores tied within ``tol``."""
    import numpy as np
    if np.abs(d1 - d2).max() > tol:
        return False
    return all(set(ra[a < a[-1] - tol].tolist()) <= set(rb.tolist())
               and set(rb[b < b[-1] - tol].tolist()) <= set(ra.tolist())
               for a, ra, b, rb in zip(d1, r1, d2, r2))


def build_ivf(col, label: str, **extra):
    """``build_ann("ivf")`` with ``bench.py``'s recipe, timed and logged."""
    import torch
    t0 = time.perf_counter()
    col.build_ann("ivf", tune=False, **IVF_BUILD, **extra)
    torch.cuda.synchronize()
    st = col._ann.stats()
    log(f"[ivf] {label}: build {time.perf_counter() - t0:.2f} s, stats {st}")
    if st["cmax"] != 640:
        raise AssertionError(f"{label}: cmax {st['cmax']}, expected 640")
    return time.perf_counter() - t0


def ivf_mode(col, label, queries, tune_queries, timing_batches, gate_truth,
             truth):
    """Search one B=1024 batch through the public API (grouped, since
    1024 * nprobe >= nlist), gate recall@10 against ``gate_truth`` (tuning
    nprobe on held-out queries if the recipe's 8 falls short), time QPS."""
    _, _, rows = col.search_arrays(queries, k=K)
    rec = recall_at_k(rows, gate_truth)
    if rec < RECALL_GATE:
        before = col._ann.nprobe
        nprobe = col._ann.tune_nprobe(tune_queries[:256], RECALL_GATE)
        log(f"[ivf] {label}: recall@10 {rec:.4f} at nprobe {before}; tuned "
            f"on held-out queries -> nprobe {nprobe}")
        _, _, rows = col.search_arrays(queries, k=K)
        rec = recall_at_k(rows, gate_truth)
    ann = col._ann
    out = {"recall": rec, "recall_f32": recall_at_k(rows, truth),
           "qps": timed_qps(lambda qb: col.search_arrays(qb, k=K),
                            timing_batches),
           "nprobe": ann.nprobe, "rerank": ann.rerank, "qcap": ann.last_qcap,
           "dropped_pairs": ann.last_dropped}
    log(f"[ivf] {label}: {out}")
    return out


def ivf_kernel_case(ann, queries, metric: str, nprobe: int):
    """The grouped score stage's arguments exactly as the main path makes
    them for one batch at ``nprobe``, from the index's own invert_pairs
    output."""
    import torch
    from fastpyvectordb_tpu_torch.ann.ivf import ok_slot_masks
    from fastpyvectordb_tpu_torch.ann.ivf_grouped import (
        cell_score_args, grouped_qcap, invert_pairs, probe_cells, route)
    nlist, cmax = ann.row_table.shape
    qf = torch.as_tensor(queries, device="cuda")
    qcap = grouped_qcap(qf.shape[0], nprobe, nlist, cmax)
    pairs = invert_pairs(probe_cells(route(qf, ann.centroids, metric),
                                     nprobe), nlist, qcap)
    vmin, scale = ann._quant_params()
    okc, _ = ok_slot_masks(ann)
    _, args = cell_score_args(qf, pairs, ann.cells, okc, vmin, scale,
                              ann._cell_norms_cached(), metric=metric,
                              qcap=qcap)
    return args


def ragged_case(gen, nlist, u, n_uniq, qcap, cmax, d, int8, metric):
    """Synthetic kernel operands at a ragged shape with a padding tail
    (compact slots past n_uniq alias cell 0)."""
    import torch
    ids = torch.randperm(nlist, generator=gen, device="cuda")[:u].int()
    ids[n_uniq:] = 0
    cell_ids = torch.cat([torch.tensor([n_uniq], device="cuda",
                                       dtype=torch.int32), ids])
    rnd = dict(generator=gen, device="cuda")
    if int8:
        qblk = torch.randint(-127, 128, (u, qcap, d), dtype=torch.int8, **rnd)
        cells = torch.randint(-127, 128, (nlist, cmax, d), dtype=torch.int8,
                              **rnd)
        norms = torch.rand((nlist, cmax), **rnd) * 50 + 1
    else:
        qblk = torch.randn((u, qcap, d), **rnd).bfloat16()
        cells = torch.randn((nlist, cmax, d), **rnd).bfloat16()
        norms = (cells.float() ** 2).sum(-1)
    okf = (torch.rand((nlist, cmax), **rnd) > 0.2).float()
    qstat = (torch.rand((u, qcap), **rnd) + 0.5) if metric != "ip" else \
        torch.zeros((u, qcap), device="cuda")
    if int8:
        return (cell_ids, qblk, cells, norms, okf,
                torch.rand((u, qcap), **rnd) * 1e-3,
                torch.randn((u, qcap), **rnd), qstat)
    return cell_ids, qblk, cells, norms, okf, qstat


def check_ivf_kernel(name, kern, plain, args, metric, rtol):
    import torch
    n_uniq = int(args[0][0])
    got = kern(*args, metric=metric)[:n_uniq]
    want = plain(*args, metric=metric)[:n_uniq]
    torch.cuda.synchronize()
    live = want < 1e38
    if not torch.equal(got < 1e38, live) or not torch.isfinite(got).all():
        raise AssertionError(f"{name}/{metric}: masked slots disagree")
    err = (got - want).abs().max().item()
    tol = rtol * max(want[live].abs().max().item(), 1.0)
    if err > tol:
        raise AssertionError(f"{name}/{metric}: max|kernel-plain| {err:.3g} "
                             f"> {tol:.3g}")
    return err, tol


# B2 / B3 (nlist, U, n_uniq, qcap, cmax, D): every tile height of the
# first-slice kernel (D 41 / 130, and int8 D 72: rows TMA cannot address),
# and on the cell stream qcap 8 / 16 / 40 / 64 / 256, two non-powers of two
# above 256 (a second pass of slots), cmax off the 128-row tile and off the
# 4-float store unit, D off the 128-byte K step; n_uniq < U throughout
IVF_RAGGED = ((7, 5, 3, 8, 200, 41), (9, 6, 4, 8, 128, 130),
              (6, 4, 3, 16, 72, 96), (5, 4, 2, 40, 130, 64),
              (6, 4, 3, 8, 200, 64), (5, 4, 3, 64, 136, 768),
              (5, 4, 2, 256, 640, 128), (4, 3, 2, 408, 260, 72),
              (4, 3, 2, 300, 130, 96))
# B7 (nlist, U, n_uniq, qcap, cmax, M, K, B, loads of the compact rows or
# None for random ones): loads 0 / 1 / a full 32-slot tile / one past it /
# saturated and every tail width; M off the staged chunk; cmax 72 / 768 /
# 1100 (two cmax tiles), 130 (no 4-byte copies); K 16 / 64 / 256 and an
# odd K 13 (no 4-byte copies either)
PQ_RAGGED = ((7, 5, 3, 8, 72, 1, 16, 20, None),
             (9, 6, 4, 40, 768, 8, 256, 50, None),
             (6, 4, 3, 8, 200, 96, 256, 30, None),
             (5, 4, 2, 40, 130, 8, 16, 10, None),
             (4, 3, 3, 16, 1100, 12, 64, 9, None),
             (5, 4, 3, 16, 100, 5, 13, 7, None),
             (8, 6, 5, 72, 768, 7, 256, 50, (0, 1, 32, 33, 72, 17)),
             (8, 6, 6, 40, 72, 40, 16, 20, (0, 1, 32, 33, 40, 9)),
             (8, 6, 5, 344, 1100, 12, 64, 64, (344, 0, 1, 33, 20, 100)))

IVF_LIBRARY = {
    False: "torch.bmm(q_slots, cells[ids].transpose(1, 2), "
           "out_dtype=torch.float32) of cells gathered beforehand",
    True: "none: PyTorch's s8 product (torch._int_mm) is 2-D only"}


def ivf_bound(args, int8: bool) -> dict:
    """B2 / B3 at the path's operands: the compact slots and the probed
    cells read once (unique cells), norms and masks of those cells and the
    per-slot tables in, the (n_uniq, qcap, cmax) f32 block out."""
    n = int(args[0][0])
    u, qcap, d = args[1].shape
    cmax = args[2].shape[1]
    elt = 1 if int8 else 2
    slot_tables = (3 if int8 else 1) * 4 * n * qcap
    nbytes = (4 * (u + 1) + elt * n * qcap * d + elt * n * cmax * d
              + 8 * n * cmax + slot_tables + 4 * n * qcap * cmax)
    return bound(nbytes, 2.0 * n * qcap * cmax * d, "int8" if int8 else "bf16")


def ivf_library(args):
    """The nearest library call to B2: one f32-output batched product of
    the compact slots and the probed cells gathered beforehand."""
    import torch
    n = int(args[0][0])
    q = args[1][:n]
    cells = args[2][args[0][1:1 + n].long()]
    return lambda: torch.bmm(q, cells.transpose(1, 2), out_dtype=torch.float32)


def phase_ivf(col, bf, queries, tune_queries, timing_batches, truth,
              bf_truth, results):
    """The IVF path: ``bench.py``'s ``ivf_grouped_int8_rr4`` on the f32
    collection (int8 cells, kernel B3) and the same recipe with bf16 cells
    on the bf16 collection (kernel B2), then per-query vs grouped dispatch,
    filtered IVF, and each kernel against its plain version at the main
    path's own operands and at ragged shapes."""
    import numpy as np
    import torch
    from fastpyvectordb_tpu_torch import Filter
    from fastpyvectordb_tpu_torch.kernels import ivf_kernels as ik

    build_i8 = build_ivf(col, "int8 cells", cell_dtype="int8")
    build_bf = build_ivf(bf, "bf16 cells")

    # -- the counted IVF path --------------------------------------------
    ik.LAUNCHES.update({key: 0 for key in ik.LAUNCHES})
    results["ivf_grouped_int8_rr4"] = {
        **ivf_mode(col, "int8 grouped rr4", queries, tune_queries,
                   timing_batches, truth, truth), "build_s": build_i8}
    results["ivf_grouped_bf16"] = {
        **ivf_mode(bf, "bf16 grouped", queries, tune_queries,
                   timing_batches, bf_truth, truth), "build_s": build_bf}
    # read before the checks below, which force a route of their own
    launches = {name: ik.LAUNCHES[name]
                for name in ("grouped_cell_scores", "grouped_cell_scores_i8")}
    log(f"[ivf] kernel launches on the IVF path (B={BATCH} batches through "
        f"search_arrays): {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the IVF path ran without {name}")
    for label, c in (("int8", col), ("bf16", bf)):
        d_pq, r_pq = c._ann.search(queries[:8], K, grouped=False)
        d_g, r_g = c._ann.search(queries[:8], K, grouped=True)
        if not same_up_to_ties(d_pq, r_pq, d_g, r_g):
            raise AssertionError(f"{label}: per-query and grouped dispatch "
                                 "disagree on a B=8 batch")
        log(f"[ivf] {label}: B=8 per-query vs grouped: same ids up to ties "
            f"(max score gap {np.abs(d_pq - d_g).max():.3g})")
    _, _, frows = col.search_arrays(queries[:64], k=K,
                                    filter=Filter.eq("cat", 3))
    if not (frows % 10 == 3).all():    # an empty slot (-1) fails too
        raise AssertionError("filtered IVF: a hit does not match the filter")
    log(f"[ivf] filtered IVF (cat == 3, 64 queries, overfetch "
        f"{col.config.overfetch}): every hit matches")

    # -- each kernel against its plain version ---------------------------
    pairs = (("grouped_cell_scores", ik.grouped_cell_scores,
              ik.grouped_cell_scores_plain, bf._ann, KERNEL_RTOL, False),
             ("grouped_cell_scores_i8", ik.grouped_cell_scores_i8,
              ik.grouped_cell_scores_i8_plain, col._ann, I8_RTOL, True))
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for name, kern, plain, ann, rtol, int8 in pairs:
        worst = 0.0
        for metric in ("cosine", "l2", "ip"):
            # the recipe's nprobe and the tuned one the path ran at
            for nprobe in sorted({IVF_BUILD["nprobe"], ann.nprobe}):
                args = ivf_kernel_case(ann, queries, metric, nprobe)
                err, tol = check_ivf_kernel(name, kern, plain, args, metric,
                                            rtol)
                worst = max(worst, err)
                u, qcap, d = args[1].shape
                log(f"[kernels] {name} main path nprobe {nprobe} U={u} "
                    f"n_uniq={int(args[0][0])} qcap={qcap} "
                    f"cmax={ann.cells.shape[1]} D={d} {metric}: "
                    f"max_abs_err {err:.3g} (tol {tol:.3g})")
            for shape in IVF_RAGGED:
                rargs = ragged_case(gen, *shape, int8, metric)
                err, tol = check_ivf_kernel(name, kern, plain, rargs, metric,
                                            rtol)
                log(f"[kernels] {name} {shape} {metric} "
                    f"({ik.grouped_design(rargs[1], rargs[2])}): max_abs_err "
                    f"{err:.3g} (tol {tol:.3g})")
        args = ivf_kernel_case(ann, queries, "cosine", ann.nprobe)
        design = ik.grouped_design(args[1], args[2])
        if design != "tma_wgmma":
            raise AssertionError(f"{name}: the main path's operands went to "
                                 f"the {design} kernel")
        ms = cuda_ms(lambda: kern(*args, metric="cosine"))
        plain_ms = cuda_ms(lambda: plain(*args, metric="cosine"))
        bnd = ivf_bound(args, int8)
        library_ms = None if int8 else cuda_ms(ivf_library(args))
        log(f"[kernels] {name} main path nprobe {ann.nprobe} cosine "
            f"({design}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library_ms} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']})")
        out[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     "library": IVF_LIBRARY[int8], "design": design, **bnd}
    return out, launches


def phase_binary(cc, queries, tune_queries, timing_batches, truth,
                 results):
    """The binary two-stage path (kernel B5 over the snapshot's packed
    codes) with its re-rank depth tuned on held-out queries, then the
    ``rerank=1`` coarse path (kernel B6), then B5 alone at the path's shape.
    Returns (B5's numbers, the path's launches)."""
    import numpy as np
    import torch
    from fastpyvectordb_tpu_torch.kernels import hamming_kernels as hk

    t0 = time.perf_counter()
    scan = cc.enable_quantized_scan("binary", tune=False)
    rerank = scan.tune_rerank(tune_queries[:256], target_recall=TUNE_TARGET)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    hk.LAUNCHES.update({key: 0 for key in hk.LAUNCHES})
    _, _, rows = cc.search_quantized_arrays(queries, k=K)
    rec = recall_at_k(rows, truth)
    qps = timed_qps(lambda qb: cc.search_quantized_arrays(qb, k=K),
                    timing_batches)
    _, d1, r1 = cc.search_quantized_arrays(queries, k=K, rerank=1)
    # the coarse scores are Hamming counts: integers in [0, D], ascending
    if (not np.array_equal(d1, np.round(d1)) or d1.min() < 0
            or d1.max() > DIMS or not (np.diff(d1, axis=1) >= 0).all()):
        raise AssertionError("binary rerank=1: scores are not sorted counts")
    launches = dict(hk.LAUNCHES)
    log(f"[binary] kernel launches on the binary path: {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the binary path ran without {name}")
    results["binary_2stage"] = {
        "recall": rec, "qps": qps, "rerank": rerank, "build_s": build_s,
        "recall_rerank1": recall_at_k(r1, truth)}
    log(f"[binary] build + tune {build_s:.1f} s: "
        f"{results['binary_2stage']}")
    # the first stage alone at the path's own shape (B=1024 x 1M rows)
    qc = scan.quantizer.encode(torch.as_tensor(queries, device="cuda"))
    codes = scan.codes
    check_hamming("hamming_mxu_scores", hk.hamming_mxu_scores,
                  hk.hamming_mxu_scores_plain, qc, codes)
    ms = cuda_ms(lambda: hk.hamming_mxu_scores(qc, codes), reps=5)
    plain_ms = cuda_ms(lambda: hk.hamming_mxu_scores_plain(qc, codes), reps=1)
    library_ms = cuda_ms(hamming_library(qc, codes), reps=5)
    n, w = codes.shape
    bnd = hamming_bound(BATCH, n, w)
    log(f"[kernels] hamming_mxu_scores main path B={BATCH} N={n} W={w}: "
        f"equal to plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']})")
    return ({"hamming_mxu_scores": {
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "library": HAMMING_LIBRARY,
        "shape": [BATCH, n, w], **bnd}}, launches)


def ivfpq_kernel_case(ann, queries, nprobe: int):
    """``grouped_cell_scores_pq``'s operands exactly as the main path makes
    them for one batch at ``nprobe``."""
    import torch
    from fastpyvectordb_tpu_torch.ann.ivf_grouped import (grouped_qcap,
                                                          probe_cells)
    from fastpyvectordb_tpu_torch.ann.ivfpq import (_pq_route,
                                                    pq_cell_score_args)
    nlist, cmax = ann.row_table.shape
    qf = torch.as_tensor(queries, device="cuda")
    _, route = _pq_route(qf, ann.centroids, ann._collection.config.metric)
    _, args = pq_cell_score_args(
        qf, probe_cells(-route, nprobe), ann._codes_t_cached(),
        ann.codebooks, ann._extents_cached(),
        qcap=grouped_qcap(qf.shape[0], nprobe, nlist, cmax))
    return args


def pq_ragged_case(gen, nlist, u, n_uniq, qcap, cmax, m, kk, b, loads=None):
    """Synthetic B7 operands at a ragged shape, with empty slots (each
    compact row's live slots a prefix, ``loads`` of them or a random count),
    a padding tail (compact slots past n_uniq alias cell 0) and cell
    extents drawn from 0..cmax (cell 0 full)."""
    import torch
    rnd = dict(generator=gen, device="cuda")
    ids = torch.randperm(nlist, **rnd)[:u].int()
    ids[n_uniq:] = 0
    cell_ids = torch.cat([torch.tensor([n_uniq], device="cuda",
                                       dtype=torch.int32), ids])
    lut = torch.randn((b, m * kk), **rnd).bfloat16()
    load = torch.randint(1, qcap + 1, (u, 1), **rnd)
    if loads is not None:
        load = torch.tensor(loads, device="cuda")[:u, None]
    qslot = torch.where(torch.arange(qcap, device="cuda")[None, :] < load,
                        torch.randint(0, b, (u, qcap), **rnd), -1).int()
    codes_t = torch.randint(0, kk, (nlist, m, cmax), dtype=torch.uint8,
                            **rnd)
    extent = torch.randint(0, cmax + 1, (nlist,), **rnd).int()
    extent[0] = cmax
    return cell_ids, lut, qslot, codes_t, extent


def pq_live_rows(args):
    """(n_uniq, qcap, cmax) bool: the (slot, cell row) entries B7 writes,
    live slots of the compact cells by the rows below each cell's
    extent."""
    import torch
    cell_ids, _, qslot, codes_t, extent = args
    n = int(cell_ids[0])
    ext = extent[cell_ids[1:1 + n].long()]
    below = (torch.arange(codes_t.shape[2], device=ext.device)[None, :]
             < ext[:, None])
    return (qslot[:n] >= 0)[:, :, None] & below[:, None, :]


def check_pq_kernel(args):
    """B7 against its plain version on the live slots of the compact cells
    and the rows below each cell's extent (the kernel leaves the rest
    unwritten)."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import ivf_kernels as ik
    got = ik.grouped_cell_scores_pq(*args)
    want = ik.grouped_cell_scores_pq_plain(*args)
    torch.cuda.synchronize()
    n = int(args[0][0])
    live = pq_live_rows(args)
    g, w = got[:n][live], want[:n][live]
    if not torch.isfinite(g).all():
        raise AssertionError("grouped_cell_scores_pq: non-finite output")
    err = (g - w).abs().max().item() if g.numel() else 0.0
    tol = PQ_RTOL * max(w.abs().max().item() if w.numel() else 0.0, 1.0)
    if err > tol:
        raise AssertionError(f"grouped_cell_scores_pq: max|kernel-plain| "
                             f"{err:.3g} > {tol:.3g}")
    return err, tol


def pq_bound(args) -> dict:
    """B7 at the path's operands: the ADC tables, the slot table and the
    probed cells' live codes in, one f32 per filled slot and live cell row
    out; one f32 add per (filled slot, live cell row, subspace)."""
    import torch
    cell_ids, lut, qslot, codes_t, extent = args
    n = int(cell_ids[0])
    m = codes_t.shape[1]
    rows = int(extent[cell_ids[1:1 + n].long()].sum())
    pairs = float(pq_live_rows(args).sum())
    nbytes = (4 * cell_ids.numel() + 2 * lut.numel() + 4 * n * qslot.shape[1]
              + rows * m + 4 * pairs)
    out = bound(nbytes, pairs * m, "f32")
    # beside the bound: the same lookups out of shared memory with no bank
    # conflict, one 4-byte bank word a lane a clock on every SM
    props = torch.cuda.get_device_properties(0)
    out["lookup_ms"] = (pairs * m / (
        props.multi_processor_count * 32 * sm_clock_hz()) * 1e3)
    return out


def sm_clock_hz() -> float:
    """The card's maximum SM clock."""
    import torch
    khz = getattr(torch.cuda.get_device_properties(0), "clock_rate", None)
    if khz:
        return khz * 1e3
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def phase_ivfpq(cc, queries, tune_queries, timing_batches, truth, results):
    """IVF-PQ at its defaults (K=256, M=D/8, cell factor 1.5, spill 8,
    re-rank 16), nprobe and re-rank tuned jointly on held-out queries; the
    grouped dispatch runs kernel B7.  Then per-query vs grouped, a filtered
    search, and B7 against its plain version at the main path's own
    operands and at ragged shapes."""
    import numpy as np
    import torch
    from fastpyvectordb_tpu_torch import Filter
    from fastpyvectordb_tpu_torch.kernels import ivf_kernels as ik

    t0 = time.perf_counter()
    cc.build_ann("ivfpq", tune=False)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ann = cc._ann
    st = ann.stats()
    log(f"[ivfpq] build {build_s:.2f} s, stats {st}")
    if (st["nlist"], st["m"], st["pq_k"], st["cmax"]) != (2000, 96, 256,
                                                          768):
        raise AssertionError(f"ivfpq: unexpected layout {st}")
    recipe_nprobe = ann.nprobe
    t0 = time.perf_counter()
    # the joint tuner doubles nprobe to its limit before it deepens the
    # re-rank; on this corpus the PQ ordering, not the routing, limits
    # recall (within a cluster the codes' error exceeds the score spread:
    # recall@10 0.751 / 0.900 / 0.986 at rerank 16 / 64 / 128 for every
    # nprobe from 32 to 2000), so nprobe stops at 2x the default and the
    # re-rank may go past the tuner's default cap of 64
    nprobe, rerank, tune_rec = ann.tune(tune_queries[:256],
                                        target_recall=TUNE_TARGET,
                                        max_nprobe=2 * recipe_nprobe,
                                        max_rerank=256)
    log(f"[ivfpq] tuned on held-out queries in "
        f"{time.perf_counter() - t0:.1f} s: nprobe {recipe_nprobe} -> "
        f"{nprobe}, rerank {rerank}, recall@10 {tune_rec:.4f}")

    # -- the counted IVF-PQ path -----------------------------------------
    ik.LAUNCHES.update({key: 0 for key in ik.LAUNCHES})
    _, _, rows = cc.search_arrays(queries, k=K)
    out = {"recall": recall_at_k(rows, truth),
           "qps": timed_qps(lambda qb: cc.search_arrays(qb, k=K),
                            timing_batches),
           "nprobe": ann.nprobe, "rerank": ann.rerank, "qcap": ann.last_qcap,
           "dropped_pairs": ann.last_dropped, "build_s": build_s,
           "overflow_rows": st["overflow_rows"],
           "codes_bytes": st["codes_bytes"]}
    # read before the checks below, which force a route of their own
    launches = {"grouped_cell_scores_pq": ik.LAUNCHES["grouped_cell_scores_pq"]}
    log(f"[ivfpq] kernel launches on the IVF-PQ path (B={BATCH} batches "
        f"through search_arrays): {launches}")
    if launches["grouped_cell_scores_pq"] == 0:
        raise AssertionError("the IVF-PQ path ran without "
                             "grouped_cell_scores_pq")
    d_pq, r_pq = ann.search(queries[:8], K, grouped=False)
    d_g, r_g = ann.search(queries[:8], K, grouped=True)
    if ann.last_dropped == 0 and not same_up_to_ties(d_pq, r_pq, d_g, r_g):
        raise AssertionError("ivfpq: per-query and grouped dispatch "
                             "disagree on a B=8 batch")
    log(f"[ivfpq] B=8 per-query vs grouped: same ids up to ties (max score "
        f"gap {np.abs(d_pq - d_g).max():.3g})")
    _, _, frows = cc.search_arrays(queries[:64], k=K,
                                   filter=Filter.eq("cat", 3))
    if not (frows % 10 == 3).all():
        raise AssertionError("filtered IVF-PQ: a hit does not match")
    log("[ivfpq] filtered IVF-PQ (cat == 3, 64 queries): every hit matches")
    results["ivfpq_grouped"] = out
    log(f"[ivfpq] {out}")

    # -- the kernel against its plain version -----------------------------
    worst = 0.0
    for npb in sorted({recipe_nprobe, ann.nprobe}):
        args = ivfpq_kernel_case(ann, queries, npb)
        err, tol = check_pq_kernel(args)
        worst = max(worst, err)
        u, qcap = args[2].shape
        log(f"[kernels] grouped_cell_scores_pq main path nprobe {npb} U={u} "
            f"n_uniq={int(args[0][0])} qcap={qcap} cmax={args[3].shape[2]} "
            f"M={args[3].shape[1]} K={args[1].shape[1] // args[3].shape[1]}:"
            f" max_abs_err {err:.3g} (tol {tol:.3g})")
    gen = torch.Generator(device="cuda").manual_seed(13)
    for shape in PQ_RAGGED:
        err, tol = check_pq_kernel(pq_ragged_case(gen, *shape))
        worst = max(worst, err)
        log(f"[kernels] grouped_cell_scores_pq {shape}: max_abs_err "
            f"{err:.3g} (tol {tol:.3g})")
    args = ivfpq_kernel_case(ann, queries, ann.nprobe)
    ms = cuda_ms(lambda: ik.grouped_cell_scores_pq(*args))
    made, over_cmax = ik.last_pq_tiles()
    skipped = 1.0 - made / max(over_cmax, 1)
    log(f"[kernels] grouped_cell_scores_pq main path nprobe {ann.nprobe}: "
        f"{made} row tiles of {over_cmax} over all of cmax "
        f"({100 * skipped:.1f}% skipped past the cells' extents)")
    plain_ms = cuda_ms(lambda: ik.grouped_cell_scores_pq_plain(*args),
                       reps=3)
    bnd = pq_bound(args)
    log(f"[kernels] grouped_cell_scores_pq main path nprobe {ann.nprobe} "
        f"({ik.PQ_DESIGN}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), conflict-free "
        f"shared-memory lookups {bnd['lookup_ms']:.4f} ms")
    return ({"grouped_cell_scores_pq": {
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "library_ms": None, "design": ik.PQ_DESIGN,
        "row_tiles": made, "row_tiles_over_cmax": over_cmax,
        "library": "none: no PyTorch call looks up a table through a slot "
                   "table", **bnd}}, launches)


def phase_pq_scan(db, host, queries, timing_batches, results):
    """The pq scan kind once, at its defaults (m=8, K=256), on the first
    65,536 rows.  Recall against that collection's exact scan and QPS are
    printed with no gate: m=8 is a compression setting, not a serving
    recipe, and the path runs no hand kernel."""
    import torch
    pc = db.create_collection("pq", dimensions=DIMS, metric="cosine")
    pc.insert_batch(host[:BLOCK_ROWS], [f"p{i}" for i in range(BLOCK_ROWS)])
    _, _, truth = pc.search_arrays(queries, k=K)
    t0 = time.perf_counter()
    scan = pc.enable_quantized_scan("pq", tune=False)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    _, _, rows = pc.search_quantized_arrays(queries, k=K)
    results["pq_2stage_65536"] = {
        "recall": recall_at_k(rows, truth),
        "qps": timed_qps(lambda qb: pc.search_quantized_arrays(qb, k=K),
                         timing_batches),
        "rerank": scan.default_rerank, "build_s": build_s, "gated": False}
    log(f"[pq] pq scan kind on {BLOCK_ROWS} rows (no gate): "
        f"{results['pq_2stage_65536']}")
    db.delete_collection("pq")


BIG_ROWS_SMALL = 262_144      # depth of the int4 and binary BigCollections
BIG_INSERT_BATCHES = 4


def big_rows(hits):
    """Row numbers of a ``search_batch`` result whose ids are ``v<row>``,
    -1 where a query has fewer hits."""
    import numpy as np
    rows = np.full((len(hits), K), -1, dtype=np.int64)
    for b, hl in enumerate(hits):
        rows[b, :len(hl)] = [int(h.id[1:]) for h in hl]
    return rows


def phase_bigcollection(tmpdir, host, ids, metas, queries, tune_queries,
                        timing_batches, truth, results):
    """``BigCollection``: vectors on the host, codes on the card, exact
    re-rank on the host.  The int8 codec on all 1M rows (its coarse scan is
    kernel B8 under the folded product): inserted in batches so that the
    code buffers grow, searched, filtered, tombstoned, saved and reloaded
    into a new object.  The int4 (B4) and binary (B5) codecs on the first
    262,144 rows, against that subset's exact top-k."""
    import numpy as np
    import torch
    from fastpyvectordb_tpu_torch import BigCollection, Filter

    # -- int8, all rows ----------------------------------------------------
    t0 = time.perf_counter()
    big = BigCollection(DIMS, metric="cosine", codec="int8",
                        base_path=tmpdir / "big_int8", device="cuda")
    caps = []
    step = -(-N_ROWS // BIG_INSERT_BATCHES)
    for s in range(0, N_ROWS, step):
        big.insert_batch(host[s:s + step], ids[s:s + step],
                         metas[s:s + step])
        caps.append(big._code_cap)
    torch.cuda.synchronize()
    st = big.stats()
    log(f"[big] int8: {N_ROWS} rows in {len(caps)} batches in "
        f"{time.perf_counter() - t0:.1f} s, code capacity {caps}, {st}")
    if (big.count() != N_ROWS or len(set(caps)) < 2 or caps[-1] != 1 << 20
            or st["device_code_capacity_bytes"] != (1 << 20) * DIMS
            or big._codes.device.type != "cuda"):
        raise AssertionError(f"big int8: unexpected layout {caps} {st}")
    zero_launches()
    hits = big.search_batch(queries, k=K)
    launches = nonzero_launches()
    rows = big_rows(hits)
    rec = recall_at_k(rows, truth)
    scores = np.array([[h.score for h in hl] for hl in hits])
    if scores.shape != (BATCH, K) or not np.isfinite(scores).all() \
            or not (np.diff(scores, axis=1) >= 0).all():
        raise AssertionError("big int8: scores are not K sorted finite hits")
    if launches.get("s8_topc", 0) == 0 or launches.get("s8_scores", 0):
        raise AssertionError(f"big int8: launches {launches}, expected "
                             "s8_topc only")
    if rec < RECALL_GATE:
        raise AssertionError(f"big int8: recall@10 {rec:.4f} < {RECALL_GATE}")
    # the final scores are exact: hold a few against the f64 host scan
    ref = host_scores(queries[:4], host)
    gap = np.abs(scores[:4] - np.take_along_axis(ref, rows[:4], axis=1)).max()
    if gap > 1e-5:
        raise AssertionError(f"big int8: score gap {gap:.3g} to a f64 scan")
    qps = timed_qps(lambda qb: big.search_batch(qb, k=K), timing_batches[:2])
    fhits = big.search_batch(queries[:64], k=K, filter=Filter.eq("cat", 3))
    frows = big_rows(fhits)
    if not (frows % 10 == 3).all():    # an empty slot (-1) fails too
        raise AssertionError("big int8 filtered: a hit does not match")
    fref = np.sort(host_scores(queries[:64], host[3::10]), axis=1)[:, :K]
    frec = float(np.mean(np.abs(np.array(
        [[h.score for h in hl] for hl in fhits]) - fref) <= 1e-5))
    if frec < RECALL_GATE:
        raise AssertionError(f"big int8 filtered: {frec:.4f} of the exact "
                             "filtered scores")
    dead = [hl[0].id for hl in hits[:32]]
    if big.delete_batch(dead) != len(set(dead)):
        raise AssertionError("big int8: delete_batch missed an id")
    after = big.search_batch(queries[:32], k=K)
    if any(h.id in set(dead) for hl in after for h in hl):
        raise AssertionError("big int8: a deleted id came back")
    t0 = time.perf_counter()
    big.save()
    before = big_rows(big.search_batch(queries[:128], k=K))
    del big
    torch.cuda.empty_cache()
    big2 = BigCollection(DIMS, base_path=tmpdir / "big_int8", device="cuda")
    same = recall_at_k(big_rows(big2.search_batch(queries[:128], k=K)),
                       before)
    if (big2.codec != "int8" or big2.count() != N_ROWS - len(set(dead))
            or same < 0.999):
        raise AssertionError(f"big int8 reload: ids {same:.4f} of before")
    results["big_int8"] = {"recall": rec, "qps": qps, "rerank": big2.rerank,
                           "launches": launches, "filtered_exact": frec}
    log(f"[big] int8: {results['big_int8']}; max score gap to a f64 host "
        f"scan {gap:.3g}; {len(set(dead))} deletes stay gone; save + reload "
        f"in {time.perf_counter() - t0:.1f} s, ids {same:.4f} of before")
    del big2
    torch.cuda.empty_cache()

    # -- int4 and binary, the first 262,144 rows ----------------------------
    n = BIG_ROWS_SMALL
    sub = torch.as_tensor(host[:n], device="cuda")

    def sub_truth(q):
        qd = torch.nn.functional.normalize(torch.as_tensor(q, device="cuda"),
                                           dim=1)
        return torch.topk(qd @ sub.T, K, dim=1).indices.cpu().numpy()

    truth_n, tune_truth = sub_truth(queries), sub_truth(tune_queries[:64])
    del sub
    for codec, kernel in (("int4", "int4_scores"),
                          ("binary", "hamming_mxu_scores")):
        t0 = time.perf_counter()
        col = BigCollection(DIMS, metric="cosine", codec=codec, device="cuda")
        col.insert_batch(host[:n], ids[:n], metas[:n])
        # the pool a codec needs is a property of the corpus: double the
        # re-rank depth on held-out queries until it clears the target
        rerank = col.rerank
        while rerank < 256 and recall_at_k(big_rows(col.search_batch(
                tune_queries[:64], k=K, rerank=rerank)),
                tune_truth) < TUNE_TARGET:
            rerank *= 2
        col.rerank = rerank
        build_s = time.perf_counter() - t0
        zero_launches()
        rows = big_rows(col.search_batch(queries, k=K))
        launches = nonzero_launches()
        if launches.get(kernel, 0) == 0:
            raise AssertionError(f"big {codec} ran without {kernel}: "
                                 f"{launches}")
        rec = recall_at_k(rows, truth_n)
        if rec < RECALL_GATE:
            raise AssertionError(f"big {codec}: recall@10 {rec:.4f} < "
                                 f"{RECALL_GATE} at rerank {rerank}")
        results[f"big_{codec}_{n}"] = {
            "recall": rec,
            "qps": timed_qps(lambda qb: col.search_batch(qb, k=K),
                             timing_batches[:1]),
            "rerank": rerank, "launches": launches, "build_s": build_s}
        log(f"[big] {codec} on {n} rows: {results[f'big_{codec}_{n}']}, "
            f"{col.memory_usage()}")
        del col
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the pipelined stream, optimize() and prewarm()
# ---------------------------------------------------------------------------

STREAM_BATCHES = 8


def phase_stream(col, batches, results):
    """``search_arrays_stream`` over distinct B=1024 batches at depth 2 on
    the 1M collection (exact f32): its triples equal ``search_arrays``' bit
    for bit; QPS of the stream and of the synchronous calls in turns; the
    int8 wire's overlap@10 against the default wire."""
    import numpy as np
    import torch

    def sync():
        return [col.search_arrays(qb, k=K) for qb in batches]

    def stream():
        return list(col.search_arrays_stream(iter(batches), k=K, depth=2))

    want, got = sync(), stream()
    for (wi, wd, wr), (gi, gd, gr) in zip(want, got):
        if not (np.array_equal(wd, gd) and np.array_equal(wr, gr)
                and (wi == gi).all()):
            raise AssertionError("stream: a triple differs from "
                                 "search_arrays'")
    qps = {}
    for name, fn in (("sync", sync), ("stream", stream), ("stream", stream),
                     ("sync", sync)):    # in turns
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        qps.setdefault(name, []).append(
            len(batches) * BATCH / (time.perf_counter() - t0))
    r8 = [r for _, _, r in col.search_arrays_stream(
        iter(batches[:2]), k=K, wire_dtype="int8")]
    overlap = float(np.mean([recall_at_k(a, b[2])
                             for a, b in zip(r8, want[:2])]))
    if overlap < 0.9:
        raise AssertionError(f"stream int8 wire: overlap@10 {overlap:.4f}")
    results["stream_exact_f32"] = {
        "recall": 1.0, "qps": float(np.mean(qps["stream"])),
        "qps_runs": qps["stream"], "sync_qps_runs": qps["sync"],
        "int8_wire_overlap": overlap, "batches": len(batches), "depth": 2}
    log(f"[stream] {len(batches)} batches of {BATCH} at depth 2: triples "
        f"equal to search_arrays' bit for bit; QPS stream {qps['stream']} "
        f"vs sync {qps['sync']} (in turns); int8 wire overlap@10 "
        f"{overlap:.4f}")


def measure_constants(store):
    """The cost model's two measured constants on this card:
    GATHER_ROW_LAT, what a randomly gathered row costs beyond its bytes (a
    B=1024 x 40-row gather from the 1M x 768 f32 store), and
    SERIAL_DISPATCH, one data-dependent serial step (a gather of 128 rows,
    their product with a query and a top-32 whose rows the next step
    gathers), queued on one stream and timed with CUDA events."""
    import torch
    from fastpyvectordb_tpu_torch.core import costmodel as cm
    vectors = store.vectors[:store.count]
    n, d = vectors.shape
    gen = torch.Generator(device="cuda").manual_seed(23)
    idxs = [torch.randint(0, n, (BATCH * 40,), generator=gen, device="cuda")
            for _ in range(8)]
    it = iter(range(10 ** 9))
    ms = cuda_ms(lambda: vectors[idxs[next(it) % 8]], reps=50)
    rows = BATCH * 40
    row_bytes = d * vectors.element_size()
    gather_lat = max(ms / 1e3 / rows - row_bytes / cm.HBM_BW, 0.0)
    q = vectors[0].clone()
    state = {"idx": torch.randint(0, n, (128,), generator=gen,
                                  device="cuda")}

    def step():
        s = vectors[state["idx"]] @ q
        top = torch.topk(s, 32).indices
        state["idx"] = (state["idx"][top].repeat(4) * 7919
                        + torch.arange(128, device="cuda")) % n

    serial = cuda_ms(step, reps=400) / 1e3
    return {"GATHER_ROW_LAT": gather_lat, "SERIAL_DISPATCH": serial,
            "gather_ms": ms, "gather_rows": rows, "row_bytes": row_bytes}


def phase_optimize(col, tune_queries, results):
    """``optimize()`` on the 1M collection with its IVF index and an int8
    scan (re-rank tuned on held-out queries): every candidate timed on the
    card; then the micro-timing of the cost model's measured constants,
    then ``prewarm(max_batch=1024)``."""
    import torch
    from fastpyvectordb_tpu_torch.core import costmodel as cm
    scan = col.enable_quantized_scan("int8", tune=False)
    scan.tune_rerank(tune_queries[:256], target_recall=RECALL_GATE)
    t0 = time.perf_counter()
    report = col.optimize()
    opt_s = time.perf_counter() - t0
    for mode in ("exact", "quantized", "ann"):
        if "cost_us_measured" not in report.get(mode, {}):
            raise AssertionError(f"optimize: {mode} has no measured cost: "
                                 f"{report}")
    log(f"[optimize] {opt_s:.3f} s; installed {report['installed']}; "
        f"report {json.dumps(report)}")
    consts = measure_constants(col._store)
    card = nvidia_smi_line()
    log(f"[optimize] cost model constants measured on {card}: "
        f"GATHER_ROW_LAT {consts['GATHER_ROW_LAT']!r} s/row (gather of "
        f"{consts['gather_rows']} rows of {consts['row_bytes']} B: "
        f"{consts['gather_ms']!r} ms), SERIAL_DISPATCH "
        f"{consts['SERIAL_DISPATCH']!r} s/step; the package holds "
        f"{cm.GATHER_ROW_LAT!r} and {cm.SERIAL_DISPATCH!r}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = col.prewarm(max_batch=1024)
    log(f"[prewarm] max_batch 1024 in {time.perf_counter() - t0:.2f} s: "
        f"{warm}")
    if len(warm) != 3 * 11:
        raise AssertionError(f"prewarm: {sorted(warm)}")
    results["optimize"] = {"installed": report["installed"],
                           "report": report, "constants": consts,
                           "card": card, "prewarm_s": warm}


# ---------------------------------------------------------------------------
# WAL durability: a writer on the card, SIGKILLed after its last ack
# ---------------------------------------------------------------------------

WAL_BATCHES, WAL_ROWS, WAL_FSYNC_BATCHES = 64, 4096, 4
WAL_CHANGED = 41                  # 1% of a batch's ids deleted, 1% updated

_WAL_WRITER = '''
import sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from fastpyvectordb_tpu_torch import VectorDB
col = VectorDB(sys.argv[2], device="cuda").create_collection(
    "w", dimensions=cs.DIMS, metric="cosine", durability="wal",
    wal_fsync=True)
for b in range(cs.WAL_BATCHES):
    if b == cs.WAL_FSYNC_BATCHES:
        col._wal.fsync = False
    v, ids, metas, dead, upd = cs.wal_batch(b)
    t0 = time.perf_counter()
    col.insert_batch(v, ids, metas)
    t1 = time.perf_counter()
    col.delete_batch(dead)
    for i in upd:
        col.update_metadata(i, {"upd": b})
    print(f"ack {b} {t1 - t0!r} {time.perf_counter() - t1!r}", flush=True)
print("done", flush=True)
time.sleep(3600)
'''


def wal_batch(b: int):
    """Batch ``b`` of the WAL phase: rows from a seeded generator on the
    card, ids, metadata, the ids it deletes and those it updates."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1000 + b)
    v = torch.randn((WAL_ROWS, DIMS), generator=gen,
                    device="cuda").cpu().numpy()
    ids = [f"w{b}_{i}" for i in range(WAL_ROWS)]
    metas = [{"b": b, "i": i, "cat": i % 10} for i in range(WAL_ROWS)]
    step = WAL_ROWS // WAL_CHANGED
    return (v, ids, metas, ids[::step][:WAL_CHANGED],
            ids[step // 2::step][:WAL_CHANGED])


def phase_wal(tmpdir: Path, queries, results):
    """A child process writes a ``durability="wal"`` collection on the card
    (64 batches of 4,096 x 768 rows with metadata, 1% of each batch's ids
    deleted and 1% updated, the first 4 batches with fsync) and prints an
    acknowledgement a batch; after the last one the parent SIGKILLs it (no
    ``save()``), reopens the directory through ``VectorDB`` and checks
    every acknowledged write, a B=1024 search against an in-memory
    collection given the same operations, that ``save()`` empties the log
    and that a further reopen reads the snapshot alone."""
    import signal
    import numpy as np
    import torch
    from fastpyvectordb_tpu_torch import Collection, CollectionConfig, VectorDB
    path = tmpdir / "wal_db"
    proc = subprocess.Popen([sys.executable, "-c", _WAL_WRITER, str(ROOT),
                             str(path)], stdout=subprocess.PIPE, text=True)
    acks = []
    try:
        for line in proc.stdout:
            if line.startswith("ack"):
                _, b, ins, rest = line.split()
                acks.append((int(b), float(ins), float(rest)))
            elif line.startswith("done"):
                break
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    if [a[0] for a in acks] != list(range(WAL_BATCHES)):
        raise AssertionError(f"wal: acknowledged {len(acks)} batches")
    log_bytes = (path / "w" / "wal.log").stat().st_size
    t0 = time.perf_counter()
    db = VectorDB(str(path), device="cuda")
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    col = db["w"]
    ref = Collection(CollectionConfig(name="ref", dimensions=DIMS,
                                      metric="cosine"), device="cuda")
    live, metas = [], {}
    for b in range(WAL_BATCHES):
        v, ids, md, dead, upd = wal_batch(b)
        ref.insert_batch(v, ids, md)
        ref.delete_batch(dead)
        for i in upd:
            ref.update_metadata(i, {"upd": b})
        gone = set(dead)
        keep = [j for j, i in enumerate(ids) if i not in gone]
        got = col.get_batch([ids[j] for j in keep], include_vectors=True)
        if any(g is None for g in got) or any(
                col.get(i) is not None for i in dead):
            raise AssertionError(f"wal: batch {b}: ids differ")
        if not np.array_equal(np.stack([g["vector"] for g in got]), v[keep]):
            raise AssertionError(f"wal: batch {b}: vectors differ")
        want_md = [{**md[j], **({"upd": b} if ids[j] in set(upd) else {})}
                   for j in keep]
        if [g["metadata"] for g in got] != want_md:
            raise AssertionError(f"wal: batch {b}: metadata differ")
        live += [ids[j] for j in keep]
    n_live = WAL_BATCHES * (WAL_ROWS - WAL_CHANGED)
    if col.count() != n_live or sorted(col.all_ids()) != sorted(live):
        raise AssertionError(f"wal: count {col.count()} != {n_live}")
    a, b_ = col.search_arrays(queries, k=K), ref.search_arrays(queries, k=K)
    if not (np.array_equal(a[1], b_[1]) and np.array_equal(a[2], b_[2])):
        raise AssertionError("wal: a B=1024 search differs from the "
                             "in-memory collection's")
    col.save()
    if (path / "w" / "wal.log").stat().st_size != 0:
        raise AssertionError("wal: save() left the log non-empty")
    del col, db
    db2 = VectorDB(str(path), device="cuda")
    c2 = db2["w"]
    if c2.count() != n_live or not np.array_equal(
            c2.search_arrays(queries, k=K)[2], b_[2]):
        raise AssertionError("wal: the reopened snapshot differs")
    fs = [a[1] for a in acks[:WAL_FSYNC_BATCHES]]
    nofs = [a[1] for a in acks[WAL_FSYNC_BATCHES:]]
    out = {"rows": WAL_BATCHES * WAL_ROWS, "live": n_live,
           "log_bytes": log_bytes, "replay_s": replay_s,
           "insert_rows_per_s_fsync": WAL_ROWS * len(fs) / sum(fs),
           "insert_rows_per_s": WAL_ROWS * len(nofs) / sum(nofs),
           "delete_update_s_per_batch": float(np.mean([a[2] for a in acks]))}
    results["wal"] = out
    log(f"[wal] SIGKILLed writer after {len(acks)} acknowledged batches; "
        f"reopen (replay of {log_bytes} log bytes) {replay_s:.2f} s; every "
        f"acknowledged write read back (ids, vectors bit for bit, "
        f"metadata), search equal to the in-memory collection's, save() "
        f"empties the log, the snapshot reopens alone: {out}")
    del c2, db2, ref
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# out-of-core: a 2M x 768 f32 memmap streamed tile by tile
# ---------------------------------------------------------------------------

OOC_ROWS = 1 << 21            # 2,097,152 rows: 6.4 GB of f32 (a cut)
OOC_TILE = 262_144            # the searchers' default tile
OOC_SMALL = 1 << 20           # int4 / binary / pq depth (a cut)
OOC_CODECS = {"int4": "s8_topc", "binary": "hamming_mxu_scores",
              "pq": None}


def write_ooc_corpus(path: Path, host):
    """The out-of-core corpus as an ``np.memmap``: the 1M collection's rows,
    then rows made on the card from a seeded generator around the same
    centres, written one tile at a time (the host never holds it whole)."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                   shape=(OOC_ROWS, DIMS))
    mm[:host.shape[0]] = host
    gen = torch.Generator(device="cuda").manual_seed(31)
    centers = 2.0 * torch.randn((N_CENTERS, DIMS), generator=gen,
                                device="cuda")
    for s in range(host.shape[0], OOC_ROWS, OOC_TILE):
        e = min(s + OOC_TILE, OOC_ROWS)
        t = clustered(gen, e - s, centers, 1.0)
        t /= torch.linalg.norm(t, dim=1, keepdim=True)
        mm[s:e] = t.cpu().numpy()
    mm.flush()
    del mm
    log(f"[ooc] corpus {OOC_ROWS}x{DIMS} f32 ({OOC_ROWS * DIMS * 4 / 1e9:.1f}"
        f" GB) written to a memmap in {time.perf_counter() - t0:.1f} s")
    return np.load(path, mmap_mode="r")


def link_rate() -> float:
    """Pinned host -> device bytes/s: one 1 GiB copy, CUDA events."""
    import torch
    n = 1 << 30
    h = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    d = torch.empty(n, dtype=torch.uint8, device="cuda")
    d.copy_(h, non_blocking=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    d.copy_(h, non_blocking=True)
    end.record()
    torch.cuda.synchronize()
    return n / (start.elapsed_time(end) / 1e3)


def _tile_arrays(searcher):
    """What a search stages a tile, as (host arrays by tile, device dtypes):
    the corpus rows (exact) or the codes and the row stat (quantized; rinv,
    the smoke's metric being cosine)."""
    import numpy as np
    import torch
    from fastpyvectordb_tpu_torch.core import outofcore as ooc
    if isinstance(searcher, ooc.OutOfCoreSearcher):
        wire = (torch.bfloat16 if searcher.compute_dtype == "bfloat16"
                else torch.float32)
        return (lambda s, e: [np.asarray(searcher.corpus[s:e])]), [wire]
    codes = searcher._codes
    dt = [ooc._TILE_DTYPE[searcher.codec]]
    if searcher.codec in ("int8", "int4"):
        dt.append(torch.float32)
        return (lambda s, e: [codes[s:e], searcher._rinv[s:e]]), dt
    if searcher.codec == "binary":
        return (lambda s, e: [codes[s:e].view(np.int32)]), dt
    return (lambda s, e: [codes[s:e]]), dt


def copies_alone(searcher) -> float:
    """Seconds to stage every tile of a search with no scoring."""
    import torch
    from fastpyvectordb_tpu_torch.core import outofcore as ooc
    arrays, dts = _tile_arrays(searcher)
    n, t = searcher.n, min(searcher.tile_rows, searcher.n)
    specs = [((t,) + tuple(a.shape[1:]), dt)
             for a, dt in zip(arrays(0, 1), dts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stager = ooc.TileStager(ooc.streams_for(torch.device("cuda")), specs)
    for s in range(0, n, t):
        parts = arrays(s, min(s + t, n))
        stager.stage(parts[0].shape[0], lambda *v: [
            x.copy_(ooc._host_tensor(p)) for x, p in zip(v, parts)])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def kernels_alone(searcher, q, k: int, c: int) -> float:
    """Seconds of a search's tile steps and merges with every tile already
    on the card (the first tile's data, at each tile's size)."""
    import torch
    from fastpyvectordb_tpu_torch.core import outofcore as ooc
    arrays, dts = _tile_arrays(searcher)
    n, t = searcher.n, min(searcher.tile_rows, searcher.n)
    dev = [ooc._host_tensor(a).to("cuda", dt) if dt == torch.bfloat16
           else ooc._host_tensor(a).to("cuda")
           for a, dt in zip(arrays(0, t), dts)]
    exact = isinstance(searcher, ooc.OutOfCoreSearcher)
    if exact:
        qd = torch.as_tensor(q, device="cuda")
    else:
        step = searcher._coarse_step(q)

    def run():
        best = None
        for s in range(0, n, t):
            rows = min(t, n - s)
            if exact:
                v, r = ooc._tile_step(qd, dev[0][:rows], None,
                                      metric=searcher.metric, k=k,
                                      compute_dtype=searcher.compute_dtype)
            else:
                stat = dev[1][:rows] if len(dev) > 1 else None
                v, r = step(dev[0][:rows], stat, None, min(c, rows))
            best = ooc._merge(best, v, r + s, c)
        return best

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def ooc_pass(label, searcher, batches, rate, results, launches_of=None,
             truth=None, **search_kw):
    """QPS over distinct batches; link bytes and the streamed pass's share
    of the link bound; the streamed pass (a quantized search's coarse scan,
    up to its candidates on the host) beside its copies alone and its
    kernels alone, and the host re-rank after it; the launch counts of one
    pass."""
    import numpy as np
    from fastpyvectordb_tpu_torch.kernels import hamming_kernels as hk
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    walls, coarse, rows = [], [], None
    for i, qb in enumerate(batches):
        for mod in (hk, s8):
            mod.LAUNCHES.update({key: 0 for key in mod.LAUNCHES})
        t0 = time.perf_counter()
        _, r = searcher.search(qb, k=K, **search_kw)
        walls.append(time.perf_counter() - t0)
        # the streamed pass alone: an exact search is nothing else; a
        # quantized one then gathers and re-ranks on the host
        coarse.append(getattr(searcher, "last_coarse_s", walls[-1]))
        if i == 0:
            counted = {k: v for mod in (hk, s8)
                       for k, v in mod.LAUNCHES.items() if v}
            rows = r
    tiles = -(-searcher.n // searcher.tile_rows)
    c = K * (search_kw.get("rerank") or getattr(searcher, "rerank", 1))
    c = min(c, searcher.n)
    if launches_of is not None:
        name = "s8_topc_wide" if (launches_of == "s8_topc"
                                  and c > s8.TOPC_MAX) else launches_of
        if counted.get(name) != tiles:
            raise AssertionError(f"ooc {label}: {counted}, expected {name} "
                                 f"once per tile ({tiles})")
    link = searcher.last_link_bytes
    streamed = float(np.mean(coarse))
    copies = copies_alone(searcher)
    kern = kernels_alone(searcher, batches[0], K, c)
    out = {"rows": searcher.n, "tiles": tiles,
           "qps": len(batches) * BATCH / sum(walls), "walls_s": walls,
           "streamed_pass_s": coarse,
           "host_rerank_s": float(np.mean(walls)) - streamed,
           "link_bytes": link, "link_bound_s": link / rate,
           "link_share": link / rate / streamed, "copies_alone_s": copies,
           "kernels_alone_s": kern,
           "overlap_saves_s": copies + kern - streamed, "launches": counted}
    if truth is not None:
        out["recall"] = recall_at_k(rows, truth)
    results[f"ooc_{label}"] = out
    log(f"[ooc] {label}: {out}")
    return rows


def phase_outofcore(tmpdir, host, queries, tune_queries, timing_batches,
                    truth, exact_scores, results):
    """``OutOfCoreSearcher`` (f32 and bf16) and ``QuantizedOutOfCoreSearcher``
    (int8) over a 2M x 768 memmap; int4, binary and pq over its first
    1,048,576 rows.  Checks: the streamed exact scan of the 1M collection's
    rows equals its in-memory exact scan; int8 codes written through
    ``codes_path`` and adopted with ``codes_reuse=True`` search alike; each
    codec tuned on 256 held-out queries reaches recall@10 >= 0.95 against
    the streamed exact search on 1,024 others; s8_topc (int8, int4) and B5
    (binary) launch once per tile."""
    import numpy as np
    import torch
    from fastpyvectordb_tpu_torch.core.outofcore import (
        OutOfCoreSearcher, QuantizedOutOfCoreSearcher)
    from fastpyvectordb_tpu_torch.kernels import hamming_kernels as hk
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    mm = write_ooc_corpus(tmpdir / "ooc_corpus.npy", host)
    rate = link_rate()
    log(f"[ooc] pinned host -> device link: {rate / 1e9:.2f} GB/s (1 GiB "
        "copy, CUDA events)")
    results["ooc_link"] = {"pinned_h2d_bytes_per_s": rate}
    batches = timing_batches[:2]

    # the streamed exact scan of the 1M collection's rows (3 full tiles and
    # a ragged one) against the collection's in-memory exact scan
    d1, r1 = OutOfCoreSearcher(mm[:host.shape[0]], tile_rows=OOC_TILE,
                               device="cuda").search(queries, k=K)
    if not same_up_to_ties(d1, r1, exact_scores, truth, tol=1e-5):
        raise AssertionError("ooc: the streamed exact scan of the 1M rows "
                             "differs from the in-memory scan")
    log(f"[ooc] streamed exact scan of the {host.shape[0]} collection rows: "
        f"equal to the in-memory exact scan up to ties (max score gap "
        f"{np.abs(d1 - exact_scores).max():.3g})")

    exact = OutOfCoreSearcher(mm, tile_rows=OOC_TILE, device="cuda")
    _, truth4 = exact.search(queries, k=K)
    ooc_pass("exact_f32", exact, batches, rate, results)
    bf = OutOfCoreSearcher(mm, tile_rows=OOC_TILE, compute_dtype="bfloat16",
                           device="cuda")
    _, rbf = bf.search(queries, k=K)   # also the timed passes' warm-up
    ooc_pass("exact_bf16", bf, batches, rate, results)
    results["ooc_exact_bf16"]["recall"] = recall_at_k(rbf, truth4)

    def build(label, corpus, **kw):
        t0 = time.perf_counter()
        s = QuantizedOutOfCoreSearcher(corpus, tile_rows=OOC_TILE,
                                       device="cuda", **kw)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rr = s.tune_rerank(tune_queries[:256], k=K, target_recall=TUNE_TARGET)
        tune_s = time.perf_counter() - t0
        log(f"[ooc] {label}: build {build_s:.1f} s, tune {tune_s:.1f} s -> "
            f"rerank {rr}")
        return s, build_s

    codes_path = str(tmpdir / "ooc_int8_codes.npy")
    i8, build_s = build("int8", mm, codec="int8", codes_path=codes_path)
    ooc_pass("int8", i8, batches, rate, results, "s8_topc")
    d8, r8 = i8.search(queries, k=K)
    again = QuantizedOutOfCoreSearcher(mm, codec="int8", tile_rows=OOC_TILE,
                                       device="cuda", codes_path=codes_path,
                                       codes_reuse=True, rerank=i8.rerank)
    d8b, r8b = again.search(queries, k=K)
    if not (np.array_equal(d8, d8b)
            and same_up_to_ties(d8, r8, d8b, r8b, tol=0.0)):
        raise AssertionError("ooc int8: codes_reuse searches differently")
    del again
    res = results["ooc_int8"]
    res.update(recall=recall_at_k(r8, truth4), rerank=i8.rerank,
               build_s=build_s)
    log(f"[ooc] int8 codes adopted with codes_reuse=True: equal results; "
        f"recall@10 {res['recall']:.4f} at rerank {i8.rerank}")
    del i8

    small = mm[:OOC_SMALL]
    _, truth_s = OutOfCoreSearcher(small, tile_rows=OOC_TILE,
                                   device="cuda").search(queries, k=K)
    for codec, kernel in OOC_CODECS.items():
        kw = {"pq_k": 16} if codec == "pq" else {}
        s, build_s = build(codec, small, codec=codec, **kw)
        ooc_pass(codec, s, batches, rate, results, kernel)
        _, rows = s.search(queries, k=K)
        results[f"ooc_{codec}"].update(recall=recall_at_k(rows, truth_s),
                                       rerank=s.rerank, build_s=build_s)
        del s
    for label in ("int8", "int4", "binary", "pq"):
        r = results[f"ooc_{label}"]["recall"]
        if r < RECALL_GATE:
            raise AssertionError(f"ooc {label}: recall@10 {r:.4f} < "
                                 f"{RECALL_GATE}")
    log("[ooc] recall@10 against the streamed exact search: " + ", ".join(
        f"{c} {results[f'ooc_{c}']['recall']:.4f} (rerank "
        f"{results[f'ooc_{c}']['rerank']})"
        for c in ("int8", "int4", "binary", "pq")))
    for mod in (hk, s8):
        mod.LAUNCHES.update({key: 0 for key in mod.LAUNCHES})
    del mm
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the serving layer: the port's REST / WebSocket server on the card
# ---------------------------------------------------------------------------
SERVING_PACKAGES = ("aiohttp", "pydantic", "httpx", "msgpack")
SRV_SEQ, SRV_CONC, SRV_C = 256, 2048, 64     # benchmarks/server_load.py's mix
SRV_QUERIES = SRV_SEQ + 2 * SRV_CONC + QPS_BATCHES * BATCH
SRV_WRITES, SRV_WRITE_BATCH = 4096, 256
SRV_TEXTS, TEXT_DIMS = 10_000, 384
GRAPH_NODES, GRAPH_EDGES = 5_000, 12_000     # past the native threshold
SHARD_ROWS = 131_072                         # rows a shard (a cut of depth)
MSGPACK = {"Content-Type": "application/msgpack"}


class AppThread:
    """An aiohttp application served on 127.0.0.1 by a thread with its own
    event loop (as ``tests/test_server.py`` runs it)."""

    def __init__(self, factory):
        import asyncio
        import socket
        import threading
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self.loop = asyncio.new_event_loop()
        self.error = None
        ready = threading.Event()

        def run():
            from aiohttp import web
            asyncio.set_event_loop(self.loop)
            try:
                self.app = factory()
                self.runner = web.AppRunner(self.app)
                self.loop.run_until_complete(self.runner.setup())
                self.loop.run_until_complete(web.TCPSite(
                    self.runner, "127.0.0.1", self.port).start())
            except BaseException as e:  # reported by the starting thread
                self.error = e
                ready.set()
                return
            ready.set()
            self.loop.run_forever()
            self.loop.run_until_complete(self.runner.cleanup())
            self.loop.close()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        if not ready.wait(300) or self.error is not None:
            raise RuntimeError(f"server failed to start: {self.error!r}")

    def stop(self):
        """Stop the loop; the thread then runs the app's shutdown (which
        saves its databases) and exits."""
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(300)
        if self.thread.is_alive():
            raise RuntimeError("server thread did not stop")


def _pct(lat, p) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(lat) * 1e3, p))


def drive_here(base: str, requests, concurrency: int):
    """POST each (path, kwargs) request from this process: ``concurrency``
    workers, each sending its share serially over one aiohttp session.
    Returns the responses in request order as (status, content type, body
    bytes), the per-request latencies (s) and the wall time (s)."""
    import asyncio
    import aiohttp

    async def run():
        out = [None] * len(requests)
        lat = [0.0] * len(requests)
        conn = aiohttp.TCPConnector(limit=concurrency)
        timeout = aiohttp.ClientTimeout(total=600)
        async with aiohttp.ClientSession(base, connector=conn,
                                         timeout=timeout) as s:
            async def worker(w):
                for i in range(w, len(requests), concurrency):
                    path, kw = requests[i]
                    t0 = time.perf_counter()
                    async with s.post(path, **kw) as r:
                        body = await r.read()
                    lat[i] = time.perf_counter() - t0
                    out[i] = (r.status, r.content_type, body)
            t0 = time.perf_counter()
            await asyncio.gather(*[worker(w) for w in range(concurrency)])
            return out, lat, time.perf_counter() - t0
    return asyncio.run(run())


_CLIENT = """
import importlib.util, pickle, sys
spec = importlib.util.spec_from_file_location("chip_smoke_client", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
with open(sys.argv[2], "rb") as f:
    args = pickle.load(f)
with open(sys.argv[3], "wb") as f:
    pickle.dump(mod.drive_here(*args), f)
"""


def drive(base: str, requests, concurrency: int):
    """``drive_here`` in a child process: the load generator gets its own
    interpreter, as a service's clients would, instead of taking turns
    with the server for its interpreter lock
    (``tools/serving_probe.py`` measures both)."""
    import pickle
    with tempfile.TemporaryDirectory(prefix="chip_smoke_client_") as d:
        inp, out = Path(d) / "in.pkl", Path(d) / "out.pkl"
        with open(inp, "wb") as f:
            pickle.dump((base, requests, concurrency), f)
        subprocess.run([sys.executable, "-c", _CLIENT,
                        str(Path(__file__).resolve()), str(inp), str(out)],
                       check=True, timeout=900)
        with open(out, "rb") as f:
            return pickle.load(f)


def _ok(resps, what: str):
    bad = [(st, body[:300]) for st, _, body in resps if st >= 300]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} failed responses, first "
                             f"{bad[0]}")


def _rows_of(ids) -> "np.ndarray":
    import numpy as np
    return np.array([[int(i[1:]) if i is not None else -1 for i in row]
                     for row in ids], dtype=np.int64)


def _decode_json_hits(resps):
    """JSON single/batch search responses -> (scores, rows) grids."""
    import numpy as np
    sc, ids = [], []
    for _, _, body in resps:
        res = json.loads(body)["results"]
        for hits in (res if res and isinstance(res[0], list) else [res]):
            sc.append([h["score"] for h in hits])
            ids.append([h["id"] for h in hits])
    return np.asarray(sc, np.float32), _rows_of(ids)


def _decode_msgpack_hits(resps):
    import msgpack
    import numpy as np
    sc, ids = [], []
    for _, _, body in resps:
        b = msgpack.unpackb(body, raw=False)
        rows = b["ids"] if b["ids"] and isinstance(b["ids"][0], list) \
            else [b["ids"]]
        sc.append(np.frombuffer(b["scores"], "<f4").reshape(len(rows), -1))
        ids.extend(rows)
    return np.concatenate(sc), _rows_of(ids)


def _check_same(label, got, want):
    import numpy as np
    (gd, gr), (wd, wr) = got, want
    wr = np.asarray(wr)
    if gd.shape != wd.shape or not same_up_to_ties(gd, gr, wd, wr):
        raise AssertionError(f"server {label}: results differ from the "
                             "direct Collection call")


def _wave_counter(col, name: str, waves: list):
    """Record the batch size of every call of ``col.<name>`` (the
    batcher's waves); the wrapper is an instance attribute, so the
    collection's own method runs unchanged."""
    orig = getattr(col, name)

    def counted(queries, *a, **kw):
        waves.append(len(queries))
        return orig(queries, *a, **kw)
    setattr(col, name, counted)
    return orig


def _serving_packages():
    import importlib
    missing = []
    for name in SERVING_PACKAGES:
        try:
            importlib.import_module(name)
        except ImportError:
            missing.append(name)
    return missing


def phase_server(tmpdir: Path, host, queries_srv, results):
    """The port's server (``create_app(device="cuda")``, the ``jax``
    transformer embedder, a graph, the full tier) in a thread on
    127.0.0.1 over the saved 1M x 768 collection (its IVF index and the
    int8 scan tuned on held-out queries), driven over HTTP as
    ``benchmarks/server_load.py`` drives the JAX server: sequential and
    concurrent singles (JSON exact, msgpack quantized), /search/batch at
    B=1024 (exact, quantized, filtered; msgpack and JSON), writes with a
    WebSocket change feed, texts through the embedder on the card, the
    graph past the native threshold, and two shards behind the router.
    Every served result is held against the direct ``Collection`` call."""
    import shutil
    missing = _serving_packages()
    log(f"[server] serving packages: "
        f"{', '.join(p + (' MISSING' if p in missing else ' ok') for p in SERVING_PACKAGES)}; "
        f"g++ {shutil.which('g++') or 'not found'}")
    if missing:
        raise AssertionError(f"server: the card's Python lacks {missing}")
    from fastpyvectordb_tpu_torch.server.app import create_app

    card = nvidia_smi_line()
    serve = tmpdir / "serve"
    serve.mkdir()
    shutil.move(str(tmpdir / "main"), str(serve / "main"))
    t0 = time.perf_counter()
    srv = AppThread(lambda: create_app(
        db_path=str(serve), device="cuda", embedding_provider="jax",
        graph_path=str(tmpdir / "serve_graph"), full=True))
    col = srv.app["state"]["db"]["main"]
    if col.device.type != "cuda" or col._quantized is None \
            or col._quantized.kind != "int8":
        raise AssertionError("server: the 1M collection is not on the card "
                             "with its int8 scan")
    log(f"[server] create_app(device='cuda') over the saved 1M x {DIMS} "
        f"collection: started in {time.perf_counter() - t0:.1f} s "
        f"(int8 rerank {col._quantized.default_rerank}); {card}")
    try:
        _server_searches(srv, col, queries_srv, card, results)
        _server_writes(srv, col, card, results)
        _server_texts(srv, card, results)
        _server_graph(srv, card, results)
    finally:
        # dropping the big collection first keeps the shutdown's save small
        import httpx
        httpx.delete(srv.url + "/collections/main", timeout=300)
        srv.stop()
    _server_router(tmpdir, host, queries_srv[-BATCH:], card, results)


def _server_searches(srv, col, qs, card, results):
    import msgpack
    import numpy as np
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    seq = qs[:SRV_SEQ]
    conc = qs[SRV_SEQ:SRV_SEQ + SRV_CONC]
    qconc = qs[SRV_SEQ + SRV_CONC:SRV_SEQ + 2 * SRV_CONC]
    batches = [qs[SRV_SEQ + 2 * SRV_CONC + i * BATCH:
                  SRV_SEQ + 2 * SRV_CONC + (i + 1) * BATCH]
               for i in range(QPS_BATCHES)]
    path = "/collections/main/search"

    def json_single(q):
        return (path, {"json": {"vector": q.tolist(), "k": K,
                                "mode": "exact"}})

    def mp_body(**obj):
        return {"data": msgpack.packb(obj, use_bin_type=True),
                "headers": MSGPACK}

    def direct_qps(fn, chunks) -> float:
        t0 = time.perf_counter()
        for c in chunks:
            fn(c)
        return sum(len(c) for c in chunks) / (time.perf_counter() - t0)

    def report(label, n, lat, wall, direct, extra="", launches=None):
        qps = n / wall
        results[f"server_{label}"] = {
            "gated": False, "qps": qps, "p50_ms": _pct(lat, 50),
            "p99_ms": _pct(lat, 99), "direct_qps": direct, "card": card,
            **({"launches": launches} if launches else {})}
        log(f"[server] {label}: {n} requests, QPS {qps:.1f}, client p50 "
            f"{_pct(lat, 50):.2f} ms p99 {_pct(lat, 99):.2f} ms; the "
            f"direct Collection call of the same queries {direct:.1f} QPS"
            f"{extra}; {card}")
    # the batcher's waves: JSON singles run search_batch, msgpack singles
    # search_arrays / search_quantized_arrays
    waves = []
    orig_batch = _wave_counter(col, "search_batch", waves)
    orig_arrays = _wave_counter(col, "search_arrays", waves)
    orig_quant = _wave_counter(col, "search_quantized_arrays", waves)

    # 1. sequential JSON singles, exact
    resps, lat, wall = drive(srv.url, [json_single(q) for q in seq], 1)
    _ok(resps, "sequential singles")
    _check_same("sequential singles", _decode_json_hits(resps),
                _direct(orig_arrays(seq, k=K, exact=True)))
    report("json_singles_seq", SRV_SEQ, lat, wall, direct_qps(
        lambda c: orig_arrays(c, k=K, exact=True),
        [seq[i:i + 1] for i in range(SRV_SEQ)]))

    # 2. concurrent JSON singles, exact, through the batcher's waves
    waves.clear()
    resps, lat, wall = drive(srv.url, [json_single(q) for q in conc], SRV_C)
    _ok(resps, "concurrent singles")
    mean_wave = float(np.mean(waves))
    _check_same("concurrent singles", _decode_json_hits(resps),
                _direct(orig_arrays(conc, k=K, exact=True)))
    w = max(int(round(mean_wave)), 1)
    report(f"json_singles_c{SRV_C}", SRV_CONC, lat, wall, direct_qps(
        lambda c: orig_arrays(c, k=K, exact=True),
        [conc[i:i + w] for i in range(0, SRV_CONC, w)]),
        f"; {len(waves)} waves, mean wave {mean_wave:.1f}")
    results[f"server_json_singles_c{SRV_C}"]["mean_wave"] = mean_wave

    # 3. concurrent msgpack singles, quantized: one s8_topc launch a wave
    waves.clear()
    s8.LAUNCHES.update({key: 0 for key in s8.LAUNCHES})
    resps, lat, wall = drive(srv.url, [
        (path, mp_body(vector=q.tobytes(), k=K, mode="quantized"))
        for q in qconc], SRV_C)
    launches = dict(s8.LAUNCHES)
    _ok(resps, "quantized singles")
    got = _decode_msgpack_hits(resps)
    if launches["s8_topc"] != len(waves) or launches["s8_scores"] \
            or launches["s8_topc_wide"]:
        raise AssertionError(f"server quantized singles: {len(waves)} waves "
                             f"but launches {launches}")
    _check_same("quantized singles", got,
                _direct(orig_quant(qconc, k=K)))
    exact = _direct(orig_arrays(qconc, k=K, exact=True))
    rec = recall_at_k(got[1], exact[1])
    if rec < RECALL_GATE:
        raise AssertionError(f"server quantized singles: recall@10 {rec}")
    mean_q = float(np.mean(waves))
    w = max(int(round(mean_q)), 1)
    report(f"msgpack_quantized_singles_c{SRV_C}", SRV_CONC, lat, wall,
           direct_qps(lambda c: orig_quant(c, k=K),
                      [qconc[i:i + w] for i in range(0, SRV_CONC, w)]),
           f"; {len(waves)} waves, mean wave {mean_q:.1f}, s8_topc "
           f"launches {launches['s8_topc']} (one a wave), recall@10 "
           f"{rec:.4f}", launches={"s8_topc": launches["s8_topc"]})
    results[f"server_msgpack_quantized_singles_c{SRV_C}"].update(
        mean_wave=mean_q, recall=rec, waves=len(waves))

    # 4-5. /search/batch at B=1024, msgpack (and JSON once), exact and
    # quantized, without and with the cat == 3 filter
    for where in (None, {"cat": 3}):
        tag = "" if where is None else "_cat3"
        extra = {} if where is None else {"where": where}
        for mode in ("exact", "quantized"):
            s8.LAUNCHES.update({key: 0 for key in s8.LAUNCHES})
            resps, lat, wall = drive(srv.url, [
                ("/collections/main/search/batch",
                 mp_body(vectors=b.tobytes(), k=K, mode=mode, **extra))
                for b in batches], 1)
            launches = dict(s8.LAUNCHES)
            _ok(resps, f"batch {mode}{tag}")
            got = _decode_msgpack_hits(resps)
            allq = np.concatenate(batches)
            filt = None
            if where is not None:
                from fastpyvectordb_tpu_torch import Filter
                filt = Filter.eq("cat", 3)
                if not (got[1] % 10 == 3).all():
                    raise AssertionError("server filtered batch: a hit "
                                         "misses the filter")
            if mode == "exact":
                def fn(c, filt=filt):
                    return orig_arrays(c, k=K, filter=filt, exact=True)
            else:
                def fn(c, filt=filt):
                    return orig_quant(c, k=K, filter=filt)
                if launches["s8_topc"] != QPS_BATCHES \
                        or launches["s8_scores"]:
                    raise AssertionError(f"server batch quantized{tag}: "
                                         f"launches {launches}")
            want = [_direct(fn(b)) for b in batches]
            _check_same(f"batch {mode}{tag}", got,
                        (np.concatenate([w_[0] for w_ in want]),
                         np.concatenate([w_[1] for w_ in want])))
            note, counted = "", None
            if mode == "quantized":
                ex = _direct(orig_arrays(allq, k=K, filter=filt, exact=True))
                rec = recall_at_k(got[1], ex[1])
                if rec < RECALL_GATE:
                    raise AssertionError(f"server batch quantized{tag}: "
                                         f"recall@10 {rec}")
                note = f"; s8_topc launches {launches['s8_topc']}, " \
                       f"recall@10 {rec:.4f}"
                counted = {"s8_topc": launches["s8_topc"]}
            report(f"msgpack_batch{BATCH}_{mode}{tag}",
                   QPS_BATCHES * BATCH, lat, wall,
                   direct_qps(fn, batches), note, counted)
            # the same batch over JSON once: the same hits as msgpack
            jr, jlat, jwall = drive(srv.url, [(
                "/collections/main/search/batch",
                {"json": {"vectors": batches[0].tolist(), "k": K,
                          "mode": mode, **extra}})], 1)
            _ok(jr, f"JSON batch {mode}{tag}")
            jd, jrows = _decode_json_hits(jr)
            md, mrows = got[0][:BATCH], got[1][:BATCH]
            if not same_up_to_ties(jd, jrows, md, mrows):
                raise AssertionError(f"server batch {mode}{tag}: JSON and "
                                     "msgpack differ")
            log(f"[server] json_batch{BATCH}_{mode}{tag}: one request "
                f"{jwall * 1e3:.1f} ms ({BATCH / jwall:.1f} QPS), equal to "
                f"msgpack's hits")
            results[f"server_msgpack_batch{BATCH}_{mode}{tag}"][
                "json_qps"] = BATCH / jwall
    col.search_batch = orig_batch
    col.search_arrays = orig_arrays
    col.search_quantized_arrays = orig_quant


def _direct(triple):
    """(ids, scores, rows) of a direct call -> (scores, numeric id rows)."""
    ids, scores, _ = triple
    return scores, _rows_of(ids)


def _server_writes(srv, col, card, results):
    """A WebSocket subscriber on the collection, then SRV_WRITES rows
    through /vectors/batch (msgpack): every insert event arrives, and every
    acknowledged row is found by its own vector."""
    import asyncio
    import aiohttp
    import msgpack
    import numpy as np
    rng = np.random.default_rng(21)
    rows = rng.standard_normal((SRV_WRITES, DIMS)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    ids = [f"w{i}" for i in range(SRV_WRITES)]

    async def run():
        events, acked, lat = [], [], []
        async with aiohttp.ClientSession(srv.url) as s:
            async with s.ws_connect("/ws/main") as ws:
                await ws.send_str(json.dumps({
                    "action": "subscribe", "collection": "main",
                    "event_types": ["batch_insert"]}))
                while not json.loads((await ws.receive(timeout=60)).data
                                     ).get("subscribed"):
                    pass
                t0 = time.perf_counter()
                for i in range(0, SRV_WRITES, SRV_WRITE_BATCH):
                    t1 = time.perf_counter()
                    async with s.post(
                            "/collections/main/vectors/batch",
                            headers=MSGPACK, data=msgpack.packb({
                                "vectors": rows[i:i + SRV_WRITE_BATCH
                                                ].tobytes(),
                                "ids": ids[i:i + SRV_WRITE_BATCH],
                                "metadatas": [{"cat": 99}] * SRV_WRITE_BATCH},
                                use_bin_type=True)) as r:
                        if r.status != 201:
                            raise AssertionError(f"server write: {r.status} "
                                                 f"{await r.text()}")
                        acked += msgpack.unpackb(await r.read())["ids"]
                    lat.append(time.perf_counter() - t1)
                wall = time.perf_counter() - t0
                while sum(e["data"]["count"] for e in events) < len(acked):
                    msg = await ws.receive(timeout=60)
                    events.append(json.loads(msg.data))
        return events, acked, lat, wall

    events, acked, lat, wall = asyncio.run(run())
    if acked != ids or any(e["type"] != "batch_insert"
                           or e["collection"] != "main" for e in events) \
            or len(events) != SRV_WRITES // SRV_WRITE_BATCH:
        raise AssertionError(f"server writes: {len(acked)} acknowledged, "
                             f"events {[e['type'] for e in events][:4]}...")
    resps, _, _ = drive(srv.url, [(
        "/collections/main/search/batch",
        {"data": msgpack.packb({"vectors": rows[i:i + BATCH].tobytes(),
                                "k": 1, "mode": "exact"}, use_bin_type=True),
         "headers": MSGPACK}) for i in range(0, SRV_WRITES, BATCH)], 1)
    _ok(resps, "write read-back")
    found = [row[0] for _, _, body in resps
             for row in msgpack.unpackb(body, raw=False)["ids"]]
    if found != ids:
        miss = sum(a != b for a, b in zip(found, ids))
        raise AssertionError(f"server writes: {miss} acknowledged rows not "
                             "found by their own vector")
    results["server_writes"] = {
        "gated": False, "rows_per_s": SRV_WRITES / wall,
        "p50_ms": _pct(lat, 50), "p99_ms": _pct(lat, 99),
        "events": len(events), "card": card}
    log(f"[server] writes: {SRV_WRITES} rows in {len(lat)} msgpack batches "
        f"of {SRV_WRITE_BATCH}, {SRV_WRITES / wall:.1f} rows/s (batch p50 "
        f"{_pct(lat, 50):.2f} ms p99 {_pct(lat, 99):.2f} ms); "
        f"{len(events)} batch_insert events over the WebSocket, every "
        f"acknowledged row found by its own vector; {card}")


def _texts(n: int):
    import numpy as np
    rng = np.random.default_rng(31)
    vocab = [f"w{i:04d}" for i in range(2000)] + [
        "search", "vector", "card", "graph", "server", "query", "the", "a"]
    return [" ".join(rng.choice(vocab, size=int(rng.integers(5, 40))))
            for _ in range(n)]


def _server_texts(srv, card, results):
    """SRV_TEXTS texts through /texts (the transformer embedder on the
    card), text searches, the embedder's texts/s, and its embeddings
    against the CPU embedder with the same weights."""
    import numpy as np
    from fastpyvectordb_tpu_torch.embeddings import TransformerEmbedder
    texts = _texts(SRV_TEXTS)
    _ok(drive(srv.url, [("/collections", {"json": {
        "name": "texts", "dimensions": TEXT_DIMS}})], 1)[0], "texts")
    t0 = time.perf_counter()
    resps, lat, wall = drive(srv.url, [(
        "/collections/texts/texts",
        {"json": {"text": t, "id": f"t{i}", "metadata": {"i": i}}})
        for i, t in enumerate(texts)], SRV_C)
    _ok(resps, "texts")
    emb = srv.app["state"]["embedder"]
    if not isinstance(emb, TransformerEmbedder) \
            or emb.tok.device.type != "cuda":
        raise AssertionError(f"server texts: embedder {emb!r} is not the "
                             "transformer on the card")
    probe = list(range(0, SRV_TEXTS, SRV_TEXTS // 64))
    sresps, slat, swall = drive(srv.url, [(
        "/collections/texts/search",
        {"json": {"text": texts[i], "k": K, "mode": "exact"}})
        for i in probe], SRV_C)
    _ok(sresps, "text search")
    top = [json.loads(b)["results"][0]["id"] for _, _, b in sresps]
    if top != [f"t{i}" for i in probe]:
        raise AssertionError("server text search: a text does not find "
                             "itself first")
    torch_sync()
    t1 = time.perf_counter()
    vecs = emb.embed_batch(texts)
    emb_s = time.perf_counter() - t1
    cpu = TransformerEmbedder.from_numpy(emb.params_numpy(),
                                         n_heads=emb.n_heads, device="cpu")
    gap = float(np.abs(vecs[:256] - cpu.embed_batch(texts[:256])).max())
    if gap > 1e-4 or vecs.shape != (SRV_TEXTS, TEXT_DIMS):
        raise AssertionError(f"embedder: card vs CPU gap {gap:.3g}")
    results["server_texts"] = {
        "gated": False, "qps": SRV_TEXTS / wall, "p50_ms": _pct(lat, 50),
        "p99_ms": _pct(lat, 99), "search_qps": len(probe) / swall,
        "embedder_texts_per_s": SRV_TEXTS / emb_s, "cpu_gap": gap,
        "card": card}
    log(f"[server] texts: {SRV_TEXTS} POST /texts at concurrency {SRV_C} "
        f"(first one builds the embedder): {SRV_TEXTS / wall:.1f} texts/s, "
        f"p50 {_pct(lat, 50):.2f} ms p99 {_pct(lat, 99):.2f} ms, "
        f"{time.perf_counter() - t0:.1f} s in all; text search "
        f"{len(probe) / swall:.1f} QPS (each text finds itself first); "
        f"embed_batch on the card {SRV_TEXTS / emb_s:.1f} texts/s; max gap "
        f"to the CPU embedder with the same weights {gap:.3g}; {card}")


def torch_sync():
    import torch
    torch.cuda.synchronize()


def _server_graph(srv, card, results):
    """A graph past NATIVE_TRAVERSAL_THRESHOLD in the server's GraphDB:
    /graph/traverse, /graph/shortest-path and /graph/query equal the same
    calls in process with Python traversal."""
    import numpy as np
    import fastpyvectordb_tpu_torch.graphdb.graph as gmod
    from fastpyvectordb_tpu_torch import native
    g = srv.app["state"]["graph"]
    rng = np.random.default_rng(41)
    t0 = time.perf_counter()
    for i in range(GRAPH_NODES):
        g.create_node(["Person" if i % 2 else "Paper"],
                      {"i": i, "age": int(rng.integers(18, 80))},
                      id=f"g{i}")
    src = rng.integers(0, GRAPH_NODES, GRAPH_EDGES).tolist()
    dst = rng.integers(0, GRAPH_NODES, GRAPH_EDGES).tolist()
    for e, (a, b) in enumerate(zip(src, dst)):
        g.create_edge(f"g{a}", f"g{b}", "KNOWS" if e % 3 else "CITES",
                      id=f"ge{e}")
    build_s = time.perf_counter() - t0
    starts = [f"g{int(x)}" for x in rng.integers(0, GRAPH_NODES, 8)]
    pairs = [(f"g{int(a)}", f"g{int(b)}")
             for a, b in rng.integers(0, GRAPH_NODES, (16, 2))]
    cypher = ["MATCH (n:Person) WHERE n.age > 75 RETURN n.i",
              "MATCH (a:Paper)-[:CITES]->(b:Person) WHERE a.age < 20 "
              "RETURN a.i, b.i",
              "MATCH (a:Person {i: 7})-[:KNOWS*1..2]->(b) RETURN b.i"]
    reqs = ([("/graph/traverse", {"json": {"start": s, "max_depth": 3,
                                           "direction": "out"}})
             for s in starts]
            + [("/graph/shortest-path", {"json": {"source": a,
                                                  "target": b}})
               for a, b in pairs]
            + [("/graph/query", {"json": {"query": q}}) for q in cypher])
    resps, lat, wall = drive(srv.url, reqs, 1)
    _ok(resps, "graph")
    used_native = native.graph_available() and bool(g._csr_cache)
    if native.graph_available() and not used_native:
        raise AssertionError("graph: the native CSR traversal did not run")
    bodies = [json.loads(b) for _, _, b in resps]
    saved = gmod.NATIVE_TRAVERSAL_THRESHOLD
    gmod.NATIVE_TRAVERSAL_THRESHOLD = float("inf")   # Python traversal
    try:
        want_t = [g.traverse(s, 3, None, "out") for s in starts]
        want_p = [g.shortest_path(a, b) for a, b in pairs]
        want_q = [g.query(q) for q in cypher]
    finally:
        gmod.NATIVE_TRAVERSAL_THRESHOLD = saved
    got_t = [b["paths"] for b in bodies[:8]]
    got_p = [b["path"] for b in bodies[8:24]]
    got_q = [b["rows"] for b in bodies[24:]]
    if got_t != want_t or got_q != want_q:
        raise AssertionError("graph: traverse / Cypher differ from the "
                             "in-process calls")
    for (a, b), gp, wp in zip(pairs, got_p, want_p):
        if (gp is None) != (wp is None) or (gp is not None and (
                len(gp) != len(wp) or gp[0] != a or gp[-1] != b or any(
                    v not in {n.id for n in g.neighbors(u, "both")}
                    for u, v in zip(gp, gp[1:])))):
            raise AssertionError(f"graph: shortest path {a}->{b}: {gp} vs "
                                 f"{wp}")
    results["server_graph"] = {
        "gated": False, "requests": len(reqs), "qps": len(reqs) / wall,
        "p50_ms": _pct(lat, 50), "p99_ms": _pct(lat, 99),
        "native": used_native, "card": card}
    log(f"[server] graph: {GRAPH_NODES} nodes, {GRAPH_EDGES} edges built in "
        f"{build_s:.1f} s; {len(reqs)} traverse / shortest-path / Cypher "
        f"requests, p50 {_pct(lat, 50):.2f} ms p99 {_pct(lat, 99):.2f} ms, "
        f"traversal {'native (graph.cpp)' if used_native else 'Python'}; "
        f"equal to the in-process calls with Python traversal "
        f"(shortest paths: same length, valid); {card}")


def _server_router(tmpdir: Path, host, batch, card, results):
    """Two shard servers over SHARD_ROWS rows each and the router in front;
    B=1024 through the router equals one server over the union."""
    import httpx
    import msgpack
    from fastpyvectordb_tpu_torch.server.app import create_app
    from fastpyvectordb_tpu_torch.server.router import create_router_app
    n = 2 * SHARD_ROWS
    apps = [AppThread(lambda p=p: create_app(
        db_path=str(tmpdir / p), device="cuda", full=False))
        for p in ("shard0", "shard1", "solo")]
    router = AppThread(lambda: create_router_app([a.url for a in apps[:2]]))
    try:
        out = {}
        for name, base in (("router", router.url), ("one", apps[2].url)):
            with httpx.Client(base_url=base, timeout=600) as c:
                c.post("/collections", json={
                    "name": "r", "dimensions": DIMS}).raise_for_status()
                t0 = time.perf_counter()
                for s in range(0, n, 16_384):
                    e = min(s + 16_384, n)
                    c.post("/collections/r/vectors/batch", headers=MSGPACK,
                           content=msgpack.packb({
                               "vectors": host[s:e].tobytes(),
                               "ids": [f"v{i}" for i in range(s, e)],
                               "metadatas": [{"cat": i % 10}
                                             for i in range(s, e)]},
                               use_bin_type=True)).raise_for_status()
                ins = time.perf_counter() - t0
                body = msgpack.packb({"vectors": batch.tobytes(), "k": K,
                                      "mode": "exact"}, use_bin_type=True)
                c.post("/collections/r/search/batch", headers=MSGPACK,
                       content=body).raise_for_status()   # warm
                t0 = time.perf_counter()
                r = c.post("/collections/r/search/batch", headers=MSGPACK,
                           content=body)
                ms = (time.perf_counter() - t0) * 1e3
                _ok([(r.status_code, "", r.content)], f"{name} search")
                out[name] = (_decode_msgpack_hits(
                    [(r.status_code, "", r.content)]), ms, ins)
        per = [httpx.get(a.url + "/collections/r", timeout=60).json()["count"]
               for a in apps[:2]]
        if sum(per) != n or min(per) == 0:
            raise AssertionError(f"router: shard counts {per}")
        (rd, rr), rms, rins = out["router"]
        (od, orow), oms, oins = out["one"]
        if not same_up_to_ties(rd, rr, od, orow):
            raise AssertionError("router: B=1024 differs from one server "
                                 "over the union")
        for base in (router.url, apps[2].url):
            httpx.delete(base + "/collections/r", timeout=300)
    finally:
        router.stop()
        for a in apps:
            a.stop()
    results["server_router"] = {
        "gated": False, "rows": n, "shard_rows": per,
        "router_batch_ms": rms, "one_server_batch_ms": oms,
        "router_insert_s": rins, "one_server_insert_s": oins, "card": card}
    log(f"[server] router: 2 shards ({per} rows) behind the router; B={BATCH} "
        f"msgpack exact {rms:.1f} ms through the router vs {oms:.1f} ms on "
        f"one server over the {n} rows, hits equal up to ties; insert "
        f"{rins:.1f} s vs {oins:.1f} s; {card}")


# ---------------------------------------------------------------------------
# the sharded paths (dist/), the multi-process runtime, profiling, hybrid
# ---------------------------------------------------------------------------

SHARDS = 4                    # logical shards of the sharded phase, on cuda:0
NCCL_ROWS = 262_144           # rows of the one-rank NCCL child (one shard's)
HYB_ROWS = 262_144            # depth of the hybrid collection (a cut)
HYB_VOCAB = 50_000            # words of the hybrid texts, Zipf(1.1)
HYB_QUERIES = 256
HYB_SKIP = 50                 # the most frequent words stay out of queries
TRACE_NAME = "sharded_batch"


def _launch_modules():
    from fastpyvectordb_tpu_torch.kernels import graph_kernels as gk
    from fastpyvectordb_tpu_torch.kernels import hamming_kernels as hk
    from fastpyvectordb_tpu_torch.kernels import ivf_kernels as ik
    from fastpyvectordb_tpu_torch.kernels import quant_kernels as qk
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    return gk, hk, ik, qk, s8


def zero_launches() -> None:
    for mod in _launch_modules():
        mod.LAUNCHES.update({key: 0 for key in mod.LAUNCHES})


def nonzero_launches() -> dict:
    return {k: v for mod in _launch_modules() for k, v in mod.LAUNCHES.items()
            if v}


def in_turns(single, sharded, batches):
    """QPS of the single-card and the sharded call over the same batches,
    in turns: single, sharded, sharded, single."""
    a = timed_qps(single, batches)
    b = timed_qps(sharded, batches)
    b2 = timed_qps(sharded, batches)
    return [a, timed_qps(single, batches)], [b, b2]


def sharded_mode(label, results, search, single, queries, timing_batches,
                 truth, expect, tmpdir, single_rows=None, agree_gate=None):
    """One sharded mode at B=1024: the launches of one counted batch must
    be exactly ``expect`` (a kernel per shard), recall@10 against
    ``truth``, row agreement with the single-card route, QPS in turns,
    then a traced batch (``trace_batch``)."""
    import torch
    zero_launches()
    d, rows = search(queries)
    torch.cuda.synchronize()
    launches = nonzero_launches()
    if launches != expect:
        raise AssertionError(f"{label}: launches of a sharded batch "
                             f"{launches}, expected {expect}")
    rows = rows.cpu().numpy() if hasattr(rows, "cpu") else rows
    if rows.shape != (BATCH, K) or (rows < 0).any():
        raise AssertionError(f"{label}: bad rows {rows.shape}")
    out = {"recall": recall_at_k(rows, truth), "launches": launches}
    if single_rows is not None:
        out["agree_single"] = recall_at_k(rows, single_rows)
        if agree_gate is not None and out["agree_single"] < agree_gate:
            raise AssertionError(f"{label}: row agreement with the "
                                 f"single-card route {out['agree_single']:.4f}"
                                 f" < {agree_gate}")
    out["qps_single"], out["qps"] = in_turns(single, search, timing_batches)
    out["trace"] = trace_batch(label, lambda: search(queries), tmpdir,
                               expect.get("s8_topc"))
    results[label] = out
    log(f"[sharded] {label} ({nvidia_smi_line()}): {out}")
    return d, rows


def phase_sharded(col, bf, cc, scans, queries, timing_batches, truth,
                  bf_truth, scores, tmpdir: Path, results):
    """The sharded searchers of ``dist/`` on a mesh of four logical shards
    on cuda:0, over the snapshots and indexes the earlier phases built:
    exact f32 (equal to the single-card scan up to ties; also on
    ``make_mesh()``, the card itself), ``ShardedInt8`` with the int8 codec
    (one ``s8_topc`` a shard) and the int4 codec (one ``int4_scores`` a
    shard), ``ShardedIVF`` with int8 cells (B3) and bf16 cells (B2),
    ``ShardedIVFPQ`` (B7) at the IVF-PQ phase's tuned nprobe / rerank, each
    beside its single-card route and traced (``profiling.trace``: one
    ``s8_topc`` kernel event a shard in the int8 batch); the distributed k-means step on the 1M rows against a
    one-shard mesh; ``dryrun_multichip(4)``; a one-rank NCCL job in a
    child process."""
    import torch
    from fastpyvectordb_tpu_torch.dist.dryrun import dryrun_multichip
    from fastpyvectordb_tpu_torch.dist.mesh import (Mesh, logical_mesh,
                                                    make_mesh)
    from fastpyvectordb_tpu_torch.dist.sharded import (
        build_sharded_kmeans_step)
    from fastpyvectordb_tpu_torch.dist.sharded_ann import (ShardedInt8,
                                                           ShardedIVF,
                                                           ShardedIVFPQ)
    t_phase = time.perf_counter()
    mesh = logical_mesh(SHARDS, device="cuda:0")
    log(f"[sharded] mesh {mesh}; {nvidia_smi_line()}")

    # -- exact f32 ----------------------------------------------------------
    for label, m in (("sharded_exact_f32", mesh),
                     ("sharded_exact_f32_card_mesh", make_mesh())):
        sh = col.as_sharded_searcher(m)
        d, rows = sharded_mode(
            label, results, lambda qb: tuple(
                t.cpu() for t in sh.search(torch.as_tensor(qb,
                                                           device="cuda"),
                                           K)),
            lambda qb: col.search_arrays(qb, k=K, exact=True), queries,
            timing_batches, truth, {}, tmpdir)
        if not same_up_to_ties(scores, truth, d.numpy(), rows):
            raise AssertionError(f"{label}: differs from the single-card "
                                 "exact scan beyond ties")
        results[label]["shard_rows"] = sh.vectors.block(0, 0).shape[0]
        del sh
    torch.cuda.empty_cache()

    # -- int8 / int4 two-stage ---------------------------------------------
    for kind, rerank, kernel in (("int8", 4, {"s8_topc": SHARDS}),
                                 ("int4", 8, {"int4_scores": SHARDS})):
        scan = scans[kind]
        sh = ShardedInt8.from_scan(mesh, scan)
        _, single_rows = scan.search(queries, K, rerank=rerank)
        sharded_mode(f"sharded_{kind}_rr{rerank}", results,
                     lambda qb: sh.search(qb, K, rerank=rerank),
                     lambda qb: scan.search(qb, K, rerank=rerank), queries,
                     timing_batches, truth, kernel, tmpdir, single_rows, 0.9)
        del sh
        torch.cuda.empty_cache()

    # -- IVF: int8 cells (B3) and bf16 cells (B2) ---------------------------
    for label, c, gate_truth, kernel in (
            ("sharded_ivf_int8", col, truth, "grouped_cell_scores_i8"),
            ("sharded_ivf_bf16", bf, bf_truth, "grouped_cell_scores")):
        ann = c._ann
        sh = ShardedIVF.from_index(mesh, ann)
        if not sh._allow_grouped or BATCH * sh.nprobe_local < \
                sh.centroids.block(0, 0).shape[0]:
            raise AssertionError(f"{label}: the grouped branch would not run")
        _, single_rows = ann.search(queries, K)
        sharded_mode(label, results, lambda qb: sh.search(qb, K),
                     lambda qb: ann.search(qb, K), queries, timing_batches,
                     gate_truth, {kernel: SHARDS}, tmpdir, single_rows)
        results[label].update(
            nprobe=ann.nprobe, nprobe_local=sh.nprobe_local,
            local_cells=sh.centroids.block(0, 0).shape[0],
            boost_cells=int(sh.cent_boost.full().sum()),
            dropped_pairs=sh.last_dropped, rerank=sh.rerank,
            recall_f32=recall_at_k(sh.search(queries, K)[1], truth))
        log(f"[sharded] {label}: dropped pairs {sh.last_dropped}")
        del sh
        torch.cuda.empty_cache()

    # -- IVF-PQ (B7) ----------------------------------------------------------
    ann = cc._ann
    sh = ShardedIVFPQ.from_index(mesh, ann)
    _, single_rows = ann.search(queries, K)
    sharded_mode("sharded_ivfpq", results, lambda qb: sh.search(qb, K),
                 lambda qb: ann.search(qb, K), queries, timing_batches,
                 truth, {"grouped_cell_scores_pq": SHARDS}, tmpdir,
                 single_rows)
    results["sharded_ivfpq"].update(
        nprobe=ann.nprobe, nprobe_local=sh.nprobe_local, rerank=sh.rerank,
        overflow_rows=int((sh.orow_ids.full() >= 0).sum()),
        dropped_pairs=sh.last_dropped)
    del sh
    torch.cuda.empty_cache()

    # -- the distributed k-means step ----------------------------------------
    data = col._store.vectors[:N_ROWS]
    # the IVF build's initial centroids (quant/kmeans.py: a permutation of
    # the rows from a CPU generator seeded with the build's seed, 0)
    init = torch.randperm(N_ROWS, generator=torch.Generator().manual_seed(0))
    c0 = data[init[:IVF_BUILD["nlist"]].to("cuda")].float()
    w = torch.ones((N_ROWS,), device="cuda")
    km = {}
    for label, m in (("one", Mesh(["cuda:0"])), ("four", mesh)):
        step = build_sharded_kmeans_step(m, k=IVF_BUILD["nlist"])
        step(data, w, c0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        km[label] = step(data, w, c0)
        torch.cuda.synchronize()
        km[label + "_ms"] = (time.perf_counter() - t0) * 1e3
    (c1, n1), (c4, n4) = km["one"], km["four"]
    if int(n4.sum()) != N_ROWS or int(n1.sum()) != N_ROWS:
        raise AssertionError(f"k-means: counts sum to {int(n4.sum())}")
    rel = float((c4 - c1).abs().max() / c1.abs().max())
    moved = int((n4 != n1).sum())
    if rel > 1e-4:
        raise AssertionError(f"k-means: 4-shard centroids {rel:.3g} "
                             f"relative from the one-shard step ({moved} "
                             "counts differ)")
    results["sharded_kmeans_step"] = {
        "gated": False, "rel_err": rel, "counts_differ": moved,
        "ms_one_shard": km["one_ms"], "ms_four_shards": km["four_ms"],
        "live_centroids": int((n4 > 0).sum())}
    log(f"[sharded] k-means step on {N_ROWS}x{DIMS}, k "
        f"{IVF_BUILD['nlist']}: {results['sharded_kmeans_step']}")
    del data, c0, w, km, c1, c4
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dryrun_multichip(SHARDS, device="cuda")
    log(f"[sharded] dryrun_multichip({SHARDS}, device='cuda'): passed in "
        f"{time.perf_counter() - t0:.1f} s")
    results["sharded_nccl_one_rank"] = nccl_child(col, queries, tmpdir)
    log(f"[sharded] phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# the graph ANN (ann/graph_ann.py) on the main path's corpus
# ---------------------------------------------------------------------------

# the JAX package's build defaults (GraphANN.build)
GRAPH_BUILD = {"r": 32, "n_entries": 4096, "random_links": 4, "chunk": 4096}
# (beam, iters) tried in order on the held-out queries, up to TUNE_TARGET,
# when tune's pick misses the gate on the evaluation batch: the top of
# GraphANN.tune's grid (beam <= 256, iters <= 32), then points past it
GRAPH_PAST_GRID = ((256, 32), (256, 48), (512, 32), (512, 48), (512, 64))
GRAPH_SINGLES = 256
# (batch, knobs) at which the beam kernel is timed against the plain
# rounds: the graph-b1 cell's (portbench/configs/cohere768-1m-graph.json)
# and the JAX package's defaults at the main path's batch
GRAPH_KERNEL_SHAPES = {
    "b1": (1, {"beam": 64, "expand": 8, "iters": 8, "n_init": 32}),
    "b1024": (BATCH, {"beam": 128, "expand": 8, "iters": 16, "n_init": 32})}
# of the top 10 ids of the kernel's beam and the plain rounds' beam, the
# share that may differ (a near tie that the f32 sums, in another order,
# break the other way) and the largest gap of a row both found
GRAPH_IDS_DIFFER, GRAPH_SCORE_GAP = 5e-4, 1e-5


class BeamCounter:
    """Counts graph searches (``graph_ann._beam_search_kernel`` calls) from
    its creation until ``stop()``, which puts the function back and
    returns the count."""

    def __init__(self):
        from fastpyvectordb_tpu_torch.ann import graph_ann
        self._mod, self._orig, self.n = graph_ann, \
            graph_ann._beam_search_kernel, 0

        def counted(*args, **kw):
            self.n += 1
            return self._orig(*args, **kw)

        graph_ann._beam_search_kernel = counted

    def stop(self) -> int:
        self._mod._beam_search_kernel = self._orig
        return self.n


class RowRecorder:
    """Stands in for the store in ``graph_beam_plain``, which reads it only
    by gathering rows: keeps the row ids of every gather."""

    def __init__(self, vectors):
        self.vectors, self.rows = vectors, []

    def __getitem__(self, rows):
        self.rows.append(rows.reshape(-1))
        return self.vectors[rows]

    def unique(self) -> int:
        import torch
        return int(torch.unique(torch.cat(self.rows)).numel())


# distinct queries the B=1 timing cycles through (one query repeated keeps
# its rows in L2 and times too fast)
GRAPH_B1_POOL = 128


def graph_kernel_vs_plain(ann, queries) -> dict:
    """``fpv_graph_beam`` against the plain rounds (``graph_beam_plain``) on
    the index's own tables and the main path's queries, at each of
    ``GRAPH_KERNEL_SHAPES``: ms a call of each (CUDA events; at B=1 cycling
    through ``GRAPH_B1_POOL`` distinct queries, and the plain rounds' time
    is the host launching them); one launch a call; the top 10 of the two
    beams (at most ``GRAPH_IDS_DIFFER`` of the ids differ, a row both found
    scores within ``GRAPH_SCORE_GAP``).  Two bytes bounds at 3.35 TB/s: the
    distinct rows the batch gathers (counted from the plain rounds'
    gathers), each read once, and every gather, B (e0 + T E R) rows, each
    read from memory (a row that queries share comes from L2 after its
    first read, so the first bound is the one a kernel could approach)."""
    import itertools
    import torch
    from fastpyvectordb_tpu_torch.ann import graph_ann
    from fastpyvectordb_tpu_torch.kernels import graph_kernels as gk
    col = ann._collection
    store, cfg = col._store, col.config
    nbr, init_ok = ann._nav_tables(store)
    out = {}

    def routed(q, e0):
        init_ids, live = graph_ann._route(q, ann.centroids, ann.medoids,
                                          init_ok, cfg.metric, e0)
        return (q, store.vectors, nbr, init_ids, live)

    for label, (b, knobs) in GRAPH_KERNEL_SHAPES.items():
        q = torch.as_tensor(queries[:b], device="cuda")
        e0 = min(knobs["n_init"], knobs["beam"], ann.medoids.shape[0])
        args = routed(q, e0)
        kw = {"beam": knobs["beam"], "expand": knobs["expand"],
              "iters": knobs["iters"], "metric": cfg.metric,
              "compute_dtype": "bfloat16" if cfg.compute_dtype == "bfloat16"
              else "float32"}
        before = gk.LAUNCHES["graph_beam"]
        got = gk.graph_beam(*args, **kw)
        if gk.LAUNCHES["graph_beam"] != before + 1:
            raise AssertionError(f"graph kernel {label}: no launch")
        rec = RowRecorder(store.vectors)
        want = gk.graph_beam_plain(args[0], rec, *args[2:], **kw)
        top = [(ids.gather(1, graph_ann._ascending(sc, K)).cpu().numpy(),
                sc.gather(1, graph_ann._ascending(sc, K)).cpu().numpy())
               for ids, sc in (got, want)]
        (gi, gs), (wi, ws) = top
        differ = sum(len(set(a) - set(w)) for a, w in zip(gi, wi))
        gap = 0.0
        for a, sa, w, sw in zip(gi, gs, wi, ws):
            mine = dict(zip(a.tolist(), sa.tolist()))
            gap = max([gap] + [abs(mine[r] - s) for r, s in
                               zip(w.tolist(), sw.tolist()) if r in mine])
        if differ > GRAPH_IDS_DIFFER * wi.size or gap > GRAPH_SCORE_GAP:
            raise AssertionError(f"graph kernel {label}: {differ} of "
                                 f"{wi.size} top-10 ids differ from the "
                                 f"plain rounds, score gap {gap}")
        if b == 1:
            pool = [routed(torch.as_tensor(queries[i:i + 1], device="cuda"),
                           e0) for i in range(GRAPH_B1_POOL)]
            nxt = itertools.cycle(pool).__next__
            kernel_ms = cuda_ms(lambda: gk.graph_beam(*nxt(), **kw),
                                reps=GRAPH_B1_POOL - 1)
            plain_ms = cuda_ms(lambda: gk.graph_beam_plain(*nxt(), **kw),
                               reps=20)
        else:
            kernel_ms = cuda_ms(lambda: gk.graph_beam(*args, **kw), reps=10)
            plain_ms = cuda_ms(lambda: gk.graph_beam_plain(*args, **kw),
                               reps=3)
        item = store.vectors.element_size()
        gathers = b * (e0 + knobs["iters"] * knobs["expand"] * nbr.shape[1])
        unique = rec.unique()
        bnd = bound(unique * DIMS * item, 0.0, "f32")
        every = bound(gathers * DIMS * item, 0.0, "f32")["bound_ms"]
        out[label] = {"batch": b, **knobs, "kernel_ms": kernel_ms,
                      "plain_ms": plain_ms, "ids_differ": differ,
                      "ids": int(wi.size), "same_beam": bool(
                          torch.equal(got[0], want[0])),
                      "score_gap": gap, **bnd, "rows_gathered": gathers,
                      "rows_distinct": unique,
                      "share_of_bound": bnd["bound_ms"] / kernel_ms,
                      "gathers_bound_ms": every,
                      "share_of_gathers_bound": every / kernel_ms}
        log(f"[graph] fpv_graph_beam at B={b} {knobs}: {kernel_ms:.4f} ms "
            f"(plain rounds {plain_ms:.4f} ms); {unique} distinct rows of "
            f"{gathers} gathered: bytes bound {bnd['bound_ms']:.4f} ms "
            f"({100 * bnd['bound_ms'] / kernel_ms:.1f}%), every gather "
            f"from memory {every:.4f} ms ({100 * every / kernel_ms:.1f}%); "
            f"top-10 ids differing {differ} of {wi.size}, score gap "
            f"{gap:.3g}, whole beam equal {out[label]['same_beam']}")
    return out


def phase_graph(host, ids, metas, queries, tune_queries, timing_batches,
                truth, tmpdir: Path, results):
    """``build_ann("graph")`` at the JAX package's defaults on a collection
    of the main path's 1M x 768 cosine rows (f32 store): build seconds by
    stage; ``tune`` on held-out queries (target ``RECALL_GATE``; if its
    grid falls short, explicit ``beam`` / ``iters`` past it, measured on the
    held-out queries); recall@10 against the exact f32 truth (gated); QPS at
    B=1024; B=1 p50 / p99 over 256 singles; one traced B=1024 batch; one
    ``search(..., device_out=True)`` under
    ``torch.cuda.set_sync_debug_mode("error")``; a filtered search
    (``cat == 3``) against the filtered exact scan; ``optimize()``'s graph
    branch; save -> reopen -> equal hits.  Every search up to the save
    makes one ``fpv_graph_beam`` launch (the beam's rounds in one kernel)
    and no other hand kernel runs; then ``graph_kernel_vs_plain``."""
    import shutil
    import warnings
    import numpy as np
    import torch
    from fastpyvectordb_tpu_torch import Filter, VectorDB
    from fastpyvectordb_tpu_torch.persist.format import load_container
    from fastpyvectordb_tpu_torch.profiling import QueryTimer
    t_phase = time.perf_counter()
    card = nvidia_smi_line()
    path = tmpdir / "graph"
    db = VectorDB(str(path), device="cuda")
    col = db.create_collection("graph", dimensions=DIMS, metric="cosine")
    col.insert_batch(host, ids, metas)
    zero_launches()
    beams = BeamCounter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        col.build_ann("graph", tune=False, **GRAPH_BUILD)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ann = col._ann
    stages = dict(ann.build_seconds)
    if not any("graph" in str(w.message) for w in warned):
        raise AssertionError("graph: build_ann(kind='graph') did not warn")
    st = ann.stats()
    log(f"[graph] build {build_s:.2f} s on {card}: stages {stages}, "
        f"stats {st}")
    if st["nodes"] != N_ROWS or st["degree"] != GRAPH_BUILD["r"] \
            or st["entries"] != GRAPH_BUILD["n_entries"]:
        raise AssertionError(f"graph: stats {st}")

    # -- tune on held-out queries, then the gate on the evaluation batch --
    t0 = time.perf_counter()
    tuned = ann.tune(tune_queries[:256], target_recall=RECALL_GATE, k=K)
    tune_s = time.perf_counter() - t0
    _, _, rows = col.search_arrays(queries, k=K)
    rec = recall_at_k(rows, truth)
    log(f"[graph] tune {tune_s:.2f} s -> {tuned}; recall@10 on the "
        f"evaluation batch {rec:.4f}")
    escalated = None
    if rec < RECALL_GATE:
        tune_truth = col.search_arrays(tune_queries[:256], k=K,
                                       exact=True)[2]
        for beam, iters in GRAPH_PAST_GRID:
            if beam * iters <= ann.beam * ann.iters:
                continue
            hrec = recall_at_k(ann.search(tune_queries[:256], K, beam=beam,
                                          iters=iters)[1], tune_truth)
            log(f"[graph] beam {beam}, iters {iters}: held-out recall@10 "
                f"{hrec:.4f}")
            if hrec >= TUNE_TARGET:
                col.set_search_params(beam=beam, iters=iters)
                escalated = {"beam": beam, "iters": iters, "recall": hrec}
                break
        _, _, rows = col.search_arrays(queries, k=K)
        rec = recall_at_k(rows, truth)
    log(f"[graph] recall@10 on the evaluation batch {rec:.4f} at beam "
        f"{ann.beam}, iters {ann.iters}, expand {ann.expand} (escalated "
        f"past tune's pick: {escalated})")
    if rec < RECALL_GATE:
        raise AssertionError(f"graph: recall@10 {rec:.4f} < {RECALL_GATE}")

    # -- throughput, single-query latency, a traced batch -----------------
    qps = timed_qps(lambda qb: col.search_arrays(qb, k=K), timing_batches)
    timer = QueryTimer(seed=0)
    singles = queries[:GRAPH_SINGLES]
    col.search_arrays(singles[:1], k=K)
    for qv in singles:
        with timer.measure():
            col.search_arrays(qv[None], k=K)
    lat = timer.summary()
    trace = trace_batch("graph", lambda: col.search_arrays(queries, k=K),
                        tmpdir)

    # -- the beam loop never waits for the host ----------------------------
    qd = torch.as_tensor(queries, device="cuda")
    ann.search(qd, K, device_out=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, drows = ann.search(qd, K, device_out=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not np.array_equal(drows.cpu().numpy(), rows):
        raise AssertionError("graph: the device_out search differs from "
                             "search_arrays on the same batch")
    log(f"[graph] search(device_out=True) of a B={BATCH} batch ran under "
        "torch.cuda.set_sync_debug_mode('error'): no host sync")

    # -- filtered: post-navigation filter vs the filtered exact scan ------
    flt = Filter.eq("cat", 3)
    _, _, frows = col.search_arrays(queries, k=K, filter=flt)
    _, _, fexact = col.search_arrays(queries, k=K, filter=flt, exact=True)
    if not (frows[frows >= 0] % 10 == 3).all():
        raise AssertionError("graph: a filtered hit does not match")
    frec = recall_at_k(frows, fexact)
    report = col.optimize(k=K, build=False, install=False)
    if "cost_us_measured" not in report.get("ann", {}):
        raise AssertionError(f"graph: optimize report {report}")
    searches = beams.stop()
    launches = nonzero_launches()
    if launches != {"graph_beam": searches}:
        raise AssertionError(f"graph: {searches} searches made {launches}: "
                             "one fpv_graph_beam launch a search and no "
                             "other hand kernel")
    log(f"[graph] {searches} searches, {launches['graph_beam']} "
        "fpv_graph_beam launches, no other hand kernel")
    kernel_vs_plain = graph_kernel_vs_plain(ann, queries)

    # -- save -> reopen -> equal hits --------------------------------------
    t0 = time.perf_counter()
    db.save()
    saved = load_container(path / "graph" / "collection.fpvt")
    for name, t in (("ann_neighbors", ann.neighbors),
                    ("ann_centroids", ann.centroids),
                    ("ann_medoids", ann.medoids)):
        if saved.read(name).tobytes() != t.cpu().numpy().tobytes():
            raise AssertionError(f"graph: saved {name} differs")
    del col, ann, db, saved
    torch.cuda.empty_cache()
    col2 = VectorDB(str(path), device="cuda")["graph"]
    _, _, rows2 = col2.search_arrays(queries, k=K)
    if col2.config.index != "graph" or not np.array_equal(rows2, rows):
        raise AssertionError("graph: hits differ after save -> reopen")
    reload_s = time.perf_counter() - t0
    results["graph"] = {
        "recall": rec, "qps": qps, "beam": col2._ann.beam,
        "iters": col2._ann.iters, "expand": col2._ann.expand,
        "tune": tuned, "tune_s": tune_s, "escalated": escalated,
        "build_s": build_s, "build_stages_s": stages,
        "b1_p50_ms": lat["p50_ms"], "b1_p99_ms": lat["p99_ms"],
        "b1_qps": lat["qps"], "trace": trace, "no_sync": True,
        "filtered_recall": frec, "optimize_ann": report["ann"],
        "save_reload_s": reload_s, "launches": launches,
        "kernel_vs_plain": kernel_vs_plain, "card": card}
    log(f"[graph] {card}: recall@10 {rec:.4f}, QPS {qps:.1f} at B={BATCH}, "
        f"B=1 p50 {lat['p50_ms']:.3f} ms / p99 {lat['p99_ms']:.3f} ms, "
        f"trace idle share {trace['idle_share']}, filtered (cat == 3) "
        f"recall@10 {frec:.4f} against the filtered exact scan, optimize "
        f"ann {report['ann']}, save + reopen {reload_s:.1f} s: equal hits")
    del col2
    shutil.rmtree(path)
    torch.cuda.empty_cache()
    log(f"[graph] phase {time.perf_counter() - t_phase:.1f} s")


def trace_batch(label, run, tmpdir: Path, expect_topc=None) -> dict:
    """``profiling.trace`` around one batch of a sharded mode, annotated
    with ``TRACE_NAME``: where its device time goes (busy = kernels, copies
    and sets; idle share against the annotated region's wall time; the
    largest items).  ``expect_topc``: the ``s8_topc`` kernel events the
    trace must hold (one a shard)."""
    from fastpyvectordb_tpu_torch import profiling
    with profiling.trace(str(tmpdir / "trace"), device="cuda") as d:
        with profiling.annotate(TRACE_NAME):
            run()
    path = Path(d) / profiling.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    topc = [n for n in kernels if "S8TopcOp" in n]
    named = [e for e in events if e.get("name") == TRACE_NAME]
    busy, by_name = 0.0, {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy += e.get("dur", 0.0)
            key = "S8TopcOp" if "S8TopcOp" in e.get("name", "") else \
                e.get("name", "")[:60]
            by_name[key] = by_name.get(key, 0.0) + e.get("dur", 0.0)
    wall = max((e.get("dur", 0.0) for e in named), default=0.0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"kernel_events": len(kernels), "s8_topc_events": len(topc),
           "annotated": bool(named), "wall_ms": wall / 1e3,
           "busy_ms": busy / 1e3,
           "idle_share": 1.0 - busy / wall if wall else None,
           "top_device_ms": {k: v / 1e3 for k, v in top}}
    log(f"[profiling] trace of one {label} batch: {out}")
    if not named or (expect_topc is not None and len(topc) != expect_topc):
        raise AssertionError(f"trace: {len(topc)} s8_topc kernel events "
                             f"(expected {expect_topc}), annotation "
                             f"{bool(named)}; kernels seen: "
                             f"{sorted(set(kernels))[:20]}")
    return out


_NCCL_CHILD = '''
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
from fastpyvectordb_tpu_torch.dist import multihost
from fastpyvectordb_tpu_torch.dist.sharded import build_sharded_search
rows = np.load(sys.argv[2] + "/nccl_rows.npy")
q = np.load(sys.argv[2] + "/nccl_q.npy")
multihost.initialize(f"localhost:{sys.argv[3]}", 1, 0, timeout=60)
assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
mesh = multihost.global_mesh()
v = multihost.shard_local_corpus(mesh, rows)
valid = multihost.shard_local_corpus(mesh, np.ones((rows.shape[0],), bool))
d, r = build_sharded_search(mesh, metric="cosine", k=int(sys.argv[4]))(
    torch.as_tensor(q, device="cuda"), v, valid)
np.savez(sys.argv[2] + "/nccl_out.npz", d=d.cpu().numpy(), r=r.cpu().numpy(),
         shape=np.array(list(mesh.shape.values())))
dist.destroy_process_group()
print("nccl child ok", flush=True)
'''


def nccl_child(col, queries, tmpdir: Path) -> dict:
    """A child process with a time limit joins a one-rank NCCL job
    (``multihost.initialize``), builds ``global_mesh``, places the first
    262,144 rows with ``shard_local_corpus`` and runs one sharded exact
    search; it must equal a single-card collection's search of the same
    rows up to ties."""
    import socket
    import numpy as np
    from fastpyvectordb_tpu_torch import Collection, CollectionConfig
    rows = col._store.get_rows(np.arange(NCCL_ROWS))
    np.save(tmpdir / "nccl_rows.npy", rows)
    np.save(tmpdir / "nccl_q.npy", queries)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", _NCCL_CHILD, str(ROOT),
                          str(tmpdir), str(port), str(K)],
                         capture_output=True, text=True, timeout=180)
    child_s = time.perf_counter() - t0
    if out.returncode != 0 or "nccl child ok" not in out.stdout:
        raise AssertionError(f"NCCL child rc {out.returncode}:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    got = np.load(tmpdir / "nccl_out.npz")
    one = Collection(CollectionConfig(name="n", dimensions=DIMS,
                                      metric="cosine"), device="cuda")
    one.insert_batch(rows)
    _, sd, sr = one.search_arrays(queries, k=K)
    if not same_up_to_ties(sd, sr, got["d"], got["r"]):
        raise AssertionError("NCCL child: its sharded search differs from "
                             "the single-card one beyond ties")
    for name in ("nccl_rows.npy", "nccl_q.npy", "nccl_out.npz"):
        (tmpdir / name).unlink()
    res = {"gated": False, "child_s": child_s,
           "mesh": got["shape"].tolist(), "rows": NCCL_ROWS}
    log(f"[sharded] one-rank NCCL child: initialize, global_mesh "
        f"{res['mesh']}, shard_local_corpus, sharded search equal to the "
        f"single-card one up to ties ({child_s:.1f} s)")
    return res


def hybrid_texts(n: int, seed: int):
    """``n`` texts of 8-64 words from a Zipf(1.1) vocabulary of
    ``HYB_VOCAB`` words (ranks past the vocabulary drawn again)."""
    import numpy as np
    gen = np.random.default_rng(seed)
    words = np.array([f"t{i}" for i in range(HYB_VOCAB)])
    lens = gen.integers(8, 65, n)
    ranks = gen.zipf(1.1, int(lens.sum()) * 2)
    ranks = ranks[ranks <= HYB_VOCAB][:int(lens.sum())] - 1
    toks = words[ranks].tolist()
    ends = np.cumsum(lens).tolist()
    return [" ".join(toks[e - ln:e]) for e, ln in zip(ends, lens.tolist())], \
        words


def fused(vec_hits, kw_hits, k, alpha):
    """The fusion ``HybridCollection.hybrid_search`` documents (cosine):
    distances to ``1 - d / max_d``, BM25 to ``s / max_s``, blended by
    ``alpha``, sorted by (-score, id)."""
    vs, ks = {}, {}
    if vec_hits:
        max_d = max(h.score for h in vec_hits) or 1.0
        max_d = max_d if max_d > 0 else 1.0
        vs = {h.id: 1.0 - h.score / max_d for h in vec_hits}
    if kw_hits:
        max_s = max(s for _, s in kw_hits) or 1.0
        ks = {i: s / max_s for i, s in kw_hits}
    out = [(alpha * vs.get(i, 0.0) + (1 - alpha) * ks.get(i, 0.0), i)
           for i in set(vs) | set(ks)]
    out.sort(key=lambda t: (-t[0], t[1]))
    return out[:k]


def phase_hybrid(host, queries, results):
    """A ``HybridCollection`` on the card (262,144 x 768 rows, each with a
    text of 8-64 words, native BM25): insert rate, ``keyword_search``
    against the Python ``BM25Index`` over the same documents, and
    ``hybrid_search(alpha=0.5)`` against the fusion of the collection's own
    ``search_batch`` and ``keyword_search`` hits, for 256 queries; hybrid
    QPS with p50 / p99 (``profiling.QueryTimer``)."""
    import numpy as np
    import torch
    from fastpyvectordb_tpu_torch import CollectionConfig, native
    from fastpyvectordb_tpu_torch.hybrid import BM25Index, HybridCollection
    from fastpyvectordb_tpu_torch.profiling import QueryTimer
    t0 = time.perf_counter()
    texts, words = hybrid_texts(HYB_ROWS, 7)
    ids = [f"h{i}" for i in range(HYB_ROWS)]
    log(f"[hybrid] {HYB_ROWS} texts made in {time.perf_counter() - t0:.1f} s"
        f" (mean {np.mean([t.count(' ') + 1 for t in texts[:4096]]):.1f} "
        "words)")
    col = HybridCollection(CollectionConfig(name="hyb", dimensions=DIMS,
                                            metric="cosine"),
                           text_fields=["text"], device="cuda")
    if not isinstance(col._bm25, native.NativeBM25):
        raise AssertionError("hybrid: the native BM25 engine did not build")
    step = HYB_ROWS // 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, HYB_ROWS, step):
        col.insert_batch(host[s:s + step], ids[s:s + step],
                         [{"text": t} for t in texts[s:s + step]])
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = BM25Index()
    for i, t in zip(ids, texts):
        ref.add_document(i, t)
    ref_s = time.perf_counter() - t0
    gen = np.random.default_rng(8)
    qr = gen.zipf(1.1, HYB_QUERIES * 40)
    qr = qr[(qr > HYB_SKIP) & (qr <= HYB_VOCAB)] - 1
    nterm = gen.integers(1, 5, HYB_QUERIES)
    ends = np.cumsum(nterm)
    qtexts = [" ".join(words[qr[e - n:e]]) for e, n in zip(ends, nterm)]
    qvecs = queries[:HYB_QUERIES]
    for text in qtexts:
        got = [(h.id, h.score) for h in col.keyword_search(text, k=K)]
        want = ref.search(text, K)
        if [i for i, _ in got] != [i for i, _ in want] or not np.allclose(
                [s for _, s in got], [s for _, s in want], rtol=1e-9,
                atol=0):
            raise AssertionError(f"hybrid: keyword_search({text!r}) {got} "
                                 f"!= BM25Index {want}")
    timer, vec_t, kw_t = (QueryTimer(seed=0) for _ in range(3))
    fetch = 5 * K
    for qv, text in zip(qvecs, qtexts):
        with timer.measure():
            res = col.hybrid_search(qv, text, k=K, alpha=0.5)
        # the two stages of the same query alone, for where the time goes
        with vec_t.measure():
            vec_hits = col.search_batch(qv[None], k=fetch)[0]
        with kw_t.measure():
            kw_hits = [(h.id, h.score)
                       for h in col.keyword_search(text, k=fetch)]
        want = fused(vec_hits, kw_hits, K, 0.5)
        if [r.id for r in res] != [i for _, i in want] or any(
                abs(r.score - s) > 1e-6 for r, (s, _) in zip(res, want)):
            raise AssertionError(f"hybrid: hybrid_search({text!r}) differs "
                                 "from the fusion of its own hits")
    summ = timer.summary()
    results["hybrid"] = {
        "gated": False, "rows": HYB_ROWS, "insert_rows_per_s":
        HYB_ROWS / insert_s, "python_index_s": ref_s,
        "hybrid_qps": summ["qps"], "p50_ms": summ["p50_ms"],
        "p99_ms": summ["p99_ms"], "terms": col._bm25.stats()["terms"],
        **{f"{name}_{q}_ms": t.summary()[f"{q}_ms"]
           for name, t in (("vector_stage", vec_t), ("keyword_stage", kw_t))
           for q in ("p50", "p99")}}
    log(f"[hybrid] {nvidia_smi_line()}: {results['hybrid']}; "
        f"keyword_search equal to BM25Index on {HYB_QUERIES} queries, "
        "hybrid_search equal to the fusion of its own hits")
    del col, ref
    torch.cuda.empty_cache()


PRIME_ROWS = 1 << 20          # the primer's default rows (bench.py's size)
PRIME_WARM_ROWS = 65_536      # the warm run's rows: it builds nothing
PRIME_ARGS = ("--dims", str(DIMS), "--metric", "cosine", "--modes",
              "exact,int8,binary", "--max-batch", str(BATCH), "--k", str(K))
PRIME_SOURCES = ("quant_scores.cu", "grouped_cell_scores.cu",
                 "grouped_cell_scores_pq.cu", "hamming_scores.cu",
                 "s8_scores.cu", "graph_beam.cu")
NATIVE_SOURCES = ("bm25.cpp", "graph.cpp")


def child_env() -> dict:
    """The environment of a child that imports the package from this
    checkout."""
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH", "")) if p)
    return env


def check_prime_lines(lines, rows: int, cache, built) -> list:
    """The primer's JSON lines: ``built`` (the sources compiled: ``built``,
    or with ``built=None`` no ``.cu`` source, and every library loaded),
    ``filled_rows``, one ``primed`` line a batch bucket (8 ... BATCH) with
    the rows' power-of-two bucket, ``k`` and the modes, then ``{"cache":
    ..., "done": true}``; returns each bucket's seconds."""
    buckets = [8 << i for i in range((BATCH // 8).bit_length())]
    cap = 1 << (rows - 1).bit_length()
    head, fill, primed, last = lines[0], lines[1], lines[2:-1], lines[-1]
    built_ok = (not set(head["built"]) & set(PRIME_SOURCES) if built is None
                else sorted(head["built"]) == sorted(built))
    if not built_ok or \
            sorted(head["loaded"]) != sorted(PRIME_SOURCES + NATIVE_SOURCES):
        raise AssertionError(f"prime: built / loaded {head}, expected "
                             f"built {sorted(built)}")
    if fill.get("filled_rows") != rows:
        raise AssertionError(f"prime: {fill} is not filled_rows {rows}")
    want = [{"rows_bucket": cap, "batch_bucket": b, "k": [K],
             "modes": ["exact", "int8", "binary"]} for b in buckets]
    if [ln.get("primed") for ln in primed] != want:
        raise AssertionError(f"prime: bucket lines {primed}")
    if cache is not None and last != {"cache": str(cache), "done": True}:
        raise AssertionError(f"prime: last line {last}")
    return [ln["s"] for ln in primed]


def prime_child(cache: Path, rows: int, built) -> dict:
    """``python -m fastpyvectordb_tpu_torch.prime`` in a child process with
    ``--cache cache``; checks every line and the libraries in the cache."""
    cmd = [sys.executable, "-m", "fastpyvectordb_tpu_torch.prime",
           *PRIME_ARGS, "--rows", str(rows), "--cache", str(cache)]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=child_env(), capture_output=True,
                         text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"prime child exited {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    lines = [json.loads(ln) for ln in out.stdout.splitlines() if ln.strip()]
    bucket_s = check_prime_lines(lines, rows, cache.resolve(), built)
    for kind, n in (("kernels", len(PRIME_SOURCES)),
                    ("native", len(NATIVE_SOURCES))):
        libs = sorted((cache / kind).glob("lib*.so"))
        if len(libs) != n:
            raise AssertionError(f"prime: {cache / kind} holds {libs}")
    return {"wall_s": wall, "build_s": lines[0]["s"],
            "fill_s": lines[1]["s"], "bucket_s": bucket_s}


def b5_launches(scan, b: int) -> int:
    """``hamming_mxu_scores`` launches of a binary search of ``b`` queries:
    the scan splits a batch whose (B, N) score block would pass its budget
    into power-of-two sub-batches (``QuantizedScan.search``; N counts the
    codes' padded rows)."""
    n = int(scan.codes.shape[0])
    cap = max(8, int(scan._score_hbm_budget // (max(n, 1) * 4)))
    sub = 8
    while sub * 2 <= cap:
        sub *= 2
    return -(-b // sub)


def phase_prime(tmpdir: Path, results):
    """The cold-start primer (``fastpyvectordb_tpu_torch/prime.py``) at the
    full corpus size: a cold child into a fresh ``--cache`` (every
    ``csrc/*.cu`` built by ``nvcc`` and both native libraries by g++ in
    that directory: what a fresh machine pays), a warm child on the same
    cache that builds nothing, then an in-process run at 1,048,576 rows
    whose int8 and binary searches are counted: one ``s8_topc`` launch a
    bucket and k, one ``hamming_mxu_scores`` a score-block sub-batch, and
    no ``s8_scores``.
    The zero corpus's answers are checked (every score tied, rows valid
    and distinct) and the re-rank auto-tune is run on it once, timed."""
    import contextlib
    import io

    import numpy as np
    import torch
    from fastpyvectordb_tpu_torch import prime

    torch.cuda.empty_cache()
    cache = tmpdir / "prime_cache"
    cold = prime_child(cache, PRIME_ROWS, PRIME_SOURCES + NATIVE_SOURCES)
    warm = prime_child(cache, PRIME_WARM_ROWS, ())
    log(f"[prime] {nvidia_smi_line()}: cold child {cold['wall_s']:.2f} s "
        f"(nvcc + g++ {cold['build_s']} s into a fresh cache, fill "
        f"{PRIME_ROWS} rows {cold['fill_s']} s, buckets "
        f"{cold['bucket_s']} s); warm child at {PRIME_WARM_ROWS} rows "
        f"{warm['wall_s']:.2f} s (built nothing; build step "
        f"{warm['build_s']} s, buckets {warm['bucket_s']} s)")

    n_buckets = len(cold["bucket_s"])
    zero_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        prime.main([*PRIME_ARGS, "--rows", str(PRIME_ROWS)])
    wall = time.perf_counter() - t0
    launches = nonzero_launches()
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    bucket_s = check_prime_lines(lines, PRIME_ROWS, None, None)
    build_s, fill_s = lines[0]["s"], lines[1]["s"]

    # the same fill again: its answers on the zero corpus, the launches its
    # scans' routes take, and the tune a primer skips
    col = prime.filled_collection(PRIME_ROWS, DIMS, "cosine", "bfloat16",
                                  "cuda")
    scans = {kind: col.enable_quantized_scan(kind, tune=False)
             for kind in ("int8", "binary")}
    want = {"s8_topc": n_buckets, "hamming_mxu_scores": sum(
        b5_launches(scans["binary"], 8 << i) for i in range(n_buckets))}
    if launches != want:
        raise AssertionError(f"prime: launches {launches}, expected {want} "
                             "(one fused int8 scan a bucket, B5 once a "
                             "score-block sub-batch)")
    q = np.random.default_rng(1).standard_normal((BATCH, DIMS)).astype(
        np.float32)
    _, ed, er = col.search_arrays(q, k=K, exact=True)
    got = {"exact": (ed, er)}
    for kind, scan in scans.items():
        got[kind] = scan.search(q, K)
    tie = float(ed[0, 0])
    for kind, (d, r) in got.items():
        d, r = np.asarray(d), np.asarray(r)
        distinct = all(len(set(row.tolist())) == K for row in r)
        if d.shape != (BATCH, K) or not np.allclose(d, tie, atol=1e-6) or \
                r.min() < 0 or r.max() >= PRIME_ROWS or not distinct:
            raise AssertionError(f"prime: {kind} on the zero corpus gave "
                                 f"scores {d[:1]} rows {r[:1]}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tuned = col.enable_quantized_scan("int8").default_rerank
    tune_s = time.perf_counter() - t0
    code_rows = int(scans["binary"].codes.shape[0])
    del col, scans
    torch.cuda.empty_cache()
    results["prime"] = {
        "gated": False, "rows": PRIME_ROWS, "launches": launches,
        "cold_child_s": cold["wall_s"], "cold_build_s": cold["build_s"],
        "cold_fill_s": cold["fill_s"], "cold_bucket_s": cold["bucket_s"],
        "warm_child_s": warm["wall_s"], "warm_build_s": warm["build_s"],
        "warm_bucket_s": warm["bucket_s"], "counted_run_s": wall,
        "counted_build_s": build_s, "counted_fill_s": fill_s,
        "counted_bucket_s": bucket_s, "code_rows": code_rows,
        "zero_corpus_tie": tie,
        "zero_corpus_tuned_rerank": tuned, "zero_corpus_tune_s": tune_s}
    log(f"[prime] {nvidia_smi_line()}: in-process run at {PRIME_ROWS} rows "
        f"{wall:.2f} s (build step {build_s} s, fill {fill_s} s), buckets "
        f"{bucket_s} s, launches {launches} (codes "
        f"padded to {code_rows} rows); exact, "
        f"int8 and binary all tied at {tie} on the zero corpus; the int8 "
        f"auto-tune on it ends at rerank {tuned} in {tune_s:.2f} s")


EXAMPLES = (
    ("quickstart", ["examples_torch/quickstart.py", "--device", "cuda",
                    "--path", "{tmp}/quickstart"],
     ("7. SEARCH TIERS", "int8 two-stage", "persisted to {tmp}/quickstart",
      "cleaned up {tmp}/quickstart")),
    ("production_ops", ["examples_torch/production_ops.py", "--device",
                        "cuda", "--base", "{tmp}/production_ops"],
     ("recovered 99 rows", "corrupted file detected",
      "python -m fastpyvectordb_tpu_torch.prime",
      "All production-ops demos passed.")),
    ("news_intelligence", ["-m", "examples_torch.news_intelligence.demo",
                           "--articles", "400", "--device", "cuda",
                           "--db-path", "{tmp}/news", "--fresh"],
     ("DEMO COMPLETE", "SEARCH DEMONSTRATIONS",
      "KNOWLEDGE GRAPH DEMONSTRATIONS", "trending entities",
      "PERSISTENCE ROUNDTRIP",
      "search works: True")),
)


def run_example(argv, tmpdir: Path):
    """One example in a child process: (completed process, wall s)."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *[a.format(tmp=tmpdir)
                                            for a in argv]],
                         cwd=ROOT, env=child_env(), capture_output=True,
                         text=True, timeout=300)
    return out, time.perf_counter() - t0


def phase_examples(tmpdir: Path, results):
    """The port's examples (``examples_torch/``) on the card, all three at
    once, each in a child process from this checkout, their output held to
    the sentinel strings the CPU tests check."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(EXAMPLES)) as pool:
        runs = [pool.submit(run_example, argv, tmpdir)
                for _, argv, _ in EXAMPLES]
        runs = [r.result() for r in runs]
    total = time.perf_counter() - t0
    walls = {}
    for (name, _, sentinels), (out, wall) in zip(EXAMPLES, runs):
        walls[name] = wall
        missing = [s.format(tmp=tmpdir) for s in sentinels
                   if s.format(tmp=tmpdir) not in out.stdout]
        if out.returncode != 0 or missing:
            raise AssertionError(
                f"examples: {name} exited {out.returncode}, missing "
                f"{missing}:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    results["examples"] = {"gated": False, "together_s": total,
                           **{f"{n}_s": w for n, w in walls.items()}}
    log(f"[examples] {nvidia_smi_line()}: wall s "
        f"{ {n: round(w, 2) for n, w in walls.items()} } (run together, "
        f"{total:.2f} s in all), every sentinel found")


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
        phase_prime(Path(tmp), results)
        phase_examples(Path(tmp), results)
    pq, pi = ("fastpyvectordb_tpu/kernels/pallas_quant.py",
              "fastpyvectordb_tpu/kernels/pallas_ivf.py")
    lab = "benchmarks/int8_mxu_lab.py"
    where = {  # kernel: (source, the TPU kernel it replaces)
        "sq_scores": ("quant_scores.cu", f"{pq}:81"),
        "int4_scores": ("quant_scores.cu", f"{pq}:163"),
        "grouped_cell_scores": ("grouped_cell_scores.cu", f"{pi}:102"),
        "grouped_cell_scores_i8": ("grouped_cell_scores.cu", f"{pi}:234"),
        "hamming_mxu_scores": ("hamming_scores.cu", f"{pq}:241"),
        "hamming_scores": ("hamming_scores.cu", f"{pq}:292"),
        "grouped_cell_scores_pq": ("grouped_cell_scores_pq.cu", f"{pi}:179"),
        "s8_scores": ("s8_scores.cu", f"{lab}:50"),
        "s8_scores_tn": ("s8_scores.cu", f"{lab}:72"),
        # B8's redesign: the same scan with a running top-c epilogue
        "s8_topc": ("s8_scores.cu", f"{lab}:50")}
    # each counted path's launches by kernel (BigCollection, out-of-core)
    by_path = {}
    for mode, r in results.items():
        for name, n in r.get("launches", {}).items():
            by_path.setdefault(name, {})[mode] = n
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"fastpyvectordb_tpu_torch/csrc/{src}",
         "replaces": tpu,
         "launches": launches[name],
         "launches_by_path": by_path.get(name, {}), **kernels[name]}
        for name, (src, tpu) in where.items()],
        "modes": results}
    print(json.dumps(line), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
