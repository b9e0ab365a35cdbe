#!/usr/bin/env python3
"""Time the scan kernels of ``fastpyvectordb_tpu_torch/csrc`` against an
earlier version of the same sources, in turns on one CUDA card.

    git show <rev>:fastpyvectordb_tpu_torch/csrc/quant_scores.cu > build/old/quant_scores.cu
    git show <rev>:fastpyvectordb_tpu_torch/csrc/hamming_scores.cu > build/old/hamming_scores.cu
    python3 tools/kernel_ab.py build/old

The earlier sources are those whose C entry points take the f32 queries
(``fpv_sq_scores`` / ``fpv_int4_scores``: q, codes, vmin, rscale, qsq, out,
B, N, width, metric, stream) and the packed query words
(``fpv_hamming_*``: q, codes, out, B, N, W, stream).  Each is built with the
port's own nvcc flags.  Shapes: int4_scores and hamming_mxu_scores at the
two-stage paths' B=1024 x 1M rows x 768 dims, sq_scores and hamming_scores
at a B=1024 x 65,536-row block; cosine; random rows made on the card from a
fixed seed.  Each pair is timed old, new, new, old (CUDA events, mean of
``REPS`` launches after a warm-up) and checked to agree.  Prints one line a
kernel and, last, the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
REPS = 10
P, I = ctypes.c_void_p, ctypes.c_int


def build_old(src: Path, out_dir: Path) -> ctypes.CDLL:
    from fastpyvectordb_tpu_torch.kernels import cuda_build
    so = out_dir / f"lib{src.stem}_old.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                    str(src)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def ms(fn) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def in_turns(name, old, new, tol):
    import torch
    a, b = old(), new()
    torch.cuda.synchronize()
    gap = (a.double() - b.double()).abs().max().item()
    if gap > tol * max(b.double().abs().max().item(), 1.0):
        raise AssertionError(f"{name}: old and new differ by {gap}")
    t = [ms(old), ms(new), ms(new), ms(old)]
    print(f"{name}: old {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / "
          f"{t[2]:.4f} ms, speed-up {(t[0] + t[3]) / (t[1] + t[2]):.2f}x, "
          f"max gap {gap:.3g}", flush=True)


def main(old_dir: str) -> None:
    import torch
    from fastpyvectordb_tpu_torch.kernels import hamming_kernels as hk
    from fastpyvectordb_tpu_torch.kernels import quant_kernels as qk
    from fastpyvectordb_tpu_torch.kernels import cuda_build
    from fastpyvectordb_tpu_torch.quant.binary import BinaryQuantizer
    from fastpyvectordb_tpu_torch.quant.int4 import Int4Quantizer
    from fastpyvectordb_tpu_torch.quant.scalar import ScalarQuantizer
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    out_dir = ROOT / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    cuda_build.build_all(qk.SOURCE, hk.SOURCE)
    oq = build_old(Path(old_dir) / "quant_scores.cu", out_dir)
    oh = build_old(Path(old_dir) / "hamming_scores.cu", out_dir)
    for fn in ("fpv_sq_scores", "fpv_int4_scores"):
        getattr(oq, fn).argtypes = [P] * 6 + [I] * 4 + [P]
    for fn in ("fpv_hamming_mxu_scores", "fpv_hamming_scores"):
        getattr(oh, fn).argtypes = [P] * 3 + [I] * 3 + [P]

    gen = torch.Generator(device="cuda").manual_seed(3)
    b, d = 1024, 768
    rows = torch.randn((1_000_000, d), generator=gen, device="cuda")
    queries = torch.randn((b, d), generator=gen, device="cuda")
    qn = torch.nn.functional.normalize(queries, dim=1)
    zeros = torch.zeros(b, device="cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def old_quant(fn, codes, vmin, rscale, width):
        def run():
            out = torch.empty((b, codes.shape[0]), device="cuda")
            rc = getattr(oq, fn)(qn.data_ptr(), codes.data_ptr(),
                                 vmin.data_ptr(), rscale.data_ptr(),
                                 zeros.data_ptr(), out.data_ptr(), b,
                                 codes.shape[0], width, 0, stream())
            assert rc == 0, rc
            return out
        return run

    i4 = Int4Quantizer()
    i4.train(rows[:65_536])
    packed = i4.encode(rows)
    in_turns(f"int4_scores B={b} N={packed.shape[0]} D={d}",
             old_quant("fpv_int4_scores", packed, i4.vmin,
                       (i4.scale / 15.0).contiguous(), packed.shape[1]),
             lambda: qk.int4_scores(queries, packed, i4.vmin, i4.scale,
                                    metric="cosine"), 1e-3)
    del packed
    sq = ScalarQuantizer()
    sq.train(rows[:65_536])
    codes = sq.encode(rows[:65_536])
    in_turns(f"sq_scores B={b} N={codes.shape[0]} D={d}",
             old_quant("fpv_sq_scores", codes, sq.vmin,
                       (sq.scale / 255.0).contiguous(), d),
             lambda: qk.sq_scores(queries, codes, sq.vmin, sq.scale,
                                  metric="cosine"), 1e-3)
    bq = BinaryQuantizer(device="cuda").train(rows[:65_536])
    qc, words = bq.encode(queries), bq.encode(rows)

    def old_hamming(fn, c, dtype):
        def run():
            out = torch.empty((b, c.shape[0]), dtype=dtype, device="cuda")
            rc = getattr(oh, fn)(qc.data_ptr(), c.data_ptr(), out.data_ptr(),
                                 b, c.shape[0], c.shape[1], stream())
            assert rc == 0, rc
            return out
        return run

    in_turns(f"hamming_mxu_scores B={b} N={words.shape[0]} "
             f"W={words.shape[1]}",
             old_hamming("fpv_hamming_mxu_scores", words, torch.float32),
             lambda: hk.hamming_mxu_scores(qc, words), 0.0)
    block = words[:65_536]
    in_turns(f"hamming_scores B={b} N={block.shape[0]} W={block.shape[1]}",
             old_hamming("fpv_hamming_scores", block, torch.int32),
             lambda: hk.hamming_scores(qc, block), 0.0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
