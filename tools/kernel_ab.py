#!/usr/bin/env python3
"""Time the hand kernels of ``fastpyvectordb_tpu_torch/csrc`` against an
earlier version of the same sources, in turns on one CUDA card.

    git show <rev>:fastpyvectordb_tpu_torch/csrc/quant_scores.cu > build/old/quant_scores.cu
    git show <rev>:fastpyvectordb_tpu_torch/csrc/hamming_scores.cu > build/old/hamming_scores.cu
    git show <rev>:fastpyvectordb_tpu_torch/csrc/grouped_cell_scores.cu > build/old/grouped_cell_scores.cu
    git show <rev>:fastpyvectordb_tpu_torch/csrc/grouped_cell_scores_pq.cu > build/old/grouped_cell_scores_pq.cu
    git show <rev>:fastpyvectordb_tpu_torch/csrc/s8_scores.cu > build/old/s8_scores.cu
    git show <rev>:fastpyvectordb_tpu_torch/csrc/hopper_scan.cuh > build/old/hopper_scan.cuh
    (the same for hopper_common.cuh and topc_epilogue.cuh)
    python3 tools/kernel_ab.py build/old

Only the kernels whose earlier source lies in the directory are timed.  The
earlier scan sources (``quant_scores.cu``, ``hamming_scores.cu``,
``s8_scores.cu``) have today's entry points and are timed through today's
wrappers with the library swapped; the earlier grouped sources are the
first-slice kernels (``fpv_grouped_cell_scores[_i8]`` as now;
``fpv_grouped_cell_scores_pq`` without the scratch argument).  Each is
built with the port's own nvcc flags, beside the headers it was written
for where ``hopper_scan.cuh`` / ``hopper_common.cuh`` /
``topc_epilogue.cuh`` lie in the directory too, else beside today's.
Shapes: s8_scores and s8_scores_tn at the int8 two-stage path's B=1024 x
1,048,576 x 768 (beside ``torch._int_mm`` on B8's and on
B9's operands, ``s8_kernels.s8_tn_library``, and B9's two-pass yardstick,
the transposing copy and ``s8_scores``), ``s8_topc`` at the same shape
(cosine, c = 40, 90% of rows unmasked; through the wrapper), int4_scores and
hamming_mxu_scores at the two-stage paths' B=1024 x 1M rows x 768 dims,
sq_scores and hamming_scores at a B=1024 x 65,536-row block, on random rows
made on the card from a fixed seed; grouped_cell_scores (bf16 cells, nprobe
32), grouped_cell_scores_i8 (int8 cells, nprobe 16) and
grouped_cell_scores_pq (nprobe 64) at the operands ``chip_smoke.py``'s IVF
and IVF-PQ paths make for one B=1024 batch on its 1M x 768 corpus
(``main_path_operands``); cosine.  Each pair is timed old, new, new, old
(CUDA events, mean of ``REPS`` launches after a warm-up) and checked to
agree; grouped_cell_scores also beside its library call, ``torch.bmm`` of
cells gathered beforehand.  It first prints, for each earlier source, the
kernels whose SASS (``cuobjdump -sass``) is the same in both builds and
those whose SASS differs; then one line a kernel and, last, the card's
nvidia-smi name and power limit.
"""

from __future__ import annotations

import contextlib
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
    # headers beside the old source win; today's fill in the rest
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                    str(cuda_build.CSRC), "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def old_lib(source, old_dir: Path, out_dir: Path) -> ctypes.CDLL:
    """The earlier ``source`` (a ``CudaSource``) from ``old_dir``, its entry
    points bound with today's argument types."""
    lib = build_old(old_dir / f"{source.name}.cu", out_dir)
    for fn, argtypes in source.signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def swapped(source, lib):
    """``source``'s library swapped for ``lib`` inside the block, and the
    one it had put back after it."""
    before = source._lib
    source._lib = lib
    try:
        yield
    finally:
        source._lib = before


def through(source, lib, fn):
    """``fn`` run with ``source``'s library swapped for ``lib``."""
    def run():
        with swapped(source, lib):
            return fn()
    return run


def unhash(name: str) -> str:
    """A mangled name without its anonymous namespace's tag
    (``_GLOBAL__N__<hash>_<n>_<file>_<hash>``), which the source's path
    sets."""
    head, sep, rest = name.partition("_GLOBAL__N__")
    if not sep:
        return name
    length, _, tail = rest[9:].partition("_")   # past "<8 hex>_"
    return head + "_GLOBAL__N_" + unhash(tail[int(length) + 9:])


def sass_by_kernel(so: Path) -> dict:
    """Each kernel's SASS in a built library: {mangled name without its
    anonymous namespace's tag: text}."""
    from fastpyvectordb_tpu_torch.kernels import cuda_build
    tool = Path(cuda_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = unhash(line.split("Function : ", 1)[1].strip())
            out[name] = []
        elif name is not None:
            out[name].append(line.strip())
    return {k: "\n".join(v) for k, v in out.items()}


def same_sass(old_dir: Path, out_dir: Path) -> None:
    """For each earlier source in ``old_dir``: which kernels compile to the
    same SASS as today's and which do not."""
    from fastpyvectordb_tpu_torch.kernels import cuda_build
    from fastpyvectordb_tpu_torch.kernels import hamming_kernels as hk
    from fastpyvectordb_tpu_torch.kernels import ivf_kernels as ik
    from fastpyvectordb_tpu_torch.kernels import quant_kernels as qk
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    for source in (qk.SOURCE, hk.SOURCE, s8.SOURCE, ik.SOURCE, ik.SOURCE_PQ):
        if not (old_dir / f"{source.name}.cu").exists():
            continue
        cuda_build.build_all(source)
        build_old(old_dir / f"{source.name}.cu", out_dir)
        old = sass_by_kernel(out_dir / f"lib{source.name}_old.so")
        new = sass_by_kernel(source._so())
        same = sorted(k for k in new if old.get(k) == new[k])
        differ = sorted(k for k in new if old.get(k) != new[k])
        print(f"{source.name}.cu SASS: {len(same)} kernels the same "
              f"{same}; {len(differ)} differ {differ}", flush=True)


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


def in_turns(name, old, new, tol, mask=None):
    import torch
    a, b = old(), new()
    torch.cuda.synchronize()
    if mask is not None:   # what both versions leave unwritten is not compared
        a, b = a[mask.expand_as(a)], b[mask.expand_as(b)]
    gap = (a.double() - b.double()).abs().max().item()
    if gap > tol * max(b.double().abs().max().item(), 1.0):
        raise AssertionError(f"{name}: old and new differ by {gap}")
    t = [ms(old), ms(new), ms(new), ms(old)]
    print(f"{name}: old {t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / "
          f"{t[2]:.4f} ms, speed-up {(t[0] + t[3]) / (t[1] + t[2]):.2f}x, "
          f"max gap {gap:.3g}", flush=True)


# the nprobe each of chip_smoke.py's IVF modes tunes to on its corpus
MAIN_PATH_NPROBE = {"b2": 32, "b3": 16, "b7": 64}


def main_path_operands(which=("b2", "b3", "b7")) -> dict:
    """The arguments ``chip_smoke.py``'s IVF (bf16 cells: "b2", int8 cells:
    "b3") and IVF-PQ ("b7") paths hand their kernel for one B=1024 batch:
    its corpus and queries, its build recipes, the nprobe each mode tunes
    to there."""
    import tempfile
    import torch
    import chip_smoke as cs
    from fastpyvectordb_tpu_torch import VectorDB
    gen = torch.Generator(device="cuda").manual_seed(0)
    centers = 2.0 * torch.randn((cs.N_CENTERS, cs.DIMS), generator=gen,
                                device="cuda")
    corpus = cs.clustered(gen, cs.N_ROWS, centers, 1.0)
    corpus /= torch.linalg.norm(corpus, dim=1, keepdim=True)
    queries = cs.clustered(gen, cs.BATCH, centers, 0.5).cpu().numpy()
    host = corpus.cpu().numpy()
    del corpus
    ids = [f"v{i}" for i in range(cs.N_ROWS)]
    out = {}
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        db = VectorDB(tmp, device="cuda")
        if "b2" in which:
            bf = db.create_collection("bf16", dimensions=cs.DIMS,
                                      metric="cosine",
                                      compute_dtype="bfloat16",
                                      storage_dtype="bfloat16")
            bf.insert_batch(host, ids)
            bf.build_ann("ivf", tune=False, **cs.IVF_BUILD)
            out["b2"] = cs.ivf_kernel_case(bf._ann, queries, "cosine",
                                           MAIN_PATH_NPROBE["b2"])
            db.delete_collection("bf16")
        if "b3" in which or "b7" in which:
            col = db.create_collection("main", dimensions=cs.DIMS,
                                       metric="cosine")
            col.insert_batch(host, ids)
        if "b3" in which:
            col.build_ann("ivf", tune=False, cell_dtype="int8",
                          **cs.IVF_BUILD)
            out["b3"] = cs.ivf_kernel_case(col._ann, queries, "cosine",
                                           MAIN_PATH_NPROBE["b3"])
        if "b7" in which:
            col.build_ann("ivfpq", tune=False)
            out["b7"] = cs.ivfpq_kernel_case(col._ann, queries,
                                             MAIN_PATH_NPROBE["b7"])
    torch.cuda.empty_cache()
    return out


def grouped_in_turns(old_dir: Path, out_dir: Path) -> None:
    """B2, B3 and B7, old against new at the main path's operands."""
    import torch
    import chip_smoke as cs
    from fastpyvectordb_tpu_torch.kernels import cuda_build
    from fastpyvectordb_tpu_torch.kernels import ivf_kernels as ik
    have_ivf = (old_dir / "grouped_cell_scores.cu").exists()
    have_pq = (old_dir / "grouped_cell_scores_pq.cu").exists()
    if not (have_ivf or have_pq):
        return
    cuda_build.build_all(ik.SOURCE, ik.SOURCE_PQ)
    ops = main_path_operands((("b2", "b3") if have_ivf else ())
                             + (("b7",) if have_pq else ()))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def shape_of(args):
        u, qcap, d = args[1].shape
        return (f"U={u} n_uniq={int(args[0][0])} qcap={qcap} "
                f"cmax={args[2].shape[1]} D={d}")

    if have_ivf:
        old = build_old(old_dir / "grouped_cell_scores.cu", out_dir)
        old.fpv_grouped_cell_scores.argtypes = [P] * 7 + [I] * 5 + [P]
        old.fpv_grouped_cell_scores_i8.argtypes = [P] * 9 + [I] * 5 + [P]
        for key, fn, new, tol in (
                ("b2", "fpv_grouped_cell_scores", ik.grouped_cell_scores,
                 cs.KERNEL_RTOL),
                ("b3", "fpv_grouped_cell_scores_i8",
                 ik.grouped_cell_scores_i8, cs.I8_RTOL)):
            args = ops[key]
            u, qcap, d = args[1].shape
            cmax = args[2].shape[1]
            n = int(args[0][0])

            def run_old(fn=fn, args=args, dims=(u, qcap, cmax, d)):
                out = torch.empty(dims[:3], device="cuda")
                rc = getattr(old, fn)(*(t.data_ptr() for t in args),
                                      out.data_ptr(), *dims, 0, stream())
                assert rc == 0, rc
                return out[:n]

            design = ik.grouped_design(args[1], args[2])
            in_turns(f"{fn[4:]} nprobe {MAIN_PATH_NPROBE[key]} "
                     f"{shape_of(args)} (new design: {design})", run_old,
                     lambda new=new, args=args: new(*args,
                                                    metric="cosine")[:n],
                     tol)
            if key == "b2":
                print(f"grouped_cell_scores library (torch.bmm of cells "
                      f"gathered beforehand): "
                      f"{ms(cs.ivf_library(args)):.4f} ms", flush=True)
    if have_pq:
        old = build_old(old_dir / "grouped_cell_scores_pq.cu", out_dir)
        old.fpv_grouped_cell_scores_pq.argtypes = [P] * 5 + [I] * 5 + [P]
        args = ops["b7"]
        cell_ids, lut, qslot, codes_t = args
        u, qcap = qslot.shape
        _, m, cmax = codes_t.shape
        n = int(cell_ids[0])
        live = (qslot[:n] >= 0)[:, :, None]

        def run_old():
            out = torch.empty((u, qcap, cmax), device="cuda")
            rc = old.fpv_grouped_cell_scores_pq(
                *(t.data_ptr() for t in args), out.data_ptr(), u, qcap, cmax,
                m, lut.shape[1] // m, stream())
            assert rc == 0, rc
            return out[:n]

        # only live slots are written: compare those (the timed calls
        # return the block itself)
        in_turns(f"grouped_cell_scores_pq nprobe {MAIN_PATH_NPROBE['b7']} "
                 f"U={u} n_uniq={n} qcap={qcap} cmax={cmax} M={m} "
                 f"K={lut.shape[1] // m} filled={int(live.sum())}",
                 run_old, lambda: ik.grouped_cell_scores_pq(*args)[:n],
                 cs.PQ_RTOL, mask=live)


def scans_in_turns(old_dir: Path, out_dir: Path) -> None:
    """B4, B1, B5 and B6, old against new on random rows, through today's
    wrappers with the library swapped."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import hamming_kernels as hk
    from fastpyvectordb_tpu_torch.kernels import quant_kernels as qk
    from fastpyvectordb_tpu_torch.kernels import cuda_build
    from fastpyvectordb_tpu_torch.quant.binary import BinaryQuantizer
    from fastpyvectordb_tpu_torch.quant.int4 import Int4Quantizer
    from fastpyvectordb_tpu_torch.quant.scalar import ScalarQuantizer
    if not ((old_dir / "quant_scores.cu").exists()
            and (old_dir / "hamming_scores.cu").exists()):
        return
    cuda_build.build_all(qk.SOURCE, hk.SOURCE)
    libs = {qk.SOURCE: (old_lib(qk.SOURCE, old_dir, out_dir),
                        qk.SOURCE.load()),
            hk.SOURCE: (old_lib(hk.SOURCE, old_dir, out_dir),
                        hk.SOURCE.load())}

    gen = torch.Generator(device="cuda").manual_seed(3)
    b, d = 1024, 768
    rows = torch.randn((1_000_000, d), generator=gen, device="cuda")
    queries = torch.randn((b, d), generator=gen, device="cuda")

    def turns(name, source, fn, tol):
        old, new = libs[source]
        in_turns(name, through(source, old, fn), through(source, new, fn),
                 tol)

    i4 = Int4Quantizer()
    i4.train(rows[:65_536])
    packed = i4.encode(rows)
    turns(f"int4_scores B={b} N={packed.shape[0]} D={d}", qk.SOURCE,
          lambda: qk.int4_scores(queries, packed, i4.vmin, i4.scale,
                                 metric="cosine"), 1e-3)
    del packed
    sq = ScalarQuantizer()
    sq.train(rows[:65_536])
    codes = sq.encode(rows[:65_536])
    turns(f"sq_scores B={b} N={codes.shape[0]} D={d}", qk.SOURCE,
          lambda: qk.sq_scores(queries, codes, sq.vmin, sq.scale,
                               metric="cosine"), 1e-3)
    bq = BinaryQuantizer(device="cuda").train(rows[:65_536])
    qc, words = bq.encode(queries), bq.encode(rows)
    turns(f"hamming_mxu_scores B={b} N={words.shape[0]} "
          f"W={words.shape[1]}", hk.SOURCE,
          lambda: hk.hamming_mxu_scores(qc, words), 0.0)
    block = words[:65_536]
    turns(f"hamming_scores B={b} N={block.shape[0]} W={block.shape[1]}",
          hk.SOURCE, lambda: hk.hamming_scores(qc, block), 0.0)


def s8_in_turns(old_dir: Path, out_dir: Path) -> None:
    """B8, B9 and ``s8_topc``, old against new at the int8 path's shape on
    random codes, through today's wrappers with the library swapped, and
    the library calls and B9's two-pass yardstick beside them."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    if not (old_dir / "s8_scores.cu").exists():
        return
    new = s8.SOURCE.load()
    old = old_lib(s8.SOURCE, old_dir, out_dir)
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, n, d = 1024, 1 << 20, 768
    codes = torch.randint(-128, 128, (n, d), generator=gen, device="cuda",
                          dtype=torch.int8)
    qi = torch.randint(-127, 128, (b, d), generator=gen, device="cuda",
                       dtype=torch.int8)

    def turns(name, fn, tol=0.0):
        in_turns(name, through(s8.SOURCE, old, fn),
                 through(s8.SOURCE, new, fn), tol)

    turns(f"s8_scores B={b} N={n} D={d}", lambda: s8.s8_scores(qi, codes))
    print(f"s8_scores library ({s8.S8_LIBRARY}): "
          f"{ms(lambda: torch._int_mm(qi, codes.T)):.4f} ms", flush=True)
    qscale = torch.rand(b, generator=gen, device="cuda") * 1e-3 + 1e-4
    const = torch.randn(b, generator=gen, device="cuda")
    qn = torch.rand(b, generator=gen, device="cuda") * 10 + 1
    rinv = torch.rand(n, generator=gen, device="cuda") + 0.5
    mask = torch.rand(n, generator=gen, device="cuda") < 0.9
    # the sorted values are compared (rows may differ on ties)
    turns(f"s8_topc B={b} N={n} D={d} cosine c=40",
          lambda: s8.s8_topc(qi, codes, qscale, const, qn, rinv, mask, c=40,
                             metric="cosine")[0])
    codes_t = codes.T.contiguous()
    del codes
    turns(f"s8_scores_tn B={b} N={n} D={d}",
          lambda: s8.s8_scores_tn(qi, codes_t))
    call, label, refusal = s8.s8_tn_library(qi, codes_t)
    if refusal:
        print(f"torch._int_mm refuses (D, N) codes: {refusal}", flush=True)
    print(f"s8_scores_tn library ({label}): {ms(call):.4f} ms; two-pass "
          f"yardstick ({s8.S8_TWO_PASS}): "
          f"{ms(lambda: s8.s8_scores(qi, codes_t.t().contiguous())):.4f} ms",
          flush=True)


def main(old_dir: str) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    out_dir = ROOT / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    same_sass(Path(old_dir), out_dir)
    grouped_in_turns(Path(old_dir), out_dir)
    torch.cuda.empty_cache()
    scans_in_turns(Path(old_dir), out_dir)
    torch.cuda.empty_cache()
    s8_in_turns(Path(old_dir), out_dir)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    main(sys.argv[1])
