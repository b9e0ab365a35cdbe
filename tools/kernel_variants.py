#!/usr/bin/env python3
"""Where the time of the hand kernels goes, on one CUDA card.

    python3 tools/kernel_variants.py            # the Hopper scan (B4, B5)
    python3 tools/kernel_variants.py s8         # the same scan under B8, B9
    python3 tools/kernel_variants.py grouped    # B2, B3 and B7
    python3 tools/kernel_variants.py topc       # the fused int8 scan s8_topc
    python3 tools/kernel_variants.py s8 base no_store      # these variants only

The Hopper scan: time ``int4_scores`` and ``hamming_mxu_scores`` at the
two-stage paths' B=1024 x 1M x 768 with parts of ``csrc/hopper_scan.cuh``
switched off.  ``s8``: the same variants of ``s8_scores`` and
``s8_scores_tn`` at the int8 two-stage path's B=1024 x 1M x 768, beside
B8's library call ``torch._int_mm(q, codes.T)``, B9's on its own (D, N)
operands (``s8_tn_library``) and B9's two-pass yardstick (the transposing
copy ``codes_t.t().contiguous()`` and ``s8_scores`` on it); the base
build's B9 output is checked against ``s8_scores``.

Each variant is a copy of ``csrc/`` under ``build/kernel_variants/<name>``
with one or more lines replaced (the outputs of such a copy are wrong; only
its time means something), built with the port's nvcc flags and timed in a
child process of its own with a time limit, in two rounds:

  base       the sources as they are
  no_expand  the consumers never expand the codes into their fragments
  no_tma     the query tile is never loaded (the barrier is arrived on)
  no_store   the epilogue stages the scores but never stores them
  no_mma     the consumers issue no wgmma
  no_tma_no_expand   both
  no_store_no_tma    neither the query tile nor the scores move
  no_codes           the producers never copy the corpus tile
  no_store_no_codes  neither the corpus tile nor the scores move

``grouped``: ``grouped_cell_scores``, ``grouped_cell_scores_i8`` and
``grouped_cell_scores_pq`` at the operands of ``chip_smoke.py``'s IVF and
IVF-PQ paths (``tools/kernel_ab.py:main_path_operands``), each variant the
sources as they are built with the switches of ``GROUPED_VARIANTS`` (design
choices: B7's staged chunk size, narrowest tail tile, producer warps and
bank-word padding, B2's second staging tile; and ablations whose outputs are wrong: no
lookups, no table staging, no products, no stores).  One child process builds the
operands once and times the variants in two rounds; if it runs into its
time limit (a mis-sized barrier hangs the card), the variant it was at is
dropped and a new child goes on with the rest.

``topc``: ``s8_topc`` (B8's redesign: the s8 scan with a running top-c
epilogue) at the int8 two-stage path's B=1024 x 1,048,576 x 768, cosine, c
= 40, on random codes, beside the route it replaced (``s8_scores`` + the
folded epilogue's PyTorch passes + ``masked_fill`` + ``torch.topk``), each
variant ``csrc/s8_scores.cu`` built with the switches of ``TOPC_VARIANTS``
(outputs wrong, times only): no epilogue at all, no epilogue arithmetic
(the score is the integer product), no threshold compare (no row enters a
list), both of these, no compactions, no prefilter (every score runs the
exact test, as before the integer floors); ``merge``, the merge kernel
alone on the lists the full kernel left; ``cell``, the full kernel on the
int8 cells' own operands (``_cell_args``) at B=1024 and B=1; and
``stats``, a build that counts the rows that enter the lists, the
compactions, the scores that pass the integer test and those tested in
place without it (printed a block and query, and as a share of the
scores), on random codes and on the cells' operands at B=1024 and B=1.
Each variant is timed beside the full kernel in the same child process.
Run on an older checkout, a switch its sources lack builds the full
kernel, and its stats have no pass count.

Prints one line a variant and round, then the card's nvidia-smi name and
power limit.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "fastpyvectordb_tpu_torch" / "csrc"
OUT = ROOT / "build" / "kernel_variants"

TMA = """        if (r == 0) {
          mbar_arrive_tx(&full[stage], Q_BYTES);
          tma_load_2d(st, &qmap, &full[stage], k * Op::KSTEP_ELEMS,
                      (tile % qtiles) * BQ);
        }"""
NO_TMA = "        if (r == 0) mbar_arrive(&full[stage]);"
EXPAND = """          Op::fragment(p, st + Q_BYTES, frow, lane, kk, a[kk & 1], rs0, rs1);"""
NO_EXPAND = """          a[kk & 1][0] = a[kk & 1][1] = a[kk & 1][2] = a[kk & 1][3] = 0x3F803F80u;"""
STORE = """              tma_store_2d(&omap, buf, n0, m0 + 32 * r);
              tma_store_2d(&omap, buf + OUT_BOX, n0 + 32, m0 + 32 * r);"""
CODES = """        if (tma_codes) {
          if (r == 0) {
            mbar_arrive_tx(&full[stage], Op::STAGE_EXTRA);
            const int c0 = k * Op::KSTEP_ELEMS, c1 = (tile / qtiles) * BC;
            if constexpr (CodesDN<Op>::value)
              tma_load_2d(st + Q_BYTES, &cmap, &full[stage], c1, c0);
            else
              tma_load_2d(st + Q_BYTES, &cmap, &full[stage], c0, c1);
          } else {
            mbar_arrive(&full[stage]);
          }
        } else if (Op::fetch(p, st + Q_BYTES, r, n, k)) {
          mbar_arrive_cp_async(&full[stage]);
        } else {
          mbar_arrive(&full[stage]);
        }"""
NO_CODES = "        mbar_arrive(&full[stage]);"
MMA = """          Op::mma(d, a[kk & 1], db + 2 * kk, (k > 0 || kk > 0) ? 1 : 0);"""
VARIANTS = {
    "base": [],
    "no_expand": [(EXPAND, NO_EXPAND)],
    "no_tma": [(TMA, NO_TMA)],
    "no_store": [(STORE, "")],
    "no_mma": [(MMA, "")],
    "no_tma_no_expand": [(TMA, NO_TMA), (EXPAND, NO_EXPAND)],
    "no_store_no_tma": [(STORE, ""), (TMA, NO_TMA)],
    "no_codes": [(CODES, NO_CODES)],
    "no_store_no_codes": [(STORE, ""), (CODES, NO_CODES)],
}
SOURCES = {"scan": ("quant_scores", "hamming_scores"), "s8": ("s8_scores",)}


def build(which: str, names) -> None:
    from fastpyvectordb_tpu_torch.kernels import cuda_build
    procs = []
    for name in names:
        subs = VARIANTS[name]
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        header = (d / "hopper_scan.cuh").read_text()
        for old, new in subs:
            if old not in header:
                raise SystemExit(f"{name}: the text to replace is gone from "
                                 "hopper_scan.cuh")
            header = header.replace(old, new)
        (d / "hopper_scan.cuh").write_text(header)
        for src in SOURCES[which]:
            procs.append(subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                 str(d / f"lib{src}.so"), str(d / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(out)


def time_variant(name: str, rnd: str, which: str) -> None:
    import torch
    from fastpyvectordb_tpu_torch.kernels import hamming_kernels as hk
    from fastpyvectordb_tpu_torch.kernels import quant_kernels as qk
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    from fastpyvectordb_tpu_torch.quant.binary import BinaryQuantizer
    from fastpyvectordb_tpu_torch.quant.int4 import Int4Quantizer
    for src, mod in zip(SOURCES[which], (s8,) if which == "s8" else (qk, hk)):
        lib = ctypes.CDLL(str(OUT / name / f"lib{src}.so"))
        for fn, argtypes in mod.SOURCE.signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        mod.SOURCE._lib = lib
    gen = torch.Generator(device="cuda").manual_seed(1)

    def ms(fn, reps=5):
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

    if which == "s8":
        codes = torch.randint(-128, 128, (1 << 20, 768), generator=gen,
                              device="cuda", dtype=torch.int8)
        qi = torch.randint(-127, 128, (1024, 768), generator=gen,
                           device="cuda", dtype=torch.int8)
        t8 = ms(lambda: s8.s8_scores(qi, codes))
        lib_ms = ms(lambda: torch._int_mm(qi, codes.T))
        codes_t = codes.T.contiguous()
        t9 = ms(lambda: s8.s8_scores_tn(qi, codes_t))
        tn_lib, tn_label, _ = s8.s8_tn_library(qi, codes_t)
        tn_lib_ms = ms(tn_lib)
        two_ms = ms(lambda: s8.s8_scores(qi, codes_t.t().contiguous()))
        check = ""
        if name == "base":
            same = torch.equal(s8.s8_scores_tn(qi, codes_t),
                               s8.s8_scores(qi, codes))
            check = "  B9 equal to B8" if same else "  B9 DIFFERS from B8"
        print(f"round {rnd} {name:18s} s8_scores {t8:.4f} ms  s8_scores_tn "
              f"{t9:.4f} ms  torch._int_mm {lib_ms:.4f} ms  B9 library "
              f"{tn_lib_ms:.4f} ms ({tn_label})  two-pass {two_ms:.4f} ms"
              f"{check}", flush=True)
        return
    rows = torch.randn((1_000_000, 768), generator=gen, device="cuda")
    q = torch.randn((1024, 768), generator=gen, device="cuda")
    i4 = Int4Quantizer()
    i4.train(rows[:65_536])
    packed = i4.encode(rows)
    bq = BinaryQuantizer(device="cuda").train(rows[:65_536])
    qc, words = bq.encode(q), bq.encode(rows)
    del rows
    t4 = ms(lambda: qk.int4_scores(q, packed, i4.vmin, i4.scale,
                                   metric="cosine"))
    t5 = ms(lambda: hk.hamming_mxu_scores(qc, words))
    print(f"round {rnd} {name:18s} int4_scores {t4:.4f} ms  "
          f"hamming_mxu_scores {t5:.4f} ms", flush=True)


# name: (source the switches apply to, extra nvcc flags)
GROUPED_VARIANTS = {
    "base": (None, []),
    "pq_chunk512": ("pq", ["-DFPV_PQ_CHUNK_BYTES=512"]),
    "pq_chunk1024": ("pq", ["-DFPV_PQ_CHUNK_BYTES=1024"]),
    "pq_chunk1536": ("pq", ["-DFPV_PQ_CHUNK_BYTES=1536"]),
    "pq_tails16": ("pq", ["-DFPV_PQ_MIN_W=16"]),
    "pq_tails32": ("pq", ["-DFPV_PQ_MIN_W=32"]),
    "pq_producers4": ("pq", ["-DFPV_PQ_PRODUCER_WARPS=4"]),
    "pq_nopad": ("pq", ["-DFPV_PQ_PAD=0"]),
    "pq_no_lookup": ("pq", ["-DFPV_PQ_NO_LOOKUP"]),
    "pq_no_stage": ("pq", ["-DFPV_PQ_NO_STAGE"]),
    "ivf_one_buf": ("ivf", ["-DFPV_GROUPED_ONE_BUF"]),
    "ivf_no_store": ("ivf", ["-DFPV_GROUPED_NO_STORE"]),
    "ivf_no_mma": ("ivf", ["-DFPV_GROUPED_NO_MMA"]),
}
GROUPED_SOURCES = {"ivf": "grouped_cell_scores", "pq": "grouped_cell_scores_pq"}
PROGRESS = OUT / "grouped_progress.txt"


def build_grouped() -> None:
    from fastpyvectordb_tpu_torch.kernels import cuda_build
    procs = []
    for name, (which, flags) in GROUPED_VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for key, src in GROUPED_SOURCES.items():
            if which not in (None, key):
                continue
            procs.append(subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o",
                 str(d / f"lib{src}.so"), str(CSRC / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(out)


def time_grouped(todo) -> None:
    """Child: time the (round, variant) pairs of ``todo`` in order."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import ivf_kernels as ik
    from kernel_ab import main_path_operands, ms
    ops = main_path_operands()
    calls = {
        "ivf": (("grouped_cell_scores",
                 lambda: ik.grouped_cell_scores(*ops["b2"], metric="cosine")),
                ("grouped_cell_scores_i8",
                 lambda: ik.grouped_cell_scores_i8(*ops["b3"],
                                                   metric="cosine"))),
        "pq": (("grouped_cell_scores_pq",
                lambda: ik.grouped_cell_scores_pq(*ops["b7"])),)}
    for item in todo:
        rnd, name = item.split(":")
        with PROGRESS.open("a") as f:
            f.write(f"start {item}\n")
        which = GROUPED_VARIANTS[name][0]
        times = []
        for key, mod_src in (("ivf", ik.SOURCE), ("pq", ik.SOURCE_PQ)):
            if which not in (None, key):
                continue
            lib = ctypes.CDLL(str(OUT / name / f"lib{mod_src.name}.so"))
            for fn, argtypes in mod_src.signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            mod_src._lib = lib
            times += [f"{kernel} {ms(fn):.4f} ms" for kernel, fn in calls[key]]
        torch.cuda.synchronize()
        print(f"round {rnd} {name:20s} " + "  ".join(times), flush=True)
        with PROGRESS.open("a") as f:
            f.write(f"done {item}\n")


def main_grouped() -> None:
    build_grouped()
    todo = [f"{rnd}:{name}" for rnd in range(2) for name in GROUPED_VARIANTS]
    while todo:
        PROGRESS.unlink(missing_ok=True)
        try:
            subprocess.run([sys.executable, __file__, "grouped-child", *todo],
                           timeout=600, check=False)
        except subprocess.TimeoutExpired:
            pass
        lines = PROGRESS.read_text().split("\n") if PROGRESS.exists() else []
        done = {ln[5:] for ln in lines if ln.startswith("done ")}
        started = [ln[6:] for ln in lines if ln.startswith("start ")]
        hung = [it for it in started if it not in done]
        if not done and not hung:
            raise SystemExit("grouped variants: the child timed nothing")
        for it in hung:
            print(f"round {it.split(':')[0]} {it.split(':')[1]}: timed out "
                  "or failed", flush=True)
        todo = [it for it in todo if it not in done and it not in hung]


TOPC_VARIANTS = {
    "base": [],
    "no_epilogue": ["-DFPV_TOPC_NO_EPILOGUE"],
    "no_math": ["-DFPV_TOPC_NO_MATH"],
    "no_filter": ["-DFPV_TOPC_NO_FILTER"],
    "no_filter_math": ["-DFPV_TOPC_NO_FILTER", "-DFPV_TOPC_NO_MATH"],
    "no_compact": ["-DFPV_TOPC_NO_COMPACT"],
    "no_prefilter": ["-DFPV_TOPC_NO_PREFILTER"],
    "merge": [],
    "cell": [],
    "stats": ["-DFPV_TOPC_STATS"],
}


def build_topc(names) -> None:
    from fastpyvectordb_tpu_torch.kernels import cuda_build
    procs = []
    for name in {"base", *names}:
        d = OUT / f"topc_{name}"
        d.mkdir(parents=True, exist_ok=True)
        procs.append(subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *TOPC_VARIANTS[name],
             "-o", str(d / "libs8_scores.so"), str(CSRC / "s8_scores.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(out)


def _load_s8(name: str):
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    lib = ctypes.CDLL(str(OUT / f"topc_{name}" / "libs8_scores.so"))
    for fn, argtypes in s8.SOURCE.signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    if name == "stats":
        lib.fpv_s8_topc_stats.argtypes = [ctypes.c_void_p]
    return lib


def _cell_args(b: int):
    """``s8_topc``'s operands in the int8 cells: the collection of
    ``portbench/configs/cohere768-1m-int8.json`` built as the benchmark
    builds it (its vectors at seed 1, ``insert_batch`` in its chunks,
    ``enable_quantized_scan("int8")``), the snapshot's codes, rinv and
    validity mask at its 1,048,576 rows, and ``b`` of its queries folded as
    ``folded_int_topc`` folds them."""
    import json
    import torch
    from fastpyvectordb_tpu_torch import VectorDB
    from fastpyvectordb_tpu_torch.quant.scalar import _int8_rs_bias, \
        fold_queries
    from portbench import data
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "cohere768-1m-int8.json").read_text())
    rows, dims = cfg["rows"], cfg["dims"]
    corpus, centers = data.clustered(cfg["data"], rows, dims, 1, "cuda")
    host = corpus.cpu().numpy()
    del corpus
    col = VectorDB(None, device="cuda").create_collection(
        "cell", dims, **cfg["collection"])
    names, fill = data.ids(rows), cfg["fill"]["batch"]
    for s in range(0, rows, fill):
        col.insert_batch(host[s:s + fill], names[s:s + fill].tolist())
    scan = col.enable_quantized_scan("int8", tune=False)
    qz, codes = scan.quantizer, scan.codes
    _, rinv = scan._stats()
    mask = scan._valid(codes.shape[0])
    q = data.queries(cfg["data"], centers, b, 1, data.POOL)
    qi, qscale, const, qn = fold_queries(
        torch.as_tensor(q, device="cuda"), *_int8_rs_bias(qz.vmin, qz.scale),
        "cosine")
    return qi, codes, qscale, const, qn, rinv, mask


def time_topc(name: str, rnd: str) -> None:
    """Child: the variant ``name`` and the full kernel, in turns."""
    import torch
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8

    def ms(fn, reps=5):
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

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, n, d, c = 1024, 1 << 20, 768, 40
    qi = torch.randint(-127, 128, (b, d), generator=gen, device="cuda",
                       dtype=torch.int8)
    codes = torch.randint(-128, 128, (n, d), generator=gen, device="cuda",
                          dtype=torch.int8)
    qscale = torch.rand(b, generator=gen, device="cuda") * 1e-3 + 1e-4
    const = torch.randn(b, generator=gen, device="cuda")
    qn = torch.rand(b, generator=gen, device="cuda") * 10 + 1
    rinv = torch.rand(n, generator=gen, device="cuda") + 0.5
    mask = torch.rand(n, generator=gen, device="cuda") < 0.9
    args = (qi, codes, qscale, const, qn, rinv, mask)
    base, var = _load_s8("base"), _load_s8(name)

    def fused(lib, operands=args):
        def run():
            s8.SOURCE._lib = lib
            return s8.s8_topc(*operands, c=c, metric="cosine")
        return run

    def first(operands, k):
        """The same operands with only their first k queries."""
        qi_, codes_, qscale_, const_, qn_, rinv_, mask_ = operands
        return (qi_[:k], codes_, qscale_[:k], const_[:k], qn_[:k], rinv_,
                mask_)

    if name == "cell":
        cell = _cell_args(b)
        nc = cell[1].shape[0]
        t = [ms(fused(base, cell)), ms(fused(base, first(cell, 1)), reps=50)]
        print(f"round {rnd} cell         s8_topc on the int8 cells' operands "
              f"(1024 / 1 x {nc} x {d}, c = {c}): {t[0]:.4f} / {t[1]:.4f} ms",
              flush=True)
        return
    if name == "stats":
        # rows entered, compactions and scores past the floors, per block
        # and query, on random codes and the cells' operands, B=1024 and 1
        cell = _cell_args(b)
        for label, ops in (("random", args), ("cell", cell)):
            for k in (b, 1):
                one = ops if k == b else first(ops, k)
                nn = one[1].shape[0]
                s8.SOURCE._lib = var
                s8.s8_topc(*one, c=c, metric="cosine")
                got = (ctypes.c_ulonglong * 4)()
                var.fpv_s8_topc_stats(got)
                g = var.fpv_s8_topc_blocks(k, nn)
                # the scores of a tile's 256 query columns, padding included
                cols = 256 * -(-k // 256)
                print(f"round {rnd} stats {label} B={k}: "
                      f"{got[0] / (k * g):.1f} rows entered, "
                      f"{got[1] / (k * g):.2f} compactions, "
                      f"{got[2] / (k * g):.1f} scores past the floor a block "
                      f"and query (G = {g}); of the scores: past the floor "
                      f"{100.0 * got[2] / (k * nn):.3f}%, entered "
                      f"{100.0 * got[0] / (k * nn):.3f}%, tested in place "
                      f"(padding columns too) "
                      f"{100.0 * got[3] / (cols * nn):.3f}%", flush=True)
        return
    if name == "merge":
        lib = base
        g = lib.fpv_s8_topc_blocks(b, n)
        width = c + s8.TOPC_SLACK
        lists = torch.empty((b, g, width, 2), dtype=torch.int32,
                            device="cuda")
        vals = torch.empty((b, c), device="cuda")
        rows = torch.empty((b, c), dtype=torch.int64, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        qparams = torch.stack([qscale, const, qn, 1.0 / qn], dim=1)
        lib.fpv_s8_topc(s8.kernel_query(qi).data_ptr(), codes.data_ptr(),
                        qparams.data_ptr(), rinv.data_ptr(), mask.data_ptr(),
                        lists.data_ptr(), b, n, d,
                        s8.kernel_query(qi).shape[1], c, 0, stream)
        variant = lambda: lib.fpv_s8_topc_merge(  # noqa: E731
            lists.data_ptr(), vals.data_ptr(), rows.data_ptr(), b, g, width,
            c, stream)
    else:
        variant = fused(var)
    full = fused(base)
    old = lambda: s8._topc_from_scores(s8.folded_epilogue(  # noqa: E731
        s8.s8_scores(qi, codes), qscale, const, qn, rinv, "cosine"), mask, c)
    t_full, t_var = ms(full), ms(variant)
    t_var2, t_full2 = ms(variant), ms(full)
    line = (f"round {rnd} {name:12s} variant {t_var:.4f} / {t_var2:.4f} ms  "
            f"full s8_topc {t_full:.4f} / {t_full2:.4f} ms")
    if name == "base":
        line += f"  replaced route {ms(old, reps=3):.4f} ms"
    print(line, flush=True)


def main_topc(names) -> None:
    build_topc(names)
    for rnd in range(2):
        for name in names:
            try:
                subprocess.run([sys.executable, __file__, "topc-child", name,
                                str(rnd)], timeout=180, check=False)
            except subprocess.TimeoutExpired:
                print(f"round {rnd} {name}: timed out", flush=True)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "grouped-child":
        time_grouped(sys.argv[2:])
        return
    if len(sys.argv) == 4 and sys.argv[1] == "topc-child":
        time_topc(*sys.argv[2:])
        return
    if len(sys.argv) == 2 and sys.argv[1] == "grouped":
        main_grouped()
    elif sys.argv[1:2] == ["topc"]:
        main_topc([a for a in sys.argv[2:] if a in TOPC_VARIANTS]
                  or list(TOPC_VARIANTS))
    elif len(sys.argv) == 4 and sys.argv[2].isdigit():
        time_variant(*sys.argv[1:])
        return
    else:
        which = "s8" if sys.argv[1:2] == ["s8"] else "scan"
        names = [a for a in sys.argv[1:] if a in VARIANTS] or list(VARIANTS)
        scan_variants(which, names)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


def scan_variants(which: str, names) -> None:
    build(which, names)
    for rnd in range(2):
        for name in names:
            try:
                subprocess.run([sys.executable, __file__, name, str(rnd),
                                which],
                               timeout=120, check=False)
            except subprocess.TimeoutExpired:
                print(f"round {rnd} {name}: timed out", flush=True)


if __name__ == "__main__":
    main()
