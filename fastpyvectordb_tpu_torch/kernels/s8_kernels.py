"""Exact int8 corpus scans (port of ``benchmarks/int8_mxu_lab.py``
``pallas_s8`` / ``pallas_s8_tn``): (B, D) int8 x int8 corpus -> (B, N) int32
inner products; and the fused int8 coarse scan ``s8_topc`` (B8's redesign),
which turns those products into the folded int8 scores, masks them and
keeps each query's c smallest, so that no (B, N) block is written.

Each entry has two versions:

  * the hand-written Hopper kernel in ``csrc/s8_scores.cu`` (one templated
    wgmma scan with an entry for row-major (N, D) codes, one for
    transposed (D, N) codes and one whose epilogue keeps a running top-c,
    ``csrc/topc_epilogue.cuh``, with its merge pass), built with ``nvcc``
    at first use and bound with ``ctypes``;
  * a plain PyTorch version of the same function (``*_plain``: an int32
    matmul; for ``s8_topc`` that product, the folded epilogue of
    ``folded_epilogue``, ``masked_fill`` and ``torch.topk``).

The TPU kernels' grid (N a multiple of the corpus tile) is not ported: the
CUDA kernel takes any B, N and D and masks its own ragged edges.  What the
wrapper makes, once per call, is the query copy the kernel loads with TMA
(``kernel_query``: zero past D, the width a multiple of ``KSTEP``).

The wrapper takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches the kernel or raises; nothing falls back.
``LAUNCHES`` counts kernel launches (plain calls do not count).
``s8_topc`` takes c up to ``TOPC_MAX``; above it, chosen by shape before
any launch, it scores the block with ``s8_scores`` and selects in PyTorch
(counted as ``s8_topc_wide``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.types import DistanceMetric
from .cuda_build import CudaSource, I, P
from .distances import MASKED, smallest_k
from .quant_kernels import check_cuda

LAUNCHES = {"s8_scores": 0, "s8_scores_tn": 0, "s8_topc": 0,
            "s8_topc_wide": 0}

KSTEP = 128         # int8 positions in one K step of the kernel
TOPC_MAX = 1024     # the largest c of the fused scan (csrc/topc_epilogue.cuh)
TOPC_SLACK = 256    # a list's room past c (the same header)
_METRIC_ID = {DistanceMetric.COSINE: 0, DistanceMetric.L2: 1,
              DistanceMetric.DOT: 2}
_ARGS = [P] * 3 + [I] * 4 + [P]
SOURCE = CudaSource("s8_scores", {
    "fpv_s8_scores": _ARGS, "fpv_s8_scores_tn": _ARGS,
    "fpv_s8_topc": [P] * 6 + [I] * 6 + [P],
    "fpv_s8_topc_blocks": [I, I],
    "fpv_s8_topc_merge": [P] * 3 + [I] * 4 + [P]})


_PLAIN_ROWS = 65_536     # corpus rows per float64 block of the plain version


def _int_matmul(qi: torch.Tensor, blocks) -> torch.Tensor:
    """``qi`` times each of the (D, rows) int8 ``blocks``, side by side, as
    int32.  The CPU multiplies in int32.  torch has no integer
    matmul on CUDA: there the product runs in float64, block by block,
    which is exact too (|q c| <= 2^14, so any sum of fewer than 2^39 terms
    is an exactly represented integer)."""
    return torch.cat([(qi.to(torch.int32) @ blk.to(torch.int32))
                      if qi.device.type == "cpu"
                      else (qi.double() @ blk.double()).to(torch.int32)
                      for blk in blocks], dim=1)


def s8_scores_plain(qi: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Plain ``s8_scores``: (B, D) int8 x (N, D) int8 -> (B, N) int32."""
    return _int_matmul(qi, (codes[s:s + _PLAIN_ROWS].T
                            for s in range(0, codes.shape[0], _PLAIN_ROWS)))


def s8_scores_tn_plain(qi: torch.Tensor, codes_t: torch.Tensor
                       ) -> torch.Tensor:
    """Plain ``s8_scores_tn``: (B, D) int8 x (D, N) int8 -> (B, N) int32."""
    return _int_matmul(qi, (codes_t[:, s:s + _PLAIN_ROWS]
                            for s in range(0, codes_t.shape[1], _PLAIN_ROWS)))


def kernel_query(qi: torch.Tensor) -> torch.Tensor:
    """(B, Kp) int8 copy of the queries, zero past D, Kp the next multiple
    of ``KSTEP``, contiguous and 16-byte aligned: the operand the kernel
    loads with TMA.  Queries that already have that form pass through."""
    q = torch.nn.functional.pad(qi, (0, -qi.shape[1] % KSTEP)).contiguous()
    return q.clone() if q.data_ptr() % 16 else q


def _launch(entry: str, qi: torch.Tensor, codes: torch.Tensor, n: int,
            d: int) -> torch.Tensor:
    check_cuda("queries", torch.int8, qi, (qi.shape[0], d))
    if qi.device != codes.device:
        raise ValueError(f"{entry}: operands on different devices")
    b = qi.shape[0]
    qk = kernel_query(qi)
    out = torch.empty((b, n), dtype=torch.int32, device=codes.device)
    lib = SOURCE.load()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, "fpv_" + entry)(
            qk.data_ptr(), codes.data_ptr(), out.data_ptr(), b, n, d,
            qk.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    LAUNCHES[entry] += 1
    return out


def s8_scores(qi: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(B, D) int8 x (N, D) int8 -> (B, N) int32 exact inner products.
    Any B, N, D."""
    if codes.device.type == "cpu":
        return s8_scores_plain(qi, codes)
    n, d = codes.shape
    check_cuda("codes", torch.int8, codes, (n, d))
    return _launch("s8_scores", qi, codes, n, d)


def s8_scores_tn(qi: torch.Tensor, codes_t: torch.Tensor) -> torch.Tensor:
    """(B, D) int8 x (D, N) int8 (the corpus stored transposed) -> (B, N)
    int32 exact inner products.  Any B, N, D."""
    if codes_t.device.type == "cpu":
        return s8_scores_tn_plain(qi, codes_t)
    d, n = codes_t.shape
    check_cuda("codes_t", torch.int8, codes_t, (d, n))
    return _launch("s8_scores_tn", qi, codes_t, n, d)


# The PyTorch calls that B8's and B9's kernels are timed against
# (``chip_smoke.py``, ``tools/kernel_ab.py``, ``tools/kernel_variants.py``);
# no path of the package calls them.  B9's is on its own (D, N) operands,
# or the nearest call where cuBLASLt refuses that layout; B9's two-pass
# yardstick is the transposing copy and ``s8_scores`` on it.
S8_LIBRARY = "torch._int_mm(q_int8, codes.T)"
S8_TN_LIBRARY = "torch._int_mm(q_int8, codes_t)"
S8_TN_NEAREST = ("torch._int_mm(q_int8, codes_t.t().contiguous().t()), the "
                 "transposing copy included")
S8_TWO_PASS = "codes_t.t().contiguous() + s8_scores"


def s8_tn_library(qi: torch.Tensor, codes_t: torch.Tensor):
    """B9's library call on its own operands: ``torch._int_mm`` on the
    contiguous (D, N) codes or, where that layout is refused (cuBLASLt
    refuses it at some shapes), the nearest call: the transposing copy,
    then ``torch._int_mm`` on its (D, N) view.  Returns (the call, its
    label, the refusal's first line or None)."""
    try:
        torch._int_mm(qi, codes_t)
        if qi.is_cuda:
            torch.cuda.synchronize()
        return (lambda: torch._int_mm(qi, codes_t)), S8_TN_LIBRARY, None
    except RuntimeError as err:
        return (lambda: torch._int_mm(qi, codes_t.t().contiguous().t()),
                S8_TN_NEAREST, str(err).splitlines()[0])


def folded_epilogue(cross: torch.Tensor, qscale: torch.Tensor,
                    const: torch.Tensor, qstat: Optional[torch.Tensor],
                    rstat: Optional[torch.Tensor], metric) -> torch.Tensor:
    """(B, N) int32 products of the folded int8 queries -> f32 scores, in
    PyTorch passes over the block (updated in place):
        x = f32(cross) * qscale + const             (q . dequant(c))
        cosine: 1 - (x / qn) * rinv;  l2: max(qsq + vsq - 2x, 0);  dot: -x
    ``qstat`` is qn (cosine) or qsq (l2), ``rstat`` rinv or vsq, (B,) and
    (N,); dot uses neither.  The fused kernel rounds where these passes
    round."""
    metric = DistanceMetric.parse(metric)
    x = cross.float().mul_(qscale[:, None]).add_(const[:, None])
    if metric == DistanceMetric.COSINE:
        return x.div_(qstat[:, None]).mul_(rstat[None, :]).neg_().add_(1.0)
    if metric == DistanceMetric.L2:
        d2 = qstat[:, None] + rstat[None, :]
        return d2.sub_(x.mul_(2.0)).clamp_(min=0.0)
    return x.neg_()


def _topc_from_scores(s: torch.Tensor, mask: Optional[torch.Tensor], c: int):
    if mask is not None:
        s = s.masked_fill_(~mask[None, :], float(MASKED))
    return smallest_k(s, c)


def s8_topc_plain(qi, codes, qscale, const, qstat, rstat, mask, *, c: int,
                  metric):
    """Plain ``s8_topc``: the integer product, ``folded_epilogue``, masked
    rows to ``MASKED``, ``torch.topk``.  Returns (vals (B, c) f32 ascending,
    rows (B, c) int64)."""
    s = folded_epilogue(s8_scores_plain(qi, codes), qscale, const, qstat,
                        rstat, metric)
    return _topc_from_scores(s, mask, c)


def s8_topc(qi: torch.Tensor, codes: torch.Tensor, qscale: torch.Tensor,
            const: torch.Tensor, qstat: Optional[torch.Tensor],
            rstat: Optional[torch.Tensor], mask: Optional[torch.Tensor], *,
            c: int, metric):
    """The c smallest folded int8 scores of each query over the (N, D)
    int8 corpus, rows where ``mask`` is False scored ``MASKED``: (vals
    (B, c) f32 ascending, rows (B, c) int64), the function of
    ``s8_topc_plain``; values bit for bit, rows up to ties.  Arguments as
    ``folded_epilogue``'s, ``qi`` the (B, D) folded int8 queries; 1 <= c
    <= N."""
    metric = DistanceMetric.parse(metric)
    if codes.device.type == "cpu":
        return s8_topc_plain(qi, codes, qscale, const, qstat, rstat, mask,
                             c=c, metric=metric)
    n, d = codes.shape
    b = qi.shape[0]
    check_cuda("codes", torch.int8, codes, (n, d))
    check_cuda("queries", torch.int8, qi, (b, d))
    check_cuda("qscale", torch.float32, qscale, (b,))
    check_cuda("const", torch.float32, const, (b,))
    if metric != DistanceMetric.DOT:
        check_cuda("qstat", torch.float32, qstat, (b,))
        check_cuda("rstat", torch.float32, rstat, (n,))
    if mask is not None:
        check_cuda("mask", torch.bool, mask, (n,))
    if not 1 <= c <= n:
        raise ValueError(f"s8_topc: c={c} outside 1..N={n}")
    if c > TOPC_MAX:
        # by shape: the fused kernel's lists hold at most TOPC_MAX
        LAUNCHES["s8_topc_wide"] += 1
        return _topc_from_scores(
            folded_epilogue(s8_scores(qi, codes), qscale, const, qstat,
                            rstat, metric), mask, c)
    if b == 0:
        return (torch.empty((0, c), dtype=torch.float32, device=codes.device),
                torch.empty((0, c), dtype=torch.int64, device=codes.device))
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=codes.device)
    if metric == DistanceMetric.DOT:
        qstat, rstat = torch.zeros_like(qscale), qscale   # read by neither
    # per query (qscale, const, qstat, RN(1 / qstat)): the kernel divides
    # by qn with FMAs from its correctly rounded reciprocal
    qparams = torch.stack([qscale, const, qstat, 1.0 / qstat], dim=1)
    qk = kernel_query(qi)
    lib = SOURCE.load()
    with torch.cuda.device(codes.device):
        g = lib.fpv_s8_topc_blocks(b, n)
        width = c + TOPC_SLACK
        lists = torch.empty((b, g, width, 2), dtype=torch.int32,
                            device=codes.device)
        vals = torch.empty((b, c), dtype=torch.float32, device=codes.device)
        rows = torch.empty((b, c), dtype=torch.int64, device=codes.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fpv_s8_topc(
            qk.data_ptr(), codes.data_ptr(), qparams.data_ptr(),
            rstat.data_ptr(), mask.data_ptr(), lists.data_ptr(), b, n, d,
            qk.shape[1], c, _METRIC_ID[metric], stream)
        if rc == 0:
            rc = lib.fpv_s8_topc_merge(lists.data_ptr(), vals.data_ptr(),
                                       rows.data_ptr(), b, g, width, c,
                                       stream)
    if rc != 0:
        raise RuntimeError(f"s8_topc launch failed: CUDA error {rc}")
    LAUNCHES["s8_topc"] += 1
    return vals, rows
