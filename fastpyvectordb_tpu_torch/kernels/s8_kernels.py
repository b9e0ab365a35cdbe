"""Exact int8 corpus scans (port of ``benchmarks/int8_mxu_lab.py``
``pallas_s8`` / ``pallas_s8_tn``): (B, D) int8 x int8 corpus -> (B, N) int32
inner products, the product under the int8 two-stage scan.

Each entry has two versions:

  * the hand-written Hopper kernel in ``csrc/s8_scores.cu`` (one templated
    wgmma scan with an entry for row-major (N, D) codes and one for
    transposed (D, N) codes), built with ``nvcc`` at first use and bound
    with ``ctypes``;
  * a plain PyTorch version of the same product (``*_plain``: an int32
    matmul).

The TPU kernels' grid (N a multiple of the corpus tile) is not ported: the
CUDA kernel takes any B, N and D and masks its own ragged edges.  What the
wrapper makes, once per call, is the query copy the kernel loads with TMA
(``kernel_query``: zero past D, the width a multiple of ``KSTEP``).

The wrapper takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches the kernel or raises; nothing falls back.
``LAUNCHES`` counts kernel launches (plain calls do not count).
"""

from __future__ import annotations

import torch

from .cuda_build import CudaSource, I, P
from .quant_kernels import check_cuda

LAUNCHES = {"s8_scores": 0, "s8_scores_tn": 0}

KSTEP = 128         # int8 positions in one K step of the kernel
_ARGS = [P] * 3 + [I] * 4 + [P]
SOURCE = CudaSource("s8_scores", {"fpv_s8_scores": _ARGS,
                                  "fpv_s8_scores_tn": _ARGS})


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
