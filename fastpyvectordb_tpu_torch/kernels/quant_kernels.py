"""Quantized-scan kernels (port of ``fastpyvectordb_tpu/kernels/pallas_quant.py``
``sq_scores`` / ``int4_scores``).

Each entry has two versions:

  * the hand-written Hopper kernel in ``csrc/quant_scores.cu``, built with
    ``nvcc`` at first use and bound with ``ctypes``;
  * a plain PyTorch version of the same math (``*_plain``).

The wrapper takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches the kernel or raises — a failed build, a refused
launch or a missing toolkit is an error, never a silent fallback.
``LAUNCHES`` counts kernel launches (plain calls do not count).

Unlike the Pallas callers, neither B nor N is padded and the codes are
read as they are: the CUDA kernel masks its own ragged B and N edges, so
the TPU's 8/128/1024 padding helpers (``Int4Quantizer.pallas_layout`` /
``pallas_query``) are not ported.  What the wrapper does make, once per
call, are two small tables in the kernel's dimension order
(``kernel_dims``): the bf16 query copy that the kernel loads with TMA
(``kernel_query``, zero past the true width) and the (rscale, vmin) pairs
(``kernel_scales``).
"""

from __future__ import annotations

import functools

import torch

from ..core.types import DistanceMetric
from ..profiling import annotate
from .cuda_build import CudaSource, I, P, current_stream

LAUNCHES = {"sq_scores": 0, "int4_scores": 0}

METRIC_CODE = {DistanceMetric.COSINE: 0, DistanceMetric.L2: 1,
               DistanceMetric.DOT: 2}
KSTEP = 64          # bf16 dims in one K step of the kernel (128 bytes)
_ARGS = [P] * 5 + [I] * 5 + [P]
SOURCE = CudaSource("quant_scores", {"fpv_sq_scores": _ARGS,
                                     "fpv_int4_scores": _ARGS})


def _prep_queries(queries: torch.Tensor, metric: DistanceMetric):
    """(q_in, qsq): cosine queries normalised, L2 squared norms, as in
    pallas_quant.py's wrappers (qsq is zeros where unused)."""
    q = queries.float()
    if metric == DistanceMetric.COSINE:
        qn = q / torch.clamp(torch.linalg.norm(q, dim=1, keepdim=True),
                             min=1e-30)
        return qn, torch.zeros((q.shape[0],), device=q.device)
    if metric == DistanceMetric.L2:
        return q, (q * q).sum(dim=1)
    return q, torch.zeros((q.shape[0],), device=q.device)


def _epilogue(cross, v, qsq, metric):
    if metric == DistanceMetric.COSINE:
        rinv = torch.rsqrt(torch.clamp((v * v).sum(dim=1), min=1e-30))
        return 1.0 - cross * rinv[None, :]
    if metric == DistanceMetric.L2:
        vsq = (v * v).sum(dim=1)
        return torch.clamp(qsq[:, None] + vsq[None, :] - 2.0 * cross,
                           min=0.0)
    return -cross


def _bf16_cross(q_in, v):
    # bf16 operands, f32 products and sums: upcast AFTER rounding, because
    # torch.matmul of bf16 tensors would return bf16-rounded scores
    return q_in.bfloat16().float() @ v.bfloat16().float().T


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(N, W) halves-packed uint8 -> (N, 2W) uint8 codes in [0, 15]."""
    return torch.cat([packed & 0xF, packed >> 4], dim=1)


def sq_scores_plain(queries, codes, vmin, scale, *, metric):
    """Plain PyTorch ``sq_scores``: (B, D) f32 x (N, D) int8 -> (B, N)."""
    metric = DistanceMetric.parse(metric)
    q_in, qsq = _prep_queries(queries, metric)
    v = (codes.float() + 128.0) * (scale / 255.0)[None, :] + vmin[None, :]
    return _epilogue(_bf16_cross(q_in, v), v, qsq, metric)


def int4_scores_plain(queries, packed, vmin, scale, *, metric):
    """Plain PyTorch ``int4_scores``: (B, 2W) f32 x (N, W) packed uint8
    (halves layout) -> (B, N)."""
    metric = DistanceMetric.parse(metric)
    q_in, qsq = _prep_queries(queries, metric)
    v = (unpack_int4(packed).float() * (scale / 15.0)[None, :]
         + vmin[None, :])
    return _epilogue(_bf16_cross(q_in, v), v, qsq, metric)


def check_cuda(name, dtype, t, shape):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


@functools.lru_cache(maxsize=64)
def kernel_dims(kind: str, width: int, device: str = "cpu") -> torch.Tensor:
    """The true dim that each K position of the kernel reads, -1 where it
    is zero padding; the length is a multiple of ``KSTEP``.

    int8 (``width`` = D): the natural order.  int4 (``width`` = W, the
    packed row): K step j reads code bytes 32j .. 32j + 31, and position
    64j + 2i + h is nibble h of byte 32j + i, dim 32j + i + h * W (the
    halves layout's two dims of one byte sit side by side)."""
    if kind == "int8":
        d = torch.arange(-(-width // KSTEP) * KSTEP)
        return torch.where(d < width, d, -1).to(device)
    byte = torch.arange(-(-width // 32) * 32)[:, None]
    dims = byte + torch.arange(2)[None, :] * width
    return torch.where(byte < width, dims, -1).reshape(-1).to(device)


def kernel_query(q_in: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    """(B, Kp) bf16 copy of the prepared queries in the kernel's order,
    zero where ``dims`` is -1: the operand the kernel loads with TMA."""
    q = q_in.float()[:, dims.clamp(min=0)]
    return torch.where(dims[None, :] >= 0, q, 0.0).bfloat16().contiguous()


def kernel_scales(rscale: torch.Tensor, vmin: torch.Tensor,
                  dims: torch.Tensor) -> torch.Tensor:
    """(Kp, 2) f32 (rscale, vmin) per K position, zero at padding (so a
    padding position dequantises to 0)."""
    sv = torch.stack([rscale.float(), vmin.float()], dim=1)[dims.clamp(min=0)]
    return torch.where(dims[:, None] >= 0, sv, 0.0).contiguous()


def _launch(entry, counter, kind, q_in, qsq, codes, vmin, rscale, width,
            metric):
    b, de = q_in.shape
    n = codes.shape[0]
    for name, t in (("vmin", vmin), ("rscale", rscale)):
        check_cuda(name, torch.float32, t.float().contiguous(), (de,))
    check_cuda("qsq", torch.float32, qsq, (b,))
    if q_in.device != codes.device:
        raise ValueError("queries and codes are on different devices")
    dims = kernel_dims(kind, width, str(codes.device))
    qk = kernel_query(q_in, dims)
    sv = kernel_scales(rscale, vmin, dims)
    out = torch.empty((b, n), dtype=torch.float32, device=codes.device)
    lib = SOURCE.load()
    with torch.cuda.device(codes.device):
        stream = current_stream(codes.device)
        rc = getattr(lib, entry)(
            qk.data_ptr(), codes.data_ptr(), sv.data_ptr(), qsq.data_ptr(),
            out.data_ptr(), b, n, width, dims.numel(), METRIC_CODE[metric],
            stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    LAUNCHES[counter] += 1
    return out


def sq_scores(queries: torch.Tensor, codes: torch.Tensor, vmin: torch.Tensor,
              scale: torch.Tensor, *, metric) -> torch.Tensor:
    """(B, D) f32 x (N, D) int8 -> (B, N) f32 scores (lower = closer).
    Any B, N, D: no padding needed."""
    metric = DistanceMetric.parse(metric)
    if codes.device.type == "cpu":
        return sq_scores_plain(queries, codes, vmin, scale, metric=metric)
    with annotate("fpv.kernel.sq_scores"):
        n, d = codes.shape
        check_cuda("codes", torch.int8, codes, (n, d))
        q_in, qsq = _prep_queries(queries, metric)
        check_cuda("queries", torch.float32, q_in.contiguous(),
                   (q_in.shape[0], d))
        return _launch("fpv_sq_scores", "sq_scores", "int8", q_in, qsq,
                       codes, vmin, scale.float() / 255.0, d, metric)


def int4_scores(queries: torch.Tensor, packed: torch.Tensor,
                vmin: torch.Tensor, scale: torch.Tensor, *,
                metric) -> torch.Tensor:
    """(B, 2W) f32 x (N, W) halves-packed uint8 -> (B, N) f32 scores.
    vmin/scale span the 2W unpacked dims.  Any B, N, W."""
    metric = DistanceMetric.parse(metric)
    if packed.device.type == "cpu":
        return int4_scores_plain(queries, packed, vmin, scale, metric=metric)
    with annotate("fpv.kernel.int4_scores"):
        n, w = packed.shape
        check_cuda("packed", torch.uint8, packed, (n, w))
        q_in, qsq = _prep_queries(queries, metric)
        check_cuda("queries", torch.float32, q_in.contiguous(),
                   (q_in.shape[0], 2 * w))
        return _launch("fpv_int4_scores", "int4_scores", "int4", q_in, qsq,
                       packed, vmin, scale.float() / 15.0, w, metric)
