"""Grouped IVF cell-score kernels (port of
``fastpyvectordb_tpu/kernels/pallas_ivf.py`` ``grouped_cell_scores`` /
``grouped_cell_scores_i8``).

Each entry has two versions:

  * the hand-written Hopper kernel in ``csrc/grouped_cell_scores.cu``, built
    with ``nvcc`` at first use and bound with ``ctypes``;
  * a plain PyTorch version of the same math (``*_plain``): gather the
    compact cells, one batched product, the metric epilogue.

Both take the compact layout of ``ann/ivf_grouped.py:invert_pairs``:
``cell_ids`` is ``[n_uniq, compact -> cell ids...]`` (U + 1 entries) and the
output is (U, qcap, cmax) f32; rows u >= n_uniq are unspecified in both
versions (the CUDA kernel leaves them unwritten).

The wrapper takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches the kernel or raises; nothing falls back.
``LAUNCHES`` counts kernel launches (plain calls do not count).  f32 cells
never reach the kernels: ``ann/ivf_grouped.py`` sends them through the plain
batched product, as the JAX package sends them through XLA.
"""

from __future__ import annotations

import torch

from ..core.types import DistanceMetric
from .cuda_build import CudaSource, I, P
from .distances import MASKED
from .quant_kernels import METRIC_CODE, check_cuda

LAUNCHES = {"grouped_cell_scores": 0, "grouped_cell_scores_i8": 0}

SOURCE = CudaSource("grouped_cell_scores", {
    "fpv_grouped_cell_scores": [P] * 7 + [I] * 5 + [P],
    "fpv_grouped_cell_scores_i8": [P] * 9 + [I] * 5 + [P],
})

# torch >= 2.8 has an f32-output bf16 batched product on CUDA
_BMM_OUT_DTYPE = "dtype" in torch.ops.aten.bmm.overloads()


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(U, M, D) x (U, N, D) -> (U, M, N) float32, never rounded to bf16:
    an f32-output product of bf16 operands on CUDA, an upcast of the
    (already rounded) operands otherwise."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b.transpose(1, 2))
    if a.is_cuda and _BMM_OUT_DTYPE and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b.transpose(1, 2), out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float().transpose(1, 2))


def _epilogue(cross, norms, okf, qstat, metric):
    """cross (U, qcap, cmax) -> masked metric scores; norms / okf
    (U, cmax) of the compact cells, qstat (U, qcap) (cosine 1/||q||, l2
    ||q||^2, dot unused).  ``pallas_ivf.py:_epilogue`` per slot."""
    if metric == DistanceMetric.COSINE:
        rinv = torch.rsqrt(torch.clamp(norms, min=1e-30))
        s = 1.0 - cross * qstat[:, :, None] * rinv[:, None, :]
    elif metric == DistanceMetric.L2:
        s = torch.clamp(qstat[:, :, None] + norms[:, None, :] - 2.0 * cross,
                        min=0.0)
    else:
        s = -cross
    return torch.where(okf[:, None, :] > 0.5, s,
                       torch.full((), float(MASKED), device=s.device))


def _compact(cell_ids, u, *tables):
    ids = cell_ids[1:1 + u].long()
    return [t[ids] for t in tables]


def grouped_cell_scores_plain(cell_ids, qblk, cells, norms, okf, qstat, *,
                              metric):
    """Plain ``grouped_cell_scores``: (U, qcap, D) bf16 (or f32) slots x the
    compact cells of (nlist, cmax, D) -> (U, qcap, cmax) f32.  The products
    of the (bf16) operands are summed in f32."""
    metric = DistanceMetric.parse(metric)
    c, n, ok = _compact(cell_ids, qblk.shape[0], cells, norms, okf)
    return _epilogue(bmm_f32(qblk, c), n, ok, qstat, metric)


def grouped_cell_scores_i8_plain(cell_ids, qblk, cells, norms, okf, sscale,
                                 sconst, qstat, *, metric):
    """Plain ``grouped_cell_scores_i8``: int8 slots x int8 compact cells.
    The integer product runs as an f32 product of the int8 values, which
    is exact: |sum| <= D * 127^2 < 2^24 for D <= 1040."""
    metric = DistanceMetric.parse(metric)
    c, n, ok = _compact(cell_ids, qblk.shape[0], cells, norms, okf)
    cross_i = torch.bmm(qblk.float(), c.float().transpose(1, 2))
    cross = cross_i * sscale[:, :, None] + sconst[:, :, None]
    return _epilogue(cross, n, ok, qstat, metric)


def _launch(entry, counter, cell_ids, qblk, cells, norms, okf, extra, qstat,
            metric, dtype):
    u, qcap, d = qblk.shape
    nlist, cmax = cells.shape[0], cells.shape[1]
    check_cuda("cells", dtype, cells, (nlist, cmax, d))
    check_cuda("qblk", dtype, qblk, (u, qcap, d))
    check_cuda("cell_ids", torch.int32, cell_ids, (u + 1,))
    for name, t in (("norms", norms), ("okf", okf)):
        check_cuda(name, torch.float32, t, (nlist, cmax))
    for name, t in (*extra, ("qstat", qstat)):
        check_cuda(name, torch.float32, t, (u, qcap))
    for t in (qblk, cell_ids, norms, okf, qstat, *(t for _, t in extra)):
        if t.device != cells.device:
            raise ValueError(f"{entry}: operands on different devices")
    out = torch.empty((u, qcap, cmax), dtype=torch.float32,
                      device=cells.device)
    lib = SOURCE.load()
    with torch.cuda.device(cells.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            cell_ids.data_ptr(), qblk.data_ptr(), cells.data_ptr(),
            norms.data_ptr(), okf.data_ptr(),
            *(t.data_ptr() for _, t in extra), qstat.data_ptr(),
            out.data_ptr(), u, qcap, cmax, d, METRIC_CODE[metric], stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    LAUNCHES[counter] += 1
    return out


def grouped_cell_scores(cell_ids: torch.Tensor, qblk: torch.Tensor,
                        cells: torch.Tensor, norms: torch.Tensor,
                        okf: torch.Tensor, qstat: torch.Tensor, *,
                        metric) -> torch.Tensor:
    """(U+1,) i32 compact cell list, (U, qcap, D) bf16 slots, (nlist, cmax,
    D) bf16 cells, (nlist, cmax) f32 norms and liveness, (U, qcap) f32
    qstat -> (U, qcap, cmax) f32 scores (lower = closer).  Any shape."""
    metric = DistanceMetric.parse(metric)
    if cells.device.type == "cpu":
        return grouped_cell_scores_plain(cell_ids, qblk, cells, norms, okf,
                                         qstat, metric=metric)
    return _launch("fpv_grouped_cell_scores", "grouped_cell_scores",
                   cell_ids, qblk, cells, norms, okf, (), qstat, metric,
                   torch.bfloat16)


def grouped_cell_scores_i8(cell_ids: torch.Tensor, qblk: torch.Tensor,
                           cells: torch.Tensor, norms: torch.Tensor,
                           okf: torch.Tensor, sscale: torch.Tensor,
                           sconst: torch.Tensor, qstat: torch.Tensor, *,
                           metric) -> torch.Tensor:
    """As ``grouped_cell_scores`` with int8 slots and cells and per-slot
    ``sscale`` / ``sconst`` (U, qcap) f32:
    cross = float(cross_i) * sscale + sconst, then the same epilogue."""
    metric = DistanceMetric.parse(metric)
    if cells.device.type == "cpu":
        return grouped_cell_scores_i8_plain(cell_ids, qblk, cells, norms, okf,
                                            sscale, sconst, qstat,
                                            metric=metric)
    return _launch("fpv_grouped_cell_scores_i8", "grouped_cell_scores_i8",
                   cell_ids, qblk, cells, norms, okf,
                   (("sscale", sscale), ("sconst", sconst)), qstat, metric,
                   torch.int8)
