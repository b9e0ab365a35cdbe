"""Grouped IVF cell-score kernels (port of
``fastpyvectordb_tpu/kernels/pallas_ivf.py`` ``grouped_cell_scores`` /
``grouped_cell_scores_i8`` / ``grouped_cell_scores_pq``).

Each entry has two versions:

  * the hand-written Hopper kernel in ``csrc/grouped_cell_scores.cu`` (B2,
    B3) or ``csrc/grouped_cell_scores_pq.cu`` (B7), built with ``nvcc`` at
    first use and bound with ``ctypes``.  B2 / B3 have two kernels in that
    source and the launcher picks by the operands alone: the TMA / wgmma
    cell stream where the row pitch ``D * itemsize`` and both bases are
    multiples of 16 bytes (what TMA can address), the first-slice wmma
    kernel for every other shape; never on a failure
    (``grouped_design`` reports which).  B7 builds its work list in an
    int32 scratch tensor the wrapper allocates, bounded by each cell's
    occupied extent (``last_pq_tiles`` reads how many row tiles it made);
  * a plain PyTorch version of the same math (``*_plain``): gather the
    compact cells, one batched product, the metric epilogue (B2, B3); a
    table lookup per subspace, summed in order (B7).

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
from ..profiling import annotate
from .cuda_build import CudaSource, I, P, current_stream
from .distances import MASKED
from .quant_kernels import METRIC_CODE, check_cuda

LAUNCHES = {"grouped_cell_scores": 0, "grouped_cell_scores_i8": 0,
            "grouped_cell_scores_pq": 0}

SOURCE = CudaSource("grouped_cell_scores", {
    "fpv_grouped_cell_scores": [P] * 7 + [I] * 5 + [P],
    "fpv_grouped_cell_scores_i8": [P] * 9 + [I] * 5 + [P],
    "fpv_grouped_design": [P, P, I, I],
})
SOURCE_PQ = CudaSource("grouped_cell_scores_pq", {
    "fpv_grouped_cell_scores_pq": [P] * 6 + [I] * 5 + [P, P, P],
    "fpv_grouped_cell_scores_pq_scratch": [I, I, I],
})
# the one design of B7 in csrc/grouped_cell_scores_pq.cu
PQ_DESIGN = "lane_per_slot_ring"
# bytes of gathered f32 tables per chunk of compact cells (plain B7)
_PQ_PLAIN_BYTES = 256 << 20
# the last B7 launch's four plan counters, left on the card, read only by
# ``last_pq_tiles``
_PQ_LAST = {"counters": None}

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
        stream = current_stream(cells.device)
        rc = getattr(lib, entry)(
            cell_ids.data_ptr(), qblk.data_ptr(), cells.data_ptr(),
            norms.data_ptr(), okf.data_ptr(),
            *(t.data_ptr() for _, t in extra), qstat.data_ptr(),
            out.data_ptr(), u, qcap, cmax, d, METRIC_CODE[metric], stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    LAUNCHES[counter] += 1
    return out


def grouped_design(qblk: torch.Tensor, cells: torch.Tensor) -> str:
    """Which B2 / B3 kernel these CUDA operands go to: ``"tma_wgmma"`` (the
    cell stream) or ``"first_slice"`` (row pitch or a base not a multiple of
    16 bytes).  The launcher's own test, asked of the built library."""
    new = SOURCE.load().fpv_grouped_design(
        qblk.data_ptr(), cells.data_ptr(), qblk.shape[-1],
        qblk.element_size())
    return "tma_wgmma" if new else "first_slice"


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
    with annotate("fpv.kernel.grouped_cell_scores"):
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
    with annotate("fpv.kernel.grouped_cell_scores_i8"):
        return _launch("fpv_grouped_cell_scores_i8",
                       "grouped_cell_scores_i8", cell_ids, qblk, cells,
                       norms, okf, (("sscale", sscale), ("sconst", sconst)),
                       qstat, metric, torch.int8)


def grouped_cell_scores_pq_plain(cell_ids, lut, qslot, codes_t, extent=None):
    """Plain ``grouped_cell_scores_pq``: for each chunk of compact cells,
    gather the slots' bf16 tables (empty slots, -1, read query 0) and add
    ``lut[q, m*K + codes_t[cell, m, c]]`` over m in order, in f32 — the
    order the kernel sums in.  Every row of cmax is summed: ``extent`` only
    bounds which rows the kernel writes."""
    u, qcap = qslot.shape
    m, cmax = codes_t.shape[1], codes_t.shape[2]
    kk = lut.shape[1] // m
    out = torch.empty((u, qcap, cmax), dtype=torch.float32,
                      device=codes_t.device)
    slots = torch.clamp(qslot, min=0).long()
    cells = cell_ids[1:1 + u].long()
    cu = max(1, _PQ_PLAIN_BYTES // max(qcap * m * kk * 4, 1))
    for s in range(0, u, cu):
        sl = slots[s:s + cu]
        n = sl.shape[0]
        lutq = lut[sl.reshape(-1)].float().reshape(n, qcap, m * kk)
        codes = codes_t[cells[s:s + cu]].long()          # (n, M, cmax)
        acc = torch.zeros((n, qcap, cmax), dtype=torch.float32,
                          device=codes_t.device)
        for j in range(m):
            idx = codes[:, j:j + 1, :].expand(n, qcap, cmax)
            acc += torch.gather(lutq[:, :, j * kk:(j + 1) * kk], 2, idx)
        out[s:s + cu] = acc
    return out


def grouped_cell_scores_pq(cell_ids: torch.Tensor, lut: torch.Tensor,
                           qslot: torch.Tensor, codes_t: torch.Tensor,
                           extent: torch.Tensor) -> torch.Tensor:
    """(U+1,) i32 compact cell list, (B, M*K) bf16 per-query ADC tables,
    (U, qcap) slot table (query id, -1 = empty), (nlist, M, cmax) uint8
    transposed cell codes, (nlist,) i32 cell extents -> (U, qcap, cmax) f32
    ADC sums.  A cell's extent is its occupied prefix, the index of its
    last live row + 1 (``ann/ivfpq.py:cell_extents``).  Rows past
    ``cell_ids[0]``, empty slots and cell rows at or past the cell's extent
    are unspecified: the CUDA kernel leaves them unwritten, so a caller
    masks every row past a cell's last live one (the regroup's ``rok``).
    Any shape, K <= 256.  The CUDA kernel sizes its slot tiles to each
    row's load and its row tiles to each cell's extent; it is fastest where
    a row's live slots are a prefix, as ``invert_pairs`` fills them, and a
    hole is skipped all the same."""
    if codes_t.device.type == "cpu":
        return grouped_cell_scores_pq_plain(cell_ids, lut, qslot, codes_t)
    with annotate("fpv.kernel.grouped_cell_scores_pq"):
        u, qcap = qslot.shape
        nlist, m, cmax = codes_t.shape
        b, mk = lut.shape
        if mk % m:
            raise ValueError(f"lut width {mk} is not a multiple of M={m}")
        check_cuda("codes_t", torch.uint8, codes_t, (nlist, m, cmax))
        check_cuda("lut", torch.bfloat16, lut, (b, mk))
        check_cuda("qslot", torch.int32, qslot, (u, qcap))
        check_cuda("cell_ids", torch.int32, cell_ids, (u + 1,))
        check_cuda("extent", torch.int32, extent, (nlist,))
        for t in (lut, qslot, cell_ids, extent):
            if t.device != codes_t.device:
                raise ValueError("grouped_cell_scores_pq: operands on "
                                 "different devices")
        out = torch.empty((u, qcap, cmax), dtype=torch.float32,
                          device=codes_t.device)
        lib = SOURCE_PQ.load()
        # the kernel's work list lives in scratch, its counters apart (kept
        # after the call for ``last_pq_tiles``)
        ints = lib.fpv_grouped_cell_scores_pq_scratch(u, qcap, cmax)
        if ints < 0:
            raise ValueError("grouped_cell_scores_pq: too many tiles for "
                             f"U={u} qcap={qcap} cmax={cmax}")
        scratch = torch.empty(ints, dtype=torch.int32, device=codes_t.device)
        counters = torch.empty(4, dtype=torch.int32, device=codes_t.device)
        with torch.cuda.device(codes_t.device):
            stream = current_stream(codes_t.device)
            rc = lib.fpv_grouped_cell_scores_pq(
                cell_ids.data_ptr(), lut.data_ptr(), qslot.data_ptr(),
                codes_t.data_ptr(), extent.data_ptr(), out.data_ptr(), u,
                qcap, cmax, m, mk // m, counters.data_ptr(),
                scratch.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"grouped_cell_scores_pq launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES["grouped_cell_scores_pq"] += 1
        _PQ_LAST["counters"] = counters
        return out


def last_pq_tiles():
    """(row tiles, row tiles over all of cmax) of the last
    ``grouped_cell_scores_pq`` launch: the tiles its plan made from the
    cells' extents, and those a plan over every row of cmax would have
    made for the same slot table.  None before any launch (plain calls do
    not count).  Reading waits for the card."""
    counters = _PQ_LAST["counters"]
    if counters is None:
        return None
    made, _, full, _ = counters.tolist()
    return made, full
