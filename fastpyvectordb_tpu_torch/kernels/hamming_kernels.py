"""Packed-bit Hamming kernels (port of
``fastpyvectordb_tpu/kernels/pallas_quant.py`` ``hamming_mxu_scores`` /
``hamming_scores``).

Each entry has two versions:

  * the hand-written Hopper kernel in ``csrc/hamming_scores.cu`` (the
    count as an exact +-1 int8 tensor-core product, one templated kernel
    with an f32 and an int32 entry), built with ``nvcc`` at first use and
    bound with ``ctypes``;
  * a plain PyTorch version of the same count (``*_plain``).

Both take the codes as the snapshot keeps them: row-major (N, W) packed
32-bit words in a ``torch.int32`` tensor (the same bits as the JAX
package's uint32; torch's uint32 lacks shifts on the CPU), and the queries
as packed (B, W) words.  The TPU kernels' word-major transposed copies and
their 8 / 1024 / 2048 padding are not ported: the CUDA kernel reads the
row-major codes and masks its own ragged B and N.  Both entries take packed
query words, not the TPU kernel's +-1 bf16 block: the wrapper expands them
once per call into the +-1 int8 operand the kernel loads with TMA
(``pm1_queries``), and the kernel expands the corpus words the same way
and returns the count (32W - q.c)/2.

The wrapper takes the plain version only for tensors on the CPU.  For a
CUDA tensor it launches the kernel or raises; nothing falls back.
``LAUNCHES`` counts kernel launches (plain calls do not count).
"""

from __future__ import annotations

import torch

from ..profiling import annotate
from .cuda_build import CudaSource, I, P, current_stream
from .quant_kernels import check_cuda

LAUNCHES = {"hamming_mxu_scores": 0, "hamming_scores": 0}

KSTEP = 128         # +-1 int8 positions in one K step of the kernel
_ARGS = [P] * 3 + [I] * 4 + [P]
SOURCE = CudaSource("hamming_scores", {"fpv_hamming_mxu_scores": _ARGS,
                                       "fpv_hamming_scores": _ARGS})

# bits set in each byte value: torch has no popcount op
_POPC8 = torch.tensor([bin(i).count("1") for i in range(256)],
                      dtype=torch.uint8)
_PLAIN_ELEMS = 1 << 22    # XOR words per plain chunk


def hamming_scores_plain(qcodes: torch.Tensor, codes: torch.Tensor
                         ) -> torch.Tensor:
    """Plain ``hamming_scores``: (B, W) x (N, W) int32 words -> (B, N)
    int32 counts.  XOR as int32, then a 256-entry popcount table over the
    bytes, chunked over N."""
    b, w = qcodes.shape
    n = codes.shape[0]
    table = _POPC8.to(codes.device)
    out = torch.empty((b, n), dtype=torch.int32, device=codes.device)
    step = max(1, _PLAIN_ELEMS // max(b * w, 1))
    for s in range(0, n, step):
        x = torch.bitwise_xor(qcodes[:, None, :], codes[None, s:s + step, :])
        out[:, s:s + step] = table[x.view(torch.uint8).long()].sum(
            dim=2, dtype=torch.int32)
    return out


def hamming_mxu_scores_plain(qcodes: torch.Tensor, codes: torch.Tensor
                             ) -> torch.Tensor:
    """Plain ``hamming_mxu_scores``: the same counts as f32."""
    return hamming_scores_plain(qcodes, codes).float()


def pm1_queries(qcodes: torch.Tensor) -> torch.Tensor:
    """(B, W) packed int32 words -> (B, Kp) int8: bit j of word w at
    position 32w + j as +1 (set) or -1 (clear), zero past 32W, Kp the
    next multiple of ``KSTEP``.  (32W - a.b) / 2 of two such rows is their
    Hamming distance: the padding is zero on one side at least."""
    b, w = qcodes.shape
    shifts = torch.arange(32, dtype=torch.int32, device=qcodes.device)
    bits = (qcodes[:, :, None] >> shifts) & 1
    pm = (2 * bits - 1).to(torch.int8).reshape(b, 32 * w)
    return torch.nn.functional.pad(pm, (0, (-32 * w) % KSTEP)).contiguous()


def _launch(entry: str, qcodes: torch.Tensor, codes: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    n, w = codes.shape
    check_cuda("codes", torch.int32, codes, (n, w))
    check_cuda("qcodes", torch.int32, qcodes, (qcodes.shape[0], w))
    if qcodes.device != codes.device:
        raise ValueError(f"{entry}: operands on different devices")
    b = qcodes.shape[0]
    qpm = pm1_queries(qcodes)
    out = torch.empty((b, n), dtype=dtype, device=codes.device)
    lib = SOURCE.load()
    with torch.cuda.device(codes.device):
        stream = current_stream(codes.device)
        rc = getattr(lib, "fpv_" + entry)(
            qpm.data_ptr(), codes.data_ptr(), out.data_ptr(), b, n, w,
            qpm.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    LAUNCHES[entry] += 1
    return out


def hamming_scores(qcodes: torch.Tensor, codes: torch.Tensor
                   ) -> torch.Tensor:
    """(B, W) x (N, W) packed int32 words -> (B, N) int32 Hamming
    distances.  Any B, N, W."""
    if codes.device.type == "cpu":
        return hamming_scores_plain(qcodes, codes)
    with annotate("fpv.kernel.hamming_scores"):
        return _launch("hamming_scores", qcodes, codes, torch.int32)


def hamming_mxu_scores(qcodes: torch.Tensor, codes: torch.Tensor
                       ) -> torch.Tensor:
    """(B, W) x (N, W) packed int32 words -> (B, N) f32 Hamming distances
    (the binary two-stage scan's coarse scores).  Any B, N, W."""
    if codes.device.type == "cpu":
        return hamming_mxu_scores_plain(qcodes, codes)
    with annotate("fpv.kernel.hamming_mxu_scores"):
        return _launch("hamming_mxu_scores", qcodes, codes, torch.float32)
