"""Binary (1-bit) quantization — 32x compression with Hamming distance
(port of ``fastpyvectordb_tpu/quant/binary.py``).

Per-dimension thresholds (median, mean or fixed) from numpy on the host,
exactly as the JAX package computes them, so the same sample gives the same
thresholds and bit-identical codes.  Sign bits pack into 32-bit words,
W = ceil(D/32) a vector, bit j of word w holding dim 32w + j; padding bits
are zero on both sides and never count.  The words live in ``torch.int32``
tensors (the same bits as the JAX package's uint32: torch's uint32 has no
shifts on the CPU) and become uint32 only at the persistence boundary.
Hamming distances are the ``hamming_scores`` kernel (kernels/
hamming_kernels.py) on CUDA and its plain version on the CPU.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..kernels import hamming_kernels
from ..kernels.topk import masked_top_k
from ..persist.format import load_container, save_container
from ..utils import resolve_device

CHUNK = 32768    # rows packed at a time (bounds the int64 bit block)


def _n_words(dims: int) -> int:
    return (dims + 31) // 32


def _encode(data: torch.Tensor, thresholds: torch.Tensor, *, dims: int
            ) -> torch.Tensor:
    """(N, D) float -> (N, W) int32 packed sign bits.  Packs in int64 and
    keeps the low 32 bits as a two's-complement int32 explicitly (an
    out-of-range int64 -> int32 cast is not relied on)."""
    n = data.shape[0]
    w = _n_words(dims)
    out = torch.empty((n, w), dtype=torch.int32, device=data.device)
    weights = 2 ** torch.arange(32, dtype=torch.int64, device=data.device)
    for s in range(0, n, CHUNK):
        bits = (data[s:s + CHUNK].float() > thresholds[None, :]).long()
        bits = torch.nn.functional.pad(bits, (0, w * 32 - dims))
        words = (bits.reshape(-1, w, 32) * weights).sum(dim=2)
        out[s:s + CHUNK] = torch.where(words >= 1 << 31, words - (1 << 32),
                                       words).to(torch.int32)
    return out


def to_uint32(codes: torch.Tensor) -> np.ndarray:
    """int32 code words -> the uint32 array both packages persist."""
    return codes.cpu().numpy().view(np.uint32)


def from_uint32(arr, device) -> torch.Tensor:
    """A persisted uint32 (or int32) word array -> int32 words on
    ``device``."""
    return torch.from_numpy(np.array(arr).view(np.int32)).to(device)


class BinaryQuantizer:
    """1-bit-per-dimension quantizer with packed-word Hamming search."""

    def __init__(self, dims: Optional[int] = None, device=None):
        self.dims = dims
        self.device = device
        self.thresholds: Optional[torch.Tensor] = None

    @property
    def is_trained(self) -> bool:
        return self.thresholds is not None

    @property
    def n_words(self) -> int:
        return _n_words(self.dims)

    def train(self, vectors, method: str = "median",
              fixed_threshold: float = 0.0) -> "BinaryQuantizer":
        """Thresholds from a host numpy copy of ``vectors``, as in the JAX
        package (``np.median`` / ``mean`` / a constant)."""
        if isinstance(vectors, torch.Tensor):
            if self.device is None:
                self.device = vectors.device
            vectors = vectors.detach().float().cpu().numpy()
        data = np.ascontiguousarray(vectors, dtype=np.float32)
        self.dims = int(data.shape[1])
        if method == "median":
            thr = np.median(data, axis=0)
        elif method == "mean":
            thr = data.mean(axis=0)
        elif method == "fixed":
            thr = np.full(self.dims, fixed_threshold, dtype=np.float32)
        else:
            raise ValueError(f"unknown threshold method {method!r}")
        thr = torch.from_numpy(np.ascontiguousarray(thr, dtype=np.float32))
        self.device = resolve_device(self.device)
        self.thresholds = thr.to(self.device)
        return self

    def _as_rows(self, vectors) -> torch.Tensor:
        if isinstance(vectors, torch.Tensor):
            v = vectors.to(self.thresholds.device)
        else:
            v = torch.from_numpy(np.require(vectors, np.float32, ["C", "W"])
                                 ).to(self.thresholds.device)
        return v if v.ndim > 1 else v[None, :]

    def encode(self, vectors) -> torch.Tensor:
        """(N, D) -> (N, W) int32 packed words on the thresholds' device."""
        self._check()
        return _encode(self._as_rows(vectors), self.thresholds,
                       dims=self.dims)

    def hamming_distances(self, queries, codes,
                          use_pallas: Optional[bool] = None) -> torch.Tensor:
        """(B, N) int32 Hamming distances of the queries' codes to
        ``codes`` (N, W).  ``use_pallas`` is accepted for the JAX package's
        signature; the device of the codes decides (the kernel on CUDA,
        its plain version on the CPU)."""
        qcodes = self.encode(queries)
        return hamming_kernels.hamming_scores(
            qcodes, torch.as_tensor(codes).to(qcodes.device).contiguous())

    def hamming_distances_t(self, qcodes: torch.Tensor,
                            codes_t: torch.Tensor) -> torch.Tensor:
        """The JAX package's word-major entry: (B, W) query words and (W, N)
        transposed codes -> (B, N) int32.  The kernel reads row-major codes,
        so this transposes; callers that scan repeatedly should keep the
        (N, W) codes and call ``hamming_distances``."""
        return hamming_kernels.hamming_scores(
            qcodes.contiguous(), codes_t.T.contiguous())

    def search(self, queries, codes, k: int = 10,
               mask: Optional[np.ndarray] = None):
        d = self.hamming_distances(queries, codes).float()
        m = torch.as_tensor(mask).to(d.device) if mask is not None else None
        vals, idx = masked_top_k(d, min(k, d.shape[1]), m)
        return vals.cpu().numpy(), idx.to(torch.int32).cpu().numpy()

    def memory_usage(self, n_vectors: int) -> dict:
        self._check()
        orig = n_vectors * self.dims * 4
        quant = n_vectors * self.n_words * 4 + self.dims * 4
        return {"original_bytes": orig, "quantized_bytes": quant,
                "compression_ratio": orig / max(quant, 1)}

    def save(self, path) -> None:
        self._check()
        save_container(Path(path),
                       {"thresholds": self.thresholds.cpu().numpy()},
                       meta={"kind": "binary_quantizer", "dims": self.dims})

    @classmethod
    def load(cls, path, device=None) -> "BinaryQuantizer":
        device = resolve_device(device)
        c = load_container(path)
        bq = cls(dims=c.meta["dims"], device=device)
        bq.thresholds = torch.from_numpy(
            np.array(c.read("thresholds"), dtype=np.float32)).to(device)
        return bq

    def _check(self) -> None:
        if not self.is_trained:
            raise RuntimeError("BinaryQuantizer is not trained")
