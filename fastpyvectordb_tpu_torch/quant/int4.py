"""Int4 scalar quantization — 8x compression (port of
``fastpyvectordb_tpu/quant/int4.py``).

Per-dimension min/max training with 16-level codes packed two per byte in
the JAX package's *halves* layout — the low nibble of byte ``w`` holds dim
``w``, the high nibble dim ``w + W`` (W = ceil(D/2)).  That layout is the
persisted code format, so it is kept bit for bit.  Odd D pads one phantom
dim (vmin=0, scale=1e-8, query padded with 0 — contributes nothing).

The TPU-only padding helpers ``pallas_layout`` / ``pallas_query`` (128-lane
words, 1024-row tiles) are not ported: the CUDA ``int4_scores`` kernel
masks its own ragged edges.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.types import DistanceMetric
from ..kernels import quant_kernels
from ..kernels.quant_kernels import unpack_int4
from ..kernels.topk import masked_top_k
from ..persist.format import load_container, save_container
from ..utils import resolve_device
from .scalar import (CHUNK, _chunked_scores, _train, as_tensor,
                     folded_int_scores, int8_cross, row_stats)


def _padded_dims(d: int) -> int:
    return d + (d % 2)


def _encode(data, vmin, scale) -> torch.Tensor:
    """(N, De) f32 -> (N, De/2) packed uint8 (halves layout)."""
    w = data.shape[1] // 2
    out = torch.empty((data.shape[0], w), dtype=torch.uint8,
                      device=data.device)
    for s in range(0, data.shape[0], CHUNK):
        t = data[s:s + CHUNK].float()
        c = torch.clamp(torch.round((t - vmin[None, :]) / scale[None, :]
                                    * 15.0), 0.0, 15.0).to(torch.uint8)
        out[s:s + CHUNK] = c[:, :w] | (c[:, w:] << 4)
    return out


def _dequant(packed, vmin, scale) -> torch.Tensor:
    return (unpack_int4(packed).float() / 15.0 * scale[None, :]
            + vmin[None, :])


def _pad_queries(q: torch.Tensor, de: int) -> torch.Tensor:
    q = q.float()
    return F.pad(q, (0, de - q.shape[1])) if q.shape[1] != de else q


def _distances(queries, packed, vmin, scale, *, metric) -> torch.Tensor:
    """Chunked plain path: unpack + dequantize one tile at a time."""
    q = _pad_queries(queries, 2 * packed.shape[1])
    return _chunked_scores(q, vmin, scale, packed, metric, _dequant)


def _distances_int4_matmul(queries, packed, vmin, scale, vsq, rinv, *,
                           metric) -> torch.Tensor:
    """Folded int4 scan: unpack to int8 codes and run one s8 x s8 product
    with the dequantization folded into the query (as int8's)."""
    q = _pad_queries(queries, 2 * packed.shape[1])
    rs = (scale / 15.0).float()
    return folded_int_scores(
        q, packed, vmin, rs, vmin, vsq, rinv, metric,
        cross_fn=lambda qi, p: int8_cross(qi, unpack_int4(p).to(torch.int8)))


class Int4Quantizer:
    """Per-dimension min/max int4 quantizer (8x compression)."""

    def __init__(self, dims: Optional[int] = None, device=None):
        self.dims = dims            # true dims; internal arrays use _de
        self.device = device
        self.vmin: Optional[torch.Tensor] = None
        self.scale: Optional[torch.Tensor] = None

    @property
    def _de(self) -> int:
        return _padded_dims(self.dims)

    @property
    def n_words(self) -> int:
        return self._de // 2

    @property
    def is_trained(self) -> bool:
        return self.vmin is not None

    def train(self, vectors) -> "Int4Quantizer":
        data = as_tensor(vectors, self.device)
        self.dims = int(data.shape[1])
        vmin, scale = _train(data)
        if self._de != self.dims:   # phantom pad dim: never contributes
            vmin = F.pad(vmin, (0, 1))
            scale = F.pad(scale, (0, 1), value=1e-8)
        self.vmin, self.scale = vmin, scale
        self.device = vmin.device
        return self

    def encode(self, vectors) -> torch.Tensor:
        self._check()
        data = _pad_queries(as_tensor(vectors, self.device), self._de)
        return _encode(data, self.vmin, self.scale)

    def decode(self, packed) -> np.ndarray:
        self._check()
        packed = torch.as_tensor(packed).to(self.device)
        return _dequant(packed, self.vmin, self.scale)[:, : self.dims] \
            .cpu().numpy()

    def corpus_stats(self, packed) -> tuple:
        """One-time (vsq, rinv) of the dequantized corpus."""
        self._check()
        return row_stats(torch.as_tensor(packed).to(self.device), self.vmin,
                         self.scale, _dequant)

    def distances(self, queries, packed,
                  metric: DistanceMetric = DistanceMetric.L2,
                  mode: str = "auto",
                  stats: Optional[tuple] = None) -> torch.Tensor:
        """Quantized-domain distances.  Modes: pallas (the ``int4_scores``
        kernel, which unpacks on load) | int4mm (unpack + s8 product) |
        chunked (plain tile scan).  ``auto``: pallas on CUDA, chunked on
        the CPU."""
        self._check()
        metric = DistanceMetric.parse(metric)
        packed = torch.as_tensor(packed).to(self.device)
        q = as_tensor(queries, self.device).float()
        if q.ndim == 1:
            q = q[None, :]
        if mode == "auto":
            mode = "pallas" if packed.is_cuda else "chunked"
        if mode == "pallas":
            return quant_kernels.int4_scores(
                _pad_queries(q, 2 * packed.shape[1]), packed, self.vmin,
                self.scale, metric=metric)
        if mode == "int4mm":
            vsq, rinv = stats if stats is not None \
                else self.corpus_stats(packed)
            return _distances_int4_matmul(q, packed, self.vmin, self.scale,
                                          vsq, rinv, metric=metric)
        return _distances(q, packed, self.vmin, self.scale, metric=metric)

    def search(self, queries, packed, k: int = 10,
               metric: DistanceMetric = DistanceMetric.L2,
               mask: Optional[np.ndarray] = None):
        d = self.distances(queries, packed, metric)
        m = torch.as_tensor(mask).to(d.device) if mask is not None else None
        vals, idx = masked_top_k(d, min(k, d.shape[1]), m)
        return vals.cpu().numpy(), idx.to(torch.int32).cpu().numpy()

    def memory_usage(self, n_vectors: int) -> dict:
        self._check()
        orig = n_vectors * self.dims * 4
        quant = n_vectors * self.n_words + self._de * 8
        return {"original_bytes": orig, "quantized_bytes": quant,
                "compression_ratio": orig / max(quant, 1)}

    def save(self, path) -> None:
        self._check()
        save_container(Path(path), {
            "vmin": self.vmin.cpu().numpy(),
            "scale": self.scale.cpu().numpy(),
        }, meta={"kind": "int4_quantizer", "dims": self.dims})

    @classmethod
    def load(cls, path, device=None) -> "Int4Quantizer":
        device = resolve_device(device)
        c = load_container(path)
        qz = cls(dims=c.meta["dims"], device=device)
        qz.vmin = as_tensor(c.read("vmin"), device)
        qz.scale = as_tensor(c.read("scale"), device)
        return qz

    def _check(self) -> None:
        if not self.is_trained:
            raise RuntimeError("Int4Quantizer is not trained")
