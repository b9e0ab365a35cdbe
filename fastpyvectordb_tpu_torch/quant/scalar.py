"""Scalar (int8) quantization — 4x compression (port of
``fastpyvectordb_tpu/quant/scalar.py``).

Per-dimension min/max training, 255-level codes stored shifted to int8
(code - 128), bit-identical to the JAX package's codes (``torch.round`` and
``jnp.round`` both round half to even), so saved snapshots move between the
packages.  Distance modes:

  int8mm  — one s8 x s8 -> s32 product against the raw codes with the
            dequantisation folded into a per-query int8 query; the default
            on CUDA (the ``s8_scores`` kernel, kernels/s8_kernels.py; a
            plain integer matmul on the CPU)
  pallas  — the dequantise-on-load ``sq_scores`` kernel
            (kernels/quant_kernels.py; the JAX mode name is kept so callers
            port unchanged)
  chunked — plain tile-by-tile dequantise + f32 matmul (default on the CPU)
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import DistanceMetric
from ..kernels import quant_kernels
from ..kernels.s8_kernels import folded_epilogue, s8_scores, s8_topc
from ..kernels.topk import masked_top_k
from ..persist.format import load_container, save_container
from ..utils import resolve_device

CHUNK = 16384


def as_tensor(x, device=None) -> torch.Tensor:
    """Tensors pass through (moved to ``device`` if given); arrays become
    float32 tensors on ``device`` — with none given on the card, as every
    entry point of the package (``utils.resolve_device``)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    # "W": read-only arrays (memmapped container sections) are copied
    t = torch.from_numpy(np.require(x, np.float32, ["C", "W"]))
    return t.to(resolve_device(device))


def _train(data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    data = data.float()
    vmin = data.min(dim=0).values
    vmax = data.max(dim=0).values
    return vmin, torch.clamp(vmax - vmin, min=1e-8)


def _encode(data, vmin, scale) -> torch.Tensor:
    out = torch.empty(data.shape, dtype=torch.int8, device=data.device)
    for s in range(0, data.shape[0], CHUNK):
        t = data[s:s + CHUNK].float()
        c = torch.clamp(torch.round((t - vmin[None, :]) / scale[None, :]
                                    * 255.0), 0.0, 255.0)
        out[s:s + CHUNK] = (c - 128.0).to(torch.int8)
    return out


def _dequant(codes, vmin, scale) -> torch.Tensor:
    return ((codes.float() + 128.0) / 255.0 * scale[None, :]
            + vmin[None, :])


def _chunked_scores(q, vmin, scale, codes, metric, dequant) -> torch.Tensor:
    """Tile-by-tile dequantise + exact f32 metric: (B, D) x (N, .) codes.
    Shared by the int8 and int4 ``chunked`` modes."""
    n = codes.shape[0]
    out = torch.empty((q.shape[0], n), dtype=torch.float32, device=q.device)
    qn = q / torch.clamp(torch.linalg.norm(q, dim=1, keepdim=True),
                         min=1e-30)
    qsq = (q * q).sum(dim=1)
    for s in range(0, n, CHUNK):
        v = dequant(codes[s:s + CHUNK], vmin, scale)
        if metric == DistanceMetric.COSINE:
            vn = v / torch.clamp(torch.linalg.norm(v, dim=1, keepdim=True),
                                 min=1e-30)
            out[:, s:s + CHUNK] = 1.0 - qn @ vn.T
        elif metric == DistanceMetric.L2:
            vsq = (v * v).sum(dim=1)
            out[:, s:s + CHUNK] = torch.clamp(
                qsq[:, None] + vsq[None, :] - 2.0 * (q @ v.T), min=0.0)
        else:
            out[:, s:s + CHUNK] = -(q @ v.T)
    return out


def _distances(queries, codes, vmin, scale, *, metric) -> torch.Tensor:
    """(B, D) x int8 (N, D) -> (B, N) scores, dequantizing tile-by-tile."""
    return _chunked_scores(queries.float(), vmin, scale, codes, metric,
                           _dequant)


def int8_cross(qi: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(B, D) int8 x (N, D) int8 -> (B, N) int32 exact inner products: the
    ``s8_scores`` kernel on CUDA (any B, N, D, no padding copies), a plain
    int32 matmul on the CPU."""
    return s8_scores(qi, codes)


def fold_queries(queries, rs, bias, metric):
    """The query side of a product against raw codes with the
    per-dimension dequantisation folded into the query:
        q . dequant(c) = (q * rs) . c + q . bias
    (int8: rs = scale/255, bias = 128*rs + vmin; int4: rs = scale/15,
    bias = vmin).  The scaled query is quantised to int8 per row.  Returns
    (qi (B, D) int8, qscale (B,), const (B,) = q . bias, qstat (B,): qn for
    cosine, qsq for l2, None for dot)."""
    q = queries.float()
    qs = q * rs[None, :]
    const = q @ bias
    qmax = qs.abs().max(dim=1, keepdim=True).values
    qscale = torch.clamp(qmax, min=1e-30) / 127.0
    qi = torch.clamp(torch.round(qs / qscale), -127, 127).to(torch.int8)
    qstat = None
    if metric == DistanceMetric.COSINE:
        qstat = torch.clamp(torch.linalg.norm(q, dim=1), min=1e-30)
    elif metric == DistanceMetric.L2:
        qstat = (q * q).sum(dim=1)
    return qi, qscale[:, 0], const, qstat


def folded_int_scores(queries, codes, vmin, rs, bias, vsq, rinv, metric,
                      cross_fn=int8_cross) -> torch.Tensor:
    """(B, N) scores from an integer product against raw codes
    (``fold_queries``), the block updated in place by ``folded_epilogue``
    (the JAX version's temporaries would hold four 4 GB blocks at B=1024 x
    1M)."""
    metric = DistanceMetric.parse(metric)
    qi, qscale, const, qstat = fold_queries(queries, rs, bias, metric)
    rstat = rinv if metric == DistanceMetric.COSINE else vsq
    return folded_epilogue(cross_fn(qi, codes), qscale, const, qstat, rstat,
                           metric)


def folded_int_topc(queries, codes, vmin, rs, bias, vsq, rinv, mask, *,
                    c: int, metric):
    """The c smallest of ``folded_int_scores``' scores per query, rows
    where ``mask`` is False scored ``MASKED``: (vals (B, c), rows (B, c)).
    The fused ``s8_topc`` scan on CUDA writes no (B, N) block; on the CPU
    its plain version computes the block and selects."""
    metric = DistanceMetric.parse(metric)
    qi, qscale, const, qstat = fold_queries(queries, rs, bias, metric)
    rstat = rinv if metric == DistanceMetric.COSINE else vsq
    return s8_topc(qi, codes, qscale, const, qstat, rstat, mask, c=c,
                   metric=metric)


def _int8_rs_bias(vmin, scale):
    rs = (scale / 255.0).float()
    return rs, 128.0 * rs + vmin


def _distances_int8_matmul(queries, codes, vmin, scale, vsq, rinv, *,
                           metric) -> torch.Tensor:
    """Int8-native scan: one int8 x int8 product against the raw codes."""
    return folded_int_scores(queries, codes, vmin, *_int8_rs_bias(vmin, scale),
                             vsq, rinv, metric)


def int8_topc(queries, codes, vmin, scale, vsq, rinv, mask, *, c: int,
              metric):
    """Int8-native scan + masked top-c in one pass (``folded_int_topc``)."""
    return folded_int_topc(queries, codes, vmin, *_int8_rs_bias(vmin, scale),
                           vsq, rinv, mask, c=c, metric=metric)


def row_stats(codes, vmin, scale, dequant) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(vsq, rinv) of the dequantized corpus, computed tile-by-tile."""
    sq = torch.empty((codes.shape[0],), dtype=torch.float32,
                     device=codes.device)
    for s in range(0, codes.shape[0], CHUNK):
        v = dequant(codes[s:s + CHUNK], vmin, scale)
        sq[s:s + CHUNK] = (v * v).sum(dim=1)
    rinv = torch.where(sq > 0, torch.rsqrt(torch.clamp(sq, min=1e-30)),
                       torch.zeros_like(sq))
    return sq, rinv


class ScalarQuantizer:
    """Per-dimension min/max int8 quantizer (4x compression)."""

    def __init__(self, dims: Optional[int] = None, device=None):
        self.dims = dims
        self.device = device
        self.vmin: Optional[torch.Tensor] = None
        self.scale: Optional[torch.Tensor] = None

    @property
    def is_trained(self) -> bool:
        return self.vmin is not None

    def train(self, vectors) -> "ScalarQuantizer":
        data = as_tensor(vectors, self.device)
        self.dims = int(data.shape[1])
        self.vmin, self.scale = _train(data)
        self.device = self.vmin.device
        return self

    def encode(self, vectors) -> torch.Tensor:
        self._check()
        return _encode(as_tensor(vectors, self.device), self.vmin, self.scale)

    def decode(self, codes) -> np.ndarray:
        self._check()
        codes = torch.as_tensor(codes).to(self.device)
        return _dequant(codes, self.vmin, self.scale).cpu().numpy()

    def corpus_stats(self, codes) -> tuple:
        """One-time (vsq, rinv) of the dequantized corpus (int8mm mode)."""
        self._check()
        return row_stats(torch.as_tensor(codes).to(self.device), self.vmin,
                         self.scale, _dequant)

    def distances(self, queries, codes,
                  metric: DistanceMetric = DistanceMetric.L2,
                  use_pallas: Optional[bool] = None, mode: str = "auto",
                  stats: Optional[tuple] = None) -> torch.Tensor:
        """Quantized-domain distances, (B, N) f32 on the codes' device.
        Modes: int8mm | pallas | chunked (module docstring); ``auto`` is
        int8mm on CUDA and chunked on the CPU."""
        self._check()
        metric = DistanceMetric.parse(metric)
        codes = torch.as_tensor(codes).to(self.device)
        q = as_tensor(queries, self.device).float()
        if q.ndim == 1:
            q = q[None, :]
        if use_pallas is not None:  # back-compat switch
            mode = "pallas" if use_pallas else "chunked"
        if mode == "auto":
            mode = "int8mm" if codes.is_cuda else "chunked"
        if mode == "int8mm":
            vsq, rinv = stats if stats is not None \
                else self.corpus_stats(codes)
            return _distances_int8_matmul(q, codes, self.vmin, self.scale,
                                          vsq, rinv, metric=metric)
        if mode == "pallas":
            return quant_kernels.sq_scores(q, codes, self.vmin, self.scale,
                                           metric=metric)
        return _distances(q, codes, self.vmin, self.scale, metric=metric)

    def search(self, queries, codes, k: int = 10,
               metric: DistanceMetric = DistanceMetric.L2,
               mask: Optional[np.ndarray] = None):
        d = self.distances(queries, codes, metric)
        m = torch.as_tensor(mask).to(d.device) if mask is not None else None
        vals, idx = masked_top_k(d, min(k, d.shape[1]), m)
        return vals.cpu().numpy(), idx.to(torch.int32).cpu().numpy()

    def memory_usage(self, n_vectors: int) -> dict:
        self._check()
        orig = n_vectors * self.dims * 4
        quant = n_vectors * self.dims * 1 + self.dims * 8
        return {"original_bytes": orig, "quantized_bytes": quant,
                "compression_ratio": orig / max(quant, 1)}

    def save(self, path) -> None:
        self._check()
        save_container(Path(path), {
            "vmin": self.vmin.cpu().numpy(),
            "scale": self.scale.cpu().numpy(),
        }, meta={"kind": "scalar_quantizer", "dims": self.dims})

    @classmethod
    def load(cls, path, device=None) -> "ScalarQuantizer":
        device = resolve_device(device)
        c = load_container(path)
        sq = cls(dims=c.meta["dims"], device=device)
        sq.vmin = as_tensor(c.read("vmin"), device)
        sq.scale = as_tensor(c.read("scale"), device)
        return sq

    def _check(self) -> None:
        if not self.is_trained:
            raise RuntimeError("ScalarQuantizer is not trained")
