"""Product quantization (PQ) — 8-16x compression with LUT (ADC) distances
(port of ``fastpyvectordb_tpu/quant/product.py``).

M subspaces x K <= 256 centroids, per-subspace codebooks trained jointly
by the batched k-means (quant/kmeans.py:kmeans_fit_batched), uint8 codes,
and asymmetric-distance (ADC) search through per-query lookup tables.  The
training sample is the JAX package's (``default_rng(seed).choice`` on the
host); the codebooks themselves differ between the packages for one seed
(``jax.random`` and ``torch.Generator`` draw different rows), so parity is
held on codebooks carried across.  Encoding is a chunked argmin
(``torch.argmin`` returns the first minimum, as ``jnp.argmin`` does) and
the ADC scan a chunked table gather: plain PyTorch, as the JAX package
leaves both to XLA.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..kernels.topk import masked_top_k
from ..persist.format import load_container, save_container
from ..utils import resolve_device
from .kmeans import kmeans_fit_batched

CHUNK = 8192


def _encode(data: torch.Tensor, codebooks: torch.Tensor, *,
            chunk: int = 16384) -> torch.Tensor:
    """(N, D) x (M, K, ds) -> (N, M) uint8 codes: the nearest centroid per
    subspace by ``||c||^2 - 2 x.c``, chunked over rows."""
    n = data.shape[0]
    m, k, ds = codebooks.shape
    # the (M, chunk, K) f32 distance block stays under ~512 MB
    chunk = max(1, min(chunk, (512 << 20) // (m * k * 4)))
    csq = (codebooks * codebooks).sum(dim=2)                   # (M, K)
    out = torch.empty((n, m), dtype=torch.uint8, device=data.device)
    for s in range(0, n, chunk):
        x = data[s:s + chunk].float().reshape(-1, m, ds).transpose(0, 1)
        cross = torch.bmm(x, codebooks.transpose(1, 2))         # (M, c, K)
        dist = csq[:, None, :] - 2.0 * cross
        out[s:s + chunk] = torch.argmin(dist, dim=2).T.to(torch.uint8)
    return out


def _lut(queries: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(B, D) x (M, K, ds) -> (B, M, K) squared-distance lookup tables."""
    b = queries.shape[0]
    m, k, ds = codebooks.shape
    q = queries.float().reshape(b, m, ds)
    qsq = (q * q).sum(dim=2)
    csq = (codebooks * codebooks).sum(dim=2)
    cross = torch.bmm(q.transpose(0, 1), codebooks.transpose(1, 2))
    return qsq[:, :, None] + csq[None, :, :] - 2.0 * cross.transpose(0, 1)


def _adc(lut: torch.Tensor, codes: torch.Tensor, *, chunk: int = CHUNK
         ) -> torch.Tensor:
    """(B, M, K) LUT x (N, M) codes -> (B, N) approximate squared L2: the
    table entries of each row's codes, summed over the subspaces."""
    b, m, k = lut.shape
    n = codes.shape[0]
    flat = lut.reshape(b, m * k)
    offs = torch.arange(m, device=codes.device) * k
    out = torch.empty((b, n), dtype=torch.float32, device=lut.device)
    for s in range(0, n, chunk):
        idx = (codes[s:s + chunk].long() + offs[None, :]).reshape(-1)
        out[:, s:s + chunk] = flat[:, idx].reshape(b, -1, m).sum(dim=2)
    return out


class ProductQuantizer:
    """M-subspace / K-centroid product quantizer with ADC search."""

    def __init__(self, dims: Optional[int] = None, m: int = 8, k: int = 256,
                 device=None):
        if k > 256:
            raise ValueError("k must be <= 256 for uint8 codes")
        self.dims = dims
        self.m = m
        self.k = k
        self.device = device
        self.codebooks: Optional[torch.Tensor] = None   # (M, K, ds) f32

    @property
    def is_trained(self) -> bool:
        return self.codebooks is not None

    @property
    def subdim(self) -> int:
        return self.dims // self.m

    def train(self, vectors, iters: int = 12, sample: int = 100_000,
              seed: int = 0) -> "ProductQuantizer":
        """Codebooks from at most ``sample`` rows, drawn on the host as the
        JAX package draws them, fitted on ``self.device``."""
        if isinstance(vectors, torch.Tensor):
            if self.device is None:
                self.device = vectors.device
            vectors = vectors.detach().float().cpu().numpy()
        data = np.ascontiguousarray(vectors, dtype=np.float32)
        n, d = data.shape
        if d % self.m != 0:
            raise ValueError(f"dims {d} not divisible by m={self.m}")
        self.dims = d
        if n > sample:
            idx = np.random.default_rng(seed).choice(n, sample, replace=False)
            data = data[idx]
        sub = torch.from_numpy(np.ascontiguousarray(
            data.reshape(-1, self.m, self.subdim).transpose(1, 0, 2)))
        sub = sub.to(resolve_device(self.device))
        self.codebooks = kmeans_fit_batched(
            sub, seed, k=self.k, iters=iters,
            chunk=min(16384, max(256, sub.shape[1])))
        self.device = self.codebooks.device
        return self

    def _as_rows(self, vectors) -> torch.Tensor:
        if isinstance(vectors, torch.Tensor):
            v = vectors.to(self.codebooks.device)
        else:
            v = torch.from_numpy(np.require(vectors, np.float32, ["C", "W"])
                                 ).to(self.codebooks.device)
        return v if v.ndim > 1 else v[None, :]

    def encode(self, vectors) -> torch.Tensor:
        self._check()
        return _encode(self._as_rows(vectors), self.codebooks)

    def decode(self, codes) -> np.ndarray:
        self._check()
        if not isinstance(codes, torch.Tensor):
            codes = torch.from_numpy(np.array(codes))
        codes = codes.to(self.codebooks.device).long()
        sub = torch.arange(self.m, device=codes.device)[None, :]
        return self.codebooks[sub, codes].reshape(codes.shape[0], -1
                                                  ).cpu().numpy()

    def distances(self, queries, codes) -> torch.Tensor:
        """Approximate squared-L2 ADC distances (B, N)."""
        self._check()
        lut = _lut(self._as_rows(queries), self.codebooks)
        return _adc(lut, torch.as_tensor(codes).to(lut.device))

    def search(self, queries, codes, k: int = 10,
               mask: Optional[np.ndarray] = None):
        d = self.distances(queries, codes)
        m = torch.as_tensor(mask).to(d.device) if mask is not None else None
        vals, idx = masked_top_k(d, min(k, d.shape[1]), m)
        return vals.cpu().numpy(), idx.to(torch.int32).cpu().numpy()

    def memory_usage(self, n_vectors: int) -> dict:
        self._check()
        orig = n_vectors * self.dims * 4
        quant = n_vectors * self.m + self.codebooks.numel() * 4
        return {"original_bytes": orig, "quantized_bytes": quant,
                "compression_ratio": orig / max(quant, 1)}

    def save(self, path) -> None:
        self._check()
        save_container(Path(path),
                       {"codebooks": self.codebooks.cpu().numpy()},
                       meta={"kind": "product_quantizer", "dims": self.dims,
                             "m": self.m, "k": self.k})

    @classmethod
    def load(cls, path, device=None) -> "ProductQuantizer":
        device = resolve_device(device)
        c = load_container(path)
        pq = cls(dims=c.meta["dims"], m=c.meta["m"], k=c.meta["k"],
                 device=device)
        pq.codebooks = torch.from_numpy(
            np.array(c.read("codebooks"), dtype=np.float32)).to(device)
        return pq

    def _check(self) -> None:
        if not self.is_trained:
            raise RuntimeError("ProductQuantizer is not trained")
