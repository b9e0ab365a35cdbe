"""k-means (Lloyd's) on the device (port of
``fastpyvectordb_tpu/quant/kmeans.py``), used by the IVF build.

Assignment is the chunked ``||c||^2 - 2 x.c`` expansion (a plain large
product, left to ``torch.mm`` as the JAX package leaves it to XLA); the
centroid update is a segment sum (``index_add_``).  Initialisation samples
rows at random and dead centroids are re-seeded from random rows, both
from a ``torch.Generator`` seeded with ``seed``.  The generator lives on the
CPU, so a seed picks the same rows on every device; it does not give the
rows ``jax.random`` picks, so the two packages' centroids differ for one
seed.
"""

from __future__ import annotations

import torch


def _chunks(n: int, chunk: int):
    for s in range(0, n, chunk):
        yield s, min(s + chunk, n)


def _dist(x: torch.Tensor, centroids: torch.Tensor,
          csq: torch.Tensor) -> torch.Tensor:
    return csq[None, :] - 2.0 * (x.float() @ centroids.T)


def assign_chunked(data: torch.Tensor, centroids: torch.Tensor,
                   chunk: int = 65536) -> torch.Tensor:
    """argmin_k ||x - c_k||^2 for every row (int32), chunked over rows."""
    csq = (centroids * centroids).sum(dim=1)
    out = torch.empty((data.shape[0],), dtype=torch.int32,
                      device=data.device)
    for s, e in _chunks(data.shape[0], chunk):
        out[s:e] = torch.argmin(_dist(data[s:e], centroids, csq), dim=1)
    return out


def kmeans_fit(data: torch.Tensor, seed: int = 0, *, k: int, iters: int = 10,
               chunk: int = 16384, n: int = None) -> torch.Tensor:
    """Fit ``k`` centroids to the first ``n`` rows of ``data`` (N_buf, D),
    any float dtype.  Returns (k, D) f32 on ``data``'s device.

    ``n`` (default: all rows) bounds a capacity-padded buffer: rows past it
    are never read, and no copy of the buffer is made (bf16 chunks are
    upcast one at a time)."""
    n_buf, d = data.shape
    if n is None:
        n = n_buf
    dev = data.device
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    if n >= k:
        init_idx = torch.randperm(n, generator=gen)[:k]
    else:
        init_idx = torch.randint(0, n, (k,), generator=gen)
    centroids = data[init_idx.to(dev)].float()
    for _ in range(iters):
        csq = (centroids * centroids).sum(dim=1)
        sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
        counts = torch.zeros((k,), dtype=torch.float32, device=dev)
        for s, e in _chunks(n, chunk):
            x = data[s:e].float()
            a = torch.argmin(_dist(x, centroids, csq), dim=1)
            sums.index_add_(0, a, x)
            counts += torch.bincount(a, minlength=k).float()
        alive = counts > 0
        new_c = torch.where(alive[:, None],
                            sums / torch.clamp(counts, min=1.0)[:, None],
                            centroids)
        # re-seed dead centroids from random rows
        reseed = torch.randint(0, n, (k,), generator=gen).to(dev)
        centroids = torch.where(alive[:, None], new_c, data[reseed].float())
    return centroids
