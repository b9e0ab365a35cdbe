"""k-means (Lloyd's) on the device (port of
``fastpyvectordb_tpu/quant/kmeans.py``), used by the IVF build, and its
batched form over M independent subspaces (``kmeans_fit_batched``), used by
PQ codebook training where the JAX package ``vmap``s ``kmeans_fit``.

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
    upcast one at a time).  The one-subspace case of
    ``kmeans_fit_batched``."""
    n = data.shape[0] if n is None else n
    return kmeans_fit_batched(data[None, :n], seed, k=k, iters=iters,
                              chunk=chunk)[0]


# bytes of one chunk's (M, chunk, k) distance block in kmeans_fit_batched
_BATCHED_BYTES = 512 << 20


def kmeans_fit_batched(data: torch.Tensor, seed: int = 0, *, k: int,
                       iters: int = 10, chunk: int = 16384) -> torch.Tensor:
    """Fit ``k`` centroids in each of M independent subspaces: data
    (M, N, ds), any float dtype -> (M, k, ds) f32 on ``data``'s device.

    One batched product (``torch.bmm``) assigns a chunk of rows in every
    subspace at once and one ``index_add_`` over the flattened (subspace,
    centroid) index updates all sums, so an iteration costs a few launches
    a chunk whatever M is; chunks are upcast one at a time.  Initial rows
    (a random permutation per subspace) and dead-centroid re-seeds come
    from one CPU generator seeded with ``seed``."""
    m, n, ds = data.shape
    dev = data.device
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    if n >= k:
        init = torch.stack([torch.randperm(n, generator=gen)[:k]
                            for _ in range(m)])
    else:
        init = torch.randint(0, n, (m, k), generator=gen)
    sub = torch.arange(m, device=dev)[:, None]
    centroids = data[sub, init.to(dev)].float()
    chunk = max(1, min(chunk, _BATCHED_BYTES // max(m * k * 4, 1)))
    offs = (torch.arange(m, device=dev) * k)[:, None]
    for _ in range(iters):
        csq = (centroids * centroids).sum(dim=2)             # (M, k)
        sums = torch.zeros((m * k, ds), dtype=torch.float32, device=dev)
        counts = torch.zeros((m * k,), dtype=torch.float32, device=dev)
        for s, e in _chunks(n, chunk):
            x = data[:, s:e].float()                         # (M, c, ds)
            dist = csq[:, None, :] - 2.0 * torch.bmm(
                x, centroids.transpose(1, 2))
            flat = (torch.argmin(dist, dim=2) + offs).reshape(-1)
            sums.index_add_(0, flat, x.reshape(-1, ds))
            counts += torch.bincount(flat, minlength=m * k).float()
        sums, counts = sums.reshape(m, k, ds), counts.reshape(m, k)
        alive = counts > 0
        new_c = torch.where(alive[:, :, None],
                            sums / torch.clamp(counts, min=1.0)[:, :, None],
                            centroids)
        # re-seed dead centroids from random rows
        reseed = torch.randint(0, n, (m, k), generator=gen).to(dev)
        centroids = torch.where(alive[:, :, None], new_c,
                                data[sub, reseed].float())
    return centroids
