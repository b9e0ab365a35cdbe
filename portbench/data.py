"""Vectors and queries made from ``--seed`` on the run's device.

One generator, ``clustered`` (the only ``data.generator`` that
``spec.checked_config`` lets through): centres at ``center_scale``
times a standard normal, each row a random centre plus ``row_noise`` times
a standard normal (normalised when asked), each query a random centre plus
``query_noise`` times a standard normal.

The clusters are one fixed draw (``BASE``); the seed turns them by a
random rotation of its own (an orthogonal matrix, Haar distributed) and
draws the queries.  So every seed's corpus and queries differ, while the
geometry that an index is built from (the clusters' sizes and distances)
is the same for every seed: an IVF partition, and with it the work of a
search, does not change with the seed.  Both traffic mixes of one
configuration and seed search the same rows; each mix's query sets come
from streams of their own.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK_ROWS = 262_144

# stream numbers under one seed
CORPUS, POOL, EVAL, WARMUP, SAMPLE, ROTATION = range(6)

# the seed of the one draw of clusters and rows that every seed rotates
BASE = 0


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (any int, large ones too)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def rotation(dims: int, seed: int, device) -> torch.Tensor:
    """The seed's (dims, dims) f32 orthogonal matrix: QR of a float64
    normal matrix on the host, columns signed by R's diagonal."""
    g = torch.randn((dims, dims), dtype=torch.float64,
                    generator=generator(seed, ROTATION, "cpu"))
    q, r = torch.linalg.qr(g)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q.to(device=device, dtype=torch.float32)


def _rotated(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x @ rot
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def clustered(data: dict, rows: int, dims: int, seed: int, device):
    """(corpus (rows, dims) f32, centres (C, dims) f32) on ``device``,
    a block of rows a call; both in the seed's rotation."""
    gen = generator(BASE, CORPUS, device)
    centers = data["center_scale"] * torch.randn(
        (data["centers"], dims), generator=gen, device=device)
    rot = rotation(dims, seed, device)
    corpus = torch.empty((rows, dims), dtype=torch.float32, device=device)
    for s in range(0, rows, CHUNK_ROWS):
        e = min(s + CHUNK_ROWS, rows)
        pick = torch.randint(0, data["centers"], (e - s,), generator=gen,
                             device=device)
        block = torch.randn((e - s, dims), generator=gen, device=device)
        block.mul_(data["row_noise"]).add_(centers[pick])
        if data["normalize"]:
            block.div_(torch.linalg.norm(block, dim=1, keepdim=True))
        corpus[s:e] = _rotated(block, rot)
    return corpus, _rotated(centers, rot)


def queries(data: dict, centers: torch.Tensor, n: int, seed: int,
            stream: int) -> np.ndarray:
    """(n, dims) f32 host queries: a random centre plus noise each (the
    centres already rotated; the noise is isotropic, so it needs none)."""
    gen = generator(seed, stream, centers.device)
    pick = torch.randint(0, centers.shape[0], (n,), generator=gen,
                         device=centers.device)
    q = torch.randn((n, centers.shape[1]), generator=gen,
                    device=centers.device)
    q.mul_(data["query_noise"]).add_(centers[pick])
    return q.cpu().numpy()


def ids(rows: int) -> np.ndarray:
    """The string id inserted with each row (``v<row>``, the configuration's
    ``fill.ids``)."""
    return np.array([f"v{i}" for i in range(rows)], dtype=object)
