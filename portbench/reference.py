"""The plain reference: exact k-nearest search over the benchmark's own copy
of the vectors, in plain PyTorch and NumPy.  It imports nothing of the
program and takes nothing the program made.

``exact_topk`` scores every row in float32 with TF32 off, a block of rows
at a time on the run's device; ``distances`` gives chosen (query, row)
pairs their distance in float64.  Distances follow the collection's
metric as the program reports them: cosine ``1 - cos``, l2 the euclidean
distance, dot ``-q.v``; lower is closer.

``reachable_topk`` is the exact top k among the rows that an IVF
partition lets each query reach: the rows of its ``nprobe`` nearest cells
(``probed_cells``: cosine in float32, ties to the lower cell) and the
overflow block.  The partition (centroids, row table, overflow rows) is
the program's own, as its index saves it: k-means cannot be worked out
again to the row.  So this follows the program from its partition on, and
the partition itself is checked apart (``checks.partition_faults``).

``control`` is the same exact search computed in TF32, the precision just
below the configuration's float32: it stands in for the program in the
check that the comparison can fail.  On the card it runs cuBLAS in TF32;
on the CPU, which has no TF32, the operands are rounded to TF32's 10-bit
mantissa before a float32 product.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

BLOCK_ROWS = 131_072


@contextlib.contextmanager
def tf32(enabled: bool):
    """cuBLAS float32 products in TF32 (``enabled``) or in float32."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10 mantissa
    bits."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _scores(q: torch.Tensor, v: torch.Tensor, metric: str,
            in_tf32: bool) -> torch.Tensor:
    """(Q, rows) distances, lower is closer."""
    if in_tf32 and q.device.type != "cuda":
        cross = round_tf32(q) @ round_tf32(v).T
    else:
        with tf32(in_tf32):
            cross = q @ v.T
    if metric == "cosine":
        qn = torch.linalg.norm(q, dim=1, keepdim=True)
        vn = torch.linalg.norm(v, dim=1)[None, :]
        return 1.0 - cross / (qn * vn)
    if metric == "l2":
        d2 = (q * q).sum(1, keepdim=True) + (v * v).sum(1)[None, :] \
            - 2.0 * cross
        return torch.sqrt(torch.clamp(d2, min=0.0))
    if metric == "dot":
        return -cross
    raise ValueError(f"unknown metric {metric!r}")


def exact_topk(corpus: np.ndarray, queries: np.ndarray, k: int, metric: str,
               device, in_tf32: bool = False
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The k closest rows of ``corpus`` to each query: (distances (Q, k)
    f32, rows (Q, k) int64), closest first."""
    q = torch.as_tensor(np.ascontiguousarray(queries, np.float32)).to(device)
    best_d = torch.full((q.shape[0], 0), float("inf"), device=device)
    best_r = torch.zeros((q.shape[0], 0), dtype=torch.int64, device=device)
    for s in range(0, corpus.shape[0], BLOCK_ROWS):
        v = torch.as_tensor(corpus[s:s + BLOCK_ROWS]).to(device)
        d = _scores(q, v, metric, in_tf32)
        dk, rk = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
        both_d = torch.cat([best_d, dk], dim=1)
        both_r = torch.cat([best_r, rk + s], dim=1)
        best_d, pos = torch.topk(both_d, min(k, both_d.shape[1]), dim=1,
                                 largest=False)
        best_r = torch.take_along_dim(both_r, pos, dim=1)
    return best_d.cpu().numpy(), best_r.cpu().numpy()


def probed_cells(centroids: np.ndarray, queries: np.ndarray,
                 nprobe: int) -> np.ndarray:
    """(Q, nprobe) cells nearest each query by cosine, nearest first."""
    cent = torch.as_tensor(np.asarray(centroids, np.float32))
    cent = cent / torch.clamp(torch.linalg.norm(cent, dim=1, keepdim=True),
                              min=1e-30)
    q = torch.as_tensor(np.asarray(queries, np.float32))
    q = q / torch.clamp(torch.linalg.norm(q, dim=1, keepdim=True),
                        min=1e-30)
    return torch.sort(-(q @ cent.T), dim=1, stable=True).indices[
        :, :nprobe].numpy()


def reachable_topk(corpus: np.ndarray, queries: np.ndarray, k: int,
                   metric: str, device, partition: dict,
                   block: int = 32) -> np.ndarray:
    """The k closest rows to each query among those its probed cells and
    the overflow block hold: rows (Q, k) int64, closest first, float32
    with TF32 off.  ``partition``: ``centroids``, ``row_table`` (cells,
    cmax) with -1 padding, ``overflow_rows`` with -1 padding, ``nprobe``."""
    table = torch.as_tensor(np.asarray(partition["row_table"])).long()
    over = torch.as_tensor(np.asarray(partition["overflow_rows"])).long()
    over = over[over >= 0]
    probe = torch.as_tensor(probed_cells(partition["centroids"], queries,
                                         int(partition["nprobe"])))
    v = torch.as_tensor(np.ascontiguousarray(corpus, np.float32)).to(device)
    vn = torch.linalg.norm(v, dim=1)
    q = torch.as_tensor(np.ascontiguousarray(queries, np.float32)).to(device)
    out = []
    for s in range(0, q.shape[0], block):
        qb = q[s:s + block]
        rows = table[probe[s:s + block]].reshape(qb.shape[0], -1)
        rows = torch.cat([rows, over[None].expand(qb.shape[0], -1)],
                         dim=1).to(device)
        safe = torch.clamp(rows, min=0)
        with tf32(False):
            cross = torch.bmm(v[safe], qb[:, :, None])[:, :, 0]
        if metric == "cosine":
            d = 1.0 - cross / (torch.linalg.norm(qb, dim=1, keepdim=True)
                               * vn[safe])
        elif metric == "l2":
            d = torch.sqrt(torch.clamp(
                (qb * qb).sum(1, keepdim=True) + vn[safe] ** 2 - 2.0 * cross,
                min=0.0))
        elif metric == "dot":
            d = -cross
        else:
            raise ValueError(f"unknown metric {metric!r}")
        d = torch.where(rows >= 0, d, torch.full_like(d, float("inf")))
        kk = min(k, d.shape[1])
        pos = torch.topk(d, kk, dim=1, largest=False).indices
        picked = torch.take_along_dim(rows, pos, dim=1)
        gone = torch.take_along_dim(d, pos, dim=1) == float("inf")
        out.append(torch.where(gone, -1, picked).cpu())
    return torch.cat(out).numpy()


def distances(corpus: np.ndarray, queries: np.ndarray, rows: np.ndarray,
              metric: str) -> np.ndarray:
    """float64 distance of query i to row ``rows[i, j]`` (rows in range)."""
    q = np.asarray(queries, np.float64)
    v = np.asarray(corpus[rows.reshape(-1)], np.float64).reshape(
        rows.shape + (corpus.shape[1],))
    cross = np.einsum("qd,qkd->qk", q, v)
    if metric == "cosine":
        return 1.0 - cross / (np.linalg.norm(q, axis=1)[:, None]
                              * np.linalg.norm(v, axis=2))
    if metric == "l2":
        return np.sqrt(np.maximum(
            (q * q).sum(1)[:, None] + (v * v).sum(2) - 2.0 * cross, 0.0))
    if metric == "dot":
        return -cross
    raise ValueError(f"unknown metric {metric!r}")


def control(corpus: np.ndarray, queries: np.ndarray, k: int, metric: str,
            device, names: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference in the program's place, in TF32: answers shaped as the
    program's ``(ids, scores, rows)`` (``names`` the id of each row)."""
    d, r = exact_topk(corpus, queries, k, metric, device, in_tf32=True)
    return names[r], d.astype(np.float32), r.astype(np.int32)
