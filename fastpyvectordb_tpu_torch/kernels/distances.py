"""Batched distance scans (port of ``fastpyvectordb_tpu/kernels/distances.py``).

The same math as the JAX module, on torch tensors:

  * cosine via pre-cached corpus inverse norms (no per-query corpus pass),
  * L2 via the ||a||^2 + ||b||^2 - 2ab expansion (squared inside; sqrt only
    on the k winners),
  * dot as the negated inner product,
  * an optional validity/filter mask applied as ``where(mask, d, MASKED)``.

The distance GEMM is a plain ``torch`` matrix product: the JAX package
leaves it to XLA as well, outside any Pallas kernel.  Selection is exact
``torch.topk`` in f32 everywhere — CUDA has no counterpart of the TPU's
``lax.approx_max_k``.  Where the JAX
code builds new arrays, the (B, N) score block here is updated in place so a
B=1024 x 1M search holds one 4 GB block, not three.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.types import DistanceMetric

# Large-but-finite sentinel that disqualifies masked-out rows (the JAX
# package's value: files and tests compare against it).
MASKED = np.float32(3.0e38)

# torch >= 2.8 has an f32-output bf16 product on CUDA (aten::mm.dtype)
_MM_OUT_DTYPE = "dtype" in torch.ops.aten.mm.overloads()

_STATS_CHUNK = 65536


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, D) x (N, D) -> (M, N) float32 = a @ b.T, never rounded to bf16.

    ``torch.matmul`` of bf16 operands returns bf16 (JAX asks for f32 with
    ``preferred_element_type``).  On CUDA the f32-output product is used;
    on the CPU (and older CUDA torch) the bf16 operands are upcast, which
    gives the same exact products summed in f32."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b.T
    if a.is_cuda and _MM_OUT_DTYPE and a.dtype == b.dtype:
        return torch.mm(a, b.T, out_dtype=torch.float32)
    return a.float() @ b.float().T


def _norms_sq(v: torch.Tensor) -> torch.Tensor:
    """Row sums of squares in f32, chunked so a bf16 corpus is never upcast
    whole (a full f32 copy of a 1M x 768 bf16 store is 3 GB)."""
    if v.dtype == torch.float32:
        return (v * v).sum(dim=1)
    out = torch.empty((v.shape[0],), dtype=torch.float32, device=v.device)
    for s in range(0, v.shape[0], _STATS_CHUNK):
        t = v[s:s + _STATS_CHUNK].float()
        out[s:s + _STATS_CHUNK] = (t * t).sum(dim=1)
    return out


def _rinv(sq: torch.Tensor) -> torch.Tensor:
    return torch.where(sq > 0, torch.rsqrt(torch.clamp(sq, min=1e-30)),
                       torch.zeros_like(sq))


def corpus_stats(vectors: torch.Tensor) -> dict:
    """Per-row ``sq`` (squared L2 norms) and ``rinv`` (reciprocal norms,
    0-norm rows -> 0), both (N,) float32."""
    sq = _norms_sq(vectors)
    return {"sq": sq, "rinv": _rinv(sq)}


def host_exact_scores(q: np.ndarray, cand: np.ndarray,
                      metric: DistanceMetric) -> np.ndarray:
    """Exact metric over gathered candidates on the HOST: q (B, D) f32 x
    cand (B, C, D) f32 -> (B, C) scores, lower = closer."""
    cross = np.einsum("bd,bcd->bc", q, cand, optimize=True)
    if metric == DistanceMetric.COSINE:
        qn = np.linalg.norm(q, axis=1, keepdims=True)
        cn = np.linalg.norm(cand, axis=2)
        return 1.0 - cross / np.maximum(qn * cn, 1e-30)
    if metric == DistanceMetric.L2:
        qsq = np.einsum("bd,bd->b", q, q)
        csq = np.einsum("bcd,bcd->bc", cand, cand, optimize=True)
        return np.sqrt(np.maximum(qsq[:, None] + csq - 2.0 * cross, 0.0))
    return -cross


def scores(queries: torch.Tensor, vectors: torch.Tensor,
           metric: DistanceMetric, *,
           corpus_sq: Optional[torch.Tensor] = None,
           corpus_rinv: Optional[torch.Tensor] = None,
           compute_dtype: str = "float32") -> torch.Tensor:
    """(B, D) x (N, D) -> (B, N) f32 score matrix; lower = closer.  For L2
    the scores are *squared* distances (rank-equivalent)."""
    cd = getattr(torch, compute_dtype)
    q = queries.float()

    def mm(a):
        return mm_f32(a.to(cd), vectors.to(cd))

    if metric == DistanceMetric.COSINE:
        qinv = _rinv(_norms_sq(q))
        if corpus_rinv is None:
            corpus_rinv = corpus_stats(vectors)["rinv"]
        s = mm(q * qinv[:, None])
        return s.mul_(corpus_rinv[None, :]).neg_().add_(1.0)
    if metric == DistanceMetric.L2:
        if corpus_sq is None:
            corpus_sq = corpus_stats(vectors)["sq"]
        d2 = _norms_sq(q)[:, None] + corpus_sq[None, :]
        return d2.sub_(mm(q).mul_(2.0)).clamp_(min=0.0)
    if metric == DistanceMetric.DOT:
        return mm(q).neg_()
    raise ValueError(f"unknown metric {metric}")


def mask_scores(s: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """Disqualify rows where ``mask`` is False (mask (N,) or (B, N)); in
    place on ``s``."""
    if mask is None:
        return s
    if mask.ndim == 1:
        mask = mask[None, :]
    return s.masked_fill_(~mask, float(MASKED))


def smallest_k(s: torch.Tensor, k: int):
    """Exact ascending top-k of each row.  Ties come back in no promised
    order (``lax.top_k`` puts the lower index first); NaN scores sort
    after everything, so a NaN corpus row never takes a result slot."""
    return torch.topk(s, k, dim=1, largest=False, sorted=True)


def search_kernel(queries: torch.Tensor, vectors: torch.Tensor,
                  corpus_sq: torch.Tensor, corpus_rinv: torch.Tensor,
                  mask: Optional[torch.Tensor], *, metric: DistanceMetric,
                  k: int, compute_dtype: str = "float32",
                  sqrt_l2: bool = True):
    """Distances + masked top-k.  Returns (dists (B,k) f32, rows (B,k)
    int64).  The JAX version's ``approx`` (the TPU's approximate top-k)
    has no CUDA counterpart: selection is always exact."""
    s = scores(queries, vectors, metric, corpus_sq=corpus_sq,
               corpus_rinv=corpus_rinv, compute_dtype=compute_dtype)
    s = mask_scores(s, mask)
    vals, rows = smallest_k(s, k)
    if metric == DistanceMetric.L2 and sqrt_l2:
        vals = torch.where(vals >= float(MASKED), vals,
                           torch.sqrt(torch.clamp(vals, min=0.0)))
    return vals, rows
