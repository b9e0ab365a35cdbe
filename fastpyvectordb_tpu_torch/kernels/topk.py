"""Top-k utilities (port of ``fastpyvectordb_tpu/kernels/topk.py``):
masked top-k and partial-result merging, exact ``torch.topk`` in f32."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .distances import MASKED, smallest_k


def masked_top_k(scores: torch.Tensor, k: int,
                 mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k of a (B, N) score matrix with optional boolean mask.
    Disqualified rows surface with score >= MASKED so callers can trim
    them.  ``scores`` is not modified."""
    if mask is not None:
        if mask.ndim == 1:
            mask = mask[None, :]
        scores = torch.where(mask, scores,
                             torch.full((), float(MASKED),
                                        device=scores.device))
    return smallest_k(scores, k)


def merge_top_k(vals_parts: torch.Tensor, idx_parts: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge P partial top-k lists per query: (P, B, k_p) scores and
    global row indices -> (vals (B,k), idx (B,k))."""
    p, b, kp = vals_parts.shape
    vals = vals_parts.movedim(0, 1).reshape(b, p * kp)
    idxs = idx_parts.movedim(0, 1).reshape(b, p * kp)
    top_vals, pos = smallest_k(vals, k)
    return top_vals, torch.take_along_dim(idxs, pos, dim=1)


def merge_topk_host(d1, r1, d2, r2, k: int):
    """Host-side merge of two per-query top-k lists over disjoint row
    spaces (a snapshot's hits plus the exact scan over the appended tail).
    MASKED sentinels sort last naturally."""
    d = np.concatenate([np.asarray(d1), np.asarray(d2)], axis=1)
    r = np.concatenate([np.asarray(r1), np.asarray(r2)], axis=1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(d, order, axis=1),
            np.take_along_axis(r, order, axis=1))


def valid_hits(vals):
    """Boolean (B, k) marking hits that were not masked out, in the
    caller's domain (numpy in, numpy out; tensor in, tensor out)."""
    return vals < float(MASKED) * 0.5
