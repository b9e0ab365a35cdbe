"""Two-stage quantized scan: compressed first pass -> exact re-rank (port of
``fastpyvectordb_tpu/quant/scan.py``, the int8 and int4 kinds).

  stage 1: quantized distances over all rows (int8: folded s8 x s8 product;
           int4: the ``int4_scores`` kernel) + masked top-c candidates;
  stage 2: gather the candidates' rows and apply the exact metric, then
           the final top-k.

Candidate selection is exact ``torch.topk`` in f32: the TPU's approximate
top-k (``lax.approx_max_k``) has no CUDA counterpart, and the JAX package
itself selects exactly off the TPU.  ``binary`` and ``pq`` snapshots are
not ported yet (ROADMAP queue A items 7 and 9).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import DistanceMetric
from ..kernels.distances import MASKED, smallest_k
from ..kernels.quant_kernels import int4_scores
from .int4 import Int4Quantizer, _pad_queries
from .scalar import ScalarQuantizer, _distances_int8_matmul, as_tensor

_NOT_PORTED = {
    "binary": "binary two-stage scan (ROADMAP queue A item 7)",
    "pq": "PQ two-stage scan (ROADMAP queue A item 9)",
}
_KIND_ALIASES = {"int8": "int8", "sq": "int8", "scalar": "int8",
                 "int4": "int4", "sq4": "int4",
                 "binary": "binary", "bq": "binary", "hamming": "binary",
                 "pq": "pq", "product": "pq"}


def _canonical_kind(kind: str) -> str:
    if kind not in _KIND_ALIASES:
        raise ValueError(f"unknown quantized scan kind {kind!r}")
    kind = _KIND_ALIASES[kind]
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"kind={kind!r} is not ported to the PyTorch package yet: "
            f"{_NOT_PORTED[kind]}")
    return kind


def _masked_candidates(s, mask, *, c: int):
    """Masked top-c candidate selection on the (B, N) scores, exact in f32
    (the JAX package's TPU path selects approximately in bf16; its exact
    re-rank then restores the order — here nothing needs restoring)."""
    if mask is not None:
        s = s.masked_fill_(~mask[None, :], float(MASKED))
    return smallest_k(s, c)


def _int8_coarse_topk(q, codes, vmin, scale, vsq, rinv, mask, *,
                      metric: DistanceMetric, k: int):
    """int8 scan + masked top-k (the rerank<=1 path)."""
    s = _distances_int8_matmul(q, codes, vmin, scale, vsq, rinv,
                               metric=metric)
    return _masked_candidates(s, mask, c=k)


def _int4_coarse_topk(q, codes, vmin, scale, mask, *,
                      metric: DistanceMetric, k: int):
    """int4 scan (``int4_scores``) + masked top-k."""
    s = int4_scores(_pad_queries(q, 2 * codes.shape[1]), codes, vmin, scale,
                    metric=metric)
    return _masked_candidates(s, mask, c=k)


def _rerank_body(queries, cand_vecs, cand_rows, cand_ok, metric, k,
                 compute_dtype="float32"):
    """Exact-metric re-rank over gathered candidates: queries (B, D);
    cand_vecs (B, C, D) in storage dtype; cand_rows / cand_ok (B, C).
    Returns (dists (B, k), rows (B, k)).  The cross term rounds its
    operands to ``compute_dtype`` and sums in f32."""
    cd = getattr(torch, compute_dtype)
    q = queries.float()
    cf = cand_vecs.float()
    vsq = (cf * cf).sum(dim=2)
    cross = torch.einsum("bd,bcd->bc", q.to(cd).float(),
                         cand_vecs.to(cd).float())
    if metric == DistanceMetric.COSINE:
        qinv = 1.0 / torch.clamp(torch.linalg.norm(q, dim=1, keepdim=True),
                                 min=1e-30)
        rinv = torch.rsqrt(torch.clamp(vsq, min=1e-30))
        s = 1.0 - cross * qinv * rinv
    elif metric == DistanceMetric.L2:
        qsq = (q * q).sum(dim=1)
        s = torch.sqrt(torch.clamp(qsq[:, None] + vsq - 2.0 * cross,
                                   min=0.0))
    else:
        s = -cross
    s = s.masked_fill_(~cand_ok, float(MASKED))
    vals, pos = smallest_k(s, k)
    return vals, torch.take_along_dim(cand_rows, pos, dim=1)


def gather_rerank(q, cvals, crows, vectors, metric, k, rerank_dtype):
    """Gather the candidates' rows and re-rank them exactly.  Rows of -1
    (padding of an IVF row table) gather row 0 and are masked: torch
    indexing would wrap -1 to the last row."""
    safe = torch.clamp(crows, min=0, max=vectors.shape[0] - 1).long()
    ok = (cvals < float(MASKED) * 0.5) & (crows >= 0)
    return _rerank_body(q, vectors[safe], crows, ok, metric, k, rerank_dtype)


def _int8_two_stage(q, codes, vmin, scale, vsq, rinv, vectors, mask, *,
                    metric: DistanceMetric, k: int, c: int,
                    rerank_dtype: str):
    """The whole int8 two-stage search: folded s8 product -> top-c
    candidates -> gather -> exact re-rank -> final top-k."""
    s = _distances_int8_matmul(q, codes, vmin, scale, vsq, rinv,
                               metric=metric)
    cvals, crows = _masked_candidates(s, mask, c=c)
    return gather_rerank(q, cvals, crows, vectors, metric, k, rerank_dtype)


def _int4_two_stage(q, codes, vmin, scale, vectors, mask, *,
                    metric: DistanceMetric, k: int, c: int,
                    rerank_dtype: str):
    """The whole int4 two-stage search.  The coarse scores come from the
    ``int4_scores`` kernel on CUDA (its plain version on the CPU): the scan
    streams N x D/2 code bytes, half of int8's.  ``q`` keeps the true dims
    for the re-rank; the kernel query is padded to the packed width."""
    s = int4_scores(_pad_queries(q, 2 * codes.shape[1]), codes, vmin, scale,
                    metric=metric)
    cvals, crows = _masked_candidates(s, mask, c=c)
    return gather_rerank(q, cvals, crows, vectors, metric, k, rerank_dtype)


class QuantizedScan:
    """Compressed snapshot of a collection's live rows + 2-stage search."""

    # per-dispatch budget for the int4 coarse (B, N) f32 score block, which
    # the kernel writes to device memory.  4 GB holds the B=1024 x 1M-row
    # block in one dispatch (the main path); larger corpora split the batch
    # so peak memory stays bounded.  Kept at the JAX value rather than
    # derived from free memory: a bigger block buys no speed, since the
    # kernel's time is linear in B*N either way.
    _score_hbm_budget = 4 << 30

    def __init__(self, kind: str, quantizer, codes: torch.Tensor, store,
                 metric: DistanceMetric):
        self.kind = kind
        self.quantizer = quantizer
        self.codes = codes
        self._store = store
        self.metric = metric
        self.default_rerank = {"int8": 4, "int4": 8}.get(kind, 16)
        self.built_count = int(codes.shape[0])
        self.built_n_valid = int(codes.shape[0])
        self.compute_dtype = "float32"
        self._sq_stats = None
        self._valid_key = None

    @classmethod
    def build(cls, collection, kind: str = "int8") -> "QuantizedScan":
        kind = _canonical_kind(kind)
        store = collection._store
        n = store.count
        # train on a bounded strided sample of the live rows (the capacity
        # tail is zero padding), encode the whole capacity buffer: rows
        # past n are masked at search time by built_count
        dev = store.vectors
        t_cap = 262_144
        t_step = max(1, -(-max(n, 1) // t_cap))
        t_idx = torch.arange(0, max(n, 1), t_step,
                             device=dev.device)[:t_cap]
        sample = dev[t_idx].float()
        qz = (ScalarQuantizer() if kind == "int8" else Int4Quantizer())
        qz.train(sample)
        codes = qz.encode(dev)
        scan = cls(kind, qz, codes, store, collection.config.metric)
        scan.built_count = n
        scan.built_n_valid = store.n_valid
        scan.compute_dtype = collection.config.compute_dtype
        return scan

    def _stats(self):
        if self._sq_stats is None:
            self._sq_stats = self.quantizer.corpus_stats(self.codes)
        return self._sq_stats

    def _valid(self, n: int) -> torch.Tensor:
        """Store validity over the snapshot's rows, cached per store
        ``version`` (the validity tensor is updated in place, so its
        identity cannot key the cache)."""
        key = (self._store.version, n, self.built_count)
        if self._valid_key != key:
            v = self._store.valid[:n].clone()
            v[self.built_count:] = False  # appended after the build
            self._valid_cached = v
            self._valid_key = key
        return self._valid_cached

    def search(self, queries, k: int, rerank: Optional[int] = None,
               mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        if rerank is None:
            rerank = self.default_rerank
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        n = int(self.codes.shape[0])
        # cap the int4 kernel's (B, N) f32 output at the budget: split the
        # batch into pow2 sub-batches (int8's product is a library GEMM
        # whose block is the same size, but the JAX package streams it)
        cap = max(8, int(self._score_hbm_budget // (max(n, 1) * 4)))
        sub = 8
        while sub * 2 <= cap:
            sub *= 2
        if self.kind == "int4" and b > sub:
            parts = [self.search(q[s:s + sub], k, rerank, mask)
                     for s in range(0, b, sub)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        device = self.codes.device
        valid = self._valid(n)
        if mask is not None:
            mk = np.asarray(mask[:n], dtype=bool)
            if mk.shape[0] < n:
                mk = np.pad(mk, (0, n - mk.shape[0]))
            m = torch.as_tensor(mk, device=device) & valid
        else:
            m = valid
        c = min(max(k * max(rerank, 1), k), n)
        kk = min(k, c)
        qd = torch.as_tensor(q).to(device)
        if self.compute_dtype == "bfloat16":
            # the JAX package ships bf16 queries in bf16 serving
            qd = qd.bfloat16().float()
        qz = self.quantizer
        if rerank > 1:
            if self.kind == "int8":
                vsq, rinv = self._stats()
                d, r = _int8_two_stage(
                    qd, self.codes, qz.vmin, qz.scale, vsq, rinv,
                    self._store.vectors, m, metric=self.metric, k=kk, c=c,
                    rerank_dtype=self.compute_dtype)
            else:
                d, r = _int4_two_stage(
                    qd, self.codes, qz.vmin, qz.scale, self._store.vectors,
                    m, metric=self.metric, k=kk, c=c,
                    rerank_dtype=self.compute_dtype)
        elif self.kind == "int8":
            vsq, rinv = self._stats()
            d, r = _int8_coarse_topk(qd, self.codes, qz.vmin, qz.scale,
                                     vsq, rinv, m, metric=self.metric, k=kk)
        else:
            d, r = _int4_coarse_topk(qd, self.codes, qz.vmin, qz.scale, m,
                                     metric=self.metric, k=kk)
        return d.cpu().numpy(), r.to(torch.int32).cpu().numpy()

    def tune_rerank(self, queries, target_recall: float = 0.95,
                    k: int = 10, max_rerank: int = 256) -> int:
        """Smallest re-rank factor whose recall@k vs the exact scan clears
        ``target_recall`` on the given queries; also becomes the default."""
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        tail_mask = None
        if self.built_count < self._store.count:
            tail_mask = np.zeros((self._store.count,), dtype=bool)
            tail_mask[: self.built_count] = True
        _, exact_r = self._store.search(q, k, self.metric,
                                        extra_mask=tail_mask,
                                        compute_dtype=self.compute_dtype)
        rerank = 4
        while rerank <= max_rerank:
            _, rows = self.search(q, k, rerank=rerank)
            hits = np.mean([len(set(a.tolist()) & set(e.tolist())) / k
                            for a, e in zip(rows, exact_r)])
            if hits >= target_recall:
                self.default_rerank = rerank
                return rerank
            rerank *= 2
        self.default_rerank = max_rerank
        return max_rerank

    def memory_usage(self) -> dict:
        return self.quantizer.memory_usage(self.built_count)

    # -- persistence (sections inside the collection's FPVT container) ----
    def export_sections(self) -> Tuple[dict, dict]:
        """Codes (real rows only) + quantizer params + tuned defaults, laid
        out exactly as the JAX package writes them."""
        qz = self.quantizer
        sections = {
            "quant_codes": self.codes[:self.built_count].cpu().numpy(),
            "quant_vmin": qz.vmin.cpu().numpy(),
            "quant_scale": qz.scale.cpu().numpy(),
        }
        meta = {"kind": self.kind,
                "default_rerank": int(self.default_rerank),
                "built_count": int(self.built_count),
                "built_n_valid": int(self.built_n_valid),
                "compute_dtype": self.compute_dtype,
                "dims": qz.dims}
        return sections, meta

    @classmethod
    def from_sections(cls, collection, sections: dict, meta: dict
                      ) -> "QuantizedScan":
        kind = _canonical_kind(meta["kind"])
        device = collection._store.device
        qz = (ScalarQuantizer if kind == "int8" else Int4Quantizer)(
            dims=meta["dims"], device=device)
        qz.vmin = as_tensor(np.array(sections["quant_vmin"]), device)
        qz.scale = as_tensor(np.array(sections["quant_scale"]), device)
        codes = torch.as_tensor(np.array(sections["quant_codes"])).to(device)
        # saved codes cover built_count rows; pad to a multiple of 8 (the
        # s8 GEMM's row granularity) as a fresh build's capacity-wide codes
        # are — the padding rows sit past built_count and never rank
        codes = torch.nn.functional.pad(codes, (0, 0, 0, -codes.shape[0] % 8))
        scan = cls(kind, qz, codes, collection._store,
                   collection.config.metric)
        scan.default_rerank = int(meta.get("default_rerank",
                                           scan.default_rerank))
        scan.built_count = int(meta.get("built_count", codes.shape[0]))
        scan.built_n_valid = int(meta.get("built_n_valid",
                                          collection._store.n_valid))
        scan.compute_dtype = meta.get("compute_dtype", "float32")
        return scan
