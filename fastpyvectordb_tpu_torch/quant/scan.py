"""Two-stage quantized scan: compressed first pass -> exact re-rank (port of
``fastpyvectordb_tpu/quant/scan.py``: the int8, int4, binary and pq kinds).

  stage 1: quantized distances over all rows + masked top-c candidates
           (int8: the fused ``s8_topc`` kernel, folded s8 x s8 product,
           scores, mask and a running top-c in one pass, no (B, N) block;
           int4: the ``int4_scores`` kernel; binary: the packed-Hamming
           ``hamming_mxu_scores`` kernel; pq: the ADC table scan; each of
           these writes its block, then ``torch.topk``);
  stage 2: gather the candidates' rows and apply the exact metric, then
           the final top-k.

Candidate selection is exact in f32 (``torch.topk``, or the int8 scan's
fused top-c, which gives the same sorted scores): the TPU's approximate
top-k (``lax.approx_max_k``) has no CUDA counterpart, and the JAX package
itself selects exactly off the TPU.  int8, int4 and binary run the JAX
package's fused single-dispatch pipelines on every device, re-ranking in
the collection's ``compute_dtype``; pq runs its general path (f32
re-rank), as the JAX package does everywhere.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import DistanceMetric
from ..kernels.distances import MASKED, smallest_k
from ..kernels.hamming_kernels import hamming_mxu_scores, hamming_scores
from ..kernels.quant_kernels import int4_scores
from ..kernels.s8_kernels import TOPC_MAX
from ..kernels.topk import masked_top_k
from ..profiling import annotate
from ..utils import next_pow2
from .binary import BinaryQuantizer, _encode as _binary_encode
from .binary import from_uint32, to_uint32
from .int4 import Int4Quantizer, _pad_queries
from .product import ProductQuantizer, _encode as _pq_encode
from .scalar import ScalarQuantizer, as_tensor, int8_topc

_KIND_ALIASES = {"int8": "int8", "sq": "int8", "scalar": "int8",
                 "int4": "int4", "sq4": "int4",
                 "binary": "binary", "bq": "binary", "hamming": "binary",
                 "pq": "pq", "product": "pq"}
# the kinds whose two-stage search is one fused pipeline (the JAX package
# ships their queries in bf16 under bf16 serving)
_FUSED = ("int8", "int4", "binary")
_PQ_ENCODE_ROWS = 65536


def _canonical_kind(kind: str) -> str:
    if kind not in _KIND_ALIASES:
        raise ValueError(f"unknown quantized scan kind {kind!r}")
    return _KIND_ALIASES[kind]


def _masked_candidates(s, mask, *, c: int):
    """Masked top-c candidate selection on the (B, N) scores, exact in f32
    (the JAX package's TPU path selects approximately in bf16; its exact
    re-rank then restores the order — here nothing needs restoring)."""
    if mask is not None:
        s = s.masked_fill_(~mask[None, :], float(MASKED))
    return smallest_k(s, c)


def _int8_coarse_topk(q, codes, vmin, scale, vsq, rinv, mask, *,
                      metric: DistanceMetric, k: int):
    """int8 scan + masked top-k (the rerank<=1 path): one fused
    ``s8_topc`` pass."""
    return int8_topc(q, codes, vmin, scale, vsq, rinv, mask, c=k,
                     metric=metric)


def _int4_coarse_topk(q, codes, vmin, scale, mask, *,
                      metric: DistanceMetric, k: int):
    """int4 scan (``int4_scores``) + masked top-k."""
    s = int4_scores(_pad_queries(q, 2 * codes.shape[1]), codes, vmin, scale,
                    metric=metric)
    return _masked_candidates(s, mask, c=k)


def _hamming_coarse_topk(qcodes, codes, mask, *, k: int,
                         chunk: int = 262_144):
    """Packed-Hamming scan (``hamming_scores``) + masked top-k, chunked over
    N with a per-chunk top-k and a final merge: bounded memory at any
    corpus size.  Returns (Hamming counts as f32, rows)."""
    n = codes.shape[0]
    vals, rows = [], []
    for s in range(0, n, chunk):
        sc = hamming_scores(qcodes, codes[s:s + chunk]).float()
        if mask is not None:
            sc.masked_fill_(~mask[None, s:s + chunk], float(MASKED))
        v, i = smallest_k(sc, min(k, sc.shape[1]))
        vals.append(v)
        rows.append(i + s)
    v, i = torch.cat(vals, dim=1), torch.cat(rows, dim=1)
    top, pos = smallest_k(v, min(k, v.shape[1]))
    return top, torch.take_along_dim(i, pos, dim=1)


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
    """The whole int8 two-stage search: the fused folded s8 scan with
    its top-c candidates (``s8_topc``) -> gather -> exact re-rank -> final
    top-k."""
    with annotate("fpv.scan.coarse"):
        cvals, crows = int8_topc(q, codes, vmin, scale, vsq, rinv, mask,
                                 c=c, metric=metric)
    with annotate("fpv.scan.rerank"):
        return gather_rerank(q, cvals, crows, vectors, metric, k,
                             rerank_dtype)


def _int4_two_stage(q, codes, vmin, scale, vectors, mask, *,
                    metric: DistanceMetric, k: int, c: int,
                    rerank_dtype: str):
    """The whole int4 two-stage search.  The coarse scores come from the
    ``int4_scores`` kernel on CUDA (its plain version on the CPU): the scan
    streams N x D/2 code bytes, half of int8's.  ``q`` keeps the true dims
    for the re-rank; the kernel query is padded to the packed width."""
    with annotate("fpv.scan.coarse"):
        s = int4_scores(_pad_queries(q, 2 * codes.shape[1]), codes, vmin,
                        scale, metric=metric)
        cvals, crows = _masked_candidates(s, mask, c=c)
    with annotate("fpv.scan.rerank"):
        return gather_rerank(q, cvals, crows, vectors, metric, k,
                             rerank_dtype)


def _binary_two_stage(q, thresholds, codes, vectors, mask, *, dims: int,
                      metric: DistanceMetric, k: int, c: int,
                      rerank_dtype: str):
    """The whole binary two-stage search: query sign bits -> Hamming scan
    (the ``hamming_mxu_scores`` kernel on CUDA, over the snapshot's own
    row-major words) -> top-c candidates -> gather -> exact re-rank."""
    with annotate("fpv.scan.coarse"):
        s = hamming_mxu_scores(_binary_encode(q, thresholds, dims=dims),
                               codes)
        cvals, crows = _masked_candidates(s, mask, c=c)
    with annotate("fpv.scan.rerank"):
        return gather_rerank(q, cvals, crows, vectors, metric, k,
                             rerank_dtype)


def _pq_encode_rows(vectors: torch.Tensor, codebooks: torch.Tensor, *,
                    normalize: bool) -> torch.Tensor:
    """PQ codes of a whole (capacity) buffer, encoded on its device a block
    of rows at a time; cosine snapshots encode the normalized rows."""
    out = torch.empty((vectors.shape[0], codebooks.shape[0]),
                      dtype=torch.uint8, device=vectors.device)
    for s in range(0, vectors.shape[0], _PQ_ENCODE_ROWS):
        x = vectors[s:s + _PQ_ENCODE_ROWS].float()
        if normalize:
            x = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True),
                                min=1e-30)
        out[s:s + _PQ_ENCODE_ROWS] = _pq_encode(x, codebooks)
    return out


def _fetch(d: torch.Tensor, r: torch.Tensor
           ) -> Tuple[np.ndarray, np.ndarray]:
    """The result's host copies (the host waits for the card here)."""
    with annotate("fpv.scan.fetch"):
        return d.cpu().numpy(), r.to(torch.int32).cpu().numpy()


def _normalized_host(q: np.ndarray) -> np.ndarray:
    """Rows over their norms, in numpy exactly as the JAX package does."""
    qn = np.linalg.norm(q, axis=-1, keepdims=True)
    return q / np.maximum(qn, 1e-30)


class QuantizedScan:
    """Compressed snapshot of a collection's live rows + 2-stage search."""

    # per-dispatch budget for the coarse (B, N) score block of the
    # kernel-scored kinds (int4, binary; int8 above the fused scan's
    # TOPC_MAX), which their kernels write to device memory.  4 GB holds the
    # B=1024 x 1M-row block in one dispatch; larger corpora split the batch
    # so peak memory stays bounded.  Kept at the JAX value rather than
    # derived from free memory: a bigger block buys no speed, since the
    # kernels' time is linear in B*N either way.  The fused int8 scan
    # writes no block and takes any batch whole.
    _score_hbm_budget = 4 << 30

    def __init__(self, kind: str, quantizer, codes: torch.Tensor, store,
                 metric: DistanceMetric):
        self.kind = kind
        self.quantizer = quantizer
        self.codes = codes
        self._store = store
        self.metric = metric
        # 1-bit Hamming orders clustered corpora coarsely and needs a deep
        # candidate pool (the JAX package's default); tune_rerank overrides
        self.default_rerank = {"int8": 4, "int4": 8,
                               "binary": 128}.get(kind, 16)
        self.built_count = int(codes.shape[0])
        self.built_n_valid = int(codes.shape[0])
        self.compute_dtype = "float32"
        self._sq_stats = None
        self._valid_key = None

    @classmethod
    def build(cls, collection, kind: str = "int8",
              **kwargs) -> "QuantizedScan":
        """Train on a strided sample of the live rows and encode the whole
        capacity buffer (rows past the build-time count are masked at
        search time).  ``kwargs`` go to the quantizer's training, as in the
        JAX package: binary ``method`` / ``fixed_threshold``; pq ``m``,
        ``k``, ``iters``, ``sample``, ``seed``; int8 and int4 ignore them."""
        kind = _canonical_kind(kind)
        store = collection._store
        n = store.count
        metric = collection.config.metric
        dev = store.vectors
        t_cap = 262_144
        t_step = max(1, -(-max(n, 1) // t_cap))
        t_idx = torch.arange(0, max(n, 1), t_step,
                             device=dev.device)[:t_cap]
        sample = dev[t_idx].float()
        if kind in ("int8", "int4"):
            qz = ScalarQuantizer() if kind == "int8" else Int4Quantizer()
            qz.train(sample)
            codes = qz.encode(dev)
        elif kind == "binary":
            # per-dim thresholds from numpy on the host, as in the JAX
            # package: the same sample gives bit-identical codes
            qz = BinaryQuantizer(device=dev.device).train(
                sample.cpu().numpy(), **kwargs)
            codes = qz.encode(dev)
        else:
            # PQ ADC distances are squared L2: cosine encodes the
            # normalized corpus (L2 order over unit vectors is cosine
            # order; the exact re-rank restores true scores), dot has no
            # such reduction
            if metric == DistanceMetric.DOT:
                raise ValueError(
                    "kind='pq' supports cosine/l2 collections only; the "
                    "squared-L2 ADC ordering is wrong for dot — use "
                    "kind='int8' for dot-metric collections")
            cosine = metric == DistanceMetric.COSINE
            kw = dict(kwargs)
            qz = ProductQuantizer(m=kw.pop("m", 8), k=kw.pop("k", 256),
                                  device=dev.device)
            if cosine:
                sample = sample / torch.clamp(
                    torch.linalg.norm(sample, dim=1, keepdim=True),
                    min=1e-30)
            qz.train(sample.cpu().numpy(), **kw)
            codes = _pq_encode_rows(dev, qz.codebooks, normalize=cosine)
        scan = cls(kind, qz, codes, store, metric)
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

    def coarse_distances(self, q) -> torch.Tensor:
        """(B, N) first-stage distances of the queries to every code row:
        the quantized metric (int8, int4), Hamming counts (binary) or
        squared-L2 ADC (pq; cosine queries normalized first)."""
        q = np.ascontiguousarray(q, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        qz = self.quantizer
        if self.kind == "int8":
            return qz.distances(q, self.codes, metric=self.metric,
                                stats=self._stats())
        if self.kind == "int4":
            return qz.distances(q, self.codes, metric=self.metric)
        if self.kind == "binary":
            return qz.hamming_distances(q, self.codes).float()
        if self.metric == DistanceMetric.COSINE:
            q = _normalized_host(q)
        return qz.distances(q, self.codes)

    def search(self, queries, k: int, rerank: Optional[int] = None,
               mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        with annotate("fpv.scan.search"):
            return self._search(queries, k, rerank, mask)

    def _search(self, queries, k: int, rerank: Optional[int],
                mask: Optional[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        if rerank is None:
            rerank = self.default_rerank
        q = np.ascontiguousarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        b = q.shape[0]
        n = int(self.codes.shape[0])
        c = min(max(k * max(rerank, 1), k), n)
        # cap a kernel-written (B, N) 4-byte score block at the budget:
        # split the batch into pow2 sub-batches (the fused int8 scan, like
        # XLA's fusion in the JAX package, writes none)
        cap = max(8, int(self._score_hbm_budget // (max(n, 1) * 4)))
        sub = 8
        while sub * 2 <= cap:
            sub *= 2
        writes_block = self.kind != "int8" or c > TOPC_MAX
        if self.kind in _FUSED and writes_block and b > sub:
            parts = [self._search(q[s:s + sub], k, rerank, mask)
                     for s in range(0, b, sub)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        device = self.codes.device
        with annotate("fpv.scan.upload"):
            valid = self._valid(n)
            if mask is not None:
                mk = np.asarray(mask[:n], dtype=bool)
                if mk.shape[0] < n:
                    mk = np.pad(mk, (0, n - mk.shape[0]))
                m = torch.as_tensor(mk, device=device) & valid
            else:
                m = valid
            qd = torch.as_tensor(q).to(device)
        kk = min(k, c)
        qz = self.quantizer
        vectors = self._store.vectors
        if rerank > 1 and self.kind in _FUSED:
            # the fused pipelines; bf16 serving ships their queries in bf16
            # (the JAX package's q_dev()), every other path keeps f32
            qf = qd.bfloat16().float() if self.compute_dtype == "bfloat16" \
                else qd
            common = dict(metric=self.metric, k=kk, c=c,
                          rerank_dtype=self.compute_dtype)
            if self.kind == "int8":
                vsq, rinv = self._stats()
                d, r = _int8_two_stage(qf, self.codes, qz.vmin, qz.scale,
                                       vsq, rinv, vectors, m, **common)
            elif self.kind == "int4":
                d, r = _int4_two_stage(qf, self.codes, qz.vmin, qz.scale,
                                       vectors, m, **common)
            else:
                d, r = _binary_two_stage(qf, qz.thresholds, self.codes,
                                         vectors, m, dims=qz.dims, **common)
            return _fetch(d, r)
        # the general path (pq, and rerank <= 1): coarse top-c in f32
        with annotate("fpv.scan.coarse"):
            if self.kind == "int8":
                vsq, rinv = self._stats()
                cvals, crows = _int8_coarse_topk(qd, self.codes, qz.vmin,
                                                 qz.scale, vsq, rinv, m,
                                                 metric=self.metric, k=c)
            elif self.kind == "int4":
                cvals, crows = _int4_coarse_topk(qd, self.codes, qz.vmin,
                                                 qz.scale, m,
                                                 metric=self.metric, k=c)
            elif self.kind == "binary":
                cvals, crows = _hamming_coarse_topk(
                    qz.encode(qd), self.codes, m, k=c,
                    chunk=int(min(262_144, next_pow2(n))))
            else:
                cvals, crows = masked_top_k(self.coarse_distances(q), c, m)
        if rerank <= 1:
            return _fetch(cvals[:, :k], crows[:, :k])
        # only pq re-ranks here, in f32 as the JAX package's _rerank does
        with annotate("fpv.scan.rerank"):
            d, r = gather_rerank(qd, cvals, crows, vectors, self.metric, kk,
                                 "float32")
        return _fetch(d, r)

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
        out exactly as the JAX package writes them (binary words as
        uint32)."""
        qz = self.quantizer
        codes = self.codes[:self.built_count]
        sections = {"quant_codes": (to_uint32(codes) if self.kind == "binary"
                                    else codes.cpu().numpy())}
        meta = {"kind": self.kind,
                "default_rerank": int(self.default_rerank),
                "built_count": int(self.built_count),
                "built_n_valid": int(self.built_n_valid),
                "compute_dtype": self.compute_dtype}
        if self.kind in ("int8", "int4"):
            sections["quant_vmin"] = qz.vmin.cpu().numpy()
            sections["quant_scale"] = qz.scale.cpu().numpy()
            meta["dims"] = qz.dims
        elif self.kind == "binary":
            sections["quant_thresholds"] = qz.thresholds.cpu().numpy()
            meta["dims"] = qz.dims
        else:
            sections["quant_codebooks"] = qz.codebooks.cpu().numpy()
            meta.update(dims=qz.dims, m=qz.m, k=qz.k)
        return sections, meta

    @classmethod
    def from_sections(cls, collection, sections: dict, meta: dict
                      ) -> "QuantizedScan":
        kind = _canonical_kind(meta["kind"])
        device = collection._store.device
        if kind in ("int8", "int4"):
            qz = (ScalarQuantizer if kind == "int8" else Int4Quantizer)(
                dims=meta["dims"], device=device)
            qz.vmin = as_tensor(np.array(sections["quant_vmin"]), device)
            qz.scale = as_tensor(np.array(sections["quant_scale"]), device)
        elif kind == "binary":
            qz = BinaryQuantizer(dims=meta["dims"], device=device)
            qz.thresholds = as_tensor(np.array(sections["quant_thresholds"]),
                                      device)
        else:
            qz = ProductQuantizer(dims=meta["dims"], m=meta["m"],
                                  k=meta["k"], device=device)
            qz.codebooks = as_tensor(np.array(sections["quant_codebooks"]),
                                     device)
        if kind == "binary":
            codes = from_uint32(sections["quant_codes"], device)
        else:
            codes = torch.as_tensor(np.array(sections["quant_codes"])
                                    ).to(device)
        # saved codes cover built_count rows; pad them back to the store's
        # capacity as a fresh build's codes are (and at least to a multiple
        # of 8, the s8 GEMM's row granularity) — the padding rows sit past
        # built_count and never rank.  Same-shaped score blocks make the
        # top-c cut keep the same rows among tied coarse scores (Hamming
        # counts tie massively) before and after a reload.
        n_codes = codes.shape[0]
        codes = torch.nn.functional.pad(codes, (
            0, 0, 0, max(collection._store.capacity - n_codes,
                         -n_codes % 8)))
        scan = cls(kind, qz, codes, collection._store,
                   collection.config.metric)
        scan.default_rerank = int(meta.get("default_rerank",
                                           scan.default_rerank))
        scan.built_count = int(meta.get("built_count", codes.shape[0]))
        scan.built_n_valid = int(meta.get("built_n_valid",
                                          collection._store.n_valid))
        scan.compute_dtype = meta.get("compute_dtype", "float32")
        return scan
