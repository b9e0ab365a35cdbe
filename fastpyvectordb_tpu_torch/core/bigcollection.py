"""BigCollection: corpora beyond device memory on one card — host vectors,
device codes (port of ``fastpyvectordb_tpu/core/bigcollection.py``).

  * full-precision vectors live on the HOST (any (N, D) float32 array-like:
    ndarray, np.memmap, np.load(..., mmap_mode="r"));
  * a compressed snapshot lives on the DEVICE — 1-bit packed codes (32x,
    row-major (cap, W) int32 words, as the Hamming kernels read them), int4
    packed nibbles (8x, quant/int4.py) or int8 codes (4x) — so the coarse
    scan over ALL rows runs on the card: the fused ``s8_topc`` kernel
    (folded int8 product, scores and top-C in one pass), ``int4_scores``,
    or ``hamming_mxu_scores``;
  * search = device coarse scan + top-C -> host gather of C candidate rows
    -> exact f32 re-rank on host BLAS -> top-k.

Appends encode incrementally into pre-allocated power-of-two device code
buffers, written in place under the lock (no rebuild); deletes are
validity-mask tombstones; metadata filters compile to masks fused into the
coarse scan, exactly like the core Collection.  The (B, rows) coarse score
block of the int4 and binary codecs is bounded: the code buffer is scanned
in row chunks of at most ``_score_budget`` bytes of scores, each with its
own top-C, and the chunks' candidates are merged (the merged top-C is the
same function).  The fused int8 scan writes no block and scans the whole
buffer at once (up to its ``TOPC_MAX`` candidates; past it, as the
others).

The files (``bigcollection.fpvt`` + ``vectors.npy``) are the JAX package's:
a collection saved by either package loads in the other.  Codes are not
saved; they are re-encoded on load.

Recall note: 1-bit codes collapse near-duplicate rows onto identical sign
patterns, so the candidate count (k * rerank) must exceed the typical
same-code mass.  If your corpus has huge tight clusters, raise ``rerank``
(or use the int8 codec, which keeps 8 bits/dim of resolution).
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..kernels.distances import MASKED, host_exact_scores, smallest_k
from ..kernels.hamming_kernels import hamming_mxu_scores
from ..kernels.s8_kernels import TOPC_MAX
from ..persist.format import load_container, save_container
from ..quant.binary import BinaryQuantizer
from ..quant.int4 import Int4Quantizer
from ..quant.scalar import ScalarQuantizer, as_tensor
from ..quant.scan import (QuantizedScan, _int4_coarse_topk, _int8_coarse_topk,
                          _masked_candidates)
from ..utils import resolve_device
from .filters import ColumnView, Filter
from .types import DistanceMetric, SearchResult, as_f32_matrix

MIN_CAP = 4096
STORE_FILE = "bigcollection.fpvt"
VECTORS_FILE = "vectors.npy"
_ENCODE_ROWS = 1_000_000     # rows re-encoded at a time (load, retrain)
_QUANTIZERS = {"binary": BinaryQuantizer, "int4": Int4Quantizer,
               "int8": ScalarQuantizer}


def _next_pow2(n: int) -> int:
    p = MIN_CAP
    while p < n:
        p <<= 1
    return p


class BigCollection:
    """Host-resident vectors + device-resident compressed serving codes."""

    # bytes of f32 coarse scores per scan chunk: the budget of the
    # two-stage scans (one B=1024 x 1M-row block)
    _score_budget = QuantizedScan._score_hbm_budget

    def __init__(self, dims: int, metric: "DistanceMetric | str" = "cosine",
                 codec: str = "binary", name: str = "big",
                 base_path: Optional[Path] = None,
                 train_rows: int = 200_000, rerank: int = 16, device=None):
        if codec not in _QUANTIZERS:
            raise ValueError(
                f"unknown codec {codec!r} (binary | int8 | int4)")
        self.name = name
        self.dims = int(dims)
        self.metric = DistanceMetric.parse(metric)
        self.codec = codec
        self.rerank = rerank
        self.train_rows = train_rows
        self.base_path = Path(base_path) if base_path is not None else None
        self.device = resolve_device(device)
        self._lock = threading.RLock()

        self._vectors: Optional[np.ndarray] = None  # host (N_cap, D) f32
        self._count = 0
        self._valid = np.zeros(0, dtype=bool)       # host, length count
        self._row_to_id: List[Optional[str]] = []
        self._id_to_row: Dict[str, int] = {}
        self._metadata: List[Optional[dict]] = []
        self._columns: Optional[ColumnView] = None

        self._qz = None            # trained codec
        self._trained_rows: Optional[int] = None    # None once loaded
        # device: binary (cap, W) int32 / int8 (cap, D) / int4 (cap, W) uint8
        self._codes: Optional[torch.Tensor] = None
        self._code_cap = 0
        self._sq_stats = None      # int8: (vsq, rinv) device tensors, len cap
        self._dvalid: Optional[torch.Tensor] = None  # device bool (cap,)

        if self.base_path is not None and \
                (self.base_path / STORE_FILE).exists():
            self._load()

    # ------------------------------------------------------------------
    def count(self) -> int:
        return int(self._valid[:self._count].sum())

    def __len__(self) -> int:
        return self.count()

    def all_ids(self) -> List[str]:
        return [i for i in self._row_to_id if i is not None]

    # ------------------------------------------------------------------
    # Ingest
    # ------------------------------------------------------------------
    def insert_batch(self, vectors, ids: Optional[Sequence[str]] = None,
                     metadatas: Optional[Sequence[Optional[dict]]] = None
                     ) -> List[str]:
        v = as_f32_matrix(vectors, self.dims)
        n = v.shape[0]
        if ids is None:
            ids = [f"{self.name}-{self._count + i}" for i in range(n)]
        ids = list(ids)
        if len(ids) != n:
            raise ValueError(f"got {len(ids)} ids for {n} vectors")
        if metadatas is not None and len(metadatas) != n:
            raise ValueError(f"got {len(metadatas)} metadatas for {n} vectors")
        if len(set(ids)) != n:
            raise ValueError("duplicate ids within the batch")
        with self._lock:
            dup = [i for i in ids if i in self._id_to_row]
            if dup:
                raise ValueError(f"duplicate ids: {dup[:5]}"
                                 + ("..." if len(dup) > 5 else ""))
            self._grow_host(self._count + n)
            self._vectors[self._count:self._count + n] = v
            total = self._count + n
            trained = total if self._trained_rows is None \
                else self._trained_rows
            if self._qz is None:
                self._train(self._vectors[:total])
                self._trained_rows = total
            elif (total >= 8 * trained
                  and (self._trained_rows or 0) < self.train_rows):
                # the codec was trained on a much smaller prefix (e.g. a
                # single first row -> degenerate scale/thresholds and
                # near-random coarse ordering); retrain on the grown
                # corpus and re-encode.  Triggers O(log N) times total.
                self._train(self._vectors[:total])
                self._trained_rows = total
                self._encode_rows(self._vectors, self._count)
            self._append_codes(v)
            start = self._count
            self._count += n
            self._valid = np.concatenate(
                [self._valid, np.ones(n, dtype=bool)])
            for j, rid in enumerate(ids):
                self._id_to_row[rid] = start + j
            self._row_to_id.extend(ids)
            self._metadata.extend(metadatas if metadatas is not None
                                  else [None] * n)
            self._columns = None
            # incremental device-validity update: only a capacity change
            # forces a capacity-sized rebuild + upload
            if (self._dvalid is None
                    or self._dvalid.shape[0] != self._code_cap):
                self._sync_dvalid()
            else:
                self._dvalid[start:start + n] = True
        return ids

    def insert(self, vector, id: Optional[str] = None,
               metadata: Optional[dict] = None) -> str:
        return self.insert_batch(as_f32_matrix(vector, self.dims),
                                 None if id is None else [id],
                                 None if metadata is None else [metadata])[0]

    def delete(self, id: str) -> bool:
        return self.delete_batch([id]) == 1

    def delete_batch(self, ids: Sequence[str]) -> int:
        with self._lock:
            rows = [self._id_to_row.pop(i) for i in ids
                    if i in self._id_to_row]
            for r in rows:
                self._valid[r] = False
                self._row_to_id[r] = None
                self._metadata[r] = None
            if rows:
                self._columns = None
                if (self._dvalid is None
                        or self._dvalid.shape[0] != self._code_cap):
                    self._sync_dvalid()
                else:  # point tombstones, O(len(rows)) not O(capacity)
                    self._dvalid[torch.as_tensor(
                        np.asarray(rows, dtype=np.int64),
                        device=self.device)] = False
            return len(rows)

    def get(self, id: str, include_vector: bool = False) -> Optional[dict]:
        row = self._id_to_row.get(id)
        if row is None:
            return None
        out = {"id": id, "metadata": self._metadata[row] or {}}
        if include_vector:
            out["vector"] = np.array(self._vectors[row])
        return out

    # ------------------------------------------------------------------
    # Search: device coarse scan -> host gather -> exact host re-rank
    # ------------------------------------------------------------------
    def search(self, query, k: int = 10, filter: Optional[Filter] = None,
               rerank: Optional[int] = None) -> List[SearchResult]:
        return self.search_batch(query, k, filter, rerank)[0]

    def search_batch(self, queries, k: int = 10,
                     filter: Optional[Filter] = None,
                     rerank: Optional[int] = None
                     ) -> List[List[SearchResult]]:
        q = as_f32_matrix(queries, self.dims)
        with self._lock:
            if self.count() == 0:
                return [[] for _ in range(q.shape[0])]
            fmask = (filter.mask(self._column_view())
                     if filter is not None else None)
            c = min(max(k * (rerank or self.rerank), k),
                    int(self._valid.sum()))
            mask = self._device_mask(fmask)
            cvals, crows = self._coarse(q, c, mask)        # (B, C) host
            # host gather + exact re-rank: the only full-precision bytes a
            # query ever touches
            safe = np.clip(crows, 0, self._count - 1)
            cand = self._vectors[safe.reshape(-1)].reshape(
                q.shape[0], -1, self.dims)                  # (B, C, D) f32
            # a selective filter can match fewer rows than c: the coarse
            # top-c then contains MASKED picks whose clipped indices are
            # arbitrary rows — screen them by coarse value, not just by
            # validity (quant/scan.py's cand_ok contract)
            ok = (cvals < float(MASKED) * 0.5) & np.take(self._valid, safe)
            if fmask is not None:
                ok &= np.take(fmask, safe)
            dists = host_exact_scores(q, cand, self.metric)  # (B, C)
            dists = np.where(ok, dists, np.inf)
            order = np.argsort(dists, axis=1)[:, :k]
            top_d = np.take_along_axis(dists, order, axis=1)
            top_r = np.take_along_axis(safe, order, axis=1)
            results: List[List[SearchResult]] = []
            for bi in range(q.shape[0]):
                hits: List[SearchResult] = []
                for ki in range(top_d.shape[1]):
                    if not np.isfinite(top_d[bi, ki]):
                        continue
                    row = int(top_r[bi, ki])
                    rid = self._row_to_id[row]
                    if rid is None:
                        continue
                    hits.append(SearchResult(
                        id=rid, score=float(top_d[bi, ki]),
                        metadata=self._metadata[row] or {}))
                results.append(hits)
            return results

    # ------------------------------------------------------------------
    def memory_usage(self) -> dict:
        n = self._count
        host = n * self.dims * 4
        if self.codec == "binary":
            per_row = (self._codes.shape[1] * 4
                       if self._codes is not None else 0)
        elif self.codec == "int4":
            per_row = (self._codes.shape[1]
                       if self._codes is not None else (self.dims + 1) // 2)
        else:
            per_row = self.dims
        dev = n * per_row
        cap_dev = self._code_cap * per_row
        return {"rows": n, "host_vector_bytes": host,
                "device_code_bytes": dev,
                "device_code_capacity_bytes": cap_dev,
                "compression": round(host / max(dev, 1), 1)}

    def stats(self) -> dict:
        return {"kind": "bigcollection", "codec": self.codec,
                "rows": self._count, "live": self.count(),
                **self.memory_usage()}

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------
    def _grow_host(self, needed: int) -> None:
        cap = 0 if self._vectors is None else self._vectors.shape[0]
        if needed <= cap:
            return
        new_cap = _next_pow2(needed)
        grown = np.empty((new_cap, self.dims), np.float32)
        if self._count:
            grown[:self._count] = self._vectors[:self._count]
        self._vectors = grown

    def _train(self, sample: np.ndarray) -> None:
        # strided sample (not the prefix): an ingestion-ordered corpus
        # would otherwise train on one drifted slice
        step = max(1, sample.shape[0] // self.train_rows)
        s = np.ascontiguousarray(sample[::step][:self.train_rows])
        self._qz = _QUANTIZERS[self.codec](device=self.device).train(s)

    def _encode_rows(self, vectors, rows: int) -> None:
        """(Re-)encode the first ``rows`` host rows through the current
        codec into fresh code buffers, a block of rows at a time (after a
        retrain, and on load)."""
        self._codes, self._code_cap, self._sq_stats = None, 0, None
        count_bak, self._count = self._count, 0
        for st in range(0, rows, _ENCODE_ROWS):
            block = np.asarray(vectors[st:min(st + _ENCODE_ROWS, rows)],
                               dtype=np.float32)
            self._append_codes(block)
            self._count += block.shape[0]
        self._count = count_bak
        self._dvalid = None  # capacity may have changed; rebuild lazily

    def _append_codes(self, v: np.ndarray) -> None:
        """Encode new rows on the device into the pre-allocated code
        buffer (grown to the next power of two when full)."""
        at, n = self._count, v.shape[0]
        new = self._qz.encode(v)        # (n, W) int32 | (n, D) int8 | uint8
        if at + n > self._code_cap:
            cap = _next_pow2(at + n)
            old, old_stats = self._codes, self._sq_stats
            self._codes = torch.zeros((cap, new.shape[1]), dtype=new.dtype,
                                      device=self.device)
            if old is not None and at:
                self._codes[:at] = old[:at]
            if self.codec == "int8":
                self._sq_stats = tuple(
                    torch.zeros((cap,), device=self.device) for _ in "vr")
                if old_stats is not None and at:
                    for grown, prev in zip(self._sq_stats, old_stats):
                        grown[:at] = prev[:at]
            self._code_cap = cap
        self._codes[at:at + n] = new
        if self.codec == "int8":
            for buf, part in zip(self._sq_stats, self._qz.corpus_stats(new)):
                buf[at:at + n] = part

    def _sync_dvalid(self) -> None:
        m = np.zeros(self._code_cap, dtype=bool)
        m[:self._count] = self._valid[:self._count]
        self._dvalid = torch.as_tensor(m).to(self.device)

    def _device_mask(self, fmask: Optional[np.ndarray]) -> torch.Tensor:
        if self._dvalid is None:
            self._sync_dvalid()
        if fmask is None:
            return self._dvalid
        m = np.zeros(self._code_cap, dtype=bool)
        m[:self._count] = self._valid[:self._count] & fmask[:self._count]
        return torch.as_tensor(m).to(self.device)

    def _column_view(self) -> ColumnView:
        if self._columns is None:
            self._columns = ColumnView(self._metadata)
        return self._columns

    def _coarse(self, q: np.ndarray, c: int, mask: torch.Tensor):
        """Coarse top-c over the whole code buffer -> host (vals, rows),
        (B, c) each.  Scanned in row chunks whose (B, rows) f32 score block
        stays inside ``_score_budget``; one chunk covers the buffer until
        B x capacity outgrows it, and always for the fused int8 scan (no
        block) while c <= ``TOPC_MAX``."""
        qd = torch.as_tensor(q).to(self.device)
        qz = self._qz
        if self.codec == "binary":
            qcodes = qz.encode(qd)                         # (B, W)

            def top(s, e, kk):
                return _masked_candidates(
                    hamming_mxu_scores(qcodes, self._codes[s:e]), mask[s:e],
                    c=kk)
        elif self.codec == "int4":
            def top(s, e, kk):
                return _int4_coarse_topk(qd, self._codes[s:e], qz.vmin,
                                         qz.scale, mask[s:e],
                                         metric=self.metric, k=kk)
        else:
            vsq, rinv = self._sq_stats

            def top(s, e, kk):
                return _int8_coarse_topk(qd, self._codes[s:e], qz.vmin,
                                         qz.scale, vsq[s:e], rinv[s:e],
                                         mask[s:e], metric=self.metric, k=kk)

        step = MIN_CAP
        while step * 2 * q.shape[0] * 4 <= self._score_budget:
            step *= 2
        if self.codec == "int8" and c <= TOPC_MAX:
            step = self._code_cap
        vals, rows = [], []
        for s in range(0, self._code_cap, step):
            e = min(s + step, self._code_cap)
            v, r = top(s, e, min(c, e - s))
            vals.append(v)
            rows.append(r + s)
        if len(vals) > 1:
            v, r = torch.cat(vals, dim=1), torch.cat(rows, dim=1)
            vals, pos = smallest_k(v, c)
            rows = torch.take_along_dim(r, pos, dim=1)
        else:
            vals, rows = vals[0], rows[0]
        return vals.cpu().numpy(), rows.cpu().numpy()

    # ------------------------------------------------------------------
    # Persistence: container for ids/meta/codec, raw .npy for vectors
    # (np.load(..., mmap_mode="r") keeps reloads lazy at any scale)
    # ------------------------------------------------------------------
    def save(self) -> None:
        if self.base_path is None:
            raise ValueError("BigCollection has no base_path; cannot save")
        with self._lock:
            self.base_path.mkdir(parents=True, exist_ok=True)
            # After _load(), self._vectors may still be a read-only memmap
            # of vectors.npy itself; np.save would truncate the backing
            # file before reading the mapped pages.  Write to a temp file
            # and atomically swap.
            tmp = self.base_path / "vectors.tmp.npy"  # .npy: np.save keeps it
            np.save(tmp, self._vectors[:self._count])
            os.replace(tmp, self.base_path / VECTORS_FILE)
            if self.codec == "binary":
                qz_sections = {
                    "thresholds": self._qz.thresholds.cpu().numpy()}
            else:
                qz_sections = {"vmin": self._qz.vmin.cpu().numpy(),
                               "scale": self._qz.scale.cpu().numpy()}
            save_container(
                self.base_path / STORE_FILE,
                {"ids": self._row_to_id, "metadata": self._metadata,
                 "valid": self._valid[:self._count], **qz_sections},
                meta={"kind": "bigcollection", "name": self.name,
                      "dims": self.dims, "metric": self.metric.value,
                      "codec": self.codec, "count": self._count,
                      "rerank": self.rerank})

    def _load(self) -> None:
        c = load_container(self.base_path / STORE_FILE)
        meta = c.meta
        self.name = meta["name"]
        self.dims = int(meta["dims"])
        self.metric = DistanceMetric.parse(meta["metric"])
        self.codec = meta["codec"]
        self.rerank = int(meta.get("rerank", 16))
        vecs = np.load(self.base_path / VECTORS_FILE, mmap_mode="r")
        n = int(meta["count"])
        # host copy stays a memmap until the first append forces growth
        self._vectors = vecs
        self._count = n
        # np.array (copy): the container reader hands back a read-only
        # buffer view, and delete_batch writes into _valid in place
        self._valid = np.array(c.read("valid"), dtype=bool)
        self._row_to_id = list(c.read("ids"))
        self._metadata = list(c.read("metadata"))
        self._id_to_row = {i: j for j, i in enumerate(self._row_to_id)
                           if i is not None}
        qz = _QUANTIZERS[self.codec](dims=self.dims, device=self.device)
        if self.codec == "binary":
            qz.thresholds = as_tensor(np.array(c.read("thresholds")),
                                      self.device)
        else:
            qz.vmin = as_tensor(np.array(c.read("vmin")), self.device)
            qz.scale = as_tensor(np.array(c.read("scale")), self.device)
        self._qz = qz
        # re-encode the serving codes on the device, a block at a time
        self._encode_rows(vecs, n)
        self._sync_dvalid()
