"""Device-resident corpus buffer (port of ``fastpyvectordb_tpu/core/store.py``).

The corpus lives on the device as a pre-allocated ``(cap, D)`` tensor with a
row-validity vector and per-row norm caches (squared norms + reciprocal
norms).  Inserts write a block in place, deletes tombstone the validity
vector in place, and ``compact()`` physically reclaims space.

Capacity keeps the JAX package's {2^k, 3*2^(k-1)} ladder (>= 1024) and its
padded write blocks, so row numbering, mask widths and snapshot sizes match
the reference exactly.  PyTorch has no compile cache to reuse, so the
buckets are no longer needed for that; they only bound regrowth copies.

Because writes are in place, the tensor objects survive mutations: caches
keyed on them would go stale.  ``version`` is bumped by every mutation and
is the key of every cache over the validity mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import distances as K
from ..utils import next_pow2 as _next_pow2
from ..utils import resolve_device

MIN_CAPACITY = 1024


def _ladder(n: int) -> int:
    """Smallest value >= n from the {2^k, 3*2^(k-1)} ladder
    (..., 1024, 1536, 2048, 3072, ...)."""
    p = _next_pow2(n)
    h = 3 * p // 4
    return h if n <= h else p


def _next_bucket(n: int) -> int:
    return _ladder(max(n, MIN_CAPACITY))


class DeviceVectorStore:
    """Append-only device buffer of vectors with tombstone deletes."""

    def __init__(self, dims: int, capacity: int = MIN_CAPACITY,
                 storage_dtype: str = "float32", device=None):
        self.dims = int(dims)
        self.storage_dtype = storage_dtype
        self._tdtype = getattr(torch, storage_dtype)
        self.device = resolve_device(device)
        cap = _next_bucket(max(capacity, MIN_CAPACITY))
        self._alloc(cap)
        self.count = 0          # rows ever allocated (high-water mark)
        self.n_valid = 0        # live rows (count minus tombstones)
        self.version = 0        # bumped by every mutation of the buffers
        self._mask_memo: dict = {}  # id(host mask) -> (mask, version, dev)

    def _alloc(self, cap: int) -> None:
        dev = self.device
        self.vectors = torch.zeros((cap, self.dims), dtype=self._tdtype,
                                   device=dev)
        self.valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
        self.sq = torch.zeros((cap,), dtype=torch.float32, device=dev)
        self.rinv = torch.zeros((cap,), dtype=torch.float32, device=dev)

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    def _grow(self, needed: int) -> None:
        old = (self.vectors, self.valid, self.sq, self.rinv)
        self._alloc(_next_bucket(needed))
        for new, prev in zip((self.vectors, self.valid, self.sq, self.rinv),
                             old):
            new[: prev.shape[0]] = prev
        self.version += 1

    def append(self, vecs: np.ndarray) -> np.ndarray:
        """Append a (n, D) float32 batch; returns the assigned row indices.
        The written block is padded to a ladder size like the JAX store's,
        so the same rows exist (zero, invalid) in both packages."""
        n = vecs.shape[0]
        if n == 0:
            return np.empty((0,), dtype=np.int64)
        p = _ladder(max(n, 8))
        if self.count + p > self.capacity:
            self._grow(self.count + p)
        block = torch.zeros((p, self.dims), dtype=torch.float32,
                            device=self.device)
        # "W": a read-only input (a memmapped snapshot) is copied once
        # rather than wrapped as a tensor torch may not write through
        block[:n] = torch.from_numpy(
            np.require(vecs, np.float32, ["C", "W"])).to(self.device)
        s, e = self.count, self.count + p
        self.vectors[s:e] = block.to(self._tdtype)
        self.valid[s:e] = False
        self.valid[s:s + n] = True
        stats = K.corpus_stats(block)   # from the f32 block, as in JAX
        self.sq[s:e] = stats["sq"]
        self.rinv[s:e] = stats["rinv"]
        rows = np.arange(self.count, self.count + n, dtype=np.int64)
        self.count += n
        self.n_valid += n
        self.version += 1
        return rows

    def delete_rows(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return
        rows = rows[(rows >= 0) & (rows < self.capacity)]  # JAX: mode="drop"
        self.valid[torch.as_tensor(rows, device=self.device)] = False
        self.n_valid -= int(rows.size)
        self.version += 1

    def get_rows(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int64)
        if rows.size == 0:
            return np.empty((0, self.dims), dtype=np.float32)
        out = self.vectors[torch.as_tensor(rows, device=self.device)]
        return out.float().cpu().numpy()

    # -- search -----------------------------------------------------------
    def search(self, queries, k: int, metric,
               extra_mask: Optional[np.ndarray] = None,
               compute_dtype: str = "float32",
               return_device: bool = False,
               wire_dtype: Optional[str] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Masked top-k over the live rows.  queries: (B, D) numpy or
        tensor.  Selection is always exact: CUDA has no approximate top-k,
        so ``CollectionConfig.topk`` (kept for the file format) selects
        nothing here — ``"auto"`` is exact off the TPU in the JAX package
        too.

        wire_dtype: how host queries travel to the device.  None ships
        f32, or bf16 demoted on the host when compute is bf16 (the kernel
        rounds to bf16 anyway); ``"int8"`` ships codes with a symmetric
        per-batch scale, dequantised on the device with the JAX package's
        arithmetic (a small, measured ordering cost; opt-in for throughput
        callers).  Host queries go through pinned memory, so the upload
        does not hold the host.

        Returns (dists (B, k'), rows (B, k')) with k' = min(k, capacity):
        numpy (f32, int32), or with ``return_device`` the device tensors
        (f32, int64), for a caller that pipelines and syncs itself."""
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32)
            if compute_dtype == "bfloat16":
                q = q.bfloat16()
        else:
            q = self._upload_queries(
                np.ascontiguousarray(queries, dtype=np.float32),
                "bfloat16" if wire_dtype is None
                and compute_dtype == "bfloat16" else wire_dtype)
        mask = self._combined_mask(extra_mask)
        kk = min(k, self.capacity)
        vals, rows = K.search_kernel(
            q, self.vectors, self.sq, self.rinv, mask, metric=metric, k=kk,
            compute_dtype=compute_dtype)
        if return_device:
            return vals, rows
        return vals.cpu().numpy(), rows.to(torch.int32).cpu().numpy()

    def _upload_queries(self, qh: np.ndarray, wire: Optional[str]
                        ) -> torch.Tensor:
        """Host queries -> device tensor over the chosen wire encoding."""
        scale = None
        if wire == "int8":
            # symmetric per-batch scale: codes = round(q / s), s putting the
            # largest magnitude on +-127
            scale = float(np.abs(qh).max(initial=0.0)) / 127.0 or 1.0
            t = torch.from_numpy(np.clip(np.rint(qh / scale), -127, 127)
                                 .astype(np.int8))
        else:
            t = torch.from_numpy(qh)
            if wire == "bfloat16":
                t = t.bfloat16()   # demoted on the host: half the bytes
        if self.device.type == "cuda":
            t = t.pin_memory()
        q = t.to(self.device, non_blocking=True)
        if scale is not None:
            q = q.float() * torch.tensor(scale, dtype=torch.float32,
                                         device=self.device)
        return q

    def _combined_mask(self, extra_mask: Optional[np.ndarray]):
        """valid AND extra_mask as a device bool tensor, memoized on the
        identity of the caller's host mask and the store ``version`` (the
        validity tensor is updated in place, so its identity is no key)."""
        if extra_mask is None:
            return self.valid
        key = id(extra_mask)
        hit = self._mask_memo.get(key)
        if hit is not None and hit[0] is extra_mask and hit[1] == self.version:
            return hit[2]
        m = np.zeros((self.capacity,), dtype=bool)
        m[: extra_mask.shape[0]] = extra_mask
        dm = self.valid & torch.as_tensor(m, device=self.device)
        if len(self._mask_memo) >= 8:
            self._mask_memo.clear()
        self._mask_memo[key] = (extra_mask, self.version, dm)
        return dm

    # -- maintenance ------------------------------------------------------
    def live_rows_host(self) -> np.ndarray:
        v = self.valid[: self.count].cpu().numpy()
        return np.nonzero(v)[0]

    def compact(self) -> np.ndarray:
        """Physically drop tombstoned rows.  Returns the old rows kept, in
        order (the caller remaps its id <-> row tables)."""
        live = self.live_rows_host()
        vecs = self.get_rows(live)
        self._alloc(_next_bucket(max(live.size, MIN_CAPACITY)))
        self.count = 0
        self.n_valid = 0
        self.version += 1
        self._mask_memo.clear()
        if live.size:
            self.append(vecs)
        return live

    # -- persistence helpers ---------------------------------------------
    def export_arrays(self) -> dict:
        n = self.count
        return {"vectors": self.vectors[:n].float().cpu().numpy(),
                "valid": self.valid[:n].cpu().numpy()}

    @classmethod
    def from_arrays(cls, vectors: np.ndarray, valid: np.ndarray,
                    storage_dtype: str = "float32",
                    device=None) -> "DeviceVectorStore":
        n, d = vectors.shape
        store = cls(d, capacity=max(n, MIN_CAPACITY),
                    storage_dtype=storage_dtype, device=device)
        if n:
            store.append(np.asarray(vectors, dtype=np.float32))
            dead = np.nonzero(~np.asarray(valid, dtype=bool))[0]
            if dead.size:
                store.delete_rows(dead)
        return store
