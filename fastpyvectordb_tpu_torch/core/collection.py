"""Core Collection: CRUD + exact, quantized and IVF search + filters +
persistence (port of ``fastpyvectordb_tpu/core/collection.py``: the exact
scan, the int8 / int4 / binary / pq two-stage scans, IVF, IVF-PQ and the
graph ANN, write-ahead-log durability, the pipelined
``search_arrays_stream``, ``optimize()`` and ``prewarm()``).

Vectors live in a DeviceVectorStore on the collection's torch device
(``device="cuda"`` unless the caller passes ``device="cpu"``).  Filters
compile to host masks that the store moves to the device as ``torch.bool``.
Deletes tombstone the validity mask and ``compact()`` physically reclaims.
Persistence is one FPVT container per collection, byte-compatible with the
JAX package, and goes through ``state.collection_from_sections``.
``as_sharded_searcher`` shards the store over a mesh (dist/sharded.py).
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import topk as topk_mod
from ..persist.format import load_container, save_container
from ..utils import resolve_device
from .filters import ColumnView, Filter
from .store import DeviceVectorStore
from .types import CollectionConfig, DistanceMetric, SearchResult, as_f32_matrix

STORE_FILE = "collection.fpvt"

# the recall knobs of each ANN kind: an explicit one turns auto-tune off
_ANN_KNOBS = {"ivf": ("nprobe",), "ivfpq": ("nprobe", "rerank"),
              "graph": ("beam", "iters")}


def _host(q) -> np.ndarray:
    if isinstance(q, torch.Tensor):
        return q.detach().float().cpu().numpy()
    return np.asarray(q, dtype=np.float32)


class Collection:
    """A named set of vectors with string ids and metadata dicts."""

    def __init__(self, config: CollectionConfig,
                 base_path: Optional[Path] = None, device=None):
        self.device = resolve_device(device)
        self.config = config
        self.base_path = Path(base_path) if base_path is not None else None
        self._lock = threading.RLock()
        self._store = DeviceVectorStore(config.dimensions,
                                        storage_dtype=config.storage_dtype,
                                        device=self.device)
        self._id_to_row: Dict[str, int] = {}
        self._row_to_id: List[Optional[str]] = []
        self._metadata: List[Optional[dict]] = []
        self._version = 0  # bumped on any mutation; invalidates caches
        self._columns: Optional[ColumnView] = None
        self._columns_version = -1
        self._columns_dirty: Optional[str] = None  # None | "sync" | "rebuild"
        self._columns_patchset: set = set()
        self._mask_cache: Dict[str, Tuple[int, np.ndarray]] = {}
        self._ids_arr: Optional[np.ndarray] = None
        self._ids_arr_version = -1
        self._quantized = None  # optional quantized scan (quant/scan.py)
        self._quant_kwargs: dict = {}  # its build recipe, for rebuilds
        self._ann = None  # optional ANN index (ann/: IVF, IVF-PQ, graph)
        self._rebuild_thread: Optional[threading.Thread] = None
        self._row_epoch = 0  # bumped by row renumbering (compact/load)
        self._serving_mode: Optional[str] = None
        self._wal = None  # write-ahead log (persist/wal.py), durability="wal"
        # durability is a runtime preference, not a data property: the
        # constructor's requested value wins over the snapshot's (else
        # enabling the WAL on a snapshot collection would be ignored)
        requested_durability = getattr(config, "durability", "snapshot")
        requested_fsync = getattr(config, "wal_fsync", False)
        if self.base_path is not None and (self.base_path / STORE_FILE).exists():
            self._load()
            self.config.durability = requested_durability
            self.config.wal_fsync = requested_fsync
        # subclass hook (HybridCollection's BM25 snapshot): after the
        # snapshot load, before WAL replay, so replayed mutations layer on
        # top of the loaded sidecar state
        self._after_snapshot_load()
        if self.base_path is not None and requested_durability == "wal":
            # open the log, then re-apply what it holds on top of the
            # snapshot; with snapshot durability a log is left unread, as
            # in the JAX package
            from ..persist.wal import WriteAheadLog
            self._wal = WriteAheadLog(self.base_path / "wal.log",
                                      fsync=requested_fsync)
            self._replay_wal()
        if self.base_path is not None:
            # VectorDB reads durability and dims back from this sidecar
            # before it decides whether to replay a log
            self._write_config_sidecar()

    def _after_snapshot_load(self) -> None:
        """Subclass hook; see __init__."""

    def _write_config_sidecar(self) -> None:
        import dataclasses
        import errno
        import json as _json
        import os
        d = dataclasses.asdict(self.config)
        d["metric"] = DistanceMetric.parse(self.config.metric).value
        payload = _json.dumps(d, default=str)
        target = self.base_path / "config.json"
        try:
            if target.exists() and target.read_text() == payload:
                return
            self.base_path.mkdir(parents=True, exist_ok=True)
            tmp = self.base_path / "config.json.tmp"
            tmp.write_text(payload)
            os.replace(tmp, target)
        except OSError as e:
            # only read-only/permission errors are survivable (opening a
            # snapshot mount must work)
            if e.errno not in (errno.EROFS, errno.EACCES, errno.EPERM):
                raise

    @staticmethod
    def load_config_sidecar(base_path) -> Optional[CollectionConfig]:
        import dataclasses
        import json as _json
        f = Path(base_path) / "config.json"
        if not f.exists():
            return None
        try:
            d = _json.loads(f.read_text())
        except (OSError, _json.JSONDecodeError):
            return None
        names = {fld.name for fld in dataclasses.fields(CollectionConfig)}
        return CollectionConfig(**{k: v for k, v in d.items() if k in names})

    # ------------------------------------------------------------------
    # CRUD
    # ------------------------------------------------------------------
    def insert(self, vector, id: Optional[str] = None,
               metadata: Optional[dict] = None) -> str:
        ids = self.insert_batch(as_f32_matrix(vector, self.config.dimensions),
                                [id] if id is not None else None,
                                [metadata] if metadata is not None else None)
        return ids[0]

    def insert_batch(self, vectors, ids: Optional[Sequence[str]] = None,
                     metadatas: Optional[Sequence[Optional[dict]]] = None
                     ) -> List[str]:
        arr = as_f32_matrix(vectors, self.config.dimensions)
        n = arr.shape[0]
        if ids is None:
            import uuid
            ids = [str(uuid.uuid4()) for _ in range(n)]
        else:
            ids = [str(i) for i in ids]
            if len(ids) != n:
                raise ValueError(f"got {len(ids)} ids for {n} vectors")
            if len(set(ids)) != n:
                raise ValueError("duplicate ids within batch")
        if metadatas is not None and len(metadatas) != n:
            raise ValueError(f"got {len(metadatas)} metadatas for {n} vectors")
        with self._lock:
            dup = [i for i in ids if i in self._id_to_row]
            if dup:
                raise ValueError(f"IDs already exist: {dup[:8]}")
            if self._wal is not None:
                # the caller's f32 rows: a bf16 store rounds them on append,
                # and replay rounds the same rows the same way
                self._wal.log_insert(
                    ids, metadatas if metadatas is not None else [None] * n,
                    arr)
            rows = self._store.append(arr)
            for rid, row in zip(ids, rows):
                self._id_to_row[rid] = int(row)
            self._row_to_id.extend(ids)
            self._metadata.extend(
                [dict(m) if m else {} for m in metadatas]
                if metadatas is not None else [{} for _ in range(n)])
            self._bump(append_only=True)
        return list(ids)

    def upsert(self, vector, id: str, metadata: Optional[dict] = None) -> str:
        return self.upsert2(vector, id, metadata)[0]

    def upsert2(self, vector, id: str, metadata: Optional[dict] = None
                ) -> Tuple[str, bool]:
        """Upsert reporting (id, existed) atomically under the lock:
        callers deciding UPDATE-vs-INSERT semantics must not race a
        separate pre-read against the write."""
        with self._lock:
            existed = id in self._id_to_row
            if existed:
                self.delete(id)
            return self.insert(vector, id, metadata), existed

    def get(self, id: str, include_vector: bool = False) -> Optional[dict]:
        return self.get_batch([id], include_vector)[0]

    def get_batch(self, ids: Sequence[str], include_vectors: bool = False
                  ) -> List[Optional[dict]]:
        with self._lock:
            found = [self._id_to_row.get(str(i)) for i in ids]
            rows = [r for r in found if r is not None]
            vecs = (self._store.get_rows(np.asarray(rows, dtype=np.int64))
                    if include_vectors and rows else None)
            out: List[Optional[dict]] = []
            vi = 0
            for i, r in zip(ids, found):
                if r is None:
                    out.append(None)
                    continue
                d = {"id": str(i), "metadata": dict(self._metadata[r] or {})}
                if include_vectors:
                    d["vector"] = vecs[vi]
                    vi += 1
                out.append(d)
            return out

    def delete(self, id: str) -> bool:
        return self.delete_batch([id]) == 1

    def delete_batch(self, ids: Sequence[str]) -> int:
        with self._lock:
            if self._wal is not None:
                live = [i for i in ids if str(i) in self._id_to_row]
                if live:
                    self._wal.log_delete(live)
            rows = []
            for i in ids:
                r = self._id_to_row.pop(str(i), None)
                if r is not None:
                    rows.append(r)
                    self._row_to_id[r] = None
                    self._metadata[r] = None
            if rows:
                self._store.delete_rows(np.asarray(rows, dtype=np.int64))
                # the quantized snapshot keeps serving: the store validity
                # mask excludes tombstones at search time
                self._bump(keep_indexes=True, patched_rows=rows)
            return len(rows)

    def update_metadata(self, id: str, metadata: dict,
                        merge: bool = True) -> bool:
        with self._lock:
            r = self._id_to_row.get(str(id))
            if r is None:
                return False
            if self._wal is not None:
                self._wal.log_update_metadata(str(id), metadata, merge)
            if merge and self._metadata[r]:
                self._metadata[r] = {**self._metadata[r], **metadata}
            else:
                self._metadata[r] = dict(metadata)
            self._bump(keep_indexes=True, patched_rows=[r])
            return True

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------
    def search(self, query, k: int = 10, filter: Optional[Filter] = None,
               include_vectors: bool = False, exact: Optional[bool] = None
               ) -> List[SearchResult]:
        return self.search_batch(as_f32_matrix(query, self.config.dimensions),
                                 k, filter, include_vectors, exact)[0]

    def search_batch(self, queries, k: int = 10,
                     filter: Optional[Filter] = None,
                     include_vectors: bool = False,
                     exact: Optional[bool] = None
                     ) -> List[List[SearchResult]]:
        q = as_f32_matrix(queries, self.config.dimensions, allow_device=True)
        with self._lock:
            if self._store.n_valid == 0:
                return [[] for _ in range(q.shape[0])]
            dists, rows = self._search_rows(q, k, filter, exact)
            return self._assemble(q, dists, rows, k, include_vectors)

    def search_arrays(self, queries, k: int = 10,
                      filter: Optional[Filter] = None,
                      exact: Optional[bool] = None):
        """Array-shaped search: ``(ids, scores, rows)`` — an object ndarray
        of ids (B, k; None where fewer than k hits), an f32 score grid
        (B, k; +inf on empty slots) and the int32 store rows (-1 empty)."""
        q = as_f32_matrix(queries, self.config.dimensions, allow_device=True)
        with self._lock:
            b = q.shape[0]
            if self._store.n_valid == 0:
                return self._empty_arrays(b, k)
            dists, rows = self._search_rows(q, k, filter, exact)
            return self._arrays_of(dists, rows, k)

    @staticmethod
    def _empty_arrays(b: int, k: int):
        return (np.full((b, k), None, dtype=object),
                np.full((b, k), np.inf, dtype=np.float32),
                np.full((b, k), -1, dtype=np.int32))

    def search_arrays_stream(self, batches, k: int = 10,
                             filter: Optional[Filter] = None,
                             depth: int = 2,
                             wire_dtype: Optional[str] = None):
        """Pipelined ``search_arrays`` over an iterable of query batches:
        yields one (ids, scores, rows) triple per batch, keeping up to
        ``depth`` batches in flight, so batch i+1's upload and kernels are
        queued while batch i's result comes back and is assembled.

        Each batch's queries go up from pinned memory without holding the
        host, and its result comes back into pinned memory by a copy queued
        behind its kernels, followed by an event; draining a batch waits on
        that event alone, never on the whole device.

        wire_dtype: forwarded to the store (``"int8"`` ships 4x-compressed
        query codes; None = bf16 when compute is bf16).  Pipelines the
        exact scan; with a quantized or ANN serving mode installed the
        stream makes one synchronous call a batch instead (still one triple
        per batch) rather than silently changing mode."""
        serving_exact = (self._serving_mode in (None, "exact")
                         and (self.config.index == "flat"
                              or self._ann is None))
        if not serving_exact:
            for q in batches:
                yield self.search_arrays(q, k, filter)
            return
        from collections import deque
        inflight: deque = deque()
        for q in batches:
            q = as_f32_matrix(q, self.config.dimensions, allow_device=True)
            with self._lock:
                if self._store.n_valid == 0:
                    inflight.append((None, q.shape[0]))
                else:
                    dv, rv = self._store.search(
                        q, k, self.config.metric,
                        extra_mask=self._filter_mask(filter),
                        compute_dtype=self.config.compute_dtype,
                        return_device=True, wire_dtype=wire_dtype)
                    inflight.append((self._fetch_async(dv, rv), q.shape[0]))
            if len(inflight) >= max(1, depth):
                yield self._drain_one(inflight, k)
        while inflight:
            yield self._drain_one(inflight, k)

    @staticmethod
    def _fetch_async(dv: torch.Tensor, rv: torch.Tensor):
        """Queue the copy of a result to the host; (vals, rows, event)."""
        if dv.device.type != "cuda":
            return dv.numpy(), rv.to(torch.int32).numpy(), None
        vh = torch.empty(dv.shape, dtype=dv.dtype, pin_memory=True)
        rh = torch.empty(rv.shape, dtype=torch.int32, pin_memory=True)
        vh.copy_(dv, non_blocking=True)
        rh.copy_(rv.to(torch.int32), non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return vh.numpy(), rh.numpy(), done

    def _drain_one(self, inflight, k: int):
        head, b = inflight.popleft()
        if head is None:
            return self._empty_arrays(b, k)
        dists, rows, done = head
        if done is not None:
            done.synchronize()   # this batch's copy, not the whole device
        with self._lock:
            return self._arrays_of(dists, rows, k)

    def _arrays_of(self, dists, rows, k: int):
        """(dists, rows) -> the (ids, scores, rows) triple of
        ``search_arrays``.  Caller holds the lock."""
        dists = np.asarray(dists)[:, :k].astype(np.float32, copy=False)
        rows = np.asarray(rows)[:, :k]
        ok = np.asarray(topk_mod.valid_hits(dists))
        nrow = len(self._row_to_id)
        ok &= (rows >= 0) & (rows < max(nrow, 1))
        if nrow:
            ids = self._ids_object_array()[np.clip(rows, 0, nrow - 1)]
            ok &= ids != None  # noqa: E711 - elementwise
        else:
            ids = np.full(rows.shape, None, dtype=object)
        ids = np.where(ok, ids, None)
        dists = np.where(ok, dists, np.float32(np.inf))
        rows = np.where(ok, rows, -1).astype(np.int32, copy=False)
        return ids, dists, rows

    def metadata_for_rows(self, rows: np.ndarray) -> list:
        """Per-row metadata dict copies for ``search_arrays`` results
        (row < 0 -> None), fetched under the collection lock."""
        with self._lock:
            md = self._metadata
            n = len(md)
            return [[dict(md[r] or {}) if 0 <= r < n else None
                     for r in row] for row in np.asarray(rows).tolist()]

    def brute_force_search(self, query, k: int = 10,
                           filter: Optional[Filter] = None,
                           include_vectors: bool = False
                           ) -> List[SearchResult]:
        """Exact search (always the flat path)."""
        return self.search(query, k, filter, include_vectors, exact=True)

    def _search_rows(self, q, k: int, filter: Optional[Filter],
                     exact: Optional[bool]):
        """Shared dispatch: (ANN | exact masked scan | installed serving
        default) -> (dists, rows).  Caller holds the lock and has handled
        the empty store."""
        if exact is None and self._serving_mode is not None:
            # a serving default saved by the JAX package's optimize();
            # explicit exact=True/False always overrides
            if (self._serving_mode == "quantized"
                    and self._quantized is not None):
                return self._quantized_rows(_host(q), k, None, filter)
            if self._serving_mode == "exact":
                exact = True
            elif self._serving_mode == "ann":
                exact = False
        use_ann = self._ann is not None and (
            exact is False or (exact is None and self.config.index != "flat"))
        mask = self._filter_mask(filter)
        if (use_ann and mask is not None and exact is None
                and int(mask.sum()) <= max(1024, 32 * k)):
            # highly selective filter: the exact masked scan over the few
            # matching rows is both faster and exact, where a filtered ANN
            # pass would collapse recall
            use_ann = False
        if use_ann:
            if self._index_rebuild_due(self._ann) and not self._ann.stale:
                if self.config.rebuild == "inline":
                    self._ann.mark_stale()  # rebuilt inside .search()
                else:
                    # this search (and every one until the swap) serves
                    # through the stale index + exact tail merge
                    self._spawn_rebuild("ann")
            q = _host(q)
            dists, rows = self._ann.search(
                q, k, mask=mask,
                overfetch=self.config.overfetch if filter is not None else 1)
            built = self._ann._built_count
            if self._store.count > built:
                # rows appended after the build: exact-scan them and merge
                # (disjoint row spaces, no dedup needed)
                td, tr = self._tail_exact(q, k, mask, built)
                dists, rows = topk_mod.merge_topk_host(dists, rows, td, tr, k)
            return dists, rows
        return self._store.search(
            q, k, self.config.metric, extra_mask=mask,
            compute_dtype=self.config.compute_dtype)

    def prewarm(self, max_batch: int = 1024, k: int = 10,
                modes: Optional[Sequence[str]] = None) -> Dict[str, float]:
        """Run the serving dispatch once at every power-of-two query batch
        size up to ``max_batch`` (and the one covering it), so that a
        deployment pays its start-up costs before the first request.  On
        the card the first call also builds every hand kernel
        (``cuda_build.build_all``, one ``nvcc`` per source at once), and the
        runs warm the caching allocators and the libraries' handles.

        modes: subset of {"exact", "quantized", "ann"}; defaults to the
        paths this collection has enabled.  Returns {mode_bN: seconds}."""
        import time as _time
        if self._store.n_valid == 0:
            return {}
        if self.device.type == "cuda":
            from ..kernels import cuda_build
            cuda_build.build_all(*cuda_build.all_sources())
        want = set(modes) if modes is not None else None

        def on(name: str, enabled: bool) -> bool:
            return enabled if want is None else (name in want)

        def timed(fn) -> float:
            t0 = _time.perf_counter()
            fn()   # returns host arrays: the device has finished
            return round(_time.perf_counter() - t0, 3)

        rng = np.random.default_rng(0)
        timings: Dict[str, float] = {}
        b = 1
        while not (b > max_batch and b // 2 >= max_batch):
            q = rng.standard_normal(
                (b, self.config.dimensions)).astype(np.float32)
            if on("exact", True):
                timings[f"exact_b{b}"] = timed(
                    lambda: self.search_arrays(q, k=k, exact=True))
            if on("quantized", self._quantized is not None):
                timings[f"quantized_b{b}"] = timed(
                    lambda: self.search_quantized_arrays(q, k=k))
            if on("ann", self._ann is not None):
                timings[f"ann_b{b}"] = timed(
                    lambda: self.search_arrays(q, k=k, exact=False))
            b <<= 1
        return timings

    def _ids_object_array(self) -> np.ndarray:
        """``_row_to_id`` as an object ndarray, memoized per version."""
        if self._ids_arr is None or self._ids_arr_version != self._version \
                or len(self._ids_arr) != len(self._row_to_id):
            self._ids_arr = np.array(self._row_to_id, dtype=object)
            self._ids_arr_version = self._version
        return self._ids_arr

    def _assemble(self, q, dists: np.ndarray, rows: np.ndarray,
                  k: int, include_vectors: bool) -> List[List[SearchResult]]:
        dists = np.asarray(dists)
        rows = np.asarray(rows)
        ok = np.asarray(topk_mod.valid_hits(dists))
        nrow = len(self._row_to_id)
        in_range = (rows >= 0) & (rows < nrow)
        if nrow:
            rid_grid = self._ids_object_array()[np.clip(rows, 0, nrow - 1)]
            ok = ok & in_range & (rid_grid != None)  # noqa: E711
        else:
            ok = ok & in_range
            rid_grid = rows  # unused: ok is all-False
        if include_vectors:
            vecs = self._store.get_rows(
                np.maximum(rows, 0).reshape(-1).astype(np.int64)
            ).reshape(rows.shape[0], rows.shape[1], -1)
        md = self._metadata
        dlist = dists.tolist()
        rlist = rows.tolist()
        idlist = rid_grid.tolist() if nrow else rlist
        all_ok = bool(ok.all())
        full_sel = list(range(min(k, rows.shape[1])))
        results: List[List[SearchResult]] = []
        for bi in range(rows.shape[0]):
            if all_ok:
                sel = full_sel
            else:
                sel = np.nonzero(ok[bi])[0][:k].tolist()
            drow, rrow, irow = dlist[bi], rlist[bi], idlist[bi]
            hits = []
            for ki in sel:
                m = md[rrow[ki]]
                hits.append(SearchResult(
                    id=irow[ki], score=drow[ki],
                    metadata={} if m is None else dict(m),
                    vector=(vecs[bi, ki] if include_vectors else None)))
            results.append(hits)
        return results

    # ------------------------------------------------------------------
    # Filters
    # ------------------------------------------------------------------
    def _column_view(self) -> ColumnView:
        if self._columns is not None and self._columns_version != self._version \
                and self._columns_dirty == "sync":
            self._columns.sync_appended()
            if self._columns_patchset:
                self._columns.patch_rows(sorted(self._columns_patchset))
            self._columns_patchset.clear()
            self._columns_version = self._version
            self._columns_dirty = None
        if self._columns is None or self._columns_version != self._version:
            self._columns = ColumnView(self._metadata)
            self._columns_version = self._version
            self._columns_dirty = None
            self._columns_patchset.clear()
        return self._columns

    def ids_matching(self, filter: Filter) -> List[str]:
        """Ids of live rows whose metadata matches ``filter``: one
        vectorized mask pass."""
        with self._lock:
            mask = self._filter_mask(filter)
            if mask is None:
                return self.all_ids()
            return [rid for rid, hit in zip(self._row_to_id, mask)
                    if hit and rid is not None]

    def _filter_mask(self, filter: Optional[Filter]) -> Optional[np.ndarray]:
        """Compile a Filter to a host boolean mask over rows [0, count),
        cached per (fingerprint, version)."""
        if filter is None:
            return None
        fp = filter.fingerprint()
        cached = self._mask_cache.get(fp)
        if cached is not None and cached[0] == self._version:
            return cached[1]
        mask = filter.mask(self._column_view())
        if len(self._mask_cache) > 64:
            self._mask_cache.clear()
        self._mask_cache[fp] = (self._version, mask)
        return mask

    def _bump(self, append_only: bool = False, keep_indexes: bool = False,
              patched_rows: Optional[Sequence[int]] = None) -> None:
        self._version += 1
        if patched_rows is not None:
            if self._columns_dirty != "rebuild":
                self._columns_patchset.update(int(r) for r in patched_rows)
                self._columns_dirty = "sync"
        elif not append_only:
            self._columns_dirty = "rebuild"
        elif self._columns_dirty != "rebuild":
            self._columns_dirty = "sync"
        if append_only or keep_indexes:
            # appended rows are served by the exact tail merge, deletes by
            # the validity mask; a threshold-triggered rebuild amortizes
            return
        if self._ann is not None:
            self._ann.mark_stale()
        self._quantized = None

    def _index_rebuild_due(self, snapshot) -> bool:
        """True when a snapshot or index built over its built count of
        rows has drifted (tail growth or mass deletes) enough that a
        rebuild beats serving through the merge path."""
        built_count = getattr(snapshot, "_built_count",
                              getattr(snapshot, "built_count", 0))
        built_live = getattr(snapshot, "_built_n_valid",
                             getattr(snapshot, "built_n_valid", built_count))
        tail = self._store.count - built_count
        return (tail > max(built_count // 4, 4096)
                or self._store.n_valid * 2 < built_live)

    def _spawn_rebuild(self, kind: str) -> None:
        """Background rebuild of the ANN index (``kind="ann"``) or the
        quantized snapshot (one in flight per collection): build off-lock
        with the live object's recipe, then swap it in, guarded against
        row renumbering and against the object having been replaced
        meanwhile.  Caller holds the lock."""
        t = self._rebuild_thread
        if t is not None and t.is_alive():
            return
        epoch = self._row_epoch
        if kind == "ann":
            snap = self._ann

            def work():
                new = snap.rebuilt()
                with self._lock:
                    if self._ann is snap and self._row_epoch == epoch:
                        self._ann = new
        else:
            snap = self._quantized
            kw = dict(self._quant_kwargs)

            def work():
                from ..quant.scan import QuantizedScan
                new = QuantizedScan.build(self, kind=snap.kind, **kw)
                new.default_rerank = snap.default_rerank  # tuned depth
                with self._lock:
                    if self._quantized is snap and self._row_epoch == epoch:
                        self._quantized = new

        def runner():
            try:
                work()
            except Exception as e:  # noqa: BLE001 - background best-effort
                import sys
                print(f"background {kind} rebuild failed "
                      f"({type(e).__name__}: {e}); serving continues on "
                      "the stale index + tail merge", file=sys.stderr)

        t = threading.Thread(target=runner, daemon=True,
                             name=f"fpv-rebuild-{self.config.name}")
        self._rebuild_thread = t
        t.start()

    def wait_for_rebuild(self, timeout: Optional[float] = None) -> bool:
        """Block until any in-flight background rebuild finishes (False on
        timeout)."""
        t = self._rebuild_thread
        if t is None or not t.is_alive():
            return True
        t.join(timeout)
        return not t.is_alive()

    def _tail_exact(self, q: np.ndarray, k: int,
                    mask: Optional[np.ndarray], start: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact scan restricted to rows appended after a snapshot."""
        tm = np.zeros((self._store.count,), dtype=bool)
        tm[start:] = True
        if mask is not None:
            tm[: mask.shape[0]] &= mask
        return self._store.search(
            q, k, self.config.metric, extra_mask=tm,
            compute_dtype=self.config.compute_dtype)

    # ------------------------------------------------------------------
    # ANN / quantization
    # ------------------------------------------------------------------
    _AUTOTUNE_MIN_ROWS = 4096

    def _sample_live_queries(self, n: int = 32) -> Optional[np.ndarray]:
        """Deterministic strided sample of live rows (self-query tuning
        set), spread across the corpus."""
        live = self._store.live_rows_host()
        if live.size == 0:
            return None
        take = int(min(n, live.size))
        idx = live[np.linspace(0, live.size - 1, take).astype(np.int64)]
        return self._store.get_rows(idx.astype(np.int64))

    def build_ann(self, kind: str = "ivf", tune: Optional[bool] = None,
                  tune_target: float = 0.95, tune_queries: int = 32,
                  **kwargs) -> None:
        """Build an approximate index: ``"ivf"`` (ann/ivf.py), whose large
        batches go through the grouped cell-score kernels, ``"ivfpq"``
        (ann/ivfpq.py, PQ-coded residual cells, the grouped ADC kernel) or
        ``"graph"`` (ann/graph_ann.py, a k-NN graph and a batched beam
        search; it warns, as the JAX package does).

        By default (``tune=None``) corpora >= 4096 rows with none of the
        kind's recall knobs given (ivf: ``nprobe``; ivfpq: ``nprobe`` or
        ``rerank``; graph: ``beam`` or ``iters``) tune them against the
        exact scan on sampled corpus rows right after the build —
        ``tune_nprobe`` for IVF, the joint ``tune`` for IVF-PQ and the
        graph (the JAX package's behaviour; those self-queries find
        themselves, so pass held-out queries to the index's tuner where
        recall matters).  ``tune=False`` skips it."""
        if kind not in _ANN_KNOBS:
            raise ValueError(f"unknown ANN kind {kind!r}")
        if kind == "graph":
            import warnings
            warnings.warn(
                "build_ann(kind='graph') is experimental: its beam search "
                "runs `iters` dependent rounds of gathers and sorts, and "
                "measured slower than kind='ivf' on an H100 (PERF.md); "
                "prefer kind='ivf'", stacklevel=2)
        if kind == "ivf":
            from ..ann.ivf import IVFIndex as index_cls
        elif kind == "ivfpq":
            from ..ann.ivfpq import IVFPQIndex as index_cls
        else:
            from ..ann.graph_ann import GraphANN as index_cls
        with self._lock:
            self._ann = index_cls.build(self, **kwargs)
            # drift-triggered rebuilds reuse the caller's build parameters
            self._ann._build_kwargs = dict(kwargs)
            self.config.index = kind
            # an explicit knob is the caller's decision: auto-tune never
            # overrides it; only tune=True re-tunes past it
            if tune is None:
                explicit = any(kwargs.get(kb) is not None
                               for kb in _ANN_KNOBS[kind])
                tune = (not explicit
                        and self._store.n_valid >= self._AUTOTUNE_MIN_ROWS)
            if tune:
                qs = self._sample_live_queries(tune_queries)
                if qs is not None:
                    if kind == "ivf":
                        self._ann.tune_nprobe(qs, target_recall=tune_target)
                    else:  # ivfpq and graph expose a joint .tune()
                        self._ann.tune(qs, target_recall=tune_target)

    def set_search_params(self, **params) -> None:
        """Set the ANN index's recall/latency knobs at runtime (IVF and
        IVF-PQ: ``nprobe``, ``rerank``; graph: ``beam``, ``expand``,
        ``iters``, ``n_init``)."""
        with self._lock:
            if self._ann is None:
                raise ValueError("no ANN index built; call build_ann first")
            for key, value in params.items():
                if not hasattr(self._ann, key):
                    raise ValueError(
                        f"{type(self._ann).__name__} has no parameter {key!r}")
                setattr(self._ann, key, int(value))

    def optimize(self, target_recall: float = 0.95, k: int = 10,
                 sample_queries: int = 32, build: bool = True,
                 install: bool = True, serving_batch: int = 256) -> dict:
        """Pick the cheapest serving mode clearing ``target_recall`` on
        sampled self-queries and install it as the default for
        ``search()`` / ``search_batch()`` (explicit ``exact=`` and
        ``search_quantized`` calls always override).

        Candidates: the exact scan (recall 1.0 by construction), the
        quantized two-stage scan (built with its auto-tune if absent and
        ``build=True``) and an IVF / IVF-PQ / graph index already built.
        Recall is measured against the exact f32 scan.  Each mode gets a
        roofline estimate (``core/costmodel.py``, amortized over
        ``serving_batch``); on the card every candidate, warm from the
        recall pass, is also timed once between two
        ``torch.cuda.synchronize()`` calls, and the measured time ranks.
        On the CPU the model ranks.

        Returns ``{mode: {recall, bytes_per_query, cost_us_model,
        cost_us_measured (card only), eligible}}`` plus ``installed``."""
        from . import costmodel as cm

        def recall_at_k(rows, oracle):
            return float(np.mean([
                len(set(a.tolist()) & set(e.tolist())) / max(len(e), 1)
                for a, e in zip(np.asarray(rows), np.asarray(oracle))]))

        dtype_bytes = {"float32": 4, "bfloat16": 2, "float16": 2}
        with self._lock:
            qs = self._sample_live_queries(sample_queries)
            report: Dict[str, dict] = {}
            runners: Dict[str, object] = {}
            n = max(self._store.n_valid, 1)
            d = self.config.dimensions
            store_b = dtype_bytes.get(self.config.storage_dtype, 4)
            compute_dtype = self.config.compute_dtype
            exact_mc = cm.exact_cost(n, d, store_b, compute_dtype,
                                     serving_batch)
            report["exact"] = {"recall": 1.0,
                               "bytes_per_query": float(n * d * store_b),
                               "cost_us_model": exact_mc.cost_us,
                               "eligible": True}
            if qs is None:
                if install:
                    self._serving_mode = "exact"
                report["installed"] = "exact" if install else None
                return report
            _, oracle = self._store.search(
                qs, k, self.config.metric, compute_dtype="float32")
            runners["exact"] = lambda: self._store.search(
                qs, k, self.config.metric, compute_dtype=compute_dtype)

            if (self._quantized is None and build
                    and n >= self._AUTOTUNE_MIN_ROWS):
                self.enable_quantized_scan("int8", tune_target=target_recall)
            if self._quantized is not None:
                _, rows = self._quantized_rows(qs, k, None, None)
                rec = recall_at_k(rows, oracle)
                kind = self._quantized.kind
                code_b = {"int8": d, "int4": (d + 1) // 2,
                          "binary": d // 8,
                          "pq": int(self._quantized.codes.shape[-1])}
                rr = self._quantized.default_rerank
                cb = code_b.get(kind, d)
                qmc = cm.quantized_cost(
                    n, d, kind, cb, store_b, rr * k, serving_batch,
                    pq_k=getattr(self._quantized.quantizer, "k", 16))
                report["quantized"] = {
                    "recall": round(rec, 4),
                    "bytes_per_query": float(n * cb + rr * k * d * store_b),
                    "cost_us_model": qmc.cost_us,
                    "eligible": rec >= target_recall}
                runners["quantized"] = lambda: self._quantized_rows(
                    qs, k, None, None)
            if self._ann is not None and not self._ann.stale:
                _, rows = self._ann.search(qs, k)
                rec = recall_at_k(rows, oracle)
                st = self._ann.stats()
                if st["kind"] == "graph":
                    # the beam search: iters * expand * degree gathered
                    # rows a query (the term counts beam * that, as the
                    # JAX package's does)
                    a = self._ann
                    amc = cm.graph_cost(d, store_b, a.beam, a.iters,
                                        a.expand, st["degree"])
                    ann_b = float(a.iters * a.expand * st["degree"] * d
                                  * store_b + a.beam * d * store_b)
                else:   # the IVF family: probed fraction + overflow
                    nlist = st["nlist"]
                    pq_k = 0
                    if hasattr(self._ann, "codes"):   # IVF-PQ: M bytes a row
                        cell_b = int(self._ann.codes.shape[2])
                        pq_k = int(self._ann.codebooks.shape[1])
                    elif self._ann.quantizer is not None:   # int8 cells
                        cell_b = d
                    else:
                        cell_b = store_b * d
                    nprobe = self._ann.nprobe
                    frac = min(1.0, nprobe / max(nlist, 1))
                    over = int(self._ann.overflow_rows.shape[0])
                    rr = self._ann.rerank
                    amc = cm.ivf_cost(n, d, cell_b, nlist, nprobe, over,
                                      store_b, rr * k, serving_batch,
                                      pq_k=pq_k)
                    ann_b = float((frac * n + over) * cell_b
                                  + rr * k * d * store_b)
                report["ann"] = {
                    "recall": round(rec, 4), "bytes_per_query": ann_b,
                    "cost_us_model": amc.cost_us,
                    "eligible": rec >= target_recall}
                runners["ann"] = lambda: self._ann.search(qs, k)

            if self.device.type == "cuda":
                # measured time ranks: every candidate is warm from its
                # recall pass, and each returns host arrays
                import time as _time
                for mode, run in runners.items():
                    torch.cuda.synchronize(self.device)
                    t0 = _time.perf_counter()
                    run()
                    torch.cuda.synchronize(self.device)
                    report[mode]["cost_us_measured"] = \
                        1e6 * (_time.perf_counter() - t0) / max(len(qs), 1)

            def _rank(m: str) -> float:
                v = report[m]
                return v.get("cost_us_measured", v["cost_us_model"])

            eligible = [m for m, v in report.items() if v.get("eligible")]
            best = min(eligible, key=_rank)
            if install:
                self._serving_mode = best
            report["installed"] = best if install else None
            return report

    def enable_quantized_scan(self, kind: str = "int8",
                              tune: Optional[bool] = None,
                              tune_target: float = 0.95,
                              tune_queries: int = 32, **kwargs):
        """Build the two-stage quantized scan snapshot ("int8", "int4",
        "binary" or "pq").  ``kwargs`` go to the quantizer's training
        (binary ``method=``; pq ``m=``, ``k=``, ...) and are kept for the
        threshold rebuilds.  By default corpora >= 4096 rows tune the
        re-rank depth on sampled self-queries (``tune_rerank``);
        ``tune=False`` skips it."""
        from ..quant.scan import QuantizedScan
        with self._lock:
            self._quantized = QuantizedScan.build(self, kind=kind, **kwargs)
            self._quant_kwargs = dict(kwargs)
            if tune is None:
                tune = self._store.n_valid >= self._AUTOTUNE_MIN_ROWS
            if tune:
                qs = self._sample_live_queries(tune_queries)
                if qs is not None:
                    self._quantized.tune_rerank(qs, target_recall=tune_target)
            return self._quantized

    def search_quantized(self, queries, k: int = 10,
                         rerank: Optional[int] = None,
                         filter: Optional[Filter] = None,
                         include_vectors: bool = False
                         ) -> List[List[SearchResult]]:
        """Two-stage compressed scan -> exact re-rank."""
        q = as_f32_matrix(queries, self.config.dimensions)
        with self._lock:
            if self._store.n_valid == 0 and self._store.count == 0:
                return [[] for _ in range(q.shape[0])]
            dists, rows = self._quantized_rows(q, k, rerank, filter)
            return self._assemble(q, dists, rows, k, include_vectors)

    def search_quantized_arrays(self, queries, k: int = 10,
                                rerank: Optional[int] = None,
                                filter: Optional[Filter] = None):
        """Array-shaped quantized search: the ``(ids, scores, rows)``
        triple of ``search_arrays``."""
        q = as_f32_matrix(queries, self.config.dimensions)
        with self._lock:
            if self._store.n_valid == 0 and self._store.count == 0:
                return self._empty_arrays(q.shape[0], k)
            dists, rows = self._quantized_rows(q, k, rerank, filter)
            return self._arrays_of(dists, rows, k)

    def _quantized_rows(self, q: np.ndarray, k: int,
                        rerank: Optional[int], filter: Optional[Filter]):
        """Shared quantized dispatch -> (dists, rows).  Caller holds the
        lock and has handled the empty store."""
        if self._quantized is None:
            self.enable_quantized_scan()
        elif self._index_rebuild_due(self._quantized):
            if self.config.rebuild == "inline":
                tuned = self._quantized.default_rerank
                self.enable_quantized_scan(kind=self._quantized.kind,
                                           tune=False, **self._quant_kwargs)
                self._quantized.default_rerank = tuned
            else:
                self._spawn_rebuild("quantized")
        mask = self._filter_mask(filter)
        if rerank is None:
            rerank = self._quantized.default_rerank
        dists, rows = self._quantized.search(q, k, rerank=rerank, mask=mask)
        built = self._quantized.built_count
        if self._store.count > built:
            if rerank <= 1:
                # coarse-unit scores: rescore exactly before merging with
                # the exact-unit tail distances
                dists = self._exact_rescore(q, dists, rows)
            td, tr = self._tail_exact(q, k, mask, built)
            dists, rows = topk_mod.merge_topk_host(dists, rows, td, tr, k)
        return dists, rows

    def _exact_rescore(self, q: np.ndarray, dists: np.ndarray,
                       rows: np.ndarray) -> np.ndarray:
        """Exact metric distances for (B, k) candidate rows (host BLAS on a
        tiny gather); masked entries become +inf."""
        from ..kernels.distances import MASKED, host_exact_scores
        rows = np.asarray(rows)
        cand = self._store.get_rows(np.maximum(rows, 0).reshape(-1)) \
            .reshape(rows.shape[0], rows.shape[1], -1)
        out = host_exact_scores(q, cand, self.config.metric)
        bad = (rows < 0) | (np.asarray(dists) >= float(MASKED) * 0.5)
        return np.where(bad, np.inf, out).astype(np.float32)

    def as_sharded_searcher(self, mesh=None):
        """Snapshot this collection into a row-sharded multi-card searcher
        (dist/sharded.py); with no ``mesh``, ``make_mesh()`` over the
        devices of the collection's device type.  The store's power-of-two
        capacity divides any power-of-two mesh, and shards on the store's
        own device are views of its buffers."""
        from ..dist.mesh import make_mesh
        from ..dist.sharded import ShardedSearcher
        with self._lock:
            mesh = mesh or make_mesh(device=self.device.type)
            return ShardedSearcher(
                mesh, self._store.vectors, self._store.valid,
                metric=self.config.metric,
                compute_dtype=self.config.compute_dtype)

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    def count(self) -> int:
        return self._store.n_valid

    def __len__(self) -> int:
        return self.count()

    def list_ids(self, limit: int = 100, offset: int = 0) -> List[str]:
        with self._lock:
            live = [i for i in self._row_to_id if i is not None]
            return live[offset: offset + limit]

    def all_ids(self) -> List[str]:
        with self._lock:
            return [i for i in self._row_to_id if i is not None]

    def stats(self) -> dict:
        return {
            "name": self.config.name,
            "count": self.count(),
            "allocated_rows": self._store.count,
            "capacity": self._store.capacity,
            "dimensions": self.config.dimensions,
            "metric": self.config.metric.value,
            "index": self.config.index,
            "device": str(self.device),
            "device_bytes": int(self._store.capacity * self.config.dimensions
                                * self._store.vectors.element_size()),
        }

    # ------------------------------------------------------------------
    # Maintenance
    # ------------------------------------------------------------------
    def compact(self) -> int:
        """Physically remove tombstones; returns rows reclaimed."""
        with self._lock:
            before = self._store.count
            live = self._store.compact()
            old_ids, old_meta = self._row_to_id, self._metadata
            self._row_to_id = [old_ids[r] for r in live]
            self._metadata = [old_meta[r] for r in live]
            self._id_to_row = {i: j for j, i in enumerate(self._row_to_id)}
            self._row_epoch += 1  # fence out a rebuild over old numbering
            self._bump()
            return before - self._store.count

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------
    def export_sections(self) -> Tuple[dict, dict]:
        """The container sections and meta this collection saves — the
        same layout the JAX package writes."""
        arrays = self._store.export_arrays()
        sections = {"vectors": arrays["vectors"], "valid": arrays["valid"],
                    "ids": self._row_to_id, "metadata": self._metadata}
        meta = {"config": self.config.to_dict(), "kind": "collection"}
        if self._serving_mode is not None:
            meta["serving_mode"] = self._serving_mode
        if self._ann is not None and not self._ann.stale:
            ann_sections, ann_meta = self._ann.export_sections()
            sections.update(ann_sections)
            meta["ann"] = ann_meta
        if self._quantized is not None:
            q_sections, q_meta = self._quantized.export_sections()
            sections.update(q_sections)
            meta["quantized"] = q_meta
        return sections, meta

    def save(self) -> None:
        if self.base_path is None:
            raise ValueError("collection has no base_path; cannot save")
        with self._lock:
            self.base_path.mkdir(parents=True, exist_ok=True)
            sections, meta = self.export_sections()
            save_container(self.base_path / STORE_FILE, sections, meta=meta)
            if self._wal is not None:
                self._wal.truncate()  # the snapshot now covers the log

    def _replay_wal(self) -> None:
        """Re-apply logged mutations on top of the loaded snapshot.

        Replay is forgiving (inserts upsert, deletes and updates of missing
        ids do nothing), so a crash between the snapshot's rename and the
        log's truncation, which leaves records the snapshot covers in the
        log, converges instead of failing on duplicates.  The log is
        swapped out meanwhile, so replay does not log again."""
        from ..persist import wal as W
        wal, self._wal = self._wal, None
        try:
            for op, obj, vecs in wal.replay():
                if op == W.OP_INSERT:
                    if not obj["ids"]:
                        continue
                    dup = [i for i in obj["ids"] if i in self._id_to_row]
                    if dup:
                        self.delete_batch(dup)
                    self.insert_batch(vecs, obj["ids"], obj["metadatas"])
                elif op == W.OP_DELETE:
                    self.delete_batch(
                        [i for i in obj["ids"] if i in self._id_to_row])
                elif op == W.OP_UPDATE_META:
                    self.update_metadata(obj["id"], obj["metadata"],
                                         obj.get("merge", True))
        finally:
            self._wal = wal

    def _load(self) -> None:
        from ..state import restore_into
        c = load_container(self.base_path / STORE_FILE)
        restore_into(self, c.meta, {k: c.read(k) for k in c.keys()})
