"""Unified versioned binary container — the engine's single on-disk format.

The reference scatters state over six ad-hoc formats (JSON + hnswlib .bin,
vectordb_optimized.py:306-331; `PYVDB` blob, binary_persistence.py:39-140;
`PYVEC001` mmap file, parallel_search.py:445-557; graph.json, graph.py:569;
quantizer .npz, quantization.py:196-213; bm25 JSON, hybrid_search.py:247).
This module consolidates all of them into one container:

    magic "FPVT" | u8 version | 3 reserved | u64 header_len |
    JSON header  | 64-byte-aligned raw blocks

The JSON header maps section name -> {kind, dtype, shape, offset, nbytes}.
Sections are either raw ndarrays (zero-copy mmap-able), JSON documents, or
opaque bytes.  Every subsystem (vector store, quantizer codebooks, IVF
layout, graph embeddings, BM25 state) serializes through this one format.

This is the port's own copy of ``fastpyvectordb_tpu/persist/format.py``
(that module cannot be imported without jax, because its package
``__init__`` imports jax): the container, the streaming out-of-core vector
file and the lossy vector compression, all pure numpy.  A file written by
either package loads in the other, byte for byte.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np

def _json_default(o):
    """JSON fallback that keeps numeric types numeric on round-trip.

    ``default=str`` silently turned numpy scalars into strings, so a node
    property of np.float32(1.5) reloaded as "1.5" and dropped out of
    numeric range indexes / equality checks.  Sets become sorted lists
    (deterministic output); anything else still degrades to str.
    """
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, (np.bool_,)):
        return bool(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (set, frozenset)):
        try:
            return sorted(o)
        except TypeError:
            return list(o)
    return str(o)


MAGIC = b"FPVT"
VERSION = 1
ALIGN = 64

SectionValue = Union[np.ndarray, bytes, Any]


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def save_container(path: Union[str, Path], sections: Dict[str, SectionValue],
                   meta: Optional[dict] = None) -> None:
    """Write a container. ndarray values become array sections; bytes become
    bytes sections; anything else is JSON-serialized."""
    path = Path(path)
    header: Dict[str, Any] = {"sections": {}, "meta": meta or {}}
    blobs = []
    offset = 0
    for name, value in sections.items():
        if isinstance(value, np.ndarray):
            arr = np.ascontiguousarray(value)
            # zero-copy buffer view where the dtype allows it: tobytes()
            # duplicates the full array, doubling peak RSS on snapshot
            # save (a 47 GB corpus section would allocate another 47 GB).
            # Custom dtypes (ml_dtypes bfloat16) reject the buffer
            # protocol — only those pay the copy.
            try:
                raw = memoryview(arr).cast("B")
            except (TypeError, ValueError):
                raw = arr.tobytes()
            entry = {"kind": "array", "dtype": str(arr.dtype),
                     "shape": list(arr.shape)}
        elif isinstance(value, (bytes, bytearray)):
            raw = bytes(value)
            entry = {"kind": "bytes"}
        else:
            raw = json.dumps(value, default=_json_default).encode("utf-8")
            entry = {"kind": "json"}
        entry["offset"] = offset
        entry["nbytes"] = len(raw)
        entry["crc32"] = zlib.crc32(raw) & 0xFFFFFFFF
        header["sections"][name] = entry
        blobs.append((offset, raw))
        offset = _align(offset + len(raw))

    hjson = json.dumps(header).encode("utf-8")
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<B3x", VERSION))
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        data_start = _align(f.tell())
        f.write(b"\0" * (data_start - f.tell()))
        for off, raw in blobs:
            f.seek(data_start + off)
            f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class Container:
    """Reader with lazy, optionally memory-mapped section access."""

    def __init__(self, path: Union[str, Path], mmap_arrays: bool = True):
        self.path = Path(path)
        self._mmap = mmap_arrays
        with open(self.path, "rb") as f:
            if f.read(4) != MAGIC:
                raise ValueError(f"{path}: not an FPVT container")
            (version,) = struct.unpack("<B3x", f.read(4))
            if version > VERSION:
                raise ValueError(f"{path}: unsupported version {version}")
            (hlen,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(hlen).decode("utf-8"))
            self._data_start = _align(f.tell())
        self.sections: Dict[str, dict] = header["sections"]
        self.meta: dict = header.get("meta", {})

    def __contains__(self, name: str) -> bool:
        return name in self.sections

    def keys(self):
        return self.sections.keys()

    def read(self, name: str) -> SectionValue:
        entry = self.sections[name]
        off = self._data_start + entry["offset"]
        nbytes = entry["nbytes"]
        if entry["kind"] == "array":
            dtype = np.dtype(entry["dtype"])
            shape = tuple(entry["shape"])
            if self._mmap:
                return np.memmap(self.path, dtype=dtype, mode="r",
                                 offset=off, shape=shape)
            with open(self.path, "rb") as f:
                f.seek(off)
                return np.frombuffer(f.read(nbytes), dtype=dtype).reshape(shape)
        with open(self.path, "rb") as f:
            f.seek(off)
            raw = f.read(nbytes)
        if entry["kind"] == "json":
            return json.loads(raw.decode("utf-8"))
        return raw

    def verify(self, name: Optional[str] = None) -> bool:
        """Recompute section checksums (all sections, or one).  Returns True
        when every checked section matches its stored crc32; sections from
        pre-CRC containers (no crc32 field) are skipped.  Raises ValueError
        naming the first corrupted section."""
        names = [name] if name is not None else list(self.sections)
        unknown = [n for n in names if n not in self.sections]
        if unknown:
            raise ValueError(f"{self.path}: no such section {unknown[0]!r}")
        with open(self.path, "rb") as f:
            for n in names:
                entry = self.sections[n]
                crc = entry.get("crc32")
                if crc is None:
                    continue
                f.seek(self._data_start + entry["offset"])
                raw = f.read(entry["nbytes"])
                if (zlib.crc32(raw) & 0xFFFFFFFF) != crc:
                    raise ValueError(
                        f"{self.path}: section {n!r} failed its CRC32 check "
                        "(file corrupted or truncated)")
        return True


def load_container(path: Union[str, Path], mmap_arrays: bool = True) -> Container:
    return Container(path, mmap_arrays=mmap_arrays)


# ---------------------------------------------------------------------------
# Streaming out-of-core vector file (append-friendly)
# ---------------------------------------------------------------------------

_STREAM_MAGIC = b"FPVS"
_STREAM_HEADER = struct.Struct("<4sBxxxQQ")  # magic, version, n_rows, dims


class StreamingVectorWriter:
    """Append vectors one batch at a time to a flat binary file.

    Layout: 24-byte header, then raw float32 rows.  The row count in the
    header is only advanced *after* the data is flushed, so a crash leaves a
    consistent prefix (fixing the reference's claimed-but-broken atomicity,
    parallel_search.py:438 vs 590-594).  Ids/metadata live in JSONL sidecars
    (`<path>.ids.jsonl` / `<path>.meta.jsonl`, one line per row) flushed on
    every append — so the crash-consistent prefix covers them too, and an
    existing file can be reopened to resume appending (``resume=True``).
    """

    def __init__(self, path: Union[str, Path], dims: int,
                 resume: bool = True):
        self.path = Path(path)
        self.dims = int(dims)
        self.n_rows = 0
        self.ids: list = []
        self.metadata: list = []
        existing = resume and self.path.exists() \
            and self.path.stat().st_size >= _STREAM_HEADER.size
        if existing:
            self._f = open(self.path, "r+b")
            magic, version, n_rows, dims_on_disk = _STREAM_HEADER.unpack(
                self._f.read(_STREAM_HEADER.size))
            if magic != _STREAM_MAGIC:
                raise ValueError(f"{path}: not an FPVS stream")
            if int(dims_on_disk) != self.dims:
                raise ValueError(
                    f"{path}: dims mismatch (file {dims_on_disk}, "
                    f"requested {self.dims})")
            self.n_rows = int(n_rows)
            self.ids, ids_keep = _read_jsonl_sidecar(
                self._ids_path, self.n_rows)
            self.metadata, meta_keep = _read_jsonl_sidecar(
                self._meta_path, self.n_rows)
        else:
            self._f = open(self.path, "w+b")
            self._write_header()
            ids_keep = meta_keep = None
        # sidecar handles: truncate any crash-orphaned lines past n_rows
        # (O(1) when the committed prefix is intact; rewrite otherwise)
        self._ids_f = _open_jsonl_sidecar(self._ids_path, self.ids,
                                          keep_bytes=ids_keep)
        self._meta_f = _open_jsonl_sidecar(self._meta_path, self.metadata,
                                           keep_bytes=meta_keep)

    @property
    def _ids_path(self) -> Path:
        return Path(str(self.path) + ".ids.jsonl")

    @property
    def _meta_path(self) -> Path:
        return Path(str(self.path) + ".meta.jsonl")

    def _write_header(self) -> None:
        self._f.seek(0)
        self._f.write(_STREAM_HEADER.pack(_STREAM_MAGIC, 1, self.n_rows, self.dims))
        self._f.flush()

    def append(self, vector: np.ndarray, id: Optional[str] = None,
               metadata: Optional[dict] = None) -> None:
        self.append_batch(np.asarray(vector, dtype=np.float32)[None, :],
                          [id] if id is not None else None,
                          [metadata] if metadata is not None else None)

    def append_batch(self, vectors: np.ndarray, ids=None, metadatas=None) -> None:
        arr = np.ascontiguousarray(vectors, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != self.dims:
            raise ValueError(f"expected (n, {self.dims}) batch, got {arr.shape}")
        n = arr.shape[0]
        ids = list(ids) if ids is not None else [None] * n
        metadatas = list(metadatas) if metadatas is not None else [None] * n
        if len(ids) != n or len(metadatas) != n:
            raise ValueError("ids/metadatas length mismatch with batch")
        self._f.seek(_STREAM_HEADER.size + self.n_rows * self.dims * 4)
        self._f.write(arr.tobytes())
        # sidecars flush *before* the row-count advances: a crash mid-append
        # leaves extra sidecar lines (trimmed by n_rows on read) rather than
        # counted rows with missing ids
        for fh, values in ((self._ids_f, ids), (self._meta_f, metadatas)):
            fh.write("".join(json.dumps(v, default=_json_default) + "\n"
                             for v in values))
            fh.flush()
            os.fsync(fh.fileno())
        self._f.flush()
        os.fsync(self._f.fileno())
        self.n_rows += n
        self._write_header()
        self.ids.extend(ids)
        self.metadata.extend(metadatas)

    def close(self) -> None:
        if self._f.closed:
            return
        self._write_header()
        self._f.close()
        self._ids_f.close()
        self._meta_f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _read_jsonl_sidecar(path: Path, n_rows: int):
    """First ``n_rows`` JSONL lines (crash-orphaned suffix lines ignored),
    padded with None up to ``n_rows``.  Falls back to the round-1 whole-list
    ``.json`` sidecar if the JSONL file does not exist.

    Returns ``(rows, keep_bytes)`` where keep_bytes is the byte offset just
    past the last kept line (None when the file must be rewritten — legacy
    format or missing): truncating there trims a crash-orphaned suffix in
    O(1) instead of re-serializing every committed line on reopen."""
    out: list = []
    keep_bytes = None
    if path.exists():
        keep_bytes = 0
        with open(path, "rb") as f:
            for raw in f:
                if len(out) >= n_rows:
                    break
                line = raw.strip()
                if line:
                    out.append(json.loads(line))
                    keep_bytes = f.tell()
    else:
        legacy = Path(str(path)[: -len(".jsonl")] + ".json")
        if legacy.exists():
            out = json.loads(legacy.read_text())[:n_rows]
    if len(out) < n_rows:        # short sidecar: pad + full rewrite
        keep_bytes = None
    out.extend([None] * (n_rows - len(out)))
    return out, keep_bytes


def _open_jsonl_sidecar(path: Path, rows: list, keep_bytes=None):
    """(Re)open a sidecar for appending.  With ``keep_bytes`` (the byte
    offset past the last committed line) the crash-orphaned suffix is
    trimmed with one truncate; otherwise the file is rewritten from the
    committed rows so legacy-format content can never misalign lines."""
    if keep_bytes is not None and path.exists():
        f = open(path, "r+", encoding="utf-8")
        f.truncate(keep_bytes)
        f.seek(0, os.SEEK_END)
        return f
    f = open(path, "w", encoding="utf-8")
    if rows:
        f.write("".join(json.dumps(v, default=_json_default) + "\n" for v in rows))
        f.flush()
        os.fsync(f.fileno())
    return f


class StreamingVectorReader:
    """Random-access / iterator reader over a StreamingVectorWriter file."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            magic, version, n_rows, dims = _STREAM_HEADER.unpack(
                f.read(_STREAM_HEADER.size))
        if magic != _STREAM_MAGIC:
            raise ValueError(f"{path}: not an FPVS stream")
        self.n_rows = int(n_rows)
        self.dims = int(dims)
        self._mm = np.memmap(self.path, dtype=np.float32, mode="r",
                             offset=_STREAM_HEADER.size,
                             shape=(self.n_rows, self.dims))
        ids_jsonl = Path(str(self.path) + ".ids.jsonl")
        ids_json = Path(str(self.path) + ".ids.json")
        self.ids = (_read_jsonl_sidecar(ids_jsonl, self.n_rows)[0]
                    if ids_jsonl.exists() or ids_json.exists() else None)
        meta_jsonl = Path(str(self.path) + ".meta.jsonl")
        meta_json = Path(str(self.path) + ".meta.json")
        self.metadata = (_read_jsonl_sidecar(meta_jsonl, self.n_rows)[0]
                         if meta_jsonl.exists() or meta_json.exists()
                         else None)

    def load_batch(self, start: int, count: int) -> np.ndarray:
        return np.array(self._mm[start: start + count])

    def __len__(self) -> int:
        return self.n_rows

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(self.n_rows):
            yield np.array(self._mm[i])

    def close(self) -> None:
        del self._mm

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Lossy vector compression (reference: binary_persistence.py:333-385)
# ---------------------------------------------------------------------------

def compress_vectors(vectors: np.ndarray, method: str = "none"):
    """Returns (payload ndarray, params dict).  Methods: none | fp16 | int8."""
    v = np.asarray(vectors, dtype=np.float32)
    if method == "none":
        return v, {"method": "none"}
    if method == "fp16":
        return v.astype(np.float16), {"method": "fp16"}
    if method == "int8":
        vmin = float(v.min()) if v.size else 0.0
        vmax = float(v.max()) if v.size else 1.0
        scale = (vmax - vmin) / 255.0 or 1.0
        q = np.clip(np.round((v - vmin) / scale), 0, 255).astype(np.uint8)
        return q, {"method": "int8", "min": vmin, "scale": scale}
    raise ValueError(f"unknown compression method {method!r}")


def decompress_vectors(payload: np.ndarray, params: dict) -> np.ndarray:
    method = params.get("method", "none")
    if method == "none":
        return np.asarray(payload, dtype=np.float32)
    if method == "fp16":
        return np.asarray(payload, dtype=np.float32)
    if method == "int8":
        return payload.astype(np.float32) * params["scale"] + params["min"]
    raise ValueError(f"unknown compression method {method!r}")
