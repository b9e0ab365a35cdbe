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

This is a copy of ``fastpyvectordb_tpu/persist/format.py``'s container
half (that module cannot be imported without jax, because its
package ``__init__`` imports jax): a file written by either package loads
in the other.  The streaming out-of-core writer/reader is not on the
ported path yet.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Union

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
