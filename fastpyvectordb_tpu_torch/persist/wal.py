"""Write-ahead log — crash durability *between* snapshots.

The reference persists only on explicit ``save()`` (vectordb_optimized.py:
306-331): every mutation since the last save is lost on a crash.  This WAL
closes that window.  With ``CollectionConfig.durability == "wal"`` every
mutation appends a checksummed record *before* it is applied; on load the
collection replays the log on top of the last snapshot, and ``save()``
truncates it (snapshot-plus-log, the standard DB recovery scheme).

Record framing (little-endian):

    u32 record_len | u32 crc32(op + payload) | u8 op | payload

Payload = ``u32 json_len | json bytes | raw bytes`` — vector data rides in
the raw tail as float32 rows (no base64 / JSON-number blowup; a 768-d
insert logs 3 KB, not ~18 KB).  Replay is prefix-consistent: the first
truncated or checksum-failing record ends recovery and the file is clipped
to the last good offset, so a crash mid-append can never corrupt state.

This is the port's own copy of ``fastpyvectordb_tpu/persist/wal.py`` (pure
numpy; that package's ``__init__`` imports jax).  The framing, the JSON of
each record and the replay rules are the same, so the same operations
written by either package produce the same ``wal.log`` bytes, and a log
written by one replays in the other.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from pathlib import Path
from typing import Iterator, Optional, Tuple, Union

import numpy as np

OP_INSERT = 1
OP_DELETE = 2
OP_UPDATE_META = 3

_FRAME = struct.Struct("<II")     # record_len (op+payload), crc32
_JLEN = struct.Struct("<I")


def _json_default(v):
    """Lossless where possible: numpy scalars/arrays become native JSON
    numbers/lists (a replayed Filter.gt still compares numerically);
    everything else stringifies — callers should keep metadata
    JSON-serializable (datetimes etc. round-trip as strings, same as the
    snapshot path's metadata serialization)."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return str(v)


class WriteAheadLog:
    """Append-only checksummed mutation log for one collection."""

    def __init__(self, path: Union[str, Path], fsync: bool = False):
        self.path = Path(path)
        self.fsync = fsync
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "ab")

    # -- writing -------------------------------------------------------
    def append(self, op: int, obj: dict, raw: bytes = b"") -> None:
        j = json.dumps(obj, default=_json_default).encode("utf-8")
        body = bytes([op]) + _JLEN.pack(len(j)) + j + raw
        self._f.write(_FRAME.pack(len(body), zlib.crc32(body)) + body)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def log_insert(self, ids, metadatas, vectors: np.ndarray) -> None:
        arr = np.ascontiguousarray(vectors, dtype=np.float32)
        if arr.shape[0] == 0:
            return  # nothing to recover; an empty record would replay oddly
        self.append(OP_INSERT,
                    {"ids": list(ids), "metadatas": list(metadatas),
                     "n": int(arr.shape[0]), "d": int(arr.shape[1])},
                    arr.tobytes())

    def log_delete(self, ids) -> None:
        self.append(OP_DELETE, {"ids": [str(i) for i in ids]})

    def log_update_metadata(self, id: str, metadata: dict,
                            merge: bool) -> None:
        self.append(OP_UPDATE_META,
                    {"id": str(id), "metadata": metadata, "merge": merge})

    # -- recovery ------------------------------------------------------
    def replay(self) -> Iterator[Tuple[int, dict, Optional[np.ndarray]]]:
        """Yield (op, obj, vectors-or-None) for every intact record, then
        clip the file to the last intact offset (torn tail discarded)."""
        self._f.flush()
        good = 0
        with open(self.path, "rb") as f:
            while True:
                head = f.read(_FRAME.size)
                if len(head) < _FRAME.size:
                    break
                rlen, crc = _FRAME.unpack(head)
                # a zero-filled torn tail (delayed allocation) yields
                # rlen=0, crc=0 — and crc32(b'') == 0, so the CRC alone
                # does not catch it; any record too short to hold the op
                # byte + JSON length prefix is torn, not valid
                if rlen < 1 + _JLEN.size:
                    break
                body = f.read(rlen)
                if len(body) < rlen or zlib.crc32(body) != crc:
                    break
                try:
                    op = body[0]
                    (jlen,) = _JLEN.unpack(body[1:1 + _JLEN.size])
                    obj = json.loads(
                        body[1 + _JLEN.size: 1 + _JLEN.size + jlen]
                        .decode("utf-8"))
                    raw = body[1 + _JLEN.size + jlen:]
                    vecs = None
                    if op == OP_INSERT and raw:
                        vecs = np.frombuffer(raw, dtype=np.float32).reshape(
                            obj["n"], obj["d"]).copy()
                except (ValueError, KeyError, UnicodeDecodeError,
                        struct.error):
                    break  # structurally invalid despite CRC: treat as torn
                good = f.tell()
                yield op, obj, vecs
        if self.path.stat().st_size > good:
            with open(self.path, "r+b") as f:
                f.truncate(good)
            self._reopen()

    # -- lifecycle -----------------------------------------------------
    def truncate(self) -> None:
        """Empty the log (called after a snapshot covers its contents)."""
        self._f.close()
        with open(self.path, "wb"):
            pass
        self._f = open(self.path, "ab")

    def size_bytes(self) -> int:
        self._f.flush()
        return self.path.stat().st_size if self.path.exists() else 0

    def _reopen(self) -> None:
        self._f.close()
        self._f = open(self.path, "ab")

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
