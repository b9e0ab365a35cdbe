"""Binary wire protocol for the hot serving endpoints.

JSON is the cost of the hot endpoints: a 768-d f32 query is ~25 KB of
decimal text but 3 KB of raw bytes, and a 256-query batch is ~6 MB of JSON
the event loop must parse before the device sees anything.  This module
carries them as msgpack envelopes whose vector/score
payloads are raw little-endian float32 buffers, negotiated by
Content-Type so the JSON API (reference parity: server.py:366-389) keeps
working unchanged.

Request  (``Content-Type: application/msgpack``)::

    {"vector":  <raw f32le bytes, D>        | [floats],   # /search
     "vectors": <raw f32le bytes, B*D>      | [[floats]], # /search/batch
     "k": int, "mode": "auto|exact|ann|quantized",
     "where": {...} | "filter_tree": {...},
     "include_metadata": bool (default false)}

Response (same content type)::

    {"ids":    [str|None ...] | [[str|None ...]],
     "scores": <raw f32le bytes, (B*)k>,    # +inf padding on empty slots
     "took_ms": float, ("metadata": [dict|None ...] nested like ids)}

Insert   (``POST .../vectors/batch``)::

    {"vectors": <raw f32le bytes, B*D>, "ids": [...], "metadatas": [...]}

The scores buffer is positionally aligned with ids; clients reshape with
``np.frombuffer(scores, '<f4').reshape(-1, k)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:
    import msgpack
    HAS_MSGPACK = True
except ImportError:  # pragma: no cover - msgpack is baked into the env
    HAS_MSGPACK = False
    msgpack = None

MSGPACK_TYPES = ("application/msgpack", "application/x-msgpack")


def is_binary(request) -> bool:
    return HAS_MSGPACK and request.content_type in MSGPACK_TYPES


def unpack(body: bytes) -> dict:
    obj = msgpack.unpackb(body, raw=False, strict_map_key=False)
    if not isinstance(obj, dict):
        raise ValueError("msgpack body must be a map")
    return obj


def pack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def decode_matrix(value, dims: int, field: str = "vectors") -> np.ndarray:
    """(B, dims) f32 from raw bytes or a nested list."""
    if isinstance(value, (bytes, bytearray, memoryview)):
        buf = np.frombuffer(value, dtype="<f4")
        if dims <= 0 or buf.size % dims:
            raise ValueError(
                f"{field}: {buf.size * 4} bytes is not a whole number of "
                f"{dims}-d float32 rows")
        return buf.reshape(-1, dims)
    arr = np.asarray(value, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2 or arr.shape[1] != dims:
        raise ValueError(f"{field}: expected (*, {dims}), got {arr.shape}")
    return arr


def decode_vector(value, dims: int) -> np.ndarray:
    """(dims,) f32 from raw bytes or a list."""
    m = decode_matrix(value, dims, field="vector")
    if m.shape[0] != 1:
        raise ValueError(f"vector: expected a single {dims}-d row")
    return m[0]


def encode_scores(scores: np.ndarray) -> bytes:
    return np.ascontiguousarray(scores, dtype="<f4").tobytes()


def ids_to_lists(ids: np.ndarray) -> list:
    """Object ndarray (B, k) of str|None → nested lists (msgpack-ready)."""
    return [list(row) for row in ids]


def search_response(ids: np.ndarray, scores: np.ndarray, took_ms: float,
                    metadata: Optional[list] = None,
                    single: bool = False) -> bytes:
    out = {"ids": list(ids[0]) if single else ids_to_lists(ids),
           "scores": encode_scores(scores[0] if single else scores),
           "took_ms": round(took_ms, 3)}
    if metadata is not None:
        out["metadata"] = metadata[0] if single else metadata
    return pack(out)
