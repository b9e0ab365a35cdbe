"""Native (C++) host runtime components, loaded via ctypes.

The reference's only native code is the third-party hnswlib index; here the
ANN index runs on the card, and the native layer instead accelerates the
host-side runtime:

  * ``bm25.cpp`` — BM25 inverted index + tokenizer (bit-identical scores
    to the JAX package's Python scorer, ``hybrid/bm25.py``);
  * ``graph.cpp`` — CSR graph traversal (multi-source BFS with hop
    distances, shortest path, seed-attributed expansion) for large
    property graphs (graphdb/graph.py uses it past a size threshold).

Shared libraries auto-build with g++ on first use into
``<build root>/native`` (``buildroot.py``: ``<repo>/build`` unless set),
named by a hash of the source and the flags; without a toolchain
``available()`` / ``graph_available()`` are False and every caller keeps
its pure-Python path.  This is host code: the card is not involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import buildroot

_DIR = Path(__file__).parent
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_SRC = _DIR / "bm25.cpp"
_GRAPH_SRC = _DIR / "graph.cpp"
_lock = threading.Lock()
_lib = None
_graph_lib = None
_build_failed = False
_graph_build_failed = False


_TOKEN_RE = re.compile(r"\b\w+\b")


def tokenize(text: str) -> List[str]:
    """The BM25 tokenizer (a copy of the JAX package's
    ``hybrid/bm25.py:tokenize``): lowercase ``\\b\\w+\\b`` words."""
    return _TOKEN_RE.findall(text.lower())


def _so_path(src: Path) -> Path:
    tag = hashlib.sha256(src.read_bytes()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return buildroot.path("native") / f"lib{src.stem}_{tag}.so"


def _build(src: Path) -> Optional[Path]:
    """The built library of ``src`` (compiled unless present), or None if
    g++ is missing or fails.  The compiler writes a file of this process
    that is renamed into place, so concurrent builds never load a
    half-written library."""
    out = _so_path(src)
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None


def load_library() -> Optional[ctypes.CDLL]:
    """Build (once) and load the native library; None if unavailable."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = _build(_SRC)
        if so is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _build_failed = True
            return None
        lib.bm25_create.restype = ctypes.c_void_p
        lib.bm25_create.argtypes = [ctypes.c_double, ctypes.c_double]
        lib.bm25_destroy.argtypes = [ctypes.c_void_p]
        lib.bm25_add_document.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                          ctypes.c_char_p]
        lib.bm25_remove_document.restype = ctypes.c_int
        lib.bm25_remove_document.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.bm25_n_docs.restype = ctypes.c_uint64
        lib.bm25_n_docs.argtypes = [ctypes.c_void_p]
        lib.bm25_n_terms.restype = ctypes.c_uint64
        lib.bm25_n_terms.argtypes = [ctypes.c_void_p]
        lib.bm25_avg_doc_len.restype = ctypes.c_double
        lib.bm25_avg_doc_len.argtypes = [ctypes.c_void_p]
        lib.bm25_idf.restype = ctypes.c_double
        lib.bm25_idf.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.bm25_score.restype = ctypes.c_double
        lib.bm25_score.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint32]
        lib.bm25_search.restype = ctypes.c_int
        lib.bm25_search.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_uint32),
                                    ctypes.POINTER(ctypes.c_double)]
        lib.bm25_tokenize.restype = ctypes.c_int
        lib.bm25_tokenize.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_int]
        lib.bm25_export_size.restype = ctypes.c_int64
        lib.bm25_export_size.argtypes = [ctypes.c_void_p]
        lib.bm25_export.restype = ctypes.c_int64
        lib.bm25_export.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int64]
        lib.bm25_import.restype = ctypes.c_void_p
        lib.bm25_import.argtypes = [ctypes.c_double, ctypes.c_double,
                                    ctypes.c_char_p, ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


class NativeBM25:
    """Drop-in for hybrid.bm25.BM25Index backed by the C++ engine.

    String doc ids map to dense uint32 handles on the Python side; the
    native index owns postings, doc lengths, and scoring.
    """

    def __init__(self, k1: float = 1.5, b: float = 0.75):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.k1, self.b = k1, b
        self._h = lib.bm25_create(k1, b)
        self._id_to_u32: Dict[str, int] = {}
        self._u32_to_id: List[Optional[str]] = []

    @staticmethod
    def _norm(text: str) -> bytes:
        """Unicode-correct normalization BEFORE the byte-level C++
        tokenizer: the Python regex tokenizer lowercases and splits on
        Unicode punctuation ('École—Bar' -> ['école', 'bar']), which a
        bytewise ASCII tokenizer cannot — so tokenize HERE and hand C++
        space-joined tokens (pure-ASCII separators keep the engines
        bit-identical on any input)."""
        return " ".join(tokenize(text)).encode("utf-8")

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.bm25_destroy(self._h)
        except Exception:
            pass

    # -- interface parity with hybrid.bm25.BM25Index -------------------
    @property
    def n_docs(self) -> int:
        return int(self._lib.bm25_n_docs(self._h))

    @property
    def avg_doc_len(self) -> float:
        return float(self._lib.bm25_avg_doc_len(self._h))

    def add_document(self, doc_id: str, text: str) -> None:
        u = self._id_to_u32.get(doc_id)
        if u is None:
            u = len(self._u32_to_id)
            self._id_to_u32[doc_id] = u
            self._u32_to_id.append(doc_id)
        self._lib.bm25_add_document(self._h, u, self._norm(text))

    def remove_document(self, doc_id: str) -> bool:
        u = self._id_to_u32.get(doc_id)
        if u is None:
            return False
        return bool(self._lib.bm25_remove_document(self._h, u))

    def idf(self, term: str) -> float:
        # RAW postings-key lookup, exactly like the Python BM25Index.idf
        # (which does not tokenize): normalizing here made the two
        # backends return different values for the same call
        return float(self._lib.bm25_idf(self._h,
                                        term.encode("utf-8")))

    def score(self, query: str, doc_id: str) -> float:
        u = self._id_to_u32.get(doc_id)
        if u is None:
            return 0.0
        return float(self._lib.bm25_score(self._h, self._norm(query), u))

    def search(self, query: str, k: int = 10) -> List[Tuple[str, float]]:
        if k <= 0:
            return []  # out[k-1] below would wrap to out[-1] and escalate
        qn = self._norm(query)
        n_docs = self.n_docs
        # The C engine tie-breaks equal scores by u32 insertion order; the
        # Python index tie-breaks by doc-id string.  Over-fetch and
        # re-sort, escalating while the cut lands inside a tie band, so
        # both backends return the same top-k membership.
        kk = min(max(k + 16, 2 * k), max(n_docs, 1))
        while True:
            ids = (ctypes.c_uint32 * kk)()
            scores = (ctypes.c_double * kk)()
            n = self._lib.bm25_search(self._h, qn, kk, ids, scores)
            out = sorted(((self._u32_to_id[ids[i]], scores[i])
                          for i in range(n)),
                         key=lambda t: (-t[1], t[0]))
            if n < kk or kk >= n_docs or len(out) <= k \
                    or out[k - 1][1] != out[k][1] or n < k:
                return out[:k]
            kk = min(kk * 4, n_docs)

    def tokenize(self, text: str) -> List[str]:
        return tokenize(text)

    # -- serialization: binary postings export (no re-tokenize) --------
    def export_blob(self) -> bytes:
        """Serialize postings + doc lengths via the C ABI (bm25.cpp
        bm25_export).  Reloading through ``from_blob`` skips tokenization
        entirely — the round-2 native index replayed the whole text
        corpus on load (VERDICT r2 item #6 / ROADMAP #21)."""
        size = int(self._lib.bm25_export_size(self._h))
        buf = ctypes.create_string_buffer(size)
        n = int(self._lib.bm25_export(self._h, buf, size))
        if n < 0:
            raise RuntimeError("bm25_export buffer sizing failed")
        return buf.raw[:n]

    @property
    def doc_ids(self) -> List[Optional[str]]:
        """u32 handle -> string doc id (None = removed handle)."""
        return list(self._u32_to_id)

    @classmethod
    def from_blob(cls, blob: bytes, ids: List[Optional[str]],
                  k1: float = 1.5, b: float = 0.75) -> "NativeBM25":
        idx = cls(k1, b)
        h = idx._lib.bm25_import(k1, b, blob, len(blob))
        if not h:
            raise ValueError("malformed BM25 state blob")
        idx._lib.bm25_destroy(idx._h)
        idx._h = h
        idx._u32_to_id = list(ids)
        idx._id_to_u32 = {d: u for u, d in enumerate(ids) if d is not None}
        return idx

    def to_dict(self) -> dict:
        """Postings-style dict, same shape as the Python BM25Index.to_dict
        (hybrid/bm25.py:115) so either engine can load it."""
        postings, doc_len = decode_bm25_blob(self.export_blob())
        u2i = self._u32_to_id
        return {"config": {"k1": self.k1, "b": self.b},
                "postings": {t: {u2i[u]: tf for u, tf in p.items()
                                 if u < len(u2i) and u2i[u] is not None}
                             for t, p in postings.items()},
                "doc_len": {u2i[u]: dl for u, dl in doc_len.items()
                            if u < len(u2i) and u2i[u] is not None},
                "native": True}

    @classmethod
    def from_dict(cls, d: dict) -> "NativeBM25":
        cfg = d.get("config", {})
        k1, b = cfg.get("k1", 1.5), cfg.get("b", 0.75)
        if "texts" in d:  # legacy round-2 containers: replay-based
            idx = cls(k1, b)
            for doc_id, text in d["texts"].items():
                idx.add_document(doc_id, text)
            return idx
        # postings-style dict (from either engine): build the binary blob
        # host-side and import — no tokenization
        ids = sorted(d.get("doc_len", {}))
        handle = {doc: u for u, doc in enumerate(ids)}
        postings = {t: {handle[doc]: int(tf) for doc, tf in p.items()}
                    for t, p in d.get("postings", {}).items()}
        doc_len = {handle[doc]: int(dl)
                   for doc, dl in d.get("doc_len", {}).items()}
        return cls.from_blob(encode_bm25_blob(postings, doc_len), ids, k1, b)

    def stats(self) -> dict:
        return {"documents": self.n_docs,
                "terms": int(self._lib.bm25_n_terms(self._h)),
                "avg_doc_len": self.avg_doc_len, "backend": "native"}


# ----------------------------------------------------------------------
# BM25 state-blob codec (pure Python mirror of bm25.cpp's export format),
# used to (a) load a native-written container on a machine with no C++
# toolchain, and (b) build an importable blob from a postings dict.
# Layout: see bm25.cpp "Binary state export/import".
# ----------------------------------------------------------------------
BM25_MAGIC = b"FVBM25\x00\x01"


def decode_bm25_blob(blob: bytes) -> Tuple[Dict[str, Dict[int, int]],
                                           Dict[int, int]]:
    """blob -> (postings {term: {handle: tf}}, doc_len {handle: len})."""
    import struct
    if blob[:8] != BM25_MAGIC:
        raise ValueError("bad BM25 blob magic")
    off = 8
    n_docs, n_terms, _total = struct.unpack_from("<QQQ", blob, off)
    off += 24
    pairs = np.frombuffer(blob, dtype="<u4", count=2 * n_docs,
                          offset=off).reshape(-1, 2)
    off += 8 * n_docs
    doc_len = {int(d): int(l) for d, l in pairs}
    postings: Dict[str, Dict[int, int]] = {}
    for _ in range(n_terms):
        (tlen,) = struct.unpack_from("<I", blob, off)
        off += 4
        term = blob[off:off + tlen].decode("utf-8")
        off += tlen
        (df,) = struct.unpack_from("<I", blob, off)
        off += 4
        tf_pairs = np.frombuffer(blob, dtype="<u4", count=2 * df,
                                 offset=off).reshape(-1, 2)
        off += 8 * df
        postings[term] = {int(d): int(tf) for d, tf in tf_pairs}
    return postings, doc_len


def encode_bm25_blob(postings: Dict[str, Dict[int, int]],
                     doc_len: Dict[int, int]) -> bytes:
    import struct
    out = [BM25_MAGIC,
           struct.pack("<QQQ", len(doc_len), len(postings),
                       sum(doc_len.values()))]
    for d, l in doc_len.items():
        out.append(struct.pack("<II", d, l))
    for term, p in postings.items():
        tb = term.encode("utf-8")
        out.append(struct.pack("<I", len(tb)))
        out.append(tb)
        out.append(struct.pack("<I", len(p)))
        for d, tf in p.items():
            out.append(struct.pack("<II", d, tf))
    return b"".join(out)


def load_graph_library() -> Optional[ctypes.CDLL]:
    """Build (once) and load the CSR traversal library; None if unavailable."""
    global _graph_lib, _graph_build_failed
    if _graph_lib is not None:
        return _graph_lib
    with _lock:
        if _graph_lib is not None or _graph_build_failed:
            return _graph_lib
        so = _build(_GRAPH_SRC)
        if so is None:
            _graph_build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _graph_build_failed = True
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.csr_bfs.restype = ctypes.c_int64
        lib.csr_bfs.argtypes = [ctypes.c_int64, i64p, i32p, i32p,
                                ctypes.c_int64, ctypes.c_int32, i32p, i32p]
        lib.csr_shortest_path.restype = ctypes.c_int64
        lib.csr_shortest_path.argtypes = [ctypes.c_int64, i64p, i32p,
                                          ctypes.c_int32, ctypes.c_int32,
                                          i32p]
        lib.csr_bfs_attributed.restype = ctypes.c_int64
        lib.csr_bfs_attributed.argtypes = [ctypes.c_int64, i64p, i32p, i32p,
                                           ctypes.c_int64, ctypes.c_int32,
                                           i32p, i32p, i32p]
        _graph_lib = lib
        return _graph_lib


def graph_available() -> bool:
    return load_graph_library() is not None


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeCSRGraph:
    """Immutable CSR adjacency snapshot traversed in C++."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray):
        self.indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        self.indices = np.ascontiguousarray(indices, dtype=np.int32)
        self.n_nodes = self.indptr.shape[0] - 1
        self._lib = load_graph_library()
        if self._lib is None:
            raise RuntimeError("native graph library unavailable")

    def bfs(self, seeds, max_hops: int):
        """Multi-source BFS -> (nodes (V,), hops (V,)) int32 arrays."""
        seeds = np.ascontiguousarray(seeds, dtype=np.int32)
        out_nodes = np.empty(self.n_nodes, dtype=np.int32)
        out_hops = np.empty(self.n_nodes, dtype=np.int32)
        count = self._lib.csr_bfs(
            self.n_nodes, _i64p(self.indptr), _i32p(self.indices),
            _i32p(seeds), seeds.size, max_hops,
            _i32p(out_nodes), _i32p(out_hops))
        return out_nodes[:count].copy(), out_hops[:count].copy()

    def bfs_attributed(self, seeds, max_hops: int):
        """Multi-source BFS -> (nodes, hops, seed_index-of-first-reach)."""
        seeds = np.ascontiguousarray(seeds, dtype=np.int32)
        out_nodes = np.empty(self.n_nodes, dtype=np.int32)
        out_hops = np.empty(self.n_nodes, dtype=np.int32)
        out_seed = np.empty(self.n_nodes, dtype=np.int32)
        count = self._lib.csr_bfs_attributed(
            self.n_nodes, _i64p(self.indptr), _i32p(self.indices),
            _i32p(seeds), seeds.size, max_hops,
            _i32p(out_nodes), _i32p(out_hops), _i32p(out_seed))
        return (out_nodes[:count].copy(), out_hops[:count].copy(),
                out_seed[:count].copy())

    def shortest_path(self, src: int, dst: int):
        """Node-index path src..dst, or None if unreachable."""
        out = np.empty(self.n_nodes, dtype=np.int32)
        n = self._lib.csr_shortest_path(
            self.n_nodes, _i64p(self.indptr), _i32p(self.indices),
            int(src), int(dst), _i32p(out))
        return out[:n].copy() if n else None
