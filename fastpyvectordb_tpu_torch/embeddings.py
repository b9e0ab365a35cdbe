"""Pluggable text embedders.

Capability parity with the reference's provider layer (embeddings.py:49-514):
an ``Embedder`` ABC, OpenAI / Cohere / sentence-transformers providers, a
deterministic ``MockEmbedder`` test fake, a disk-cached wrapper, and a
``get_embedder`` factory with "auto" resolution.

Port of ``fastpyvectordb_tpu/embeddings.py``.  The JAX package's
``JaxTransformerEmbedder`` is ``TransformerEmbedder`` here: the same small
transformer encoder with a hashing tokenizer, as a ``torch.nn.Module`` on
the card (``device="cpu"`` runs it on the host).  Its random init is the
JAX package's, bit for bit up to an ulp of ``erf_inv`` (threefry2x32 and
``jax.random.normal`` reproduced in numpy), so both packages embed the same
text to the same vector; weights move between them through the FPVT
container (``save`` / ``load``) or as a numpy tree (``from_numpy``).  The
provider name stays ``"jax"`` and the file kind ``"jax_embedder"``, so
settings and weight files carry over.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from abc import ABC, abstractmethod
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .utils import resolve_device


class Embedder(ABC):
    """Text -> vector provider (reference ABC: embeddings.py:49-88)."""

    @property
    @abstractmethod
    def dimensions(self) -> int: ...

    @property
    @abstractmethod
    def model_name(self) -> str: ...

    @abstractmethod
    def embed(self, text: str) -> np.ndarray: ...

    def embed_batch(self, texts: Sequence[str], batch_size: int = 32
                    ) -> np.ndarray:
        out = [self.embed(t) for t in texts]
        return np.stack(out) if out else np.empty((0, self.dimensions),
                                                  dtype=np.float32)

    def embed_with_metadata(self, text: str) -> dict:
        return {"embedding": self.embed(text), "model": self.model_name,
                "dimensions": self.dimensions}


class MockEmbedder(Embedder):
    """Deterministic hash-seeded embedder — the test fake for the whole
    framework (reference: embeddings.py:343-371)."""

    def __init__(self, dimensions: int = 384):
        self._dims = dimensions

    @property
    def dimensions(self) -> int:
        return self._dims

    @property
    def model_name(self) -> str:
        return f"mock-{self._dims}d"

    def embed(self, text: str) -> np.ndarray:
        seed = int.from_bytes(
            hashlib.sha256(text.encode("utf-8")).digest()[:4], "big")
        v = np.random.RandomState(seed).randn(self._dims).astype(np.float32)
        return v / np.linalg.norm(v)


class HashingEmbedder(Embedder):
    """Dependency-free bag-of-words feature-hashing embedder.

    Useful offline baseline (the reference's retrieval demo ships a similar
    BoW fallback, examples/retrieval_demo.py:1-40): tokens are hashed into
    ``dimensions`` buckets with a signed hash, l2-normalized.  Texts sharing
    vocabulary are actually close — unlike MockEmbedder."""

    def __init__(self, dimensions: int = 384):
        self._dims = dimensions

    @property
    def dimensions(self) -> int:
        return self._dims

    @property
    def model_name(self) -> str:
        return f"hashing-bow-{self._dims}d"

    def embed(self, text: str) -> np.ndarray:
        import re
        v = np.zeros(self._dims, dtype=np.float32)
        for tok in re.findall(r"\b\w+\b", text.lower()):
            h = hashlib.md5(tok.encode("utf-8")).digest()
            idx = int.from_bytes(h[:4], "big") % self._dims
            sign = 1.0 if h[4] & 1 else -1.0
            v[idx] += sign
        n = np.linalg.norm(v)
        return v / n if n > 0 else v


class SentenceTransformerEmbedder(Embedder):
    """Local sentence-transformers models (reference: embeddings.py:200-256).
    Lazy model load; dimensions discovered from the model."""

    def __init__(self, model_name: str = "all-MiniLM-L6-v2",
                 device: Optional[str] = None):
        self._model_name = model_name
        self._device = device
        self._model = None
        self._dims: Optional[int] = None
        self._lock = threading.Lock()

    def _ensure(self):
        if self._model is None:
            with self._lock:
                if self._model is None:
                    from sentence_transformers import SentenceTransformer
                    self._model = SentenceTransformer(self._model_name,
                                                      device=self._device)
                    self._dims = int(
                        self._model.get_sentence_embedding_dimension())
        return self._model

    @property
    def dimensions(self) -> int:
        if self._dims is None:
            self._ensure()
        return self._dims

    @property
    def model_name(self) -> str:
        return self._model_name

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str], batch_size: int = 32
                    ) -> np.ndarray:
        model = self._ensure()
        out = model.encode(list(texts), batch_size=batch_size,
                           show_progress_bar=len(texts) > 100,
                           convert_to_numpy=True)
        return np.ascontiguousarray(out, dtype=np.float32)


_OPENAI_DIMS = {
    "text-embedding-3-small": 1536,
    "text-embedding-3-large": 3072,
    "text-embedding-ada-002": 1536,
}


class OpenAIEmbedder(Embedder):
    """OpenAI embeddings API (reference: embeddings.py:95-193).  Supports the
    v3 models' ``dimensions`` reduction parameter."""

    def __init__(self, model_name: str = "text-embedding-3-small",
                 api_key: Optional[str] = None,
                 dimensions: Optional[int] = None):
        self._model_name = model_name
        self._api_key = api_key or os.environ.get("OPENAI_API_KEY")
        default = _OPENAI_DIMS.get(model_name, 1536)
        if dimensions is not None and "3" not in model_name:
            raise ValueError("custom dimensions require a v3 model")
        self._dims = dimensions or default
        self._client = None

    def _ensure(self):
        if self._client is None:
            import openai
            self._client = openai.OpenAI(api_key=self._api_key)
        return self._client

    @property
    def dimensions(self) -> int:
        return self._dims

    @property
    def model_name(self) -> str:
        return self._model_name

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str], batch_size: int = 512
                    ) -> np.ndarray:
        client = self._ensure()
        out = np.empty((len(texts), self._dims), dtype=np.float32)
        kwargs = {}
        if self._model_name in ("text-embedding-3-small",
                                "text-embedding-3-large") and \
                self._dims != _OPENAI_DIMS[self._model_name]:
            kwargs["dimensions"] = self._dims
        for s in range(0, len(texts), batch_size):
            chunk = list(texts[s: s + batch_size])
            resp = client.embeddings.create(model=self._model_name,
                                            input=chunk, **kwargs)
            # API may reorder; restore by index
            for item in resp.data:
                out[s + item.index] = np.asarray(item.embedding,
                                                 dtype=np.float32)
        return out


_COHERE_DIMS = {
    "embed-english-v3.0": 1024,
    "embed-multilingual-v3.0": 1024,
    "embed-english-light-v3.0": 384,
}


class CohereEmbedder(Embedder):
    """Cohere embeddings API (reference: embeddings.py:263-336)."""

    def __init__(self, model_name: str = "embed-english-v3.0",
                 api_key: Optional[str] = None,
                 input_type: str = "search_document"):
        self._model_name = model_name
        self._api_key = api_key or os.environ.get("COHERE_API_KEY")
        self._dims = _COHERE_DIMS.get(model_name, 1024)
        self.input_type = input_type
        self._client = None

    def _ensure(self):
        if self._client is None:
            import cohere
            self._client = cohere.Client(self._api_key)
        return self._client

    @property
    def dimensions(self) -> int:
        return self._dims

    @property
    def model_name(self) -> str:
        return self._model_name

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str], batch_size: int = 96
                    ) -> np.ndarray:
        client = self._ensure()
        outs: List[np.ndarray] = []
        for s in range(0, len(texts), batch_size):
            resp = client.embed(texts=list(texts[s: s + batch_size]),
                                model=self._model_name,
                                input_type=self.input_type)
            outs.append(np.asarray(resp.embeddings, dtype=np.float32))
        return (np.concatenate(outs) if outs
                else np.empty((0, self._dims), dtype=np.float32))


# ----------------------------------------------------------------------
# jax.random, reproduced in numpy for the embedder's random init: the
# threefry2x32 PRNG with jax_threefry_partitionable (the default since jax
# 0.5), PRNGKey / split / normal as jax/_src/prng.py and jax/_src/random.py
# define them, and XLA's f32 erf_inv (M. Giles' single-precision
# polynomials).
# ----------------------------------------------------------------------
_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under ``key`` = (k0, k1); uint32 arithmetic wraps."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        tmp = np.empty_like(x1)
        for i in range(5):
            for r in _THREEFRY_ROT[i % 2]:   # in place: 12.6M draws a table
                np.add(x0, x1, out=x0)
                np.left_shift(x1, np.uint32(r), out=tmp)
                np.right_shift(x1, np.uint32(32 - r), out=x1)
                np.bitwise_or(x1, tmp, out=x1)
                np.bitwise_xor(x0, x1, out=x1)
            np.add(x0, ks[(i + 1) % 3], out=x0)
            np.add(x1, ks[(i + 2) % 3] + np.uint32(i + 1), out=x1)
    return x0, x1


def _threefry_counts(n: int):
    """The partitionable counters of n draws: the 64-bit iota as (hi, lo)."""
    lo = np.arange(n, dtype=np.uint64)
    return ((lo >> np.uint64(32)).astype(np.uint32),
            (lo & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def jax_prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed)."""
    return (np.uint32(0), np.uint32(int(seed) & 0xFFFFFFFF))


def jax_split(key, n: int):
    """``jax.random.split(key, n)`` as a list of n keys."""
    b0, b1 = _threefry2x32(key, *_threefry_counts(n))
    return list(zip(b0.tolist(), b1.tolist()))


def _erf_inv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``erf_inv``; each polynomial step is a fused multiply-add
    (computed exactly in float64, rounded once to float32)."""
    w = -np.log1p(-x * x)
    lt = w < np.float32(5)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    w64 = w.astype(np.float64)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, np.float32(a), np.float32(b)).astype(np.float64)
        p = (c + p.astype(np.float64) * w64).astype(np.float32)
    return (p * x).astype(np.float32)


def jax_normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32: a uniform draw on
    [nextafter(-1, 0), 1) from the top 23 bits of each threefry word,
    then ``sqrt(2) * erf_inv``."""
    n = int(np.prod(shape))
    b0, b1 = _threefry2x32(key, *_threefry_counts(n))
    bits = (b0 ^ b1) >> np.uint32(9) | np.uint32(0x3F800000)
    f = bits.view(np.float32) - np.float32(1)
    lo = np.nextafter(np.float32(-1), np.float32(0), dtype=np.float32)
    u = np.maximum(lo, f * (np.float32(1) - lo) + lo)
    return (np.float32(np.sqrt(2)) * _erf_inv_f32(u)).reshape(shape)


_LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w1", "w2")


def _layer_norm(y: torch.Tensor) -> torch.Tensor:
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    return (y - mu) * torch.rsqrt(var + 1e-6)


class TransformerEmbedder(Embedder, torch.nn.Module):
    """Transformer encoder embedder on the card (the JAX package's
    ``JaxTransformerEmbedder``).

    Hashing tokenizer -> embedding table -> ``n_layers`` pre-LN transformer
    blocks -> masked mean pooling -> l2 normalize, in float32 (TF32 is
    never enabled by the package).  Weights default to the JAX package's
    deterministic random init for ``seed``; ``from_numpy`` takes its params
    tree and ``load`` / ``save`` move them through the FPVT container.
    The attention mask is additive (-1e9), as in the JAX package, so a text
    with no tokens embeds to the zero vector.

    One thread at a time runs the forward (a lock around the device work):
    a server embeds each request on its own executor thread, and a B=1
    forward is some 80 small launches, which many threads issuing at once
    slow far below one thread's rate.
    """

    def __init__(self, dimensions: int = 384, n_layers: int = 2,
                 n_heads: int = 6, vocab_size: int = 32768,
                 max_len: int = 128, seed: int = 0,
                 model_name: str = "jax-mini-encoder", device=None,
                 params: Optional[dict] = None):
        """params: a numpy tree ``{"tok", "pos", "layers": [{"wq", ...}]}``
        in the JAX package's layout; None draws the JAX package's random
        init for ``seed``."""
        torch.nn.Module.__init__(self)
        self._dims = dimensions
        self.n_layers, self.n_heads = n_layers, n_heads
        self.vocab_size, self.max_len = vocab_size, max_len
        self._model_name = model_name
        self.device = resolve_device(device)
        self._lock = threading.Lock()   # one forward at a time
        if params is None:
            params = self._init_params(seed)

        def param(a) -> torch.nn.Parameter:
            t = torch.from_numpy(np.array(a, dtype=np.float32))
            return torch.nn.Parameter(t.to(self.device), requires_grad=False)

        self.tok = param(params["tok"])
        self.pos = param(params["pos"])
        self.layers = torch.nn.ModuleList()
        for lp in params["layers"]:
            self.layers.append(torch.nn.ParameterDict(
                {name: param(lp[name]) for name in _LAYER_WEIGHTS}))
        if tuple(self.tok.shape) != (vocab_size, dimensions) \
                or tuple(self.pos.shape) != (max_len, dimensions) \
                or len(self.layers) != n_layers:
            raise ValueError("params do not match the embedder's config")

    @classmethod
    def from_numpy(cls, params: dict, n_heads: int = 6,
                   model_name: str = "jax-mini-encoder",
                   device=None) -> "TransformerEmbedder":
        """An embedder holding the JAX package's params tree (numpy arrays,
        e.g. ``jax.tree.map(np.asarray, emb.params)``); the shapes give
        the config."""
        vocab, d = np.shape(params["tok"])
        return cls(dimensions=d, n_layers=len(params["layers"]),
                   n_heads=n_heads, vocab_size=vocab,
                   max_len=np.shape(params["pos"])[0],
                   model_name=model_name, device=device, params=params)

    # -- tokenizer ---------------------------------------------------------
    def tokenize(self, text: str) -> np.ndarray:
        import re
        toks = re.findall(r"\b\w+\b", text.lower())[: self.max_len]
        ids = [int.from_bytes(hashlib.md5(t.encode()).digest()[:4], "big")
               % (self.vocab_size - 1) + 1 for t in toks]
        ids += [0] * (self.max_len - len(ids))  # 0 = pad
        return np.asarray(ids, dtype=np.int32)

    # -- model -------------------------------------------------------------
    def _init_params(self, seed: int) -> dict:
        d = self._dims
        keys = jax_split(jax_prng_key(seed), 2 + 6 * self.n_layers)
        # the JAX package multiplies f32 draws by f32(s): no float64 step
        s = np.float32(1.0 / np.sqrt(d))
        s2 = np.float32(1.0 / np.sqrt(d) / 2)
        p = {"tok": jax_normal(keys[0], (self.vocab_size, d)) * s,
             "pos": jax_normal(keys[1], (self.max_len, d)) * s,
             "layers": []}
        for i in range(self.n_layers):
            k = keys[2 + 6 * i: 8 + 6 * i]
            p["layers"].append({
                "wq": jax_normal(k[0], (d, d)) * s,
                "wk": jax_normal(k[1], (d, d)) * s,
                "wv": jax_normal(k[2], (d, d)) * s,
                "wo": jax_normal(k[3], (d, d)) * s,
                "w1": jax_normal(k[4], (d, 4 * d)) * s,
                "w2": jax_normal(k[5], (4 * d, d)) * s2,
            })
        return p

    def params_numpy(self) -> dict:
        """The weights as the JAX package's params tree of numpy arrays."""
        def host(t):
            return t.detach().cpu().numpy()
        return {"tok": host(self.tok), "pos": host(self.pos),
                "layers": [{n: host(lp[n]) for n in _LAYER_WEIGHTS}
                           for lp in self.layers]}

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, T) token ids (0 = pad) -> (B, d) unit embeddings."""
        d, h = self._dims, self.n_heads
        hd = d // h
        mask = ids != 0
        x = self.tok[ids] + self.pos[None, : ids.shape[1]]
        neg = torch.where(mask[:, None, None, :], 0.0, -1e9).to(x.dtype)
        for lp in self.layers:
            y = _layer_norm(x)
            b, t, _ = y.shape
            q = (y @ lp["wq"]).reshape(b, t, h, hd).transpose(1, 2)
            k = (y @ lp["wk"]).reshape(b, t, h, hd).transpose(1, 2)
            v = (y @ lp["wv"]).reshape(b, t, h, hd).transpose(1, 2)
            att = torch.softmax(
                q @ k.transpose(2, 3) / float(np.sqrt(hd)) + neg, dim=-1)
            o = (att @ v).transpose(1, 2).reshape(b, t, d)
            x = x + o @ lp["wo"]
            y = _layer_norm(x)
            # jax.nn.gelu defaults to the tanh approximation
            x = x + F.gelu(y @ lp["w1"], approximate="tanh") @ lp["w2"]
        x = _layer_norm(x)
        m = mask[:, :, None].to(x.dtype)
        pooled = (x * m).sum(1) / m.sum(1).clamp_min(1.0)
        return pooled / torch.linalg.vector_norm(
            pooled, dim=-1, keepdim=True).clamp_min(1e-9)

    @property
    def dimensions(self) -> int:
        return self._dims

    @property
    def model_name(self) -> str:
        return self._model_name

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str], batch_size: int = 64
                    ) -> np.ndarray:
        outs = []
        for s in range(0, len(texts), batch_size):
            ids = torch.from_numpy(np.stack([self.tokenize(t)
                                             for t in texts[s: s + batch_size]]))
            with self._lock, torch.no_grad():
                out = self(ids.to(self.device, torch.int64))
                outs.append(out.cpu().numpy())
        return (np.concatenate(outs) if outs
                else np.empty((0, self._dims), dtype=np.float32))

    def save(self, path) -> None:
        from .persist.format import save_container
        p = self.params_numpy()
        sections = {"tok": p["tok"], "pos": p["pos"]}
        for i, lp in enumerate(p["layers"]):
            for name in _LAYER_WEIGHTS:
                sections[f"l{i}.{name}"] = lp[name]
        save_container(Path(path), sections, meta={
            "kind": "jax_embedder", "dims": self._dims,
            "n_layers": self.n_layers, "n_heads": self.n_heads,
            "vocab_size": self.vocab_size, "max_len": self.max_len,
            "model_name": self._model_name})

    @classmethod
    def load(cls, path, device=None) -> "TransformerEmbedder":
        """An embedder from an FPVT file written by either package."""
        from .persist.format import load_container
        c = load_container(path)
        m = c.meta
        if m.get("kind") != "jax_embedder":
            raise ValueError(f"{path} is not an embedder file "
                             f"(kind {m.get('kind')!r})")
        params = {"tok": np.asarray(c.read("tok")),
                  "pos": np.asarray(c.read("pos")),
                  "layers": [{name: np.asarray(c.read(f"l{i}.{name}"))
                              for name in _LAYER_WEIGHTS}
                             for i in range(m["n_layers"])]}
        return cls(dimensions=m["dims"], n_layers=m["n_layers"],
                   n_heads=m["n_heads"], vocab_size=m["vocab_size"],
                   max_len=m["max_len"], model_name=m["model_name"],
                   device=device, params=params)


class CachedEmbedder(Embedder):
    """Disk-cached wrapper keyed by sha256(text) (reference:
    embeddings.py:374-448)."""

    def __init__(self, base: Embedder, cache_dir: str = ".embedding_cache"):
        self.base = base
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self._path = self.cache_dir / f"{base.model_name.replace('/', '_')}.json"
        self._cache: dict = {}
        self._lock = threading.Lock()
        self._dirty = 0          # misses since the last disk flush
        self._flush_every = 2048
        if self._path.exists():
            try:
                self._cache = json.loads(self._path.read_text())
            except (OSError, json.JSONDecodeError):
                self._cache = {}

    @staticmethod
    def _key(text: str) -> str:
        return hashlib.sha256(text.encode("utf-8")).hexdigest()[:32]

    @property
    def dimensions(self) -> int:
        return self.base.dimensions

    @property
    def model_name(self) -> str:
        return self.base.model_name

    def embed(self, text: str) -> np.ndarray:
        return self.embed_batch([text])[0]

    def embed_batch(self, texts: Sequence[str], batch_size: int = 32
                    ) -> np.ndarray:
        keys = [self._key(t) for t in texts]
        out = np.empty((len(texts), self.dimensions), dtype=np.float32)
        with self._lock:  # membership must be read under the lock too
            missing_idx = [i for i, k in enumerate(keys)
                           if k not in self._cache]
        if missing_idx:
            fresh = self.base.embed_batch([texts[i] for i in missing_idx],
                                          batch_size)
            with self._lock:
                for j, i in enumerate(missing_idx):
                    self._cache[keys[i]] = fresh[j].tolist()
                # rewriting the whole JSON file per batch is O(cache)
                # disk I/O — quadratic over a large ingest.  Small caches
                # keep write-through (cross-instance visibility, cheap);
                # large ones flush every _flush_every misses and on
                # flush()/clear()/__del__.
                self._dirty += len(missing_idx)
                if (self._dirty >= self._flush_every
                        or len(self._cache) <= 4096):
                    self._flush_locked()
        with self._lock:
            for i, k in enumerate(keys):
                out[i] = np.asarray(self._cache[k], dtype=np.float32)
        return out

    def _flush_locked(self) -> None:
        tmp = self._path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self._cache))
        os.replace(tmp, self._path)
        self._dirty = 0

    def flush(self) -> None:
        """Persist pending cache entries (also called by __del__)."""
        with self._lock:
            if self._dirty:
                self._flush_locked()

    def __del__(self):  # best-effort final flush
        try:
            self.flush()
        except Exception:
            pass

    def clear(self) -> None:
        with self._lock:
            self._cache = {}
            self._dirty = 0
            if self._path.exists():
                self._path.unlink()


def get_embedder(provider: str = "auto", model: Optional[str] = None,
                 cache: bool = False, cache_dir: str = ".embedding_cache",
                 device=None, **kwargs) -> Embedder:
    """Factory (reference: embeddings.py:455-514).

    providers: auto | mock | hashing | jax | sentence-transformers |
    openai | cohere.  "auto" picks openai if OPENAI_API_KEY is set, else
    sentence-transformers if importable, else mock.  "jax" is the
    ``TransformerEmbedder``, on ``device`` (None: the card); a given
    ``device`` also goes to sentence-transformers.
    """
    provider = provider.lower()
    if provider == "auto":
        if os.environ.get("OPENAI_API_KEY"):
            provider = "openai"
        else:
            try:
                import sentence_transformers  # noqa: F401
                provider = "sentence-transformers"
            except ImportError:
                provider = "mock"
    if provider == "mock":
        emb: Embedder = MockEmbedder(**kwargs)
    elif provider == "hashing":
        emb = HashingEmbedder(**kwargs)
    elif provider == "jax":
        emb = TransformerEmbedder(**({"model_name": model} if model else {}),
                                  device=device, **kwargs)
    elif provider in ("sentence-transformers", "sbert", "st"):
        if device is not None:
            kwargs["device"] = str(device)
        emb = SentenceTransformerEmbedder(model or "all-MiniLM-L6-v2", **kwargs)
    elif provider == "openai":
        emb = OpenAIEmbedder(model or "text-embedding-3-small", **kwargs)
    elif provider == "cohere":
        emb = CohereEmbedder(model or "embed-english-v3.0", **kwargs)
    else:
        raise ValueError(f"unknown embedding provider {provider!r}")
    if cache:
        emb = CachedEmbedder(emb, cache_dir)
    return emb


class EmbeddingCollection:
    """Low-level text wrapper over a core Collection (reference:
    embeddings.py:521-609): stores raw text under the ``_text`` metadata
    key and embeds transparently on add/search.  The high-level api.Client
    is the friendlier interface; this exists for engine-level use."""

    def __init__(self, collection, embedder: Embedder):
        if embedder.dimensions != collection.config.dimensions:
            raise ValueError(
                f"embedder dims {embedder.dimensions} != collection dims "
                f"{collection.config.dimensions}")
        self.collection = collection
        self.embedder = embedder

    def add_text(self, text: str, id: Optional[str] = None,
                 metadata: Optional[dict] = None) -> str:
        meta = dict(metadata or {})
        meta["_text"] = text
        return self.collection.insert(self.embedder.embed(text), id, meta)

    def add_texts(self, texts: Sequence[str],
                  ids: Optional[Sequence[str]] = None,
                  metadatas: Optional[Sequence[dict]] = None) -> List[str]:
        metas = [dict(m) for m in metadatas] if metadatas is not None \
            else [{} for _ in texts]
        for m, t in zip(metas, texts):
            m["_text"] = t
        return self.collection.insert_batch(
            self.embedder.embed_batch(list(texts)), ids, metas)

    def search_text(self, query: str, k: int = 10, filter=None):
        hits = self.collection.search(self.embedder.embed(query), k, filter)
        for h in hits:
            h.metadata.setdefault("_text", None)
        return hits

    def get_text(self, id: str) -> Optional[str]:
        row = self.collection.get(id)
        return row["metadata"].get("_text") if row else None

    def count(self) -> int:
        return self.collection.count()
