"""ChromaDB-style high-level document API.

Behavior parity with the reference's ``fastpyvectordb`` package
(fastpyvectordb/client.py): ``Client`` owning a core VectorDB plus an
embedder cache, ``Collection`` with add/upsert/query/get/update/delete/peek,
document text round-tripping through the ``_document`` metadata key
(fastpyvectordb/client.py:146-150), underscore-prefixed metadata keys
stripped from query results (:256-257), nested-list ``QueryResult`` /
flat ``GetResult`` shapes.  The database, and the ``jax`` (transformer)
embedder, live on ``device``: the card unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import time
import uuid as _uuid
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..core.collection import Collection as CoreCollection
from ..core.filters import Filter
from ..core.types import DistanceMetric
from ..core.vectordb import VectorDB
from ..embeddings import Embedder, get_embedder

DOCUMENT_KEY = "_document"


@dataclass
class QueryResult:
    """Nested per-query results (reference: fastpyvectordb/client.py:50-57)."""
    ids: List[List[str]]
    documents: List[List[Optional[str]]]
    metadatas: List[List[dict]]
    distances: List[List[float]]
    embeddings: Optional[List[List[np.ndarray]]] = None


@dataclass
class GetResult:
    """Flat results (reference: fastpyvectordb/client.py:60-66)."""
    ids: List[str]
    documents: List[Optional[str]]
    metadatas: List[dict]
    embeddings: Optional[List[np.ndarray]] = None


def _public_meta(meta: dict) -> dict:
    return {k: v for k, v in meta.items() if not k.startswith("_")}


class Collection:
    """Document collection with automatic embedding."""

    def __init__(self, name: str, base: CoreCollection, embedder: Embedder,
                 metadata: Optional[dict] = None):
        self.name = name
        self._collection = base
        self._embedder = embedder
        self.metadata = metadata or {}

    @property
    def count(self) -> int:
        return self._collection.count()

    def __len__(self) -> int:
        return self.count

    # ------------------------------------------------------------------
    def add(self, documents: Optional[Sequence[str]] = None,
            embeddings: Optional[Sequence[Sequence[float]]] = None,
            ids: Optional[Sequence[str]] = None,
            metadatas: Optional[Sequence[dict]] = None) -> List[str]:
        if documents is None and embeddings is None:
            raise ValueError("Either documents or embeddings must be provided")
        n = len(documents) if documents is not None else len(embeddings)
        if ids is None:
            ids = [str(_uuid.uuid4()) for _ in range(n)]
        elif len(ids) != n:
            raise ValueError(
                f"Number of IDs ({len(ids)}) must match number of items ({n})")
        metas = [dict(m) for m in metadatas] if metadatas is not None \
            else [{} for _ in range(n)]
        if len(metas) != n:
            raise ValueError("metadatas length mismatch")
        if documents is not None:
            for m, doc in zip(metas, documents):
                m[DOCUMENT_KEY] = doc
        if embeddings is None:
            vectors = self._embedder.embed_batch(list(documents))
        else:
            vectors = np.asarray(embeddings, dtype=np.float32)
        self._collection.insert_batch(vectors, list(ids), metas)
        return list(ids)

    def upsert(self, documents: Optional[Sequence[str]] = None,
               embeddings: Optional[Sequence[Sequence[float]]] = None,
               ids: Optional[Sequence[str]] = None,
               metadatas: Optional[Sequence[dict]] = None) -> List[str]:
        if ids is None:
            return self.add(documents, embeddings, None, metadatas)
        # validate and EMBED before deleting anything: delete-then-add
        # with a failing add (length mismatch, wrong dims, embedder
        # error) would permanently destroy the pre-existing documents
        # (the same data-loss shape update() was fixed for)
        if documents is None and embeddings is None:
            raise ValueError(
                "Either documents or embeddings must be provided")
        n = len(documents) if documents is not None else len(embeddings)
        if len(ids) != n:
            raise ValueError(
                f"Number of IDs ({len(ids)}) must match number of items "
                f"({n})")
        if embeddings is None:
            embeddings = self._embedder.embed_batch(list(documents))
        else:
            embeddings = np.asarray(embeddings, dtype=np.float32)
            if embeddings.reshape(n, -1).shape[1] !=                     self._collection.config.dimensions:
                raise ValueError(
                    f"expected {self._collection.config.dimensions}-d "
                    "embeddings")
        existing = [i for i in ids if self._collection.get(str(i)) is not None]
        if existing:
            self._collection.delete_batch(existing)
        return self.add(documents, embeddings, ids, metadatas)

    # ------------------------------------------------------------------
    def query(self, query_texts: Optional[Union[str, Sequence[str]]] = None,
              query_embeddings: Optional[Sequence[Sequence[float]]] = None,
              n_results: int = 10, where: Optional[dict] = None,
              include: Sequence[str] = ("documents", "metadatas", "distances"),
              ) -> QueryResult:
        if query_texts is None and query_embeddings is None:
            raise ValueError(
                "Either query_texts or query_embeddings must be provided")
        if query_texts is not None:
            if isinstance(query_texts, str):
                query_texts = [query_texts]
            q = self._embedder.embed_batch(list(query_texts))
        else:
            q = np.asarray(query_embeddings, dtype=np.float32)
            if q.ndim == 1:
                q = q[None, :]
        filt = Filter.from_dict(where)
        want_emb = "embeddings" in include
        batches = self._collection.search_batch(
            q, k=n_results, filter=filt, include_vectors=want_emb)
        res = QueryResult(ids=[], documents=[], metadatas=[], distances=[],
                          embeddings=[] if want_emb else None)
        for hits in batches:
            res.ids.append([h.id for h in hits])
            res.documents.append(
                [h.metadata.get(DOCUMENT_KEY) for h in hits]
                if "documents" in include else [None] * len(hits))
            res.metadatas.append([_public_meta(h.metadata) for h in hits])
            res.distances.append([h.score for h in hits])
            if want_emb:
                res.embeddings.append([h.vector for h in hits])
        return res

    # ------------------------------------------------------------------
    def get(self, ids: Optional[Union[str, Sequence[str]]] = None,
            where: Optional[dict] = None, limit: Optional[int] = None,
            offset: int = 0,
            include: Sequence[str] = ("documents", "metadatas"),
            ) -> GetResult:
        want_emb = "embeddings" in include
        filt = Filter.from_dict(where) if where else None
        if ids is not None:
            if isinstance(ids, str):
                ids = [ids]
            rows = self._collection.get_batch(list(ids),
                                              include_vectors=want_emb)
            rows = [r for r in rows if r is not None]
            if filt is not None:  # ids AND where compose (Chroma semantics)
                rows = [r for r in rows if filt.evaluate(r["metadata"])]
        else:
            all_ids = (self._collection.ids_matching(filt)
                       if filt is not None else self._collection.all_ids())
            all_ids = all_ids[offset: offset + limit
                              if limit is not None else None]
            rows = self._collection.get_batch(all_ids,
                                              include_vectors=want_emb)
            rows = [r for r in rows if r is not None]
        res = GetResult(ids=[], documents=[], metadatas=[],
                        embeddings=[] if want_emb else None)
        for r in rows:
            res.ids.append(r["id"])
            res.documents.append(r["metadata"].get(DOCUMENT_KEY)
                                 if "documents" in include else None)
            res.metadatas.append(_public_meta(r["metadata"]))
            if want_emb:
                res.embeddings.append(r["vector"])
        return res

    # ------------------------------------------------------------------
    def update(self, ids: Union[str, Sequence[str]],
               documents: Optional[Sequence[str]] = None,
               embeddings: Optional[Sequence[Sequence[float]]] = None,
               metadatas: Optional[Sequence[dict]] = None) -> None:
        if isinstance(ids, str):
            ids = [ids]
        n = len(ids)
        dims = self._collection.config.dimensions
        for name, seq in (("documents", documents),
                          ("embeddings", embeddings),
                          ("metadatas", metadatas)):
            if seq is not None and len(seq) != n:
                raise ValueError(f"got {len(seq)} {name} for {n} ids")
        # validate and assemble every replacement BEFORE mutating: the
        # old delete-then-insert order destroyed the document when the
        # new embedding failed validation (e.g. wrong dimensions)
        staged = []
        for i in range(n):
            rid = str(ids[i])
            cur = self._collection.get(rid, include_vector=True)
            if cur is None:
                raise ValueError(f"ID does not exist: {rid}")
            meta = dict(cur["metadata"])
            if metadatas is not None:
                meta.update(metadatas[i])
            doc = documents[i] if documents is not None else None
            if doc is not None:
                meta[DOCUMENT_KEY] = doc
            if embeddings is not None:
                vec = np.asarray(embeddings[i], dtype=np.float32)
            elif doc is not None:
                vec = self._embedder.embed(doc)
            else:
                vec = cur["vector"]
            vec = np.asarray(vec, dtype=np.float32).reshape(-1)
            if vec.shape[0] != dims:
                raise ValueError(
                    f"embedding for {rid!r} has {vec.shape[0]} dims, "
                    f"collection expects {dims}")
            staged.append((rid, vec, meta))
        for rid, vec, meta in staged:
            self._collection.delete(rid)
            self._collection.insert(vec, rid, meta)

    def delete(self, ids: Optional[Union[str, Sequence[str]]] = None,
               where: Optional[dict] = None) -> List[str]:
        if ids is None and where is None:
            raise ValueError("Either ids or where must be provided")
        if ids is not None:
            if isinstance(ids, str):
                ids = [ids]
            ids = [str(i) for i in ids]
        else:
            filt = Filter.from_dict(where)
            if filt is None:
                raise ValueError(
                    "where must contain at least one condition; to clear "
                    "the whole collection use delete(ids=collection ids) "
                    "or Client.delete_collection")
            ids = self._collection.ids_matching(filt)
        self._collection.delete_batch(ids)
        return ids

    def peek(self, limit: int = 10) -> GetResult:
        return self.get(ids=self._collection.list_ids(limit=limit))


class Client:
    """Top-level entry point (reference: fastpyvectordb/client.py:444-715)."""

    def __init__(self, path: Optional[str] = "./fastpyvectordb_data",
                 embedding_provider: str = "auto",
                 embedding_model: Optional[str] = None,
                 device=None, **embedder_kwargs):
        self.path = path
        self._db = VectorDB(path, device=device)
        self._default_provider = embedding_provider
        self._default_model = embedding_model
        self._embedder_kwargs = embedder_kwargs
        self._embedders: Dict[str, Embedder] = {}

    def _get_embedder(self, provider: Optional[str] = None,
                      model: Optional[str] = None) -> Embedder:
        provider = provider or self._default_provider
        model = model or self._default_model
        key = f"{provider}:{model}"
        if key not in self._embedders:
            self._embedders[key] = get_embedder(provider, model,
                                                device=self._db.device,
                                                **self._embedder_kwargs)
        return self._embedders[key]

    def create_collection(self, name: str,
                          embedding_provider: Optional[str] = None,
                          embedding_model: Optional[str] = None,
                          metric: Union[str, DistanceMetric] = "cosine",
                          metadata: Optional[dict] = None,
                          dimensions: Optional[int] = None,
                          **config_kwargs) -> Collection:
        embedder = self._get_embedder(embedding_provider, embedding_model)
        dims = dimensions or embedder.dimensions
        base = self._db.create_collection(name, dims, metric=metric,
                                          **config_kwargs)
        return Collection(name, base, embedder, metadata)

    def get_collection(self, name: str,
                       embedding_provider: Optional[str] = None,
                       embedding_model: Optional[str] = None) -> Collection:
        base = self._db.get_collection(name)
        embedder = self._get_embedder(embedding_provider, embedding_model)
        if embedder.dimensions != base.config.dimensions:
            raise ValueError(
                f"embedder dimensions {embedder.dimensions} do not match "
                f"collection dimensions {base.config.dimensions}")
        return Collection(name, base, embedder)

    def get_or_create_collection(self, name: str, **kwargs) -> Collection:
        if name in self._db:
            return self.get_collection(
                name, kwargs.get("embedding_provider"),
                kwargs.get("embedding_model"))
        return self.create_collection(name, **kwargs)

    def delete_collection(self, name: str) -> bool:
        return self._db.delete_collection(name)

    def list_collections(self) -> List[str]:
        return self._db.list_collections()

    def heartbeat(self) -> int:
        return time.time_ns()

    def persist(self) -> None:
        self._db.save()

    def reset(self) -> None:
        """Destructive: drop every collection."""
        for name in list(self._db.list_collections()):
            self._db.delete_collection(name)

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        if self.path is not None:
            self.persist()
