"""fastpyvectordb_tpu_torch — the PyTorch/CUDA port of fastpyvectordb_tpu.

The same collection API and on-disk formats as the JAX package, on torch
tensors: ``VectorDB`` / ``Collection`` with the exact scan, the int8 / int4
/ binary / pq two-stage quantized scans, IVF (flat, grouped, int8 cells),
IVF-PQ and the graph ANN (a k-NN graph and a batched beam search on the
device), write-ahead-log durability (``durability="wal"``), the
pipelined ``search_arrays_stream``, ``optimize()`` on an H100 cost model
and ``prewarm()``; the standalone quantizers; ``BigCollection`` (host
vectors, device codes) and the streamed out-of-core searchers
(``core/outofcore.py``: host corpus and host codes, tile by tile through
pinned buffers and a copy stream) for corpora beyond device memory.

The serving layer in front of them: the REST / WebSocket server
(``server/``: app, query batcher, msgpack wire, shard router, metrics;
``python -m fastpyvectordb_tpu_torch.server``), the change feed
(``realtime``), the HTTP client (``http_client.VectorDBClient``) and the
embedded ChromaDB-style client (``api.Client``); the embedders
(``embeddings``, whose ``TransformerEmbedder`` runs on the card) and the
property graph with Cypher and native CSR traversal (``graphdb``,
``native``); the BM25 hybrid collection (``HybridCollection``: BM25 over
the native engine, fused with the vector search); multi-card sharded
search (``dist/``: meshes over one process's shards or over
``torch.distributed``, the sharded exact search and k-means step, sharded
IVF / IVF-PQ / int8 / int4 searchers on the same kernels,
``Collection.as_sharded_searcher``); and ``profiling`` (``QueryTimer``,
``torch.profiler`` traces).

Every TPU Pallas kernel of the JAX package has a hand-written Hopper
counterpart under ``csrc/`` (``quant_scores.cu``, ``hamming_scores.cu``,
``s8_scores.cu``, ``grouped_cell_scores.cu``,
``grouped_cell_scores_pq.cu``), built with ``nvcc`` at first use and
wrapped, each beside its plain PyTorch version, in ``kernels/``.
Everything runs on ``device="cuda"`` unless the caller passes
``device="cpu"``.  This package never imports jax.
"""

from .core.types import (  # noqa: F401
    CollectionConfig,
    DistanceMetric,
    SearchResult,
)
from .core.filters import Filter, FilterOp  # noqa: F401
from .core.collection import Collection  # noqa: F401
from .core.bigcollection import BigCollection  # noqa: F401
from .core.vectordb import VectorDB  # noqa: F401
from .state import collection_from_sections  # noqa: F401
from .hybrid import HybridCollection  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "CollectionConfig",
    "DistanceMetric",
    "SearchResult",
    "Filter",
    "FilterOp",
    "Collection",
    "BigCollection",
    "VectorDB",
    "collection_from_sections",
    "HybridCollection",
    "__version__",
]


def __getattr__(name):
    # Lazy imports for the heavier feature layers, so that importing the
    # package stays cheap and optional deps (aiohttp, sentence-transformers)
    # are not touched until used.
    if name in ("Client", "QueryResult", "GetResult"):
        from . import api
        return getattr(api, name)
    if name in ("get_embedder", "MockEmbedder", "Embedder",
                "TransformerEmbedder"):
        from . import embeddings
        return getattr(embeddings, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
