from .bm25 import BM25Config, BM25Index, tokenize  # noqa: F401
from .collection import HybridCollection, HybridSearchResult  # noqa: F401

__all__ = ["BM25Config", "BM25Index", "tokenize", "HybridCollection",
           "HybridSearchResult"]
