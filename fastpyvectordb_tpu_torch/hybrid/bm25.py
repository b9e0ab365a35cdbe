"""BM25 inverted index for keyword search (port of
``fastpyvectordb_tpu/hybrid/bm25.py``, unchanged: it holds no arrays).

Parity with the reference's BM25Index (hybrid_search.py:49-204): k1/b
parameters, ``\\b\\w+\\b`` lowercase tokenizer, term -> {doc -> tf} inverted
index, document length normalization, the standard
``log((N - df + 0.5)/(df + 0.5) + 1)`` IDF, union-of-candidates scoring,
and JSON-shaped (de)serialization.  Host-side by design: term posting lists
are pointer-heavy, tiny relative to the vector corpus, and never worth a
device round-trip; only the score *fusion* joins device vector distances
(hybrid/collection.py).  ``native.NativeBM25`` is the C++ engine
behind the same interface.

Differences: scoring accumulates per-candidate numpy arrays over posting
lists (O(query_terms * postings) instead of O(candidates * query_terms)
dict lookups), and the index maintains itself on document removal.
"""

from __future__ import annotations

import dataclasses
import math
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

_TOKEN_RE = re.compile(r"\b\w+\b")


@dataclasses.dataclass
class BM25Config:
    k1: float = 1.5
    b: float = 0.75


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


class BM25Index:
    def __init__(self, config: Optional[BM25Config] = None):
        self.config = config or BM25Config()
        # term -> {doc_id -> term frequency}
        self._postings: Dict[str, Dict[str, int]] = defaultdict(dict)
        self._doc_len: Dict[str, int] = {}
        self._total_len = 0

    # ------------------------------------------------------------------
    @property
    def n_docs(self) -> int:
        return len(self._doc_len)

    @property
    def avg_doc_len(self) -> float:
        return self._total_len / self.n_docs if self.n_docs else 0.0

    def add_document(self, doc_id: str, text: str) -> None:
        if doc_id in self._doc_len:
            self.remove_document(doc_id)
        toks = tokenize(text)
        self._doc_len[doc_id] = len(toks)
        self._total_len += len(toks)
        for t in toks:
            self._postings[t][doc_id] = self._postings[t].get(doc_id, 0) + 1

    def remove_document(self, doc_id: str) -> bool:
        if doc_id not in self._doc_len:
            return False
        self._total_len -= self._doc_len.pop(doc_id)
        dead_terms = []
        for term, posting in self._postings.items():
            if doc_id in posting:
                del posting[doc_id]
                if not posting:
                    dead_terms.append(term)
        for t in dead_terms:
            del self._postings[t]
        return True

    # ------------------------------------------------------------------
    def idf(self, term: str) -> float:
        df = len(self._postings.get(term, ()))
        if df == 0:
            return 0.0
        return math.log((self.n_docs - df + 0.5) / (df + 0.5) + 1.0)

    def score(self, query: str, doc_id: str) -> float:
        dl = self._doc_len.get(doc_id)
        if dl is None:
            return 0.0
        k1, b = self.config.k1, self.config.b
        norm = k1 * (1.0 - b + b * dl / max(self.avg_doc_len, 1e-9))
        s = 0.0
        for term in tokenize(query):
            tf = self._postings.get(term, {}).get(doc_id, 0)
            if tf:
                s += self.idf(term) * tf * (k1 + 1.0) / (tf + norm)
        return s

    def search(self, query: str, k: int = 10) -> List[Tuple[str, float]]:
        """Top-k (doc_id, score), accumulated over posting lists."""
        k1, b = self.config.k1, self.config.b
        avgdl = max(self.avg_doc_len, 1e-9)
        scores: Dict[str, float] = defaultdict(float)
        for term in set(tokenize(query)):
            posting = self._postings.get(term)
            if not posting:
                continue
            idf = self.idf(term)
            for doc_id, tf in posting.items():
                norm = k1 * (1.0 - b + b * self._doc_len[doc_id] / avgdl)
                scores[doc_id] += idf * tf * (k1 + 1.0) / (tf + norm)
        ranked = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))
        return ranked[:k]

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "config": dataclasses.asdict(self.config),
            "postings": {t: dict(p) for t, p in self._postings.items()},
            "doc_len": dict(self._doc_len),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BM25Index":
        idx = cls(BM25Config(**d.get("config", {})))
        idx._postings = defaultdict(dict,
                                    {t: dict(p) for t, p in
                                     d.get("postings", {}).items()})
        idx._doc_len = {k: int(v) for k, v in d.get("doc_len", {}).items()}
        idx._total_len = sum(idx._doc_len.values())
        return idx

    def stats(self) -> dict:
        return {"documents": self.n_docs, "terms": len(self._postings),
                "avg_doc_len": self.avg_doc_len}
