"""Hybrid search walkthrough: vector vs BM25 keyword vs fused retrieval.

Reference parity: the reference's examples/hybrid_demo.py (341 LoC) — the
same demonstration arc (a TF-IDF bag-of-words embedder built over the
corpus, a document set engineered so each retrieval mode has queries it
wins, a per-query comparison across alpha settings, an insights summary,
and an interactive query loop with an ``alpha=X`` override), rebuilt on
the PyTorch/CUDA port's HybridCollection, on the card (``--device
cuda``, the default) or on the CPU (``--device cpu``).

Run non-interactively (prints the full comparison and exits):

    python examples_torch/hybrid_demo.py

Interactive query loop at the end:

    python examples_torch/hybrid_demo.py --interactive
"""

import argparse
import math
import re
from collections import Counter

import numpy as np

from fastpyvectordb_tpu_torch import CollectionConfig
from fastpyvectordb_tpu_torch.hybrid import HybridCollection


class TfIdfEmbedder:
    """Deterministic offline embedder: L2-normalized TF-IDF over a vocab
    built from the demo corpus.  Stands in for a real sentence encoder so
    the demo runs with zero network access, while still producing vectors
    whose cosine similarity tracks lexical-semantic overlap."""

    def __init__(self, dimensions: int = 256):
        self.dimensions = dimensions
        self._vocab: dict = {}
        self._idf: dict = {}

    @staticmethod
    def _tokenize(text: str):
        return re.findall(r"[a-z0-9]+", text.lower())

    def fit(self, documents):
        df = Counter()
        for text in documents:
            df.update(set(self._tokenize(text)))
        # most-frequent terms get the vocab slots (stable order for ties)
        terms = sorted(df, key=lambda t: (-df[t], t))[: self.dimensions]
        self._vocab = {t: i for i, t in enumerate(terms)}
        n = len(documents)
        self._idf = {t: 1.0 + math.log(n / (1 + df[t])) for t in terms}
        return self

    def embed(self, text: str) -> np.ndarray:
        v = np.zeros(self.dimensions, dtype=np.float32)
        for term, count in Counter(self._tokenize(text)).items():
            idx = self._vocab.get(term)
            if idx is not None:
                v[idx] = (1.0 + math.log(count)) * self._idf[term]
        norm = float(np.linalg.norm(v))
        return v / norm if norm > 0 else v


# A corpus engineered so the three retrieval modes disagree:
#  - acronym/jargon docs reward exact keyword match (BM25),
#  - paraphrase pairs reward vector similarity,
#  - a few docs straddle both so fusion can surface them.
DOCUMENTS = [
    dict(id="ivf-1", category="algorithm", text=(
        "IVF (inverted file) indexes partition vectors into Voronoi cells "
        "around trained centroids; queries probe only the nearest cells, "
        "trading recall for a large cut in scanned rows.")),
    dict(id="ivf-2", category="database", text=(
        "Modern vector databases route each query through a coarse "
        "quantizer and scan a handful of inverted lists, keeping tail "
        "latency flat as the corpus grows.")),
    dict(id="pq-1", category="algorithm", text=(
        "Product quantization compresses a vector into subspace codebook "
        "indices; asymmetric distance computation scores codes against a "
        "per-query lookup table without decompressing.")),
    dict(id="mxu-1", category="hardware", text=(
        "The TPU MXU is a systolic array that multiplies large matrices "
        "in bfloat16; keeping batches wide and shapes static is what "
        "lets the compiler tile work onto it.")),
    dict(id="emb-1", category="ml", text=(
        "Text embeddings map sentences to dense vectors where nearby "
        "points mean similar meaning; they power semantic search, "
        "clustering, and recommendation.")),
    dict(id="emb-2", category="ml", text=(
        "Sentence encoders capture context beyond bag-of-words: two "
        "phrasings of one idea land close together even when they share "
        "almost no vocabulary.")),
    dict(id="py-1", category="python", text=(
        "Python list comprehensions build lists in one expression; "
        "generator expressions do the same lazily without materializing "
        "the whole sequence.")),
    dict(id="py-2", category="python", text=(
        "NumPy broadcasting applies elementwise operations across arrays "
        "of different shapes, replacing slow Python loops with vectorized "
        "kernels.")),
    dict(id="pasta-1", category="cooking", text=(
        "Fresh pasta needs only flour, eggs, and kneading; rest the "
        "dough, roll it thin, and cut it into ribbons before a very "
        "short boil.")),
    dict(id="pasta-2", category="cooking", text=(
        "Homemade noodles beat the boxed kind: develop the gluten by "
        "working the dough, let it relax, then shape and cook it "
        "within the hour.")),
    dict(id="rag-1", category="ai", text=(
        "RAG (retrieval augmented generation) grounds a language model "
        "by fetching relevant passages first, so answers cite real "
        "documents instead of hallucinating.")),
    dict(id="wal-1", category="database", text=(
        "Write-ahead logging appends every mutation to a durable log "
        "before applying it, so a crash replays the tail instead of "
        "losing acknowledged writes.")),
]

# Each test pairs a query with the retrieval mode expected to shine.
TEST_CASES = [
    ("IVF inverted file index", "exact acronym 'IVF' — keyword search should nail it"),
    ("how do I make noodles from scratch", "paraphrase — vector search must bridge pasta/noodles wording"),
    ("RAG retrieval augmented generation", "acronym + expansion — keyword match is critical"),
    ("turn sentences into vectors for meaning search", "semantic concept — embedding docs should match"),
    ("python fast array math without loops", "mixed: exact term 'python' plus semantic 'array math'"),
]

ALPHAS = [
    (1.0, "VECTOR ONLY"),
    (0.0, "KEYWORD ONLY"),
    (0.5, "HYBRID balanced"),
    (0.3, "HYBRID favoring keywords"),
]


def build_collection(device="cuda"):
    emb = TfIdfEmbedder(256).fit([d["text"] for d in DOCUMENTS])
    col = HybridCollection(
        CollectionConfig(name="hybrid_demo", dimensions=emb.dimensions),
        text_fields=["text"], device=device)
    col.insert_batch(
        np.stack([emb.embed(d["text"]) for d in DOCUMENTS]),
        [d["id"] for d in DOCUMENTS],
        [{"text": d["text"], "category": d["category"]} for d in DOCUMENTS])
    return emb, col


def show(results, limit=3):
    for r in results[:limit]:
        print(f"     {r.id:8s} v={r.vector_score:.3f} "
              f"k={r.keyword_score:.3f} -> {r.score:.3f}")


def comparison(emb, col):
    print("=" * 70)
    print("  HYBRID SEARCH COMPARISON — vector vs BM25 vs fused")
    print("=" * 70)
    print(f"\ncorpus: {col.count()} documents, "
          f"{emb.dimensions}-d TF-IDF vectors + BM25 text index")

    for i, (query, note) in enumerate(TEST_CASES, 1):
        print(f"\n{'-' * 70}")
        print(f"Test {i}: {query!r}")
        print(f"  expectation: {note}")
        qvec = emb.embed(query)
        for alpha, label in ALPHAS:
            print(f"\n  {label} (alpha={alpha}):")
            show(col.hybrid_search(qvec, query, k=3, alpha=alpha))

    # keyword-only convenience surface (no vector needed at all)
    print(f"\n{'-' * 70}")
    print("keyword_search('durable write ahead log'):")
    for r in col.keyword_search("durable write ahead log", k=3):
        print(f"     {r.id:8s} bm25={r.keyword_score:.3f}")

    print("\n" + "=" * 70)
    print("  KEY INSIGHTS")
    print("=" * 70)
    print("""
  VECTOR search wins when wording differs but meaning matches
    (pasta <-> noodles, 'meaning search' <-> embedding docs).
  KEYWORD (BM25) wins on exact terms, acronyms, and jargon
    (IVF, RAG, proper names) that an embedder may dilute.
  HYBRID fuses both: alpha is the vector weight —
    0.5 balanced default, 0.3 for jargon-heavy queries,
    0.7 for conversational queries.""")


def sanity(emb, col):
    """The claims above, checked mechanically (the demo is also a test)."""
    q = "IVF inverted file index"
    kw = col.hybrid_search(emb.embed(q), q, k=3, alpha=0.0)
    assert any(r.id.startswith("ivf") for r in kw), [r.id for r in kw]
    q = "how do I make noodles from scratch"
    vec = col.hybrid_search(emb.embed(q), q, k=3, alpha=1.0)
    assert any(r.id.startswith("pasta") for r in vec), [r.id for r in vec]
    fused = col.hybrid_search(emb.embed(q), q, k=3, alpha=0.5)
    assert any(r.id.startswith("pasta") for r in fused)
    print("\nsanity checks passed: each mode wins its predicted query")


def interactive(emb, col):
    print("\n" + "=" * 70)
    print("  TRY YOUR OWN QUERIES   ('alpha=0.3 some query' overrides; "
          "'quit' exits)")
    print("=" * 70)
    alpha = 0.5
    while True:
        try:
            line = input(f"[alpha={alpha}] query: ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if line.lower() in ("quit", "exit", "q", ""):
            break
        if line.startswith("alpha="):
            head, _, rest = line.partition(" ")
            try:
                alpha = min(1.0, max(0.0, float(head.split("=", 1)[1])))
            except ValueError:
                print("   could not parse alpha")
                continue
            line = rest.strip()
            if not line:
                print(f"   alpha set to {alpha}")
                continue
        results = col.hybrid_search(emb.embed(line), line, k=5, alpha=alpha)
        for rank, r in enumerate(results, 1):
            text = (r.metadata or {}).get("text", "")
            print(f"   {rank}. [{r.score:.3f}] {r.id}  "
                  f"(v={r.vector_score:.3f} k={r.keyword_score:.3f})")
            print(f"      {text[:72]}...")
        print()


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description="vector vs BM25 vs fused")
    ap.add_argument("--interactive", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    emb, col = build_collection(device or args.device)
    comparison(emb, col)
    sanity(emb, col)
    if args.interactive:
        interactive(emb, col)
    print("\ndemo complete")


if __name__ == "__main__":
    main()
