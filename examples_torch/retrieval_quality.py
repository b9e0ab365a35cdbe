"""Retrieval-quality walkthrough: does the engine find what it should?

The PyTorch/CUDA port's rendition of the reference's retrieval demo
(examples/retrieval_demo.py:1-40): a small clustered corpus, pairwise
similarity sanity checks, expected-hit retrieval tests scored as a recall
percentage, filtered retrieval, hybrid (vector + BM25) comparison, and an
optional interactive search loop.

Runs fully offline.  The default embedder is the package's dependency-free
HashingEmbedder (signed feature-hashing bag of words — texts that share
vocabulary are genuinely close); pass ``--provider sentence-transformers``
for real semantic embeddings when the model is installed.

Run: python examples_torch/retrieval_quality.py [--interactive]
[--device cpu] (on the card by default)
"""

import argparse
import shutil
import tempfile

import numpy as np

from fastpyvectordb_tpu_torch import Filter, VectorDB
from fastpyvectordb_tpu_torch.embeddings import get_embedder
from fastpyvectordb_tpu_torch.hybrid import BM25Index

BAR = "=" * 68

CORPUS = [
    # cluster: ML / AI
    ("ml_basics", "AI", "Intro to Machine Learning",
     "Machine learning algorithms learn patterns from training data and "
     "make predictions on unseen examples without explicit programming."),
    ("ml_deep", "AI", "Deep Neural Networks",
     "Deep learning stacks many neural network layers to model complex "
     "functions; networks excel at vision and language tasks."),
    ("ml_kinds", "AI", "Supervised and Unsupervised Learning",
     "Supervised learning fits labeled data; unsupervised learning finds "
     "clusters and structure in unlabeled data."),
    # cluster: databases
    ("db_vector", "Database", "Vector Databases",
     "Vector databases index high-dimensional embeddings for fast nearest "
     "neighbor similarity search, powering semantic retrieval."),
    ("db_sql", "Database", "Relational SQL Databases",
     "Relational databases store rows in tables; SQL queries join, filter "
     "and aggregate structured records."),
    ("db_doc", "Database", "Document Stores",
     "Document databases keep flexible JSON records without a fixed schema "
     "and scale horizontally."),
    # cluster: web
    ("web_api", "Web", "REST API Design",
     "REST APIs expose web services over HTTP endpoints returning JSON, "
     "with authentication tokens and rate limits."),
    ("web_js", "Web", "Frontend Frameworks",
     "JavaScript frameworks build interactive user interfaces from "
     "components rendered efficiently in the browser."),
    # cluster: cooking
    ("cook_pasta", "Cooking", "Italian Pasta",
     "Classic Italian pasta needs al dente noodles, olive oil, and aged "
     "parmesan cheese for authentic flavor."),
    ("cook_bread", "Cooking", "Baking Bread",
     "Bread dough of flour, water, yeast and salt is kneaded, proofed and "
     "baked in a hot oven for a crisp crust."),
    # cross-domain
    ("x_ai_food", "AI+Cooking", "AI Recipe Generation",
     "Machine learning models trained on culinary data generate novel "
     "recipes by learning flavor pairings."),
    ("x_web_db", "Web+Database", "Database-Backed Web Apps",
     "Web applications persist state in databases; backend APIs serve "
     "stored records to frontend JavaScript."),
]

QUERIES = [
    ("How do neural networks learn from data?",
     {"ml_basics", "ml_deep", "ml_kinds"}),
    ("Where should I store embeddings for similarity search?",
     {"db_vector"}),
    ("Building a website with JavaScript", {"web_js", "web_api", "x_web_db"}),
    ("Making homemade Italian food", {"cook_pasta", "cook_bread"}),
    ("Using AI to invent new recipes", {"x_ai_food", "ml_basics"}),
    ("SQL tables, rows and joins", {"db_sql"}),
]


def hr(title):
    print(f"\n{BAR}\n  {title}\n{BAR}")


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--provider", default="hashing")
    ap.add_argument("--interactive", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    device = device or a.device

    hr("EMBEDDER")
    emb = get_embedder(a.provider, device=device)
    print(f"model={emb.model_name} dims={emb.dimensions}")

    texts = {i: f"{t}. {c}" for i, _, t, c in CORPUS}
    vecs = {i: v for i, v in zip(texts, emb.embed_batch(list(texts.values())))}

    tmp = tempfile.mkdtemp()
    try:
        db = VectorDB(tmp, device=device)
        col = db.create_collection("docs", dimensions=emb.dimensions,
                                   metric="cosine")
        col.insert_batch(
            np.stack([vecs[i] for i, *_ in CORPUS]),
            ids=[i for i, *_ in CORPUS],
            metadatas=[{"category": cat, "title": t} for _, cat, t, _ in CORPUS])
        print(f"inserted {col.count()} docs into {col.config.name!r}")

        hr("PAIRWISE SIMILARITY SANITY")
        pairs = [("ml_basics", "ml_deep", "same cluster -> high"),
                 ("ml_basics", "cook_pasta", "different domain -> low"),
                 ("x_ai_food", "ml_basics", "cross-domain -> middle"),
                 ("db_sql", "db_doc", "same cluster -> high-ish")]
        for x, y, note in pairs:
            sim = float(np.dot(vecs[x], vecs[y])
                        / (np.linalg.norm(vecs[x]) * np.linalg.norm(vecs[y])))
            print(f"  {x:11s} vs {y:11s}  cos={sim:+.4f}   ({note})")

        hr("RETRIEVAL TESTS (expected doc in top 3)")
        passed = 0
        for q, expected in QUERIES:
            hits = col.search(emb.embed(q), k=5)
            top3 = {h.id for h in hits[:3]}
            ok = bool(top3 & expected)
            passed += ok
            mark = "PASS" if ok else "FAIL"
            shown = ", ".join(f"{h.id}({1 - h.score:+.3f})" for h in hits[:3])
            print(f"  [{mark}] {q!r}\n         top3: {shown}")
        pct = 100.0 * passed / len(QUERIES)
        print(f"\n  retrieval accuracy: {passed}/{len(QUERIES)} ({pct:.0f}%)")

        hr("FILTERED RETRIEVAL")
        q = "How does learning work?"
        qv = emb.embed(q)
        for flt, label in ((None, "unfiltered"),
                           (Filter.eq("category", "AI"), "category=AI"),
                           (Filter.eq("category", "Cooking"),
                            "category=Cooking")):
            hits = col.search(qv, k=3, filter=flt)
            print(f"  {label:18s} ->",
                  [f"{h.id} [{h.metadata['category']}]" for h in hits])

        hr("HYBRID: VECTOR vs KEYWORD (BM25) vs EXPECTATION")
        bm = BM25Index()
        for i, text in texts.items():
            bm.add_document(i, text)
        q = "parmesan cheese pasta"
        kw = bm.search(q, k=3)
        vs = col.search(emb.embed(q), k=3)
        print(f"  query: {q!r}")
        print("  bm25  :", [(d, round(s, 2)) for d, s in kw])
        print("  vector:", [(h.id, round(1 - h.score, 3)) for h in vs])

        if a.interactive:
            hr("INTERACTIVE (empty line to quit)")
            while True:
                try:
                    q = input("query> ").strip()
                except (EOFError, KeyboardInterrupt):
                    break
                if not q:
                    break
                for r, h in enumerate(col.search(emb.embed(q), k=5), 1):
                    print(f"  {r}. [{1 - h.score:+.3f}] "
                          f"{h.metadata['title']} ({h.id})")
        print("\ndone.")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
