"""Quickstart: the canonical API walkthrough, section by section.

Mirrors the reference's examples/quickstart.py:27-307 flow — basic usage,
filtering, CRUD, batch ops, multiple collections, provider selection,
peek/get-all, cleanup — on the PyTorch/CUDA port, plus the sections the
reference doesn't have (exact-vs-ANN-vs-quantized tiers, which launch the
port's hand-written kernels on the card).

Runs offline with the hashing embedder; pass --provider to use
sentence-transformers / OpenAI (falls back gracefully without keys).
Runs on the card (``--device cuda``, the default) or ``--device cpu``:

    python examples_torch/quickstart.py --device cpu
"""

import argparse
import os
import shutil
import time
from pathlib import Path

from fastpyvectordb_tpu_torch.api import Client

BAR = "=" * 60


def _hr(title: str) -> None:
    print(f"\n{BAR}\n{title}\n{BAR}")


def basic_usage(client):
    _hr("1. BASIC USAGE")
    col = client.get_or_create_collection("documents")
    if col.count:  # re-runnable
        col.delete(ids=col._collection.all_ids())
    col.add(
        documents=[
            "JAX traces Python functions and compiles them with XLA",
            "The TPU matrix unit multiplies 128x128 tiles per cycle",
            "Good pasta water should taste like the sea",
            "Index funds passively track a market benchmark",
            "Attention layers mix information across sequence positions",
        ],
        ids=["jax", "tpu", "pasta", "funds", "attention"],
        metadatas=[
            {"category": "ml", "difficulty": "intermediate", "year": 2024},
            {"category": "hw", "difficulty": "advanced", "year": 2023},
            {"category": "food", "difficulty": "beginner", "year": 2020},
            {"category": "finance", "difficulty": "beginner", "year": 2022},
            {"category": "ml", "difficulty": "advanced", "year": 2024},
        ])
    print(f"added {col.count} documents")
    res = col.query("how does TPU hardware multiply matrices?", n_results=3)
    print("query: 'how does TPU hardware multiply matrices?'")
    for rid, doc, dist in zip(res.ids[0], res.documents[0],
                              res.distances[0]):
        print(f"  {rid:10s} d={dist:.4f}  {doc[:58]}")
    return col


def filtering(col):
    _hr("2. FILTERING")
    res = col.query("machine learning", n_results=5,
                    where={"difficulty": "advanced"})
    print("where difficulty=advanced:", res.ids[0])
    res = col.query("machine learning", n_results=5,
                    where={"category": "ml", "year": {"$gte": 2024}})
    print("where category=ml AND year>=2024:", res.ids[0])
    res = col.query("anything", n_results=5,
                    where={"$or": [{"category": "food"},
                                   {"category": "finance"}]})
    print("where food OR finance:", sorted(res.ids[0]))


def crud(col):
    _hr("3. CRUD OPERATIONS")
    print("get:", col.get(ids="pasta").documents)
    col.update("pasta", metadatas=[{"stars": 5}])
    print("after update:", col.get(ids="pasta").metadatas)
    col.upsert(documents=["Risotto requires patience and stirring"],
               ids=["pasta"])
    print("after upsert:", col.get(ids="pasta").documents)
    col.delete(ids="funds")
    print("count after delete:", col.count)
    col.add(documents=["Index funds passively track a market benchmark"],
            ids=["funds"], metadatas=[{"category": "finance", "year": 2022}])


def batch_ops(client):
    _hr("4. BATCH OPERATIONS")
    col = client.get_or_create_collection("batch_demo")
    if col.count:
        col.delete(ids=col._collection.all_ids())
    n = 200
    docs = [f"document {i} about topic {i % 10}" for i in range(n)]
    t0 = time.perf_counter()
    col.add(documents=docs, ids=[f"b{i}" for i in range(n)],
            metadatas=[{"topic": i % 10} for i in range(n)])
    dt = time.perf_counter() - t0
    print(f"batch add: {n} docs in {dt:.2f}s ({n/dt:,.0f} docs/s)")
    queries = ["topic 0", "topic 5", "some document"]
    t0 = time.perf_counter()
    res = col.query(queries, n_results=3)
    print(f"batch query: {len(queries)} texts in "
          f"{(time.perf_counter()-t0)*1e3:.1f} ms")
    for i, q in enumerate(queries):
        print(f"  {q!r} -> {res.ids[i][:2]}")


def multi_collection(client):
    _hr("5. MULTIPLE COLLECTIONS")
    articles = client.get_or_create_collection("articles")
    products = client.get_or_create_collection("products")
    for c in (articles, products):
        if c.count:
            c.delete(ids=c._collection.all_ids())
    articles.add(documents=["Python tutorial for beginners",
                            "Advanced asynchronous programming"],
                 ids=["a1", "a2"])
    products.add(documents=["Laptop with 16GB of memory",
                            "Wireless ergonomic mouse"],
                 ids=["p1", "p2"])
    print("collections:", sorted(client.list_collections()))
    q = "computer peripherals"
    print(f"query {q!r}:")
    print("  articles ->", articles.query(q, n_results=1).documents[0])
    print("  products ->", products.query(q, n_results=1).documents[0])


def providers(client):
    _hr("6. EMBEDDING PROVIDERS")
    print("active provider:", client._default_provider)
    if os.environ.get("OPENAI_API_KEY"):
        oc = client.create_collection("openai_docs",
                                      embedding_provider="openai")
        oc.add(documents=["embedding via a hosted API"], ids=["o1"])
        print("openai collection:", oc.query("hosted", n_results=1).ids[0])
        client.delete_collection("openai_docs")
    else:
        print("  (set OPENAI_API_KEY to exercise the OpenAI provider; "
              "mock / hashing / sentence-transformers also available)")


def search_tiers(col):
    _hr("7. SEARCH TIERS (exact / IVF / int8 two-stage)")
    inner = col._collection
    res = col.query("neural attention", n_results=2)
    print("exact scan      :", res.ids[0])
    inner.build_ann(kind="ivf", nlist=8, nprobe=4, iters=3)
    hits = inner.search(inner.get("attention", include_vector=True)["vector"],
                        k=2, exact=False)
    print("IVF ANN         :", [h.id for h in hits])
    inner.enable_quantized_scan("int8")
    hits = inner.search_quantized(
        inner.get("attention", include_vector=True)["vector"][None, :], k=2)
    print("int8 two-stage  :", [h.id for h in hits[0]])


def peek_and_get_all(col):
    _hr("8. PEEK AND GET ALL")
    sample = col.peek(limit=3)
    print("peek(3):", sample.ids)
    everything = col.get()
    print("get() total:", len(everything.ids))
    filtered = col.get(where={"category": "ml"})
    print("get(where category=ml):", sorted(filtered.ids))


def main(provider: str = "hashing", path: str = "./quickstart_data",
         keep: bool = False, device: str = "cuda"):
    client = Client(path=path, embedding_provider=provider, device=device)
    try:
        col = basic_usage(client)
        filtering(col)
        crud(col)
        batch_ops(client)
        multi_collection(client)
        providers(client)
        search_tiers(col)
        peek_and_get_all(col)
        client.persist()
        _hr(f"persisted to {path}")
    finally:
        if not keep and Path(path).exists():
            shutil.rmtree(path)
            print(f"cleaned up {path}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--provider", default="hashing")
    p.add_argument("--path", default="./quickstart_data")
    p.add_argument("--keep", action="store_true",
                   help="keep the database on disk after the run")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args()
    main(a.provider, a.path, a.keep, a.device)
