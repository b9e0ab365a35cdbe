"""Full-framework guided tour — every subsystem, one runnable script.

Reference parity: the reference's examples/demo.py (566 LoC) — the same
six-part walkthrough (vector search with filters, graph database with
traversal, manual hybrid fusion, automatic embeddings, realtime events,
persistence & recovery), plus the extras this framework adds: the
quantized two-stage scan, ANN indexes with incremental maintenance, and
graph+vector fusion.  On the PyTorch/CUDA port, fully offline, on the card
(``--device cuda``, the default) or on the CPU:

    python examples_torch/demo.py                 # run everything
    python examples_torch/demo.py 1 4 6           # selected demos by number
    python examples_torch/demo.py --device cpu    # on the CPU
"""

import argparse
import shutil
import tempfile
import time

import numpy as np

import fastpyvectordb_tpu_torch as fvdb
from fastpyvectordb_tpu_torch import CollectionConfig, Filter, VectorDB
from fastpyvectordb_tpu_torch.embeddings import (CachedEmbedder,
                                           EmbeddingCollection,
                                           MockEmbedder)
from fastpyvectordb_tpu_torch.graphdb import GraphDB
from fastpyvectordb_tpu_torch.graphdb.hybrid import HybridGraphVectorDB
from fastpyvectordb_tpu_torch.hybrid import HybridCollection
from fastpyvectordb_tpu_torch.realtime import EventBus, ObservableCollection


def print_header(title):
    print("\n" + "=" * 70)
    print(f"  {title}")
    print("=" * 70)


def print_section(title):
    print(f"\n--- {title} ---")


# =========================================================================
# DEMO 1: Vector search with metadata filters
# =========================================================================
def demo_vector_search(device):
    print_header("DEMO 1: Vector Search with Metadata Filters")
    tmp = tempfile.mkdtemp()
    db = VectorDB(tmp, device=device)
    col = db.create_collection("products", dimensions=128, metric="cosine")

    products = [
        ("p1", "Trail Running Shoes", "footwear", 89.99),
        ("p2", "Road Running Shoes", "footwear", 79.99),
        ("p3", "Leather Hiking Boots", "footwear", 149.99),
        ("p4", "Canvas Sneakers", "footwear", 69.99),
        ("p5", "Running T-Shirt", "clothing", 29.99),
        ("p6", "Denim Jeans", "clothing", 59.99),
        ("p7", "Rain Jacket", "clothing", 129.99),
        ("p8", "Running Shorts", "clothing", 34.99),
    ]

    # Composite attribute embeddings: similar products land close
    # together, so 'running gear' retrieves across categories.
    rng = np.random.default_rng(42)
    axes = {a: rng.standard_normal(128).astype(np.float32) * 0.1
            for a in ("running", "footwear", "clothing", "outdoor")}

    print_section("Indexing the catalog")
    vecs, ids, metas = [], [], []
    for pid, name, category, price in products:
        v = rng.standard_normal(128).astype(np.float32) * 0.05
        lname = name.lower()
        for axis in ("running", "outdoor"):
            if axis in lname or (axis == "outdoor" and
                                 ("hiking" in lname or "rain" in lname)):
                v += axes[axis]
        v += axes[category]
        vecs.append(v / np.linalg.norm(v))
        ids.append(pid)
        metas.append({"name": name, "category": category, "price": price})
        print(f"  indexed {pid}: {name}")
    col.insert_batch(np.stack(vecs), ids, metas)

    print_section("Semantic search: 'running gear'")
    q = axes["running"] + axes["footwear"]
    q = q / np.linalg.norm(q)
    hits = col.search(q, k=5)
    for i, r in enumerate(hits, 1):
        print(f"  {i}. {r.metadata['name']} (score {r.score:.4f})")
    assert any("Running" in r.metadata["name"] for r in hits[:2])

    print_section("Filtered search: footwear under $100")
    f = Filter.and_([Filter.eq("category", "footwear"),
                     Filter.lt("price", 100)])
    hits = col.search(q, k=5, filter=f)
    for i, r in enumerate(hits, 1):
        print(f"  {i}. {r.metadata['name']} — ${r.metadata['price']}")
    assert all(r.metadata["category"] == "footwear" and
               r.metadata["price"] < 100 for r in hits)

    print_section("Filter algebra: NOT clothing OR expensive")
    f = Filter.or_([Filter.not_(Filter.eq("category", "clothing")),
                    Filter.gte("price", 120)])
    hits = col.search(q, k=8, filter=f)
    print(f"  {len(hits)} matches:",
          sorted(r.metadata["name"] for r in hits))

    print_section("Mongo-style filter dicts")
    f = Filter.from_dict({"$and": [{"category": "clothing"},
                                   {"price": {"$lte": 60}}]})
    hits = col.search(q, k=8, filter=f)
    print("  clothing <= $60:", sorted(r.metadata["name"] for r in hits))

    shutil.rmtree(tmp)
    return True


# =========================================================================
# DEMO 2: Graph database with traversal
# =========================================================================
def demo_graph_database(device):   # the graph lives on the host
    print_header("DEMO 2: Graph Database with Traversal")
    g = GraphDB()

    print_section("Building a social network")
    users = [
        ("alice", "Alice", 28, "NYC"), ("bob", "Bob", 32, "LA"),
        ("charlie", "Charlie", 25, "NYC"), ("diana", "Diana", 30, "Chicago"),
        ("eve", "Eve", 27, "NYC"),
    ]
    for uid, name, age, city in users:
        (g.node().id(uid).label("Person")
          .properties(name=name, age=age, city=city).create())
        print(f"  user {name} ({city})")
    for topic in ("python", "jax", "ai", "music", "climbing"):
        g.node().id(topic).label("Interest").property(
            "name", topic.title()).create()

    friendships = [("alice", "bob"), ("alice", "charlie"), ("bob", "diana"),
                   ("charlie", "eve"), ("diana", "eve")]
    for a, b in friendships:
        (g.edge().from_node(a).to_node(b).type("FRIENDS_WITH")
          .property("since", 2023).create())
    for user, topics in [("alice", ["python", "ai"]), ("bob", ["jax", "ai"]),
                         ("charlie", ["python", "music"]),
                         ("diana", ["climbing", "music"]),
                         ("eve", ["python", "jax", "ai"])]:
        for t in topics:
            g.create_edge(user, t, "INTERESTED_IN")

    print_section("Queries")
    print("1. people in NYC (cypher):")
    for row in g.query("MATCH (p:Person) WHERE p.city = 'NYC' RETURN p.name"):
        print(f"   - {row['p.name']}")

    print("2. Alice's friends (adjacency index):")
    friends = g.neighbors("alice", edge_type="FRIENDS_WITH")
    for n in friends:
        print(f"   - {n.properties['name']}")
    assert {n.id for n in friends} == {"bob", "charlie"}

    print("3. who is into AI (reverse edges):")
    for n in g.neighbors("ai", direction="in", edge_type="INTERESTED_IN"):
        print(f"   - {n.properties['name']}")

    print("4. shortest path alice -> diana (BFS):")
    path = g.shortest_path("alice", "diana")
    names = [g.get_node(nid).properties.get("name", nid) for nid in path]
    print("   " + " -> ".join(names))
    assert len(path) == 3  # alice -> bob -> diana

    print("5. reachable people within 2 hops of alice (DFS):")
    seen = {}
    for path_ids in g.traverse("alice", max_depth=2):
        for nid in path_ids:
            node = g.get_node(nid)
            if "Person" in node.labels:
                seen[nid] = node.properties["name"]
    print("   " + ", ".join(sorted(seen.values())))

    print("6. age range scan (property range index):")
    for n in g.find_nodes_in_range("age", 26, 31):
        print(f"   - {n.properties['name']} ({n.properties['age']})")

    print("7. hyperedge: a group trip")
    g.create_hyperedge(["alice", "diana", "eve"], "TRIP",
                       {"where": "Yosemite"})
    he = g.hyperedges_of_nodes(["diana"])
    print(f"   diana's hyperedges: {[h.type for h in he]}")

    print_section("Graph stats")
    print(f"  {g.stats()}")
    return True


# =========================================================================
# DEMO 3: Hybrid search (vector + BM25 in one collection)
# =========================================================================
def demo_hybrid_search(device):
    print_header("DEMO 3: Hybrid Search (Vector + BM25)")
    emb = MockEmbedder(dimensions=128)
    col = HybridCollection(CollectionConfig(name="kb", dimensions=128),
                           text_fields=["text"], device=device)
    docs = {
        "jax": "JAX traces python functions and compiles them with XLA",
        "tpu": "TPUs multiply big bfloat16 matrices on a systolic array",
        "cnn": "convolutional networks recognize images by local patterns",
        "soup": "a slow-simmered soup recipe for cold winter evenings",
        "fed": "central banks move markets when they change interest rates",
    }
    col.insert_batch(np.stack([emb.embed(t) for t in docs.values()]),
                     list(docs), [{"text": t} for t in docs.values()])
    print(f"  indexed {col.count()} docs (BM25 backend: "
          f"{col._bm25.stats().get('backend', 'python')})")

    query = "interest rates and markets"
    qv = emb.embed(query)
    print_section(f"query: {query!r}")
    for alpha, label in [(1.0, "vector"), (0.0, "bm25"), (0.5, "fused")]:
        res = col.hybrid_search(qv, query, k=3, alpha=alpha)
        print(f"  {label:7s}:",
              [(r.id, round(r.score, 3)) for r in res])
    best = col.hybrid_search(qv, query, k=1, alpha=0.0)[0]
    assert best.id == "fed", best.id

    print_section("keyword-only surface")
    for r in col.keyword_search("systolic array matrices", k=2):
        print(f"  {r.id}: bm25={r.keyword_score:.3f}")
    return True


# =========================================================================
# DEMO 4: Automatic embeddings
# =========================================================================
def demo_embeddings(device):
    print_header("DEMO 4: Automatic Embeddings")
    # MockEmbedder: deterministic sha256-seeded vectors — no API keys.
    # Swap in OpenAIEmbedder / CohereEmbedder / SentenceTransformerEmbedder
    # for real models (embeddings.py, get_embedder factory).
    tmp = tempfile.mkdtemp()
    embedder = CachedEmbedder(MockEmbedder(dimensions=128),
                              cache_dir=f"{tmp}/emb_cache")
    db = VectorDB(tmp, device=device)
    base = db.create_collection("articles", dimensions=embedder.dimensions)
    col = EmbeddingCollection(base, embedder)

    print_section("Adding documents with auto-embedding")
    articles = [
        ("a1", "Python is a versatile language for data science and web work."),
        ("a2", "Rust guarantees memory safety through ownership, not a GC."),
        ("a3", "JavaScript drives interactive behavior in every browser."),
        ("a4", "Machine learning finds patterns in large datasets."),
        ("a5", "Cloud platforms scale compute elastically on demand."),
    ]
    col.add_texts([t for _, t in articles], [i for i, _ in articles])
    for aid, text in articles:
        print(f"  embedded & indexed {aid}: {text[:48]}...")

    print_section("Semantic text search")
    for q in ("programming languages", "AI and data analysis"):
        print(f"  query: {q!r}")
        for i, r in enumerate(col.search_text(q, k=2), 1):
            print(f"    {i}. {r.id}: {r.metadata['_text'][:56]}...")

    print_section("Embedding cache")
    before = len(embedder._cache)
    _ = embedder.embed("programming languages")  # repeat -> cache hit
    assert len(embedder._cache) == before  # served from cache, no new entry
    print(f"  {before} embeddings cached on disk; repeat query hit the cache")
    shutil.rmtree(tmp)
    return True


# =========================================================================
# DEMO 5: Real-time events
# =========================================================================
def demo_realtime(device):
    print_header("DEMO 5: Real-time Event System")
    bus = EventBus()
    col = ObservableCollection(
        fvdb.Collection(CollectionConfig(name="rt", dimensions=32),
                        device=device),
        bus.publish)

    print_section("Subscribing")
    events = []

    def on_event(e):
        tag = e.type.value if hasattr(e.type, "value") else e.type
        events.append((tag, e.data.get("id")))
        print(f"  [EVENT] {tag}: id={e.data.get('id')}")

    bus.subscribe(on_event)
    bus.start()

    print_section("Mutations (each emits an event)")
    rng = np.random.default_rng(7)
    col.insert(rng.standard_normal(32).astype(np.float32), "item1",
               {"name": "first"})
    col.insert(rng.standard_normal(32).astype(np.float32), "item2",
               {"name": "second"})
    col.upsert(rng.standard_normal(32).astype(np.float32), "item1",
               {"name": "first, updated"})
    col.delete("item2")
    time.sleep(0.3)
    bus.stop()
    kinds = [k for k, _ in events]
    assert "delete" in " ".join(kinds).lower() or len(events) >= 4, events
    print(f"\n  captured {len(events)} events in real time")
    return True


# =========================================================================
# DEMO 6: Persistence & recovery
# =========================================================================
def demo_persistence(device):
    print_header("DEMO 6: Persistence & Recovery")
    tmp = tempfile.mkdtemp()
    dbdir = f"{tmp}/demo_db"

    print_section("Create, fill, save")
    db = VectorDB(dbdir, device=device)
    col = db.create_collection("persistent", dimensions=64)
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((5, 64)).astype(np.float32)
    col.insert_batch(vecs, [f"rec{i}" for i in range(5)],
                     [{"index": i, "name": f"Record {i}"} for i in range(5)])
    db.save()
    print(f"  saved to {dbdir} (FPVT container, per-section CRC32)")

    print_section("Reopen from disk")
    db2 = VectorDB(dbdir, device=device)
    col2 = db2.get_collection("persistent")
    print(f"  loaded 'persistent' with {col2.count()} records")
    for i in range(5):
        rec = col2.get(f"rec{i}")
        assert rec and rec["metadata"]["name"] == f"Record {i}"
        print(f"    rec{i}: {rec['metadata']['name']} ok")

    print_section("Searches survive the round-trip")
    before = [r.id for r in col.search(vecs[2], k=1)]
    after = [r.id for r in col2.search(vecs[2], k=1)]
    assert before == after == ["rec2"]
    print(f"  top-1 for rec2's vector: {after[0]} (matches pre-save)")
    shutil.rmtree(tmp)
    return True


# =========================================================================
# DEMO 7 (extra): quantized two-stage scan
# =========================================================================
def demo_quantized(device):
    print_header("DEMO 7: Quantized Two-Stage Scan")
    rng = np.random.default_rng(3)
    n, d = 5000, 128
    col = fvdb.Collection(CollectionConfig(name="q", dimensions=d,
                                           metric="cosine"), device=device)
    col.insert_batch(rng.standard_normal((n, d)).astype(np.float32),
                     [f"v{i}" for i in range(n)])

    print_section("int8 coarse scan + exact re-rank")
    q = rng.standard_normal((1, d)).astype(np.float32)
    exact = [r.id for r in col.search(q[0], k=5)]
    col.enable_quantized_scan("int8")
    ids = [h.id for h in col.search_quantized(q, k=5)[0]]
    overlap = len(set(exact) & set(ids))
    print(f"  exact top-5:     {exact}")
    print(f"  quantized top-5: {ids}  (overlap {overlap}/5)")
    assert overlap >= 4

    print_section("binary (1-bit Hamming) prefilter")
    col.enable_quantized_scan("binary")
    ids = [h.id for h in col.search_quantized(q, k=5, rerank=16)[0]]
    print(f"  binary top-5:    {ids} "
          f"(overlap {len(set(exact) & set(ids))}/5)")
    print("  memory: int8 = 4x smaller than f32, binary = 32x smaller")
    return True


# =========================================================================
# DEMO 8 (extra): ANN indexes + incremental maintenance
# =========================================================================
def demo_ann(device):
    print_header("DEMO 8: ANN Indexes + Incremental Maintenance")
    rng = np.random.default_rng(5)
    n, d = 4000, 64
    col = fvdb.Collection(CollectionConfig(name="ann", dimensions=d,
                                           metric="l2"), device=device)
    base = rng.standard_normal((n, d)).astype(np.float32)
    col.insert_batch(base, [f"v{i}" for i in range(n)])

    print_section("IVF build + search")
    col.build_ann(kind="ivf", nlist=32, nprobe=4, iters=4)
    hit = col.search(base[42], k=1, exact=False)[0]
    print(f"  top-1 for row 42's own vector: {hit.id}")
    assert hit.id == "v42"

    print_section("Inserts serve immediately (no rebuild)")
    nv = rng.standard_normal(d).astype(np.float32)
    col.insert(nv, "fresh")
    hit = col.search(nv, k=1, exact=False)[0]
    print(f"  top-1 for the just-inserted vector: {hit.id} "
          "(tail-merge, index untouched)")
    assert hit.id == "fresh"

    print_section("Deletes ride the validity mask")
    col.delete("v42")
    hits = [r.id for r in col.search(base[42], k=3, exact=False)]
    print(f"  search after delete: {hits} (v42 gone, no rebuild)")
    assert "v42" not in hits
    return True


# =========================================================================
# DEMO 9 (extra): graph + vector fusion
# =========================================================================
def demo_graph_vector(device):
    print_header("DEMO 9: Graph + Vector Fusion")
    emb = MockEmbedder(dimensions=128)
    hg = HybridGraphVectorDB(dimensions=128, device=device)
    papers = {
        "xla": "XLA compiles linear algebra graphs for accelerators",
        "jax": "JAX provides composable function transforms over XLA",
        "flax": "Flax builds neural networks as JAX pytrees",
        "mnist": "a tutorial training a convnet on handwritten digits",
    }
    for nid, text in papers.items():
        hg.add_node_with_embedding(["Paper"], {"text": text},
                                   emb.embed(text), id=nid)
    hg.graph.create_edge("jax", "xla", "BUILDS_ON")
    hg.graph.create_edge("flax", "jax", "BUILDS_ON")
    hg.graph.create_edge("mnist", "flax", "USES")

    print_section("semantic seed + graph expansion")
    res = hg.semantic_graph_search(emb.embed(papers["xla"]), k=4,
                                   expand_hops=2)
    for r in res:
        print(f"  {r.node.id:6s} score={r.score:.3f} hops={r.hops}")
    ids = [r.node.id for r in res]
    assert ids[0] == "xla" and "jax" in ids
    print("  graph hops pull in related papers the raw vector "
          "similarity would rank lower")
    return True


DEMOS = [demo_vector_search, demo_graph_database, demo_hybrid_search,
         demo_embeddings, demo_realtime, demo_persistence,
         demo_quantized, demo_ann, demo_graph_vector]


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description="guided tour of the port")
    ap.add_argument("demos", nargs="*", type=int,
                    help="demo numbers to run (default: all)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = device or args.device
    chosen = [DEMOS[i - 1] for i in args.demos] if args.demos else DEMOS
    for demo in chosen:
        demo(device)
    print_header(f"ALL {len(chosen)} DEMOS COMPLETE")


if __name__ == "__main__":
    main()
