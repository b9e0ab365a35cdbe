"""Phased news-intelligence demo (reference parity:
news_intelligence_demo.py run_search_demo/run_benchmark/run_graph_demo/
run_quantization_demo/run_use_case_scenarios/run_all).

Runs fully offline, on the card (``--device cuda``, the default) or on the
CPU (``--device cpu``).  Usage, from the repository root:
    python -m examples_torch.news_intelligence.demo --articles 5000
    python -m examples_torch.news_intelligence.demo --phase graph
"""

from __future__ import annotations

import argparse
import shutil
import time

import numpy as np

from fastpyvectordb_tpu_torch import Filter
from fastpyvectordb_tpu_torch.profiling import QueryTimer
from fastpyvectordb_tpu_torch.realtime import Event, EventBus, EventType, \
    ObservableCollection

from .datagen import CATEGORIES, COMPANIES, DemoConfig
from .platform import NewsIntelligencePlatform

BAR = "=" * 72


def _hr(title: str) -> None:
    print(f"\n{BAR}\n{title}\n{BAR}")


def _show(hits, n=3, score_attr="score"):
    for i, h in enumerate(hits[:n], 1):
        meta = getattr(h, "metadata", {}) or {}
        print(f"    {i}. [{getattr(h, score_attr):.4f}] "
              f"[{meta.get('category', '?')}] "
              f"{meta.get('headline', '')[:58]}")


class NewsIntelligenceDemo:
    def __init__(self, config: DemoConfig):
        self.config = config
        self.platform = NewsIntelligencePlatform(config)
        self.articles = []

    # ------------------------------------------------------------------
    def setup(self):
        _hr("NEWS INTELLIGENCE PLATFORM — SETUP")
        cfg = self.config
        print(f"  articles={cfg.num_articles:,}  dims={cfg.embedding_dim}  "
              f"db={cfg.db_path}")
        self.articles = self.platform.generator.generate_all()
        rate = self.platform.ingest(self.articles)
        print(f"  ingest rate: {rate:,.0f} articles/s")
        gstats = self.platform.build_knowledge_graph(self.articles)
        print(f"  graph: {gstats}")
        idx = self.platform.build_indexes(
            ann="ivf", quantized="int8",
            nlist=max(16, cfg.num_articles // 64), nprobe=8, iters=4)
        print(f"  indexes: {idx}")

    # ------------------------------------------------------------------
    def run_search_demo(self):
        _hr("SEARCH DEMONSTRATIONS")
        p = self.platform

        print("\n--- 1. semantic search ---")
        for q in ["accelerator chip supply", "carbon pricing rules",
                  "offshore wind tenders"]:
            print(f"  query: {q!r}")
            _show(p.semantic_search(q, k=5))

        print("\n--- 2. filtered search (category) ---")
        print("  query: 'model training costs' in category=technology")
        _show(p.semantic_search("model training costs", k=5,
                                filters={"category": "technology"}))

        print("\n--- 3. sentiment + category filter ---")
        for s in ("positive", "negative"):
            print(f"  query: 'earnings outlook' sentiment={s}")
            _show(p.semantic_search(
                "earnings outlook", k=3,
                filters={"category": "markets", "sentiment": s}), n=2)

        print("\n--- 4. source filter (IN-list) ---")
        outlets = CATEGORIES["technology"]["outlets"][:3]
        hits = p.semantic_search(
            "datacenter buildout", k=5,
            filters={"source": {"$in": outlets}})
        for h in hits[:3]:
            print(f"    [{h.score:.4f}] [{h.metadata['source']}] "
                  f"{h.metadata['headline'][:52]}")

        print("\n--- 5. range filter (recent window) ---")
        recent = self.config.days - 60
        hits = p.collection.search(
            p.generator.query_embedding("storage deployments"), k=5,
            filter=Filter.gte("day_index", recent))
        for h in hits[:3]:
            print(f"    day={h.metadata['day_index']:3d} "
                  f"{h.metadata['headline'][:56]}")

        print("\n--- 6. keyword (BM25) vs hybrid ---")
        q = "fusion milestones announcement"
        print(f"  keyword: {q!r}")
        for r in p.keyword_search(q, k=3):
            print(f"    [{r.score:.2f}] {r.metadata['headline'][:58]}")
        print(f"  hybrid (alpha=0.5): {q!r}")
        for r in p.hybrid_search(q, k=3):
            print(f"    [{r.score:.3f}] {r.metadata['headline'][:58]}")

    # ------------------------------------------------------------------
    def run_benchmark(self):
        _hr("PERFORMANCE BENCHMARKS")
        p = self.platform
        queries = [p.generator.query_embedding(t)
                   for spec in CATEGORIES.values() for t in spec["topics"][:2]]
        qmat = np.stack(queries)

        timer = QueryTimer()
        for i in range(qmat.shape[0]):
            with timer.measure():
                p.collection.search(qmat[i], k=10, exact=True)
        st = timer.summary()
        print(f"  single-query exact: p50={st['p50_ms']:.2f} ms  "
              f"p95={st['p95_ms']:.2f} ms  ({st['qps']:.0f} qps)")

        t0 = time.perf_counter()
        p.collection.search_batch(qmat, k=10, exact=True)
        dt = time.perf_counter() - t0
        print(f"  batched exact ({qmat.shape[0]} queries): {dt*1e3:.1f} ms "
              f"({qmat.shape[0]/dt:,.0f} qps)")

        t0 = time.perf_counter()
        p.collection.search_batch(qmat, k=10, exact=False)
        dt = time.perf_counter() - t0
        print(f"  batched ANN: {dt*1e3:.1f} ms ({qmat.shape[0]/dt:,.0f} qps)")

        t0 = time.perf_counter()
        p.collection.search_quantized(qmat, k=10)
        dt = time.perf_counter() - t0
        print(f"  batched int8 2-stage: {dt*1e3:.1f} ms "
              f"({qmat.shape[0]/dt:,.0f} qps)")

        f = Filter.eq("category", "markets")
        t0 = time.perf_counter()
        p.collection.search_batch(qmat, k=10, filter=f)
        dt = time.perf_counter() - t0
        print(f"  batched filtered: {dt*1e3:.1f} ms "
              f"({qmat.shape[0]/dt:,.0f} qps)")

    # ------------------------------------------------------------------
    def run_graph_demo(self):
        _hr("KNOWLEDGE GRAPH DEMONSTRATIONS")
        p, g = self.platform, self.platform.graph

        print("\n--- 1. graph statistics ---")
        print(f"  {g.stats()}")

        print("\n--- 2. entity profile ---")
        prof = p.entity_profile(COMPANIES[0])
        print(f"  {prof['entity']}: {prof['mention_count']} mentions")
        print(f"  top topics: {prof['top_topics'][:3]}")
        print(f"  co-mentioned with: {prof['co_mentioned'][:3]}")

        print("\n--- 3. relationship traversal ---")
        arts = g.neighbors(f"company:{COMPANIES[0]}", "in", "MENTIONS")
        print(f"  {COMPANIES[0]} mentioned in {len(arts)} graph articles; "
              "latest:")
        for a in sorted(arts, key=lambda n: -n.properties["day_index"])[:3]:
            print(f"    day={a.properties['day_index']:3d} "
                  f"{a.properties['headline'][:56]}")

        print("\n--- 4. multi-hop related entities ---")
        rel = p.related_entities(COMPANIES[0], max_hops=2)
        print(f"  within 2 hops of {COMPANIES[0]}: {rel[:6]}")

        print("\n--- 5. cypher-like query ---")
        rows = g.query("MATCH (a:Article)-[:ABOUT]->(t:Topic) "
                       "WHERE a.category = 'energy' RETURN a.headline, t.name")
        print(f"  energy articles with topics: {len(rows)} rows; first 3:")
        for r in rows[:3]:
            print(f"    {r['t.name'][:28]:28s} {r['a.headline'][:44]}")

        print("\n--- 6. shortest path between entities ---")
        src, dst = f"company:{COMPANIES[0]}", f"company:{COMPANIES[1]}"
        path = g.shortest_path(src, dst)
        print(f"  {COMPANIES[0]} -> {COMPANIES[1]}: "
              f"{' -> '.join(path) if path else 'no path'}")

        print("\n--- 7. deep traversal ---")
        paths = g.traverse(f"company:{COMPANIES[2]}", max_depth=2)
        print(f"  {len(paths)} paths within depth 2 of {COMPANIES[2]}")

        print("\n--- 8. hyperedge co-mention analysis ---")
        hes = g.hyperedges_of_nodes([f"company:{COMPANIES[0]}"])
        print(f"  {COMPANIES[0]} participates in {len(hes)} co-mention "
              "hyperedges")

        print("\n--- 9. outlet coverage ---")
        outlet = CATEGORIES["markets"]["outlets"][0]
        pub = g.neighbors(f"outlet:{outlet}", "out", "PUBLISHED")
        print(f"  {outlet} published {len(pub)} graph articles")

        print("\n--- 10. trending entities ---")
        for e in p.trending_entities(k=5):
            print(f"    {e['name']:24s} ({e['type']}): {e['mentions']}")

    # ------------------------------------------------------------------
    def run_quantization_demo(self):
        _hr("QUANTIZATION DEMONSTRATIONS")
        p = self.platform
        q = "grid storage economics"
        exact = p.semantic_search(q, k=10, exact=True)
        exact_ids = {h.id for h in exact}

        for kind in ("int8", "binary"):
            scan = p.collection.enable_quantized_scan(kind)
            mem = scan.memory_usage()
            t0 = time.perf_counter()
            hits = p.quantized_search(q, k=10)
            dt = (time.perf_counter() - t0) * 1e3
            rec = len({h.id for h in hits} & exact_ids) / 10
            print(f"  {kind:6s}: compression {mem['compression_ratio']:.1f}x"
                  f"  recall@10 {rec:.2f}  first call {dt:.1f} ms")
        p.collection.enable_quantized_scan("int8")  # restore default

    # ------------------------------------------------------------------
    def run_use_case_scenarios(self):
        _hr("REAL-WORLD USE-CASE SCENARIOS")
        p = self.platform

        print("\n--- scenario 1: breaking-news alert system ---")
        # EventBus wiring: watch inserts, alert on topic match
        alerts = []
        watch = p.generator.query_embedding("refinery outage disruption")

        def on_event(ev: Event):
            if ev.type is EventType.INSERT:
                headline = ev.data.get("metadata", {}).get("headline", "")
                vec = p.generator.query_embedding(headline)
                sim = float(vec @ watch / (np.linalg.norm(vec)
                                           * np.linalg.norm(watch) + 1e-9))
                if sim > 0.15:
                    alerts.append(headline)

        bus = EventBus()
        bus.subscribe(on_event)
        bus.start()
        obs = ObservableCollection(p.collection, bus.publish)
        gen = p.generator
        existing = set(p.collection.all_ids())
        base = 10_000_000
        while f"article_{base}" in existing:  # re-run over a persisted db
            base += 100
        for i in range(40):
            a = gen.article(base + i)
            a.embedding = gen.query_embedding(a.headline + " " + a.content)
            obs.insert(a.embedding, id=a.id, metadata=a.to_metadata())
        # drain before stop(): stop() discards the queued backlog
        for _ in range(100):
            if bus.stats()["queued"] == 0:
                break
            time.sleep(0.05)
        time.sleep(0.1)  # let the in-flight handler finish
        bus.stop()
        print(f"  streamed 40 articles; {len(alerts)} matched the "
              "'refinery outage' watchlist")
        for h in alerts[:3]:
            print(f"    ALERT: {h[:60]}")

        print("\n--- scenario 2: competitive intelligence ---")
        target = COMPANIES[3]
        prof = p.entity_profile(target)
        print(f"  {target}: {prof['mention_count']} mentions, "
              f"competitors by co-mention: {prof['co_mentioned'][:3]}")

        print("\n--- scenario 3: research assistant ---")
        q = "hydrogen pilot economics"
        print(f"  question: {q!r}")
        ctx = p.hybrid_search(q, k=3)
        for r in ctx:
            print(f"    source: {r.metadata['headline'][:58]}")
        print(f"    -> answer would cite {len(ctx)} passages "
              "(see examples_torch/rag_demo.py for the full RAG loop)")

        print("\n--- scenario 4: trend analysis ---")
        recent = self.config.days - 90
        before = p.trending_entities(k=30)
        after = p.trending_entities(k=30, since_day=recent)
        b_rank = {e["name"]: i for i, e in enumerate(before)}
        movers = sorted(
            ((b_rank.get(e["name"], 30) - i, e["name"])
             for i, e in enumerate(after)), reverse=True)[:3]
        print(f"  fastest-rising entities in the last 90 days: "
              f"{[m[1] for m in movers]}")

        print("\n--- scenario 5: graph-augmented semantic search ---")
        rows = p.graph_augmented_search("chip fabrication yields", k=5)
        for r in rows[:3]:
            print(f"    [{r['score']:.3f}] deg={r['graph_degree']:3d} "
                  f"{r['headline'][:52]}")

    # ------------------------------------------------------------------
    def run_persistence_check(self):
        _hr("PERSISTENCE ROUNDTRIP")
        p = self.platform
        p.save()
        fresh = NewsIntelligencePlatform(self.config)
        assert fresh.collection.count() == p.collection.count()
        hits = fresh.semantic_search("export controls", k=3)
        print(f"  reloaded {fresh.collection.count():,} articles; "
              f"search works: {bool(hits)}")
        print(f"  graph reloaded: {fresh.graph.stats()}")

    # ------------------------------------------------------------------
    def run_all(self):
        t0 = time.perf_counter()
        self.setup()
        self.run_search_demo()
        self.run_benchmark()
        self.run_graph_demo()
        self.run_quantization_demo()
        self.run_use_case_scenarios()
        self.run_persistence_check()
        _hr(f"DEMO COMPLETE in {time.perf_counter() - t0:.1f}s")


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--articles", type=int, default=5000)
    ap.add_argument("--db-path", default="./news_intelligence_db")
    ap.add_argument("--phase", default="all",
                    choices=["all", "search", "benchmark", "graph",
                             "quantization", "scenarios"])
    ap.add_argument("--fresh", action="store_true",
                    help="delete any existing db first")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.fresh:
        shutil.rmtree(args.db_path, ignore_errors=True)
    cfg = DemoConfig(num_articles=args.articles, db_path=args.db_path,
                     graph_articles=min(args.articles, 2000),
                     device=device or args.device)
    demo = NewsIntelligenceDemo(cfg)
    if args.phase == "all":
        demo.run_all()
    else:
        demo.setup()
        getattr(demo, {"search": "run_search_demo",
                       "benchmark": "run_benchmark",
                       "graph": "run_graph_demo",
                       "quantization": "run_quantization_demo",
                       "scenarios": "run_use_case_scenarios"}[args.phase])()


if __name__ == "__main__":
    main()
