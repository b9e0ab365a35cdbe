"""The news-intelligence application: one corpus, four indexes.

  * vector index      — HybridCollection (exact scan on the card + optional
                        ANN)
  * BM25 index        — keyword search over headline+content
  * knowledge graph   — articles, entities, topics, outlets + co-mention
                        hyperedges (GraphDB)
  * quantized scans   — int8 / binary snapshots for the memory-bound tier

Reference analog: NewsIntelligenceDB (news_intelligence_demo.py:594-975).
"""

from __future__ import annotations

import time
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from fastpyvectordb_tpu_torch import CollectionConfig, Filter
from fastpyvectordb_tpu_torch.graphdb import GraphDB
from fastpyvectordb_tpu_torch.hybrid import HybridCollection

from .datagen import Article, DemoConfig, NewsDataGenerator


class NewsIntelligencePlatform:
    """Ingest + query layer shared by the demo and the interactive CLI."""

    def __init__(self, config: Optional[DemoConfig] = None):
        self.config = config or DemoConfig()
        self.generator = NewsDataGenerator(self.config)
        base = Path(self.config.db_path)
        self.collection = HybridCollection(
            CollectionConfig(name=self.config.collection_name,
                             dimensions=self.config.embedding_dim,
                             metric="cosine"),
            base_path=base / self.config.collection_name,
            text_fields=["headline", "content"], device=self.config.device)
        self.graph = GraphDB(str(base / "graph"))
        self._entity_nodes: set = set()

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------
    def ingest(self, articles: List[Article],
               show_progress: bool = True) -> float:
        """Batch-insert all articles; returns articles/sec."""
        # re-run safety: a persisted/WAL-replayed collection already
        # holds earlier articles — re-inserting their ids would raise
        existing = set(self.collection.all_ids())
        if existing:
            articles = [a for a in articles if a.id not in existing]
        n = len(articles)
        t0 = time.perf_counter()
        bs = self.config.batch_size
        for s in range(0, n, bs):
            chunk = articles[s: s + bs]
            if not chunk:
                continue
            self.collection.insert_batch(
                np.stack([a.embedding for a in chunk]),
                [a.id for a in chunk],
                [a.to_metadata() for a in chunk])
            if show_progress:
                done = min(s + bs, n)
                rate = done / max(time.perf_counter() - t0, 1e-9)
                print(f"\r  ingested {done:,}/{n:,} "
                      f"({rate:,.0f} articles/s)", end="", flush=True)
        if show_progress:
            print()
        return n / max(time.perf_counter() - t0, 1e-9)

    def build_knowledge_graph(self, articles: List[Article],
                              max_articles: Optional[int] = None) -> dict:
        """Article / entity / topic / outlet nodes, typed edges, and
        co-mention hyperedges (reference: build_knowledge_graph,
        news_intelligence_demo.py:686+)."""
        limit = max_articles or self.config.graph_articles
        subset = articles[:limit]
        g = self.graph
        # idempotent over a loaded graph: hydrate the entity-node cache
        # and skip articles already present
        if g.stats()["nodes"] and not self._entity_nodes:
            for kind in ENTITY_KINDS + ("topic", "outlet"):
                for node in g.find_nodes(kind.capitalize()):
                    self._entity_nodes.add(node.id)
        for a in subset:
            if g.get_node(a.id) is not None:
                continue
            g.create_node(["Article"], {
                "headline": a.headline, "category": a.category,
                "topic": a.topic, "source": a.outlet,
                "day_index": a.day_index, "sentiment": a.sentiment,
            }, id=a.id)
            for token in (f"topic:{a.topic}", f"outlet:{a.outlet}"):
                if token not in self._entity_nodes:
                    kind, name = token.split(":", 1)
                    g.create_node([kind.capitalize()], {"name": name},
                                  id=token)
                    self._entity_nodes.add(token)
            g.create_edge(a.id, f"topic:{a.topic}", "ABOUT")
            g.create_edge(f"outlet:{a.outlet}", a.id, "PUBLISHED")
            mention_nodes = []
            for token in a.entities:
                kind, name = token.split(":", 1)
                if token not in self._entity_nodes:
                    g.create_node([kind.capitalize()], {"name": name},
                                  id=token)
                    self._entity_nodes.add(token)
                g.create_edge(a.id, token, "MENTIONS")
                mention_nodes.append(token)
            if len(mention_nodes) >= 3:
                g.create_hyperedge([a.id] + mention_nodes, "CO_MENTION",
                                   {"n": len(mention_nodes)})
        return g.stats()

    def build_indexes(self, ann: str = "ivf", quantized: str = "int8",
                      **ann_kwargs) -> dict:
        """Optional accelerated tiers: ANN + quantized snapshot."""
        out = {}
        if ann:
            t0 = time.perf_counter()
            self.collection.build_ann(kind=ann, **ann_kwargs)
            out["ann"] = {"kind": ann,
                          "build_s": round(time.perf_counter() - t0, 2)}
        if quantized:
            t0 = time.perf_counter()
            scan = self.collection.enable_quantized_scan(quantized)
            out["quantized"] = {
                "kind": quantized,
                "build_s": round(time.perf_counter() - t0, 2),
                **scan.memory_usage()}
        return out

    # ------------------------------------------------------------------
    # query layer
    # ------------------------------------------------------------------
    def semantic_search(self, query: str, k: int = 10,
                        filters: Optional[dict] = None,
                        exact: Optional[bool] = None) -> list:
        f = Filter.from_dict(filters) if filters else None
        return self.collection.search(
            self.generator.query_embedding(query), k=k, filter=f,
            exact=exact)

    def keyword_search(self, query: str, k: int = 10) -> list:
        return self.collection.keyword_search(query, k=k)

    def hybrid_search(self, query: str, k: int = 10,
                      alpha: float = 0.5) -> list:
        return self.collection.hybrid_search(
            self.generator.query_embedding(query), query, k=k, alpha=alpha)

    def quantized_search(self, query: str, k: int = 10,
                         rerank: Optional[int] = None) -> list:
        return self.collection.search_quantized(
            self.generator.query_embedding(query)[None, :], k=k,
            rerank=rerank)[0]

    # -- graph-powered queries ------------------------------------------
    def entity_profile(self, name: str) -> dict:
        """Everything the graph knows about an entity by display name."""
        node = None
        for kind in ENTITY_KINDS:
            node = self.graph.get_node(f"{kind}:{name}")
            if node is not None:
                break
        if node is None:
            return {"error": f"unknown entity {name!r}"}
        mentions = self.graph.neighbors(node.id, "in", "MENTIONS")
        topics = Counter()
        outlets = Counter()
        for art in mentions:
            topics[art.properties.get("topic", "?")] += 1
            outlets[art.properties.get("source", "?")] += 1
        co = Counter()
        for he in self.graph.hyperedges_of_nodes([node.id]):
            for nid in he.nodes:
                if nid != node.id and ":" in nid:
                    co[nid.split(":", 1)[1]] += 1
        recent = sorted(mentions,
                        key=lambda n: -n.properties.get("day_index", 0))[:5]
        return {
            "entity": name, "labels": sorted(node.labels),
            "mention_count": len(mentions),
            "top_topics": topics.most_common(5),
            "top_outlets": outlets.most_common(3),
            "co_mentioned": co.most_common(5),
            "recent_headlines": [n.properties.get("headline", "")
                                 for n in recent],
        }

    def related_entities(self, name: str, max_hops: int = 2) -> list:
        """Entities within ``max_hops`` co-mention hops, ranked by path
        count (reference scenario 5: entity network analysis)."""
        start = None
        for kind in ENTITY_KINDS:
            if self.graph.get_node(f"{kind}:{name}") is not None:
                start = f"{kind}:{name}"
                break
        if start is None:
            return []
        seen: Dict[str, int] = defaultdict(int)
        frontier = {start}
        for _ in range(max_hops):
            nxt = set()
            for nid in frontier:
                for nb in self.graph.neighbors(nid, "both"):
                    if nb.id == start:
                        continue
                    seen[nb.id] += 1
                    nxt.add(nb.id)
            frontier = nxt
        ranked = [(nid.split(":", 1)[1], cnt) for nid, cnt in seen.items()
                  if nid.split(":", 1)[0] in ENTITY_KINDS and not nid.startswith("article_")]
        ranked.sort(key=lambda t: -t[1])
        return ranked[:10]

    def trending_entities(self, k: int = 10,
                          since_day: Optional[int] = None) -> list:
        counts: Counter = Counter()
        for e in self.graph.edges_of_type("MENTIONS"):
            if since_day is not None:
                art = self.graph.get_node(e.source)
                if art is None or art.properties.get("day_index", 0) < since_day:
                    continue
            counts[e.target] += 1
        return [{"name": nid.split(":", 1)[1], "type": nid.split(":", 1)[0],
                 "mentions": c} for nid, c in counts.most_common(k)]

    def category_stats(self) -> dict:
        counts: Counter = Counter()
        for art in self.collection.get_batch(self.collection.all_ids()):
            counts[art["metadata"].get("category", "?")] += 1
        return dict(counts)

    def graph_augmented_search(self, query: str, k: int = 10,
                               boost: float = 0.15) -> list:
        """Semantic hits re-scored by entity-graph connectivity: articles
        whose entities are heavily co-mentioned rank up (reference
        scenario 7)."""
        hits = self.semantic_search(query, k=k * 3)
        out = []
        for h in hits:
            ents = [t for t in h.metadata.get("entities", "").split(",") if t]
            degree = 0
            for t in ents:
                degree += len(self.graph.hyperedges_of_nodes([t]))
            score = h.score - boost * np.log1p(degree)  # lower = better
            out.append((score, degree, h))
        out.sort(key=lambda t: t[0])
        return [{"score": round(float(s), 4), "graph_degree": d,
                 "id": h.id, "headline": h.metadata.get("headline", "")}
                for s, d, h in out[:k]]

    # ------------------------------------------------------------------
    def save(self) -> None:
        self.collection.save()
        self.graph.save()

    def stats(self) -> dict:
        return {"collection": self.collection.stats(),
                "graph": self.graph.stats()}


ENTITY_KINDS = ("company", "person", "place", "agency")
