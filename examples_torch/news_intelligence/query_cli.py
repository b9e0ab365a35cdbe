"""Interactive analyst REPL over a news-intelligence database.

Reference parity: query_news_db.py (interactive_mode + NewsQueryInterface).
Loads a persisted platform database (built by demo.py) or builds a fresh
corpus if none exists.  Commands:

  search <query>        semantic search
  keyword <query>       BM25 keyword search
  hybrid <query>        fused vector + keyword search
  read <n | id>         print a full article (result number or id)
  entity <name>         entity profile (mentions, topics, co-mentions)
  related <name>        entities within 2 co-mention hops
  topic <name>          articles about a topic
  source <name>         articles from an outlet
  category <name>       browse a category
  sentiment <s>         browse by sentiment (positive/negative/...)
  trending              trending entities
  stats                 category statistics
  help / quit

Scriptable: --commands "search chip supply;read 1;trending;quit"
On the card unless ``--device cpu``; a database that the JAX package's
``examples/news_intelligence`` wrote opens here too.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from fastpyvectordb_tpu_torch import Filter

from .datagen import DemoConfig
from .platform import NewsIntelligencePlatform

BAR = "=" * 64


class NewsQueryInterface:
    """Query helpers + result memory for `read <n>`."""

    def __init__(self, platform: NewsIntelligencePlatform):
        self.p = platform
        self.last_results: List[str] = []  # article ids of the last listing

    # -- listings ---------------------------------------------------------
    def _remember(self, hits) -> list:
        self.last_results = [h.id for h in hits]
        return hits

    def search(self, query: str, k: int = 10) -> list:
        return self._remember(self.p.semantic_search(query, k=k))

    def keyword(self, query: str, k: int = 10) -> list:
        return self._remember(self.p.keyword_search(query, k=k))

    def hybrid(self, query: str, k: int = 10) -> list:
        return self._remember(self.p.hybrid_search(query, k=k))

    def by_filter(self, key: str, value: str, k: int = 10) -> list:
        hits = self.p.collection.search(
            self.p.generator.query_embedding(value), k=k,
            filter=Filter.eq(key, value))
        if not hits:  # fall back to pure filter browse (no semantic signal)
            from fastpyvectordb_tpu_torch.core.types import SearchResult
            rows = self.p.collection.get_batch(self.p.collection.all_ids())
            hits = [SearchResult(id=a["id"], score=0.0,
                                 metadata=a["metadata"])
                    for a in rows
                    if a is not None
                    and a["metadata"].get(key) == value][:k]
        return self._remember(hits)

    def topic(self, name: str, k: int = 10) -> list:
        hits = self.p.collection.search(
            self.p.generator.query_embedding(name), k=k,
            filter=Filter.eq("topic", name))
        if not hits:
            hits = self.p.semantic_search(name, k=k)
        return self._remember(hits)

    # -- article access -----------------------------------------------------
    def resolve(self, arg: str) -> Optional[str]:
        try:
            n = int(arg)
            if 1 <= n <= len(self.last_results):
                return self.last_results[n - 1]
            return None
        except ValueError:
            return arg

    def read_article(self, article_id: str) -> Optional[dict]:
        return self.p.collection.get(article_id)

    # -- printing -----------------------------------------------------------
    def print_results(self, hits, title: str) -> None:
        print(f"\n{BAR}\n {title}\n{BAR}")
        if not hits:
            print("  (no results)")
            return
        for i, h in enumerate(hits, 1):
            m = h.metadata or {}
            print(f"  {i:2d}. [{h.score:.4f}] [{m.get('category', '?'):10s}] "
                  f"{m.get('headline', '')[:58]}")
            print(f"      {m.get('source', '?')} | {m.get('published', '?')}"
                  f" | {m.get('sentiment', '?')} | id={h.id}")

    def print_article(self, art: Optional[dict]) -> None:
        if art is None:
            print("  article not found")
            return
        m = art["metadata"]
        print(f"\n{BAR}\n {m.get('headline', '')}\n{BAR}")
        print(f"  {m.get('source', '?')} | {m.get('published', '?')} | "
              f"{m.get('category', '?')} / {m.get('topic', '?')} | "
              f"sentiment: {m.get('sentiment', '?')}")
        print(f"  entities: {m.get('entities', '')}")
        print(f"\n  {m.get('content', '')}\n")

    def print_entity(self, info: dict) -> None:
        if "error" in info:
            print(f"  {info['error']}")
            return
        print(f"\n{BAR}\n ENTITY: {info['entity']} "
              f"({'/'.join(info['labels'])})\n{BAR}")
        print(f"  mentions: {info['mention_count']}")
        print(f"  top topics: {info['top_topics']}")
        print(f"  top outlets: {info['top_outlets']}")
        print(f"  co-mentioned: {info['co_mentioned']}")
        print("  recent headlines:")
        for h in info["recent_headlines"]:
            print(f"    - {h[:64]}")


HELP = __doc__.split("Commands:")[-1]


def dispatch(qi: NewsQueryInterface, line: str) -> bool:
    """Execute one command line; returns False on quit."""
    line = line.strip()
    if not line:
        return True
    cmd, _, args = line.partition(" ")
    cmd, args = cmd.lower(), args.strip()
    p = qi.p
    if cmd in ("quit", "exit"):
        print("bye")
        return False
    elif cmd == "help":
        print(HELP)
    elif cmd == "search" and args:
        qi.print_results(qi.search(args), f"search: {args!r}")
    elif cmd == "keyword" and args:
        qi.print_results(qi.keyword(args), f"keyword: {args!r}")
    elif cmd == "hybrid" and args:
        qi.print_results(qi.hybrid(args), f"hybrid: {args!r}")
    elif cmd == "read" and args:
        rid = qi.resolve(args)
        if rid is None:
            print("  no such result number; run a search first")
        else:
            qi.print_article(qi.read_article(rid))
    elif cmd == "entity" and args:
        qi.print_entity(p.entity_profile(args))
    elif cmd == "related" and args:
        print(f"  related to {args}: {p.related_entities(args)}")
    elif cmd == "topic" and args:
        qi.print_results(qi.topic(args), f"topic: {args!r}")
    elif cmd == "source" and args:
        qi.print_results(qi.by_filter("source", args), f"source: {args!r}")
    elif cmd == "category" and args:
        qi.print_results(qi.by_filter("category", args),
                         f"category: {args!r}")
    elif cmd == "sentiment" and args:
        qi.print_results(qi.by_filter("sentiment", args),
                         f"sentiment: {args!r}")
    elif cmd == "trending":
        print(f"\n{BAR}\n TRENDING ENTITIES\n{BAR}")
        for i, e in enumerate(p.trending_entities(k=10), 1):
            print(f"  {i:2d}. {e['name']:26s} ({e['type']}): "
                  f"{e['mentions']} mentions")
    elif cmd == "stats":
        print(f"\n{BAR}\n CATEGORY STATISTICS\n{BAR}")
        for cat, n in sorted(p.category_stats().items(),
                             key=lambda t: -t[1]):
            print(f"  {cat:14s} {n:,}")
    else:
        # bare text: treat as a search (reference behavior)
        qi.print_results(qi.search(line), f"search: {line!r}")
    return True


def ensure_platform(args) -> NewsIntelligencePlatform:
    cfg = DemoConfig(num_articles=args.articles, db_path=args.db_path,
                     graph_articles=min(args.articles, 2000),
                     device=getattr(args, "device", "cuda"))
    platform = NewsIntelligencePlatform(cfg)
    if platform.collection.count() == 0:
        print(f"no database at {args.db_path}; building "
              f"{cfg.num_articles:,} articles...")
        arts = platform.generator.generate_all()
        platform.ingest(arts)
        platform.build_knowledge_graph(arts)
        platform.save()
    else:
        print(f"loaded {platform.collection.count():,} articles "
              f"from {args.db_path}")
    return platform


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description="news-intelligence query REPL")
    ap.add_argument("--db-path", default="./news_intelligence_db")
    ap.add_argument("--articles", type=int, default=2000,
                    help="corpus size if the db must be built")
    ap.add_argument("--commands", default=None,
                    help="semicolon-separated commands (non-interactive)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    args.device = device or args.device
    qi = NewsQueryInterface(ensure_platform(args))

    if args.commands:
        for c in args.commands.split(";"):
            print(f"\n> {c.strip()}")
            if not dispatch(qi, c):
                return
        return

    print(HELP)
    while True:
        try:
            line = input("\n> ")
        except (EOFError, KeyboardInterrupt):
            print("\nbye")
            return
        try:
            if not dispatch(qi, line):
                return
        except Exception as e:  # analyst REPL: never die on a bad query
            print(f"  error: {e}")


if __name__ == "__main__":
    main()
