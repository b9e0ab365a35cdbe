"""News-intelligence end-to-end app (reference parity:
examples/news_intelligence_demo.py + query_news_db.py, at demo scale).

Builds a synthetic news corpus, indexes it three ways (vector + BM25 +
property graph of entities), then answers analyst-style questions
combining all three.  Run with --interactive for a query REPL.  On the
PyTorch/CUDA port, on the card (``--device cuda``, the default) or on the
CPU (``--device cpu``).
"""

import argparse
import random

import numpy as np

from fastpyvectordb_tpu_torch import CollectionConfig, Filter
from fastpyvectordb_tpu_torch.embeddings import HashingEmbedder
from fastpyvectordb_tpu_torch.graphdb import GraphDB
from fastpyvectordb_tpu_torch.hybrid import HybridCollection

TOPICS = {
    "tech": ["chip factory output", "cloud revenue growth",
             "open source model release", "datacenter expansion"],
    "finance": ["interest rate decision", "quarterly earnings beat",
                "bond yields climbing", "merger approval"],
    "energy": ["solar capacity record", "oil supply disruption",
               "grid storage deployment", "carbon price change"],
}
COMPANIES = ["Acme", "Globex", "Initech", "Umbrella", "Hooli", "Stark"]
REGIONS = ["US", "EU", "APAC"]


class NewsDataGenerator:
    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)

    def article(self, i: int) -> dict:
        topic = self.rng.choice(list(TOPICS))
        company = self.rng.choice(COMPANIES)
        region = self.rng.choice(REGIONS)
        event = self.rng.choice(TOPICS[topic])
        headline = f"{company} announces {event} in {region}"
        body = (f"{headline}. Analysts covering the {topic} sector note the "
                f"implications for {region} markets. "
                f"{company} shares reacted to the {event} story.")
        return {"id": f"art{i:04d}", "headline": headline, "body": body,
                "topic": topic, "company": company, "region": region,
                "day": i % 30}


class NewsIntelligenceDB:
    def __init__(self, n_articles: int = 500, seed: int = 0,
                 device="cuda"):
        self.emb = HashingEmbedder(256)
        self.col = HybridCollection(
            CollectionConfig(name="news", dimensions=256),
            text_fields=["headline", "body"], device=device)
        self.graph = GraphDB()
        gen = NewsDataGenerator(seed)
        articles = [gen.article(i) for i in range(n_articles)]
        vecs = np.stack([self.emb.embed(a["headline"] + " " + a["body"])
                         for a in articles])
        self.col.insert_batch(
            vecs, [a["id"] for a in articles],
            [{k: a[k] for k in ("headline", "body", "topic", "company",
                                "region", "day")} for a in articles])
        # entity graph: company --MENTIONED_IN--> article --ABOUT--> topic
        for name in COMPANIES:
            self.graph.create_node(["Company"], {"name": name}, id=f"c:{name}")
        for t in TOPICS:
            self.graph.create_node(["Topic"], {"name": t}, id=f"t:{t}")
        for a in articles:
            self.graph.create_node(["Article"],
                                   {"headline": a["headline"],
                                    "day": a["day"]}, id=a["id"])
            self.graph.create_edge(f"c:{a['company']}", a["id"],
                                   "MENTIONED_IN")
            self.graph.create_edge(a["id"], f"t:{a['topic']}", "ABOUT")

    def semantic(self, query: str, k: int = 5, **where):
        f = Filter.from_dict(where) if where else None
        return self.col.search(self.emb.embed(query), k=k, filter=f)

    def hybrid(self, query: str, k: int = 5, alpha: float = 0.5):
        return self.col.hybrid_search(self.emb.embed(query), query, k=k,
                                      alpha=alpha)

    def company_coverage(self, company: str, k: int = 5):
        """Graph hop: company -> mentioned articles, ranked by recency."""
        arts = self.graph.neighbors(f"c:{company}", "out", "MENTIONED_IN")
        arts.sort(key=lambda n: -n.properties.get("day", 0))
        return arts[:k]

    def topics_for_company(self, company: str):
        rows = self.graph.query(
            f"MATCH (a:Article)-[:ABOUT]->(t:Topic) RETURN a, t.name")
        mentioned = {n.id for n in self.graph.neighbors(
            f"c:{company}", "out", "MENTIONED_IN")}
        return sorted({r["t.name"] for r in rows if r["a"]["id"] in mentioned})


def main(argv=None, device=None):
    p = argparse.ArgumentParser()
    p.add_argument("--articles", type=int, default=500)
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    print(f"building news DB ({args.articles} articles)...")
    db = NewsIntelligenceDB(args.articles, device=device or args.device)
    print("graph:", db.graph.stats())

    print("\n== semantic: 'central bank raises rates' ==")
    for h in db.semantic("central bank raises interest rates", k=3):
        print(f"  {h.id}  {h.metadata['headline'][:70]}")

    print("\n== filtered: tech in APAC ==")
    for h in db.semantic("datacenter", k=3, topic="tech", region="APAC"):
        print(f"  {h.id}  {h.metadata['headline'][:70]}")

    print("\n== hybrid: 'solar record' ==")
    for r in db.hybrid("solar capacity record", k=3):
        print(f"  {r.id}  s={r.score:.2f}  {r.metadata['headline'][:60]}")

    print("\n== graph: Acme coverage + topics ==")
    for n in db.company_coverage("Acme", k=3):
        print(f"  day {n.properties['day']:2d}  {n.properties['headline'][:60]}")
    print("  topics:", db.topics_for_company("Acme"))

    if args.interactive:
        print("\nquery REPL (blank line to exit)")
        while True:
            q = input("query> ").strip()
            if not q:
                break
            for r in db.hybrid(q, k=5):
                print(f"  {r.id}  s={r.score:.2f}  "
                      f"{r.metadata['headline'][:70]}")


if __name__ == "__main__":
    main()
