"""Synthetic news-corpus generator for the news-intelligence demo.

Deterministic (seeded), fully offline: embeddings come from the package's
HashingEmbedder so semantically related texts (shared tokens) land near
each other without any model download.  Reference analog: the data
generator of examples/news_intelligence_demo.py:380-589 — the category /
entity / template tables here are original.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from datetime import date, timedelta
from typing import Dict, List, Optional

import numpy as np

from fastpyvectordb_tpu_torch.embeddings import HashingEmbedder

# --------------------------------------------------------------------------
# domain tables (original content)
# --------------------------------------------------------------------------

CATEGORIES: Dict[str, dict] = {
    "technology": {
        "weight": 0.22,
        "topics": [
            "foundation model training", "inference accelerators",
            "chip fabrication yields", "open weights release",
            "datacenter cooling", "edge deployment", "privacy regulation",
            "developer platforms", "search ranking", "browser engines",
            "autonomous drones", "battery chemistry",
        ],
        "outlets": ["Circuit Daily", "The Stack Review", "Kernel Report",
                    "Latency Weekly", "Fab Watch"],
    },
    "markets": {
        "weight": 0.20,
        "topics": [
            "rate cut expectations", "earnings guidance", "bond auction",
            "commodity futures", "currency swings", "index rebalancing",
            "credit spreads", "ipo pipeline", "buyback programs",
            "housing starts",
        ],
        "outlets": ["Ledger Post", "Macro Signal", "The Close Bell",
                    "Yield Curve Times"],
    },
    "policy": {
        "weight": 0.15,
        "topics": [
            "antitrust hearings", "export controls", "data sovereignty",
            "carbon pricing", "grid permitting", "spectrum auctions",
            "trade negotiations", "budget reconciliation",
            "procurement reform",
        ],
        "outlets": ["Capitol Brief", "Regulatory Notes", "Statecraft Daily"],
    },
    "science": {
        "weight": 0.14,
        "topics": [
            "fusion milestones", "mrna platforms", "telescope imagery",
            "protein folding", "ocean sensors", "seismic networks",
            "battery recycling research", "crop genomics",
            "antibiotic discovery",
        ],
        "outlets": ["Preprint Observer", "Field Notes Journal",
                    "The Lab Bench"],
    },
    "energy": {
        "weight": 0.12,
        "topics": [
            "solar capacity additions", "offshore wind tenders",
            "storage deployments", "refinery maintenance",
            "transmission buildout", "nuclear restarts",
            "hydrogen pilots", "demand response",
        ],
        "outlets": ["Grid Current", "Barrel & Watt", "Turbine Times"],
    },
    "health": {
        "weight": 0.10,
        "topics": [
            "hospital staffing", "drug pricing deals", "wearable trials",
            "telemedicine adoption", "vaccine logistics",
            "clinical trial readouts", "insurance networks",
        ],
        "outlets": ["Ward Round", "The Dosage", "Vital Signs Daily"],
    },
    "sport": {
        "weight": 0.07,
        "topics": [
            "transfer window", "playoff seeding", "stadium financing",
            "broadcast rights", "doping rulings", "grand tour stages",
        ],
        "outlets": ["Extra Time", "Box Score Bulletin"],
    },
}

SENTIMENTS = ["positive", "negative", "neutral", "mixed"]
SENTIMENT_WEIGHTS = [0.28, 0.22, 0.38, 0.12]

COMPANIES = [
    "Northwind Compute", "Braxton Labs", "Helios Grid", "Quanta Forge",
    "Meridian Capital", "Atlas Biotech", "Cobalt Dynamics", "Vextera",
    "Pinewood Media", "Solstice Energy", "Kite Logistics", "Ferrum Steel",
    "Aurora Semiconductors", "Bluewater Shipping", "Nimbus Cloudworks",
]
PEOPLE = [
    "Ingrid Halvorsen", "Mateo Reyes", "Priya Raghunathan", "Kenji Morita",
    "Amara Okafor", "Lukas Brandt", "Sofia Lindqvist", "Dmitri Volkov",
    "Hannah Ostrowski", "Rafael Mendes",
]
PLACES = [
    "Rotterdam", "Nairobi", "Osaka", "Porto Alegre", "Tallinn", "Geneva",
    "Busan", "Austin", "Toulouse", "Jakarta",
]
AGENCIES = [
    "Energy Directorate", "Competition Bureau", "Central Reserve",
    "Standards Commission", "Maritime Authority", "Health Agency",
]

ENTITY_TYPES = {
    "company": COMPANIES, "person": PEOPLE,
    "place": PLACES, "agency": AGENCIES,
}

HEADLINES = [
    "{entity} signals shift on {topic} after {place} summit",
    "{topic} outlook divides analysts as {entity} reports",
    "Inside {entity}'s bet on {topic}",
    "{place} pilots test {topic} at scale",
    "Regulators circle {topic} as {agency} opens review",
    "{person} to lead {entity} push into {topic}",
    "Why {topic} is suddenly everywhere",
    "Q&A: {person} on the future of {topic}",
    "{entity} and {entity2} strike {topic} partnership",
    "Data brief: {topic} numbers for the quarter",
]

BODY_SENTENCES = [
    "The announcement follows months of speculation about {topic} strategy.",
    "{entity} executives framed the move as a response to demand in {place}.",
    "Analysts at {outlet} called the development consequential for {topic}.",
    "{person} said the decision reflects changing economics of {topic}.",
    "The {agency} declined to comment on the timeline.",
    "Competitors including {entity2} are weighing similar steps.",
    "Observers in {place} noted parallels to earlier {topic} cycles.",
    "Funding for the initiative remains contingent on {topic} milestones.",
    "Supply constraints around {topic} have eased since last quarter.",
    "The filing lists {entity} as the primary counterparty.",
]


@dataclass
class DemoConfig:
    """Knobs for the demo (reference Config, news_intelligence_demo.py:93)."""
    num_articles: int = 5_000
    embedding_dim: int = 256
    db_path: str = "./news_intelligence_db"
    collection_name: str = "articles"
    batch_size: int = 2_000
    graph_articles: int = 2_000      # articles wired into the graph
    start_date: date = field(default_factory=lambda: date(2025, 1, 1))
    days: int = 400
    seed: int = 7
    device: str = "cuda"             # the collection's torch device


@dataclass
class Article:
    id: str
    headline: str
    content: str
    category: str
    topic: str
    outlet: str
    published: str               # ISO date
    day_index: int               # days since config.start_date
    sentiment: str
    word_count: int
    entities: List[str]          # "type:name" tokens
    embedding: Optional[np.ndarray] = None

    def to_metadata(self) -> dict:
        return {
            "headline": self.headline,
            "content": self.content,
            "category": self.category,
            "topic": self.topic,
            "source": self.outlet,
            "published": self.published,
            "day_index": self.day_index,
            "sentiment": self.sentiment,
            "word_count": self.word_count,
            "entities": ",".join(self.entities),
        }


class NewsDataGenerator:
    """Deterministic synthetic corpus with batch hashing embeddings."""

    def __init__(self, config: DemoConfig):
        self.config = config
        self.rng = random.Random(config.seed)
        self.embedder = HashingEmbedder(config.embedding_dim)
        cats = list(CATEGORIES)
        weights = [CATEGORIES[c]["weight"] for c in cats]
        self._cats, self._weights = cats, weights

    # -- single article ----------------------------------------------------
    def article(self, i: int) -> Article:
        r = self.rng
        cat = r.choices(self._cats, weights=self._weights)[0]
        spec = CATEGORIES[cat]
        topic = r.choice(spec["topics"])
        outlet = r.choice(spec["outlets"])
        ents = {
            "company": r.sample(COMPANIES, k=r.randint(1, 3)),
            "person": r.sample(PEOPLE, k=r.randint(0, 2)),
            "place": r.sample(PLACES, k=1),
            "agency": r.sample(AGENCIES, k=r.randint(0, 1)),
        }
        slots = {
            "topic": topic, "outlet": outlet,
            "entity": ents["company"][0],
            "entity2": (ents["company"][-1] if len(ents["company"]) > 1
                        else r.choice([c for c in COMPANIES
                                       if c != ents["company"][0]])),
            "person": ents["person"][0] if ents["person"] else r.choice(PEOPLE),
            "place": ents["place"][0],
            "agency": ents["agency"][0] if ents["agency"] else r.choice(AGENCIES),
        }
        headline = r.choice(HEADLINES).format(**slots)
        n_sent = r.randint(4, 8)
        body = " ".join(s.format(**slots)
                        for s in r.sample(BODY_SENTENCES, k=n_sent))
        content = f"{headline}. {body}"
        day = r.randint(0, self.config.days - 1)
        published = self.config.start_date + timedelta(days=day)
        entity_tokens = [f"{t}:{n}" for t, names in ents.items()
                         for n in names]
        return Article(
            id=f"article_{i:08d}", headline=headline, content=content,
            category=cat, topic=topic, outlet=outlet,
            published=published.isoformat(), day_index=day,
            sentiment=r.choices(SENTIMENTS, weights=SENTIMENT_WEIGHTS)[0],
            word_count=len(content.split()),
            entities=entity_tokens,
        )

    # -- batch generation + embedding --------------------------------------
    def generate_all(self, show_progress: bool = True) -> List[Article]:
        n = self.config.num_articles
        arts = [self.article(i) for i in range(n)]
        # batch-embed headline+content (one vectorized pass per batch)
        bs = max(self.config.batch_size, 1)
        for s in range(0, n, bs):
            chunk = arts[s: s + bs]
            embs = self.embedder.embed_batch(
                [a.headline + " " + a.content for a in chunk])
            for a, e in zip(chunk, embs):
                a.embedding = np.asarray(e, dtype=np.float32)
            if show_progress:
                print(f"\r  generated+embedded {min(s + bs, n):,}/{n:,}",
                      end="", flush=True)
        if show_progress:
            print()
        return arts

    def query_embedding(self, text: str) -> np.ndarray:
        return np.asarray(self.embedder.embed(text), dtype=np.float32)
