"""News-intelligence end-to-end application (reference parity:
examples/news_intelligence_demo.py:93-979 + query_news_db.py, rebuilt
on the PyTorch/CUDA port; on the card unless ``DemoConfig.device`` or
``--device`` says ``cpu``).

Modules:
  datagen   — synthetic news corpus generator (deterministic, offline)
  platform  — the application: vector + BM25 + knowledge-graph indexes,
              quantized scans, realtime alerts
  demo      — phased demonstration runner (search/benchmark/graph/
              quantization/scenarios)
  query_cli — interactive analyst REPL (scriptable via --commands)
"""

from .datagen import Article, DemoConfig, NewsDataGenerator
from .platform import NewsIntelligencePlatform
