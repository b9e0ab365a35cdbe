"""CLI entrypoint: ``python -m fastpyvectordb_tpu_torch.server``.

Parity with the reference's ``uvicorn server:app`` / ``server_full:app``
launch modes (server.py:136-449, server_full.py) — one process owns the
card and the VectorDB.  ``--device`` defaults to ``cuda``; ``cpu`` runs the
kernels' plain versions.
"""

import argparse

from .app import run_server


def main(argv=None):
    ap = argparse.ArgumentParser(prog="fastpyvectordb_tpu_torch.server")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--db", default="./vectordb_data",
                    help="VectorDB directory (scanned/created on start)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the collections and the "
                         "transformer embedder (cuda|cpu)")
    ap.add_argument("--graph", default=None,
                    help="graph DB path (enables the full tier)")
    ap.add_argument("--full", action="store_true",
                    help="full tier: graph REST + /texts + embeddings + WS")
    ap.add_argument("--embedder", default="hashing",
                    help="embedding provider for /texts (hashing|mock|jax|"
                         "sentence-transformers|openai|cohere|auto)")
    a = ap.parse_args(argv)
    kwargs = dict(db_path=a.db, embedding_provider=a.embedder,
                  full=bool(a.full or a.graph), device=a.device)
    if kwargs["full"]:
        kwargs["graph_path"] = a.graph or (a.db.rstrip("/") + "_graph")
    run_server(host=a.host, port=a.port, **kwargs)


if __name__ == "__main__":
    main()
