#!/usr/bin/env python3
"""Where the port's server loses time on one CUDA card: the embedder's
forward under concurrent callers, and the load generator's placement.

    python3 tools/serving_probe.py

1. ``TransformerEmbedder`` (the ``jax`` provider's defaults: d 384, 2
   layers, vocab 32,768, max_len 128) embeds one text at a time from one
   thread, then from 12 threads at once (a server's executor) with its
   lock, then with the lock replaced by a no-op.
2. The server (``create_app(device="cuda", embedding_provider="jax")``,
   as ``chip_smoke.py`` starts it) takes 1,000 ``/texts`` at concurrency
   64 with the lock and 1,000 without.
3. On a 262,144 x 768 collection (random rows, fixed seed), 2,048 exact
   singles at concurrency 64, JSON and msgpack, from a client in the
   server's process (``chip_smoke.drive_here``) and from a child process
   (``chip_smoke.drive``).

Prints each rate beside the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import contextlib
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
THREADS, N_TEXTS, N_ROWS, N_QUERIES = 12, 1000, 262_144, 2048


def main() -> int:
    import msgpack
    import numpy as np
    import torch
    import chip_smoke as cs
    from fastpyvectordb_tpu_torch.embeddings import TransformerEmbedder
    from fastpyvectordb_tpu_torch.server.app import create_app
    cs.phase_device()
    card = cs.nvidia_smi_line()
    texts = cs._texts(3 * N_TEXTS)
    emb = TransformerEmbedder()
    emb.embed_batch(texts[:64])
    torch.cuda.synchronize()
    locked = emb._lock
    t0 = time.perf_counter()
    for t in texts[:300]:
        emb.embed(t)
    one = 300 / (time.perf_counter() - t0)
    rates = {}
    for label, lock in (("lock", locked), ("no lock", contextlib.nullcontext())):
        emb._lock = lock
        with ThreadPoolExecutor(THREADS) as ex:
            t0 = time.perf_counter()
            list(ex.map(emb.embed, texts[:1200]))
            rates[label] = 1200 / (time.perf_counter() - t0)
    emb._lock = locked
    print(f"[probe] embed B=1: one thread {one:.1f} texts/s; {THREADS} "
          f"threads {rates['lock']:.1f} with the lock, {rates['no lock']:.1f} "
          f"without; {card}", flush=True)

    with tempfile.TemporaryDirectory(prefix="serving_probe_") as tmp:
        srv = cs.AppThread(lambda: create_app(
            db_path=tmp + "/db", device="cuda", embedding_provider="jax",
            graph_path=tmp + "/graph", full=True))
        try:
            cs.drive(srv.url, [("/collections", {"json": {
                "name": "texts", "dimensions": 384}})], 1)
            srv.app["state"]["embedder"] = emb
            for i, (label, lock) in enumerate((
                    ("lock", locked), ("no lock", contextlib.nullcontext()))):
                emb._lock = lock
                part = texts[N_TEXTS * (i + 1): N_TEXTS * (i + 2)]
                resps, lat, wall = cs.drive(srv.url, [(
                    "/collections/texts/texts",
                    {"json": {"text": t, "id": f"{i}-{j}"}})
                    for j, t in enumerate(part)], 64)
                cs._ok(resps, "texts")
                print(f"[probe] /texts c64, {label}: {N_TEXTS / wall:.1f} "
                      f"texts/s, p50 {cs._pct(lat, 50):.2f} ms p99 "
                      f"{cs._pct(lat, 99):.2f} ms; {card}", flush=True)
            emb._lock = locked
            rng = np.random.default_rng(0)
            rows = rng.standard_normal((N_ROWS, 768)).astype(np.float32)
            cs.drive(srv.url, [("/collections", {"json": {
                "name": "m", "dimensions": 768}})], 1)
            cs.drive(srv.url, [("/collections/m/vectors/batch", {
                "data": msgpack.packb({
                    "vectors": rows[s:s + 32_768].tobytes(),
                    "ids": [f"v{i}" for i in range(s, s + 32_768)]},
                    use_bin_type=True), "headers": cs.MSGPACK})
                for s in range(0, N_ROWS, 32_768)], 1)
            q = rng.standard_normal((N_QUERIES, 768)).astype(np.float32)
            bodies = {
                "JSON": [("/collections/m/search", {"json": {
                    "vector": x.tolist(), "k": 10, "mode": "exact"}})
                    for x in q],
                "msgpack": [("/collections/m/search", {
                    "data": msgpack.packb({"vector": x.tobytes(), "k": 10,
                                           "mode": "exact"},
                                          use_bin_type=True),
                    "headers": cs.MSGPACK}) for x in q]}
            for where, fn in (("in the server's process", cs.drive_here),
                              ("in a child process", cs.drive)):
                for wire, reqs in bodies.items():
                    resps, lat, wall = fn(srv.url, reqs, 64)
                    cs._ok(resps, wire)
                    print(f"[probe] {wire} exact singles c64, client "
                          f"{where}: {N_QUERIES / wall:.1f} QPS, p50 "
                          f"{cs._pct(lat, 50):.2f} ms p99 "
                          f"{cs._pct(lat, 99):.2f} ms; {card}", flush=True)
        finally:
            srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
