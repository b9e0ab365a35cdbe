"""Production operations walkthrough: durability, integrity, compression,
scale-out.

Demonstrates the operational features a production deployment leans on —
the capabilities *beyond* the reference's quickstart surface
(reference analog: examples/quickstart.py:27-307 covers CRUD/search only):

  1. WAL durability       — mutations survive a crash without save()
  2. container integrity  — CRC32 verification catches bit-rot
  3. IVF-PQ               — ~30x smaller index for large corpora, tuned
  4. tune_rerank          — data-driven recall for quantized serving
  5. shard router         — two engine processes behind one front
  6. beyond-memory corpora — streamed exact + quantized-code tiers
  7. warmup               — build the kernels and run the serving shapes
                            before traffic

On the PyTorch/CUDA port, on the card (``--device cuda``, the default) or
on the CPU, offline in about a minute:

    python examples_torch/production_ops.py --device cpu

Its files go to a new temporary directory unless ``--base DIR`` is given.
"""

import argparse
import asyncio
import shutil
import socket
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from fastpyvectordb_tpu_torch import Collection, CollectionConfig



def banner(title):
    print(f"\n=== {title} " + "=" * max(0, 60 - len(title)))


def make_corpus(n=5000, d=64, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, d)).astype(np.float32) * 2
    v = centers[rng.integers(0, 16, n)] + 0.3 * rng.standard_normal(
        (n, d)).astype(np.float32)
    q = centers[rng.integers(0, 16, 8)] + 0.3 * rng.standard_normal(
        (8, d)).astype(np.float32)
    return v, q


def demo_wal(base, device):
    banner("1. WAL durability: crash without save()")
    path = base / "wal_demo"
    v, q = make_corpus()
    cfg = lambda: CollectionConfig(name="events", dimensions=64,
                                   metric="cosine", durability="wal")
    col = Collection(cfg(), base_path=path, device=device)
    col.insert_batch(v[:100], [f"e{i}" for i in range(100)],
                     [{"kind": "click"} for _ in range(100)])
    col.delete("e42")
    col.update_metadata("e7", {"kind": "purchase"})
    print(f"  wrote 100 inserts + 1 delete + 1 update; wal size "
          f"{col._wal.size_bytes():,} bytes; NO save() call")
    col._wal.close()  # <- simulated crash

    recovered = Collection(cfg(), base_path=path, device=device)
    assert recovered.count() == 99
    assert recovered.get("e42") is None
    assert recovered.get("e7")["metadata"]["kind"] == "purchase"
    print(f"  recovered {recovered.count()} rows from snapshot+log replay")
    recovered.save()
    print(f"  save() wrote the snapshot and truncated the log "
          f"({recovered._wal.size_bytes()} bytes)")


def demo_integrity(base):
    banner("2. Container integrity: CRC32 per section")
    from fastpyvectordb_tpu_torch.persist.format import (load_container,
                                                   save_container)
    p = base / "integrity.fpvt"
    save_container(p, {"vectors": np.random.rand(100, 8).astype(np.float32)})
    c = load_container(p)
    print(f"  verify() on a clean file: {c.verify()}")
    raw = bytearray(p.read_bytes())
    raw[-3] ^= 0xFF  # flip one payload bit (simulated disk corruption)
    p.write_bytes(bytes(raw))
    try:
        load_container(p).verify()
    except ValueError as e:
        print(f"  corrupted file detected: {e}")


def demo_ivfpq(device):
    banner("3. IVF-PQ: compressed index + recall tuning")
    v, q = make_corpus(n=8000)
    col = Collection(CollectionConfig(name="big", dimensions=64,
                                      metric="cosine"), device=device)
    col.insert_batch(v, [f"v{i}" for i in range(len(v))])
    t0 = time.perf_counter()
    col.build_ann(kind="ivfpq", nlist=64, nprobe=8, m=8, pq_k=64,
                  pq_iters=8)
    mu = col._ann.memory_usage()
    print(f"  built in {time.perf_counter() - t0:.1f}s; index "
          f"{mu['index_bytes'] / 1024:.0f} KB vs f32 corpus "
          f"{mu['original_bytes'] / 1024:.0f} KB "
          f"({mu['compression_ratio']:.1f}x smaller)")
    npb, rr, rec = col._ann.tune(q, target_recall=0.95, k=10)
    print(f"  tune -> nprobe={npb}, rerank={rr}; recall@10 vs exact: "
          f"{rec:.3f}")


def demo_tune_rerank(device):
    banner("4. Quantized serving: tune_rerank on clustered data")
    v, q = make_corpus(n=8000, seed=3)
    col = Collection(CollectionConfig(name="qz", dimensions=64,
                                      metric="cosine"), device=device)
    col.insert_batch(v, [f"v{i}" for i in range(len(v))])
    scan = col.enable_quantized_scan("binary")
    exact = [[h.id for h in hh] for hh in col.search_batch(q, k=10)]

    def rec_at(rr):
        _, rows = scan.search(q, 10, rerank=rr)
        return np.mean([len({col._row_to_id[int(r)] for r in b if r >= 0}
                            & set(e)) / 10 for b, e in zip(rows, exact)])

    print(f"  binary 2-stage recall@10 at rerank=4:  {rec_at(4):.3f}")
    factor = scan.tune_rerank(q, target_recall=0.95, k=10)
    print(f"  tune_rerank -> factor {factor}; recall now "
          f"{rec_at(factor):.3f} (installed as serving default)")


def demo_router(base, device):
    banner("5. Scale-out: two engines behind the shard router")
    import httpx
    from aiohttp import web

    from fastpyvectordb_tpu_torch.server.app import create_app
    from fastpyvectordb_tpu_torch.server.router import create_router_app

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def boot(factory):
        port, loop = free_port(), asyncio.new_event_loop()
        ev = threading.Event()

        def run():
            asyncio.set_event_loop(loop)
            runner = web.AppRunner(factory())
            loop.run_until_complete(runner.setup())
            loop.run_until_complete(
                web.TCPSite(runner, "127.0.0.1", port).start())
            ev.set()
            loop.run_forever()

        threading.Thread(target=run, daemon=True).start()
        assert ev.wait(20)
        return f"http://127.0.0.1:{port}"

    shard_urls = [boot(lambda i=i: create_app(
        db_path=str(base / f"shard{i}"), full=False, device=device))
        for i in range(2)]
    front = boot(lambda: create_router_app(shard_urls))
    v, q = make_corpus(n=400, seed=9)
    with httpx.Client(base_url=front, timeout=60) as c:
        c.post("/collections", json={"name": "web", "dimensions": 64,
                                     "metric": "cosine"}).raise_for_status()
        c.post("/collections/web/vectors/batch",
               json={"vectors": v.tolist(),
                     "ids": [f"v{i}" for i in range(len(v))]}
               ).raise_for_status()
        per = [httpx.get(u + "/collections/web", timeout=30).json()["count"]
               for u in shard_urls]
        print(f"  400 rows hash-routed across shards: {per}")
        hits = c.post("/collections/web/search",
                      json={"vector": v[17].tolist(), "k": 3}
                      ).json()["results"]
        print(f"  merged search top-3 ids: {[h['id'] for h in hits]} "
              f"(expect v17 first)")
        assert hits[0]["id"] == "v17"


def demo_beyond_hbm(base, device):
    banner("6. Beyond-memory corpora: streamed exact + quantized-code tiers")
    # the scale ladder (reference README.md:571-578 ">10M: mmap + binary
    # codes + candidates"): OutOfCoreSearcher streams every byte exactly;
    # QuantizedOutOfCoreSearcher streams int8/pq/binary CODE tiles
    # (4x/16x/32x less transfer) and exact-re-ranks gathered candidates
    from fastpyvectordb_tpu_torch.core.outofcore import (
        OutOfCoreSearcher,
        QuantizedOutOfCoreSearcher,
    )
    v, q = make_corpus(n=20_000)
    corpus = np.lib.format.open_memmap(   # disk-backed, like a real >RAM set
        base / "ooc_corpus.npy", mode="w+", dtype=np.float32, shape=v.shape)
    corpus[:] = v
    exact = OutOfCoreSearcher(corpus, metric="cosine", tile_rows=4096,
                              device=device)
    evals, erows = exact.search(q, k=10)
    s = QuantizedOutOfCoreSearcher(
        corpus, metric="cosine", codec="pq", tile_rows=4096, rerank=16,
        codes_path=str(base / "ooc_codes.npy"), device=device)

    def recall(rows):
        return np.mean([len(set(a) & set(b)) / 10
                        for a, b in zip(rows.tolist(), erows.tolist())])

    _, rows0 = s.search(q, k=10)
    # tightly clustered corpora collapse coarse code orderings (the
    # quantized-scan story): tune the candidate depth against the exact
    # stream instead of serving the untuned default
    rr = s.tune_rerank(q, k=10)
    vals, rows = s.search(q, k=10)
    print(f"  pq recall@10 untuned rr=16: {recall(rows0):.3f} -> "
          f"tuned rr={rr}: {recall(rows):.3f} (still 16x less transfer)")
    assert recall(rows) >= 0.95
    # second open reuses the persisted codes — no re-encode pass
    s2 = QuantizedOutOfCoreSearcher(
        corpus, metric="cosine", codec="pq", tile_rows=4096, rerank=rr,
        codes_path=str(base / "ooc_codes.npy"), codes_reuse=True,
        device=device)
    v2, r2 = s2.search(q, k=10)
    assert (r2 == rows).all()
    print("  reopen with codes_reuse=True: identical results, no encode")


def demo_prewarm(device):
    banner("7. Warmup: build the kernels, run the serving shapes")
    v, q = make_corpus(n=4000)
    col = Collection(CollectionConfig(name="warm", dimensions=v.shape[1],
                                      metric="cosine"), device=device)
    col.insert_batch(v, [f"v{i}" for i in range(len(v))])
    col.enable_quantized_scan("int8", tune=False)
    t = col.prewarm(max_batch=8)
    print(f"  warmed {len(t)} serving shapes (also: create_app(prewarm=N), "
          f"python -m fastpyvectordb_tpu_torch.prime)")
    assert any(k.startswith("exact_") for k in t)
    assert any(k.startswith("quantized_") for k in t)


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description="production-ops walkthrough")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--base", default=None,
                    help="working directory (default: a new temporary one)")
    args = ap.parse_args(argv)
    device = device or args.device
    base = Path(args.base or tempfile.mkdtemp(prefix="fpvt_production_ops_"))
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    try:
        demo_wal(base, device)
        demo_integrity(base)
        demo_ivfpq(device)
        demo_tune_rerank(device)
        demo_router(base, device)
        demo_beyond_hbm(base, device)
        demo_prewarm(device)
    finally:
        if args.base is None:
            shutil.rmtree(base, ignore_errors=True)
    print("\nAll production-ops demos passed.")


if __name__ == "__main__":
    main()
