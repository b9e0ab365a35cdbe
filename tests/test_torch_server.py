"""End-to-end REST/WS tests of the port's server (``device="cpu"``): a real
aiohttp server on a port, driven through the port's httpx
``VectorDBClient`` — the cases of ``tests/test_server.py`` — and a parity
test that sends one seeded request script to the JAX package's app and to
the port's app and compares every response."""

import asyncio
import json
import socket
import threading
import time

import numpy as np
import pytest

aiohttp = pytest.importorskip("aiohttp")

from fastpyvectordb_tpu_torch.http_client import VectorDBClient
from fastpyvectordb_tpu_torch.server.app import create_app


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_app(tmp_path):
    return create_app(db_path=str(tmp_path / "srv"),
                      embedding_provider="hashing",
                      graph_path=str(tmp_path / "srv_graph"), device="cpu")


class ServerThread:
    def __init__(self, tmp_path, factory=port_app):
        self.port = free_port()
        self.tmp_path = tmp_path
        self.factory = factory
        self.app = None
        self.loop = asyncio.new_event_loop()
        self.started = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        assert self.started.wait(15), "server failed to start"

    def _run(self):
        asyncio.set_event_loop(self.loop)
        from aiohttp import web
        app = self.app = self.factory(self.tmp_path)
        runner = web.AppRunner(app)
        self.loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", self.port)
        self.loop.run_until_complete(site.start())
        self.started.set()
        self.loop.run_forever()

    def stop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(5)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    srv = ServerThread(tmp_path_factory.mktemp("server"))
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def client(server):
    with VectorDBClient(f"http://127.0.0.1:{server.port}") as c:
        yield c


def test_health(client):
    h = client.health()
    assert h["status"] == "ok" and "uptime_s" in h


def test_collection_lifecycle(client):
    client.create_collection("vecs", 8, metric="l2")
    info = client.get_collection("vecs")
    assert info["dimensions"] == 8 and info["metric"] == "l2"
    assert any(c["name"] == "vecs" for c in client.list_collections())
    assert client.get_collection("missing") is None


def test_vector_crud_and_search(client):
    rng = np.random.default_rng(0)
    v = rng.standard_normal((20, 8)).astype(np.float32)
    ids = client.insert_batch("vecs", v, [f"v{i}" for i in range(20)],
                              [{"g": i % 2} for i in range(20)])
    assert len(ids) == 20
    one = client.insert("vecs", v[0] * 0.5, "extra", {"g": 9})
    assert one == "extra"
    got = client.get("vecs", "v3", include_vector=True)
    np.testing.assert_allclose(got["vector"], v[3], rtol=1e-5)
    assert client.get("vecs", "ghost") is None

    res = client.search("vecs", vector=v[7], k=3)
    assert res["results"][0]["id"] == "v7" and res["took_ms"] >= 0
    res = client.search("vecs", vector=v[7], k=20, where={"g": 1})
    assert all(r["metadata"]["g"] == 1 for r in res["results"])

    res = client.search_batch("vecs", vectors=v[[1, 2]], k=1)
    assert [r[0]["id"] for r in res["results"]] == ["v1", "v2"]

    client.upsert("vecs", v[5] * 2, "v5", {"g": 5})
    assert client.get("vecs", "v5")["metadata"]["g"] == 5
    assert client.delete("vecs", "v5")
    assert not client.delete("vecs", "v5")
    assert "v0" in client.list_ids("vecs", limit=100)


def test_filter_tree_search(client):
    from fastpyvectordb_tpu_torch import Filter
    f = Filter.or_([Filter.eq("g", 0), Filter.eq("g", 9)])
    res = client.search("vecs", vector=np.zeros(8), k=30,
                        filter_tree=f.to_dict())
    gs = {r["metadata"]["g"] for r in res["results"]}
    assert gs <= {0, 9} and 9 in gs


def test_text_endpoints(client):
    client.create_collection("texts", 384)
    rid = client.insert_text("texts", "the hungry cat", metadata={"lang": "en"})
    client.insert_text("texts", "stock market news")
    res = client.search("texts", text="hungry cats eat", k=1)
    assert res["results"][0]["id"] == rid
    emb = client.embed("hello world")
    assert emb.shape == (384,)
    assert client.embed_batch(["a", "b"]).shape == (2, 384)


def test_validation_errors(client):
    import httpx
    with pytest.raises(httpx.HTTPStatusError) as ei:
        client.create_collection("bad", -5)
    assert ei.value.response.status_code == 422
    with pytest.raises(httpx.HTTPStatusError) as ei:
        client.create_collection("vecs", 8)  # duplicate
    assert ei.value.response.status_code == 409
    r = httpx.post(f"{client.base_url}/collections/vecs/search",
                   json={"k": 3})  # neither vector nor text
    assert r.status_code == 400
    r = httpx.post(f"{client.base_url}/collections/nope/search",
                   json={"vector": [0] * 8})
    assert r.status_code == 404
    # query dimension mismatch must be a 400, not an unhandled 500
    r = httpx.post(f"{client.base_url}/collections/vecs/search",
                   json={"vector": [0.0] * 5, "k": 3})
    assert r.status_code == 400
    r = httpx.post(f"{client.base_url}/collections/vecs/search/batch",
                   json={"vectors": [[0.0] * 5], "k": 3})
    assert r.status_code == 400


def test_graph_endpoints(client):
    client.create_node(["Person"], {"name": "Ada"}, id="ada")
    client.create_node(["Person"], {"name": "Bob"}, id="bobn")
    client.create_edge("ada", "bobn", "KNOWS")
    assert client.get_node("ada")["properties"]["name"] == "Ada"
    assert client.get_node("ghost") is None
    assert {n["id"] for n in client.find_nodes(label="Person")} == \
        {"ada", "bobn"}
    assert [n["id"] for n in client.neighbors("ada", "out")] == ["bobn"]
    rows = client.graph_query("MATCH (n:Person) RETURN n.name")
    assert sorted(r["n.name"] for r in rows) == ["Ada", "Bob"]
    assert client.shortest_path("ada", "bobn") == ["ada", "bobn"]
    assert client.traverse("ada", 1) == [["ada", "bobn"]]
    client.update_node("ada", properties={"age": 36})
    assert client.get_node("ada")["properties"]["age"] == 36
    assert client.delete_node("bobn")


def test_admin_save_and_persistence(client, server):
    assert client.save()
    assert (server.tmp_path / "srv" / "vecs").exists()


def test_websocket_change_feed(client, server):
    if client.get_collection("wsfeed") is None:
        client.create_collection("wsfeed", 8)
    received = []

    async def listen_and_mutate():
        import aiohttp
        async with aiohttp.ClientSession() as session:
            async with session.ws_connect(
                    f"http://127.0.0.1:{server.port}/ws/wsfeed") as ws:
                # trigger an insert from a worker thread while listening
                def do_insert():
                    time.sleep(0.2)
                    client.insert("wsfeed", np.zeros(8), "ws_probe")
                t = threading.Thread(target=do_insert)
                t.start()
                # connect replays history (e.g. collection_created) first;
                # read until the live insert arrives
                for _ in range(10):
                    msg = await asyncio.wait_for(ws.receive(), timeout=10)
                    received.append(json.loads(msg.data))
                    if received[-1]["type"] == "insert":
                        break
                t.join()

    asyncio.run(listen_and_mutate())
    assert received and received[-1]["type"] == "insert"
    assert received[-1]["data"]["id"] == "ws_probe"
    assert received[-1]["collection"] == "wsfeed"


def test_hyperedge_endpoints(client):
    import httpx
    client.create_node(["H"], id="h1")
    client.create_node(["H"], id="h2")
    r = httpx.post(f"{client.base_url}/graph/hyperedges",
                   json={"nodes": ["h1", "h2"], "type": "TEAM", "id": "team1"})
    assert r.status_code == 201
    r = httpx.get(f"{client.base_url}/graph/hyperedges/team1")
    assert r.json()["nodes"] == ["h1", "h2"]
    r = httpx.get(f"{client.base_url}/graph/nodes/h1/hyperedges")
    assert len(r.json()["hyperedges"]) == 1
    assert httpx.delete(
        f"{client.base_url}/graph/hyperedges/team1").status_code == 200
    assert httpx.get(
        f"{client.base_url}/graph/hyperedges/team1").status_code == 404


def test_batcher_coalesces_concurrent_queries():
    """Concurrent single-query requests in one window must merge into one
    device dispatch per (collection, k, filter) bucket."""
    import asyncio
    from fastpyvectordb_tpu_torch import Collection, CollectionConfig
    from fastpyvectordb_tpu_torch.server.batcher import QueryBatcher

    col = Collection(CollectionConfig(name="b", dimensions=8, metric="l2"),
                     device="cpu")
    rng = np.random.default_rng(0)
    v = rng.standard_normal((50, 8)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(50)])

    calls = []
    orig = col.search_batch

    def counting(queries, *a, **kw):
        calls.append(np.asarray(queries).shape[0])
        return orig(queries, *a, **kw)

    col.search_batch = counting

    async def run():
        b = QueryBatcher(window_ms=20, max_batch=64)
        results = await asyncio.gather(
            *[b.search(col, v[i], k=1) for i in range(8)])
        return results

    results = asyncio.run(run())
    assert [hits[0].id for hits in results] == [f"v{i}" for i in range(8)]
    assert calls == [8], f"expected one coalesced batch, got {calls}"


def test_batcher_continuous_coalescing_under_inflight():
    """While a dispatch is computing, arrivals must ACCUMULATE and flush as
    one wave on completion — not flush one-by-one after the fixed window."""
    import asyncio
    import time as _t
    from fastpyvectordb_tpu_torch import Collection, CollectionConfig
    from fastpyvectordb_tpu_torch.server.batcher import QueryBatcher

    col = Collection(CollectionConfig(name="cb", dimensions=8, metric="l2"),
                     device="cpu")
    rng = np.random.default_rng(2)
    v = rng.standard_normal((64, 8)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(64)])

    calls = []
    orig = col.search_batch

    def slow(queries, *a, **kw):
        calls.append(np.asarray(queries).shape[0])
        _t.sleep(0.05)  # a slow device dispatch
        return orig(queries, *a, **kw)

    col.search_batch = slow

    async def run():
        b = QueryBatcher(window_ms=1, max_batch=64)

        async def one(i, delay):
            await asyncio.sleep(delay)
            return await b.search(col, v[i], k=1)

        # staggered arrivals spread over ~64 ms: far wider than the 1 ms
        # window, but they all land while earlier dispatches compute
        return await asyncio.gather(
            *[one(i, 0.002 * i) for i in range(32)])

    results = asyncio.run(run())
    assert [h[0].id for h in results] == [f"v{i}" for i in range(32)]
    # continuous batching: the 32 staggered requests must ride FEW waves
    # (first ~1-2 alone, then big accumulated waves); one-per-request
    # would be 32 calls
    assert sum(calls) == 32
    assert len(calls) <= 8, f"expected few coalesced waves, got {calls}"


def test_batcher_bad_query_fails_bucket_not_hangs():
    """A malformed query coalesced into a bucket must reject the whole
    flush with an exception on every future — never leave them pending
    (the np.stack used to run outside the try block)."""
    import asyncio
    from fastpyvectordb_tpu_torch import Collection, CollectionConfig
    from fastpyvectordb_tpu_torch.server.batcher import QueryBatcher

    col = Collection(CollectionConfig(name="bb", dimensions=8, metric="l2"),
                     device="cpu")
    rng = np.random.default_rng(1)
    col.insert_batch(rng.standard_normal((10, 8)).astype(np.float32),
                     [f"v{i}" for i in range(10)])

    async def run():
        b = QueryBatcher(window_ms=10, max_batch=64)
        good = rng.standard_normal(8).astype(np.float32)
        bad = rng.standard_normal(5).astype(np.float32)  # wrong dims
        outs = await asyncio.wait_for(asyncio.gather(
            b.search(col, good, k=1), b.search(col, bad, k=1),
            return_exceptions=True), timeout=10)
        return outs

    outs = asyncio.run(run())
    # no hang (wait_for passed) and at least the bad request errored
    assert any(isinstance(o, Exception) for o in outs), outs


def test_batcher_admission_control_rejects_backlog():
    """Beyond max_queue pending requests per bucket, new arrivals must be
    rejected IMMEDIATELY with QueueFull — an open-loop overload degrades
    to fast 503s, not multi-second queueing."""
    import asyncio
    import time as _t
    from fastpyvectordb_tpu_torch import Collection, CollectionConfig
    from fastpyvectordb_tpu_torch.server.batcher import QueryBatcher, QueueFull

    col = Collection(CollectionConfig(name="ac", dimensions=8, metric="l2"),
                     device="cpu")
    rng = np.random.default_rng(3)
    v = rng.standard_normal((16, 8)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(16)])

    orig = col.search_batch

    def slow(queries, *a, **kw):
        _t.sleep(0.1)  # pin the first wave in flight
        return orig(queries, *a, **kw)

    col.search_batch = slow

    async def run():
        b = QueryBatcher(window_ms=1, max_batch=2, max_queue=4)
        # wave 1 (2 requests) dispatches; 4 more fill the backlog; the
        # rest must be rejected at enqueue time
        outs = await asyncio.gather(
            *[b.search(col, v[i % 16], k=1) for i in range(12)],
            return_exceptions=True)
        return outs

    outs = asyncio.run(run())
    served = [o for o in outs if not isinstance(o, Exception)]
    rejected = [o for o in outs if isinstance(o, QueueFull)]
    assert rejected, "expected QueueFull rejections at backlog limit"
    assert served, "admission control must not reject everything"
    assert len(served) + len(rejected) == 12, outs


def test_batcher_coalesces_quantized_singles():
    """Quantized singles must ride the batcher like exact ones — and in
    their OWN bucket, never np.stack'ed with exact queries."""
    import asyncio
    from fastpyvectordb_tpu_torch import Collection, CollectionConfig
    from fastpyvectordb_tpu_torch.server.batcher import QueryBatcher

    col = Collection(CollectionConfig(name="qb", dimensions=8, metric="l2"),
                     device="cpu")
    rng = np.random.default_rng(4)
    v = rng.standard_normal((64, 8)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(64)])
    col.enable_quantized_scan(kind="int8")

    qcalls, ecalls = [], []
    orig_q = col.search_quantized_arrays
    orig_e = col.search_arrays

    def counting_q(queries, *a, **kw):
        qcalls.append(np.asarray(queries).shape[0])
        return orig_q(queries, *a, **kw)

    def counting_e(queries, *a, **kw):
        ecalls.append(np.asarray(queries).shape[0])
        return orig_e(queries, *a, **kw)

    col.search_quantized_arrays = counting_q
    col.search_arrays = counting_e

    async def run():
        b = QueryBatcher(window_ms=20, max_batch=64)
        return await asyncio.gather(
            *[b.search_raw(col, v[i], k=1, quantized=True)
              for i in range(6)],
            *[b.search_raw(col, v[i], k=1) for i in range(6, 12)])

    results = asyncio.run(run())
    ids = [r[0][0] for r in results]
    assert ids == [f"v{i}" for i in range(12)]
    assert qcalls == [6], f"expected one quantized wave, got {qcalls}"
    assert ecalls == [6], f"expected one exact wave, got {ecalls}"


def test_batcher_hands_back_host_values():
    """What crosses the batcher's futures is host data (numpy arrays and
    SearchResults of Python floats), never a tensor, whatever the device."""
    import asyncio
    import torch
    from fastpyvectordb_tpu_torch import Collection, CollectionConfig
    from fastpyvectordb_tpu_torch.server.batcher import QueryBatcher

    col = Collection(CollectionConfig(name="hv", dimensions=8),
                     device="cpu")
    rng = np.random.default_rng(6)
    v = rng.standard_normal((40, 8)).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(40)], [{"g": 1}] * 40)
    col.enable_quantized_scan(kind="int8", tune=False)

    async def run():
        b = QueryBatcher(window_ms=5, max_batch=64)
        return await asyncio.gather(
            b.search(col, v[0], k=3), b.search(col, v[1], k=3,
                                               quantized=True),
            b.search_raw(col, v[2], k=3),
            b.search_raw(col, v[3], k=3, quantized=True))

    hits_e, hits_q, raw_e, raw_q = asyncio.run(run())
    for hits in (hits_e, hits_q):
        assert all(type(h.score) is float and h.vector is None
                   and type(h.metadata) is dict for h in hits)
    for ids, scores, rows in (raw_e, raw_q):
        assert isinstance(ids, np.ndarray) and ids.dtype == object
        assert isinstance(scores, np.ndarray) and scores.dtype == np.float32
        assert isinstance(rows, np.ndarray) and rows.dtype == np.int32
        assert not any(isinstance(x, torch.Tensor) for x in ids.tolist())
    assert [h.id for h in hits_e][0] == "v0" and raw_q[0][0] == "v3"


def test_server_search_wrong_dims_400(server):
    import httpx
    base = f"http://127.0.0.1:{server.port}"
    httpx.post(f"{base}/collections",
               json={"name": "wd", "dimensions": 8, "metric": "l2"},
               timeout=30)
    r = httpx.post(f"{base}/collections/wd/search",
                   json={"vector": [1.0, 2.0], "k": 3}, timeout=30)
    assert r.status_code == 400


def test_index_build_endpoints(client):
    import httpx
    rng = np.random.default_rng(1)
    client.create_collection("idx", 16, metric="l2")
    v = rng.standard_normal((300, 16)).astype(np.float32)
    client.insert_batch("idx", v, [f"v{i}" for i in range(300)])
    # IVF build over REST + ANN-mode search
    r = httpx.post(f"{client.base_url}/collections/idx/index",
                   json={"kind": "ivf", "params": {"nlist": 8, "nprobe": 4,
                                                   "iters": 3}}, timeout=120)
    assert r.status_code == 201 and r.json()["info"]["nlist"] == 8
    res = client.search("idx", vector=v[5], k=1)
    assert res["results"][0]["id"] == "v5"
    # quantized build + quantized-mode search
    r = httpx.post(f"{client.base_url}/collections/idx/index",
                   json={"kind": "int8"}, timeout=120)
    assert r.status_code == 201 and r.json()["info"]["compression_ratio"] > 3
    r = httpx.post(f"{client.base_url}/collections/idx/search",
                   json={"vector": v[7].tolist(), "k": 1,
                         "mode": "quantized"}, timeout=120)
    assert r.status_code == 200 and r.json()["results"][0]["id"] == "v7"
    # unknown kind
    r = httpx.post(f"{client.base_url}/collections/idx/index",
                   json={"kind": "hnswlib"})
    assert r.status_code == 400


def test_graph_index_build_endpoint(client):
    # the graph kind through the same route (the build warns, as in the
    # JAX package), then ANN-mode searches through the HTTP client
    import httpx
    rng = np.random.default_rng(2)
    client.create_collection("gidx", 16, metric="l2")
    v = rng.standard_normal((600, 16)).astype(np.float32)
    client.insert_batch("gidx", v, [f"v{i}" for i in range(600)])
    with pytest.warns(UserWarning, match="graph"):
        r = httpx.post(f"{client.base_url}/collections/gidx/index",
                       json={"kind": "graph",
                             "params": {"r": 8, "n_entries": 32, "beam": 32,
                                        "iters": 8}}, timeout=120)
    assert r.status_code == 201, r.text
    info = r.json()["info"]
    assert info["kind"] == "graph" and info["nodes"] == 600
    assert info["degree"] == 8 and info["beam"] == 32
    for i in (5, 321):
        res = client.search("gidx", vector=v[i], k=3)
        assert res["results"][0]["id"] == f"v{i}"


def test_websocket_subscribe_message(client, server):
    """Subscription updates over the socket: replayed history filtered by
    the new event-type subscription."""
    if client.get_collection("wssub") is None:
        client.create_collection("wssub", 8)
    results = {}

    async def run():
        import aiohttp
        async with aiohttp.ClientSession() as session:
            async with session.ws_connect(
                    f"http://127.0.0.1:{server.port}/ws/wssub") as ws:
                await ws.send_str(json.dumps({
                    "action": "subscribe", "collection": "wssub",
                    "event_types": ["delete"]}))
                # ack arrives after any replayed history
                for _ in range(10):
                    msg = await asyncio.wait_for(ws.receive(), timeout=10)
                    data = json.loads(msg.data)
                    if data.get("subscribed"):
                        results["ack"] = True
                        break
                def mutate():
                    time.sleep(0.2)
                    client.insert("wssub", np.zeros(8), "subprobe")
                    client.delete("wssub", "subprobe")
                t = threading.Thread(target=mutate)
                t.start()
                msg = await asyncio.wait_for(ws.receive(), timeout=10)
                results["event"] = json.loads(msg.data)
                t.join()

    asyncio.run(run())
    assert results.get("ack") is True
    # the insert was filtered out; only the delete is delivered
    assert results["event"]["type"] == "delete"
    assert results["event"]["data"]["id"] == "subprobe"


def test_websocket_bad_event_type_keeps_connection(client, server):
    """An invalid event type in a subscribe message must produce an error
    reply, not tear down the websocket."""
    results = {}

    async def run():
        import aiohttp
        async with aiohttp.ClientSession() as session:
            async with session.ws_connect(
                    f"http://127.0.0.1:{server.port}/ws") as ws:
                await ws.send_str(json.dumps({
                    "action": "subscribe", "event_types": ["not-a-type"]}))
                # skip any replayed history events before the error reply
                for _ in range(30):
                    msg = await asyncio.wait_for(ws.receive(), timeout=10)
                    data = json.loads(msg.data)
                    if "error" in data:
                        results["reply"] = data
                        break
                # connection still alive: a valid subscribe now succeeds
                await ws.send_str(json.dumps({
                    "action": "subscribe", "event_types": ["insert"]}))
                for _ in range(10):
                    msg = await asyncio.wait_for(ws.receive(), timeout=10)
                    data = json.loads(msg.data)
                    if data.get("subscribed"):
                        results["ack"] = True
                        break

    asyncio.run(run())
    assert "error" in results["reply"]
    assert results.get("ack") is True


def test_metrics_endpoint(server):
    import httpx
    base = f"http://127.0.0.1:{server.port}"
    httpx.get(f"{base}/health", timeout=30)
    r = httpx.get(f"{base}/metrics", timeout=30)
    assert r.status_code == 200
    body = r.text
    assert "fpvt_requests_total" in body
    assert 'route="/health"' in body
    assert "fpvt_request_seconds_bucket" in body
    assert "fpvt_collections" in body


def test_metrics_unmatched_paths_collapse(server):
    import httpx
    base = f"http://127.0.0.1:{server.port}"
    for i in range(5):
        httpx.get(f"{base}/no/such/route/{i}", timeout=30)
    body = httpx.get(f"{base}/metrics", timeout=30).text
    assert 'route="<unmatched>"' in body
    assert "/no/such/route" not in body  # raw paths never become labels


def test_client_ids_with_special_chars_roundtrip(client):
    """Ids containing '/' or '#' must survive the HTTP path (percent-
    encoded), not 404 or hit a truncated id."""
    client.create_collection("sp", dimensions=4, metric="l2")
    client.insert("sp", [1, 0, 0, 0], id="doc/1")
    client.insert("sp", [0, 1, 0, 0], id="a#1")
    client.insert("sp", [0, 0, 1, 0], id="a")
    assert client.get("sp", "doc/1") is not None
    assert client.get("sp", "a#1") is not None
    assert client.delete("sp", "a#1") is True
    # 'a' must NOT have been deleted by a fragment-truncated path
    assert client.get("sp", "a") is not None


def test_prewarm_flag_compiles_at_startup(tmp_path, capsys):
    """create_app(prewarm=N) runs the serving shapes during app startup,
    before the first request."""
    from aiohttp import web
    from fastpyvectordb_tpu_torch import VectorDB
    path = tmp_path / "pw_srv"
    db = VectorDB(str(path), device="cpu")
    col = db.create_collection("warm", dimensions=8, metric="l2")
    rng = np.random.default_rng(2)
    col.insert_batch(rng.standard_normal((64, 8)).astype(np.float32),
                     [f"v{i}" for i in range(64)])
    db.save()

    app = create_app(db_path=str(path), full=False, prewarm=2, device="cpu")
    loop = asyncio.new_event_loop()
    try:
        runner = web.AppRunner(app)
        loop.run_until_complete(runner.setup())  # fires on_startup
        loop.run_until_complete(runner.cleanup())
    finally:
        loop.close()
    assert "prewarmed warm" in capsys.readouterr().out


def test_create_collection_validation_is_400_not_409(server, client):
    import httpx
    r = httpx.post(f"http://127.0.0.1:{server.port}/collections",
                   json={"name": "badmetric", "dimensions": 8,
                         "metric": "euclidean-typo"}, timeout=30)
    assert r.status_code == 400, r.text  # 409 means "already exists"


def test_search_batch_honors_mode(server, client):
    import httpx
    """JSON /search/batch must honor exact/mode like the single-search
    endpoint — a client demanding exact must not silently get ANN."""
    base = f"http://127.0.0.1:{server.port}"
    httpx.post(f"{base}/collections",
               json={"name": "bm", "dimensions": 8}, timeout=30)
    vecs = np.random.default_rng(0).standard_normal((50, 8)).tolist()
    httpx.post(f"{base}/collections/bm/vectors/batch",
               json={"vectors": vecs,
                     "ids": [f"b{i}" for i in range(50)]}, timeout=60)
    r = httpx.post(f"{base}/collections/bm/search/batch",
                   json={"vectors": vecs[:2], "k": 3, "mode": "exact"},
                   timeout=60)
    assert r.status_code == 200
    assert r.json()["results"][0][0]["id"] == "b0"
    # a typo'd mode must 422, not silently route
    r = httpx.post(f"{base}/collections/bm/search/batch",
                   json={"vectors": vecs[:1], "k": 3, "mode": "exat"},
                   timeout=30)
    assert r.status_code == 422


def test_text_search_embedder_dims_mismatch_is_400(server, client):
    import httpx
    """A wrong-dims embedding must 400 THIS request, not poison the
    coalesced batcher bucket shared with concurrent vector queries."""
    base = f"http://127.0.0.1:{server.port}"
    # hashing embedder defaults to its own dims; make a collection whose
    # dims can't match it
    httpx.post(f"{base}/collections",
               json={"name": "txtdim", "dimensions": 3}, timeout=30)
    r = httpx.post(f"{base}/collections/txtdim/search",
                   json={"text": "hello", "k": 2}, timeout=60)
    assert r.status_code == 400
    assert "dims" in r.text or "-d" in r.text


def test_optimize_endpoint_installs_mode(server, client):
    import httpx
    base = f"http://127.0.0.1:{server.port}"
    httpx.post(f"{base}/collections",
               json={"name": "optsrv", "dimensions": 8}, timeout=30)
    vecs = np.random.default_rng(2).standard_normal((200, 8)).tolist()
    httpx.post(f"{base}/collections/optsrv/vectors/batch",
               json={"vectors": vecs,
                     "ids": [f"o{i}" for i in range(200)]}, timeout=120)
    r = httpx.post(f"{base}/collections/optsrv/optimize",
                   json={"target_recall": 0.9, "k": 5}, timeout=300)
    assert r.status_code == 200, r.text
    rep = r.json()
    # 200 rows sit under the quantizer-build floor: exact must win
    assert rep["installed"] == "exact"
    assert rep["exact"]["eligible"] is True
    # searches still work through the installed default
    r = httpx.post(f"{base}/collections/optsrv/search",
                   json={"vector": vecs[3], "k": 3}, timeout=120)
    assert r.status_code == 200
    assert r.json()["results"][0]["id"] == "o3"


def test_default_device_is_the_card(tmp_path):
    # create_app without a device puts its collections on the card; on a
    # host without one it raises instead of serving from the CPU
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda-marked test covers it")
    with pytest.raises(RuntimeError, match="cuda"):
        create_app(db_path=str(tmp_path / "d"))


def test_kernel_error_is_the_handlers_500(server, client):
    """A search that fails inside the collection (a kernel's own error)
    reaches the client as a 500 carrying that error, through the batcher's
    waves and through the direct batch path alike; nothing falls back."""
    import httpx
    import msgpack
    client.create_collection("boom", 4, metric="l2")
    client.insert_batch("boom", np.eye(4, dtype=np.float32), list("abcd"))
    col = server.app["state"]["db"]["boom"]

    def fail(*a, **kw):
        raise RuntimeError("fpv_s8_topc failed (700)")

    col.search_arrays = col.search_batch = fail
    base = f"http://127.0.0.1:{server.port}/collections/boom"
    for path, body in (("/search", {"vector": [1, 0, 0, 0], "k": 1}),
                       ("/search/batch", {"vectors": [[1, 0, 0, 0]],
                                          "k": 1})):
        r = httpx.post(base + path, json=body, timeout=30)
        assert r.status_code == 500
        assert "fpv_s8_topc failed (700)" in r.json()["detail"]
    r = httpx.post(base + "/search", timeout=30,
                   content=msgpack.packb({"vector": [1.0, 0, 0, 0], "k": 1}),
                   headers={"Content-Type": "application/msgpack"})
    assert r.status_code == 500 and "fpv_s8_topc" in r.text


@pytest.mark.cuda
def test_cuda_server_answers_as_on_the_cpu(tmp_path):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(5)
    v = rng.standard_normal((3000, 64)).astype(np.float32)
    q = rng.standard_normal((16, 64)).astype(np.float32)
    out = {}
    for dev in ("cpu", None):
        srv = ServerThread(tmp_path / str(dev), lambda p, d=dev: create_app(
            db_path=str(p / "srv"), embedding_provider="hashing",
            graph_path=str(p / "g"), device=d))
        try:
            assert srv.app["state"]["db"].device.type == (dev or "cuda")
            with VectorDBClient(f"http://127.0.0.1:{srv.port}") as c:
                c.create_collection("c", 64)
                c.insert_batch("c", v, [f"v{i}" for i in range(3000)],
                               [{"cat": i % 4} for i in range(3000)])
                out[dev] = [c.search_batch("c", vectors=q, k=10,
                                           mode=mode, where=where)
                            for mode in ("exact", "quantized")
                            for where in (None, {"cat": 3})]
        finally:
            srv.stop()
    for a, b in zip(out["cpu"], out[None]):
        for ha, hb in zip(a["results"], b["results"]):
            _same_hits(ha, hb, atol=1e-4)


# ----------------------------------------------------------------------
# Parity: one seeded request script against the JAX package's app and the
# port's app
# ----------------------------------------------------------------------
def jax_app(tmp_path):
    from fastpyvectordb_tpu.server.app import create_app as jax_create_app
    return jax_create_app(db_path=str(tmp_path / "srv"),
                          embedding_provider="hashing",
                          graph_path=str(tmp_path / "srv_graph"))


@pytest.fixture(scope="module")
def jax_server(tmp_path_factory):
    srv = ServerThread(tmp_path_factory.mktemp("jax_server"), jax_app)
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def parity_server(tmp_path_factory):
    srv = ServerThread(tmp_path_factory.mktemp("parity_server"))
    yield srv
    srv.stop()


def _tied(scores, i, atol):
    return any(abs(scores[i] - s) <= atol
               for j, s in enumerate(scores) if j != i)


def _same_hits(a, b, atol=1e-5):
    """Two hit lists agree: the same scores within ``atol``, the same id
    wherever a score is clear of its neighbours, the same id set past the
    last score, and equal metadata (and vectors) for each id."""
    assert len(a) == len(b), (a, b)
    sa = [h["score"] for h in a]
    np.testing.assert_allclose([h["score"] for h in b], sa, atol=atol,
                               rtol=0)
    for i, (ha, hb) in enumerate(zip(a, b)):
        if not _tied(sa, i, atol):
            assert ha["id"] == hb["id"], (i, a, b)
    clear = [h["id"] for h in a if abs(h["score"] - sa[-1]) > atol]
    assert set(clear) <= {h["id"] for h in b}
    by_id = {h["id"]: h for h in b}
    for h in a:
        if h["id"] in by_id:
            assert h.get("metadata") == by_id[h["id"]].get("metadata")
            if "vector" in h:
                np.testing.assert_allclose(by_id[h["id"]]["vector"],
                                           h["vector"], atol=1e-6)


def _same_raw(a, b, atol=1e-5):
    """Two msgpack search responses agree (ids up to ties, scores)."""
    ids_a, ids_b = a["ids"], b["ids"]
    nested = bool(ids_a) and isinstance(ids_a[0], list)
    if not nested:
        ids_a, ids_b = [ids_a], [ids_b]
    sa = np.frombuffer(a["scores"], "<f4").reshape(len(ids_a), -1)
    sb = np.frombuffer(b["scores"], "<f4").reshape(len(ids_b), -1)
    meta_a = a.get("metadata") or [None] * len(ids_a)
    meta_b = b.get("metadata") or [None] * len(ids_b)
    if not nested and "metadata" in a:
        meta_a, meta_b = [a["metadata"]], [b["metadata"]]
    for ia, ib, ra, rb, ma, mb in zip(ids_a, ids_b, sa, sb, meta_a, meta_b):
        hits = [[{"id": i, "score": float(s),
                  "metadata": (m[j] if m else None)}
                 for j, (i, s) in enumerate(zip(ids, sc)) if i is not None]
                for ids, sc, m in ((ia, ra, ma), (ib, rb, mb))]
        _same_hits(*hits, atol=atol)


def _request_script(base: str, app):
    """Send the script to one server; returns [(step, status, body)].
    JSON bodies are decoded, msgpack bodies unpacked."""
    import httpx
    import msgpack
    rng = np.random.default_rng(1234)
    n, d = 2000, 64
    v = rng.standard_normal((n, d)).astype(np.float32)
    ids = [f"r{i}" for i in range(n)]
    metas = [{"cat": i % 5, "tag": "even" if i % 2 == 0 else "odd",
              "x": float(i) / 7} for i in range(n)]
    q = rng.standard_normal((16, d)).astype(np.float32)
    out = []
    MP = {"Content-Type": "application/msgpack"}

    def rec(step, r):
        if r.headers.get("Content-Type", "").startswith(
                "application/msgpack"):
            body = ("msgpack", msgpack.unpackb(r.content, raw=False))
        else:
            try:
                body = ("json", r.json())
            except ValueError:
                body = ("text", r.text)
        out.append((step, r.status_code, body))

    with httpx.Client(base_url=base, timeout=120) as c:
        def post(step, path, **kw):
            rec(step, c.post(path, **kw))

        def mp(step, path, obj):
            rec(step, c.post(path, content=msgpack.packb(obj), headers=MP))

        post("create", "/collections",
             json={"name": "p", "dimensions": d, "metric": "cosine"})
        post("create_l2", "/collections",
             json={"name": "pl2", "dimensions": 8, "metric": "l2"})
        post("create_dup", "/collections", json={"name": "p",
                                                 "dimensions": d})
        post("create_badmetric", "/collections",
             json={"name": "bad", "dimensions": d, "metric": "nope"})
        post("create_422", "/collections", json={"name": "bad",
                                                 "dimensions": -3})
        rec("list", c.get("/collections"))
        post("insert_json", "/collections/p/vectors/batch",
             json={"vectors": v[:1000].tolist(), "ids": ids[:1000],
                   "metadatas": metas[:1000]})
        mp("insert_msgpack", "/collections/p/vectors/batch",
           {"vectors": v[1000:].tobytes(), "ids": ids[1000:],
            "metadatas": metas[1000:]})
        post("insert_dup", "/collections/p/vectors",
             json={"vector": v[0].tolist(), "id": "r0"})
        post("insert_wrongdims", "/collections/p/vectors",
             json={"vector": [1.0, 2.0], "id": "short"})
        post("insert_one", "/collections/p/vectors",
             json={"vector": (v[3] * 0.5).tolist(), "id": "half3",
                   "metadata": {"cat": 9}})
        rec("get", c.get("/collections/p/vectors/r7",
                         params={"include_vector": "true"}))
        rec("get_404", c.get("/collections/p/vectors/ghost"))
        rec("upsert_existing", c.put("/collections/p/vectors", json={
            "vector": v[11].tolist(), "id": "r5", "metadata": {"cat": 7}}))
        rec("upsert_new", c.put("/collections/p/vectors", json={
            "vector": v[12].tolist(), "id": "new12"}))
        rec("upsert_noid", c.put("/collections/p/vectors",
                                 json={"vector": v[1].tolist()}))
        rec("delete", c.delete("/collections/p/vectors/r9"))
        rec("delete_404", c.delete("/collections/p/vectors/r9"))
        rec("ids", c.get("/collections/p/ids",
                         params={"limit": 7, "offset": 3}))
        rec("ids_400", c.get("/collections/p/ids", params={"limit": "x"}))
        rec("info", c.get("/collections/p"))
        rec("info_404", c.get("/collections/nope"))
        for i in range(3):
            post(f"search_exact_{i}", "/collections/p/search",
                 json={"vector": q[i].tolist(), "k": 10, "mode": "exact"})
        post("search_vectors", "/collections/p/search",
             json={"vector": q[3].tolist(), "k": 5, "include_vectors": True})
        post("search_where", "/collections/p/search",
             json={"vector": q[4].tolist(), "k": 10, "where": {"cat": 3}})
        post("search_tree", "/collections/p/search",
             json={"vector": q[5].tolist(), "k": 10, "filter_tree": {
                 "type": "or", "filters": [
                     {"type": "cond", "op": "eq", "field": "tag",
                      "value": "odd"},
                     {"type": "cond", "op": "gt", "field": "x",
                      "value": 200.0}]}})
        post("search_badtree", "/collections/p/search",
             json={"vector": q[5].tolist(), "k": 10,
                   "filter_tree": {"op": "or"}})
        post("search_quantized", "/collections/p/search",
             json={"vector": q[6].tolist(), "k": 10, "mode": "quantized"})
        post("search_quantized_where", "/collections/p/search",
             json={"vector": q[7].tolist(), "k": 10, "mode": "quantized",
                   "where": {"cat": 3}})
        post("batch_exact", "/collections/p/search/batch",
             json={"vectors": q.tolist(), "k": 10, "mode": "exact"})
        post("batch_quantized_where", "/collections/p/search/batch",
             json={"vectors": q.tolist(), "k": 10, "mode": "quantized",
                   "where": {"cat": 3}})
        mp("mp_single", "/collections/p/search",
           {"vector": q[8].tobytes(), "k": 10, "mode": "exact",
            "include_metadata": True})
        mp("mp_single_quantized", "/collections/p/search",
           {"vector": q[9].tobytes(), "k": 10, "mode": "quantized"})
        mp("mp_batch", "/collections/p/search/batch",
           {"vectors": q.tobytes(), "k": 10, "mode": "exact",
            "where": {"cat": 3}, "include_metadata": True})
        mp("mp_batch_quantized", "/collections/p/search/batch",
           {"vectors": q.tobytes(), "k": 10, "mode": "quantized"})
        mp("mp_badmode", "/collections/p/search",
           {"vector": q[0].tobytes(), "k": 10, "mode": "fast"})
        mp("mp_badk", "/collections/p/search",
           {"vector": q[0].tobytes(), "k": 0})
        post("index_ivf", "/collections/p/index",
             json={"kind": "ivf", "params": {"nlist": 16, "nprobe": 16,
                                             "iters": 4}})
        post("search_ann", "/collections/p/search",
             json={"vector": q[10].tolist(), "k": 10, "mode": "ann"})
        post("batch_ann", "/collections/p/search/batch",
             json={"vectors": q.tolist(), "k": 10, "mode": "ann"})
        post("index_int8", "/collections/p/index", json={"kind": "int8"})
        post("index_unknown", "/collections/p/index",
             json={"kind": "hnswlib"})
        post("search_novec", "/collections/p/search", json={"k": 3})
        post("search_wrongdims", "/collections/p/search",
             json={"vector": [0.0] * 5, "k": 3})
        post("batch_wrongdims", "/collections/p/search/batch",
             json={"vectors": [[0.0] * 5], "k": 3})
        post("search_404", "/collections/nope/search",
             json={"vector": [0.0] * d})
        post("search_badmode_422", "/collections/p/search/batch",
             json={"vectors": q[:1].tolist(), "k": 3, "mode": "exat"})
        post("search_badjson", "/collections/p/search", content=b"{",
             headers={"Content-Type": "application/json"})
        # texts through the hashing embedder
        post("create_texts", "/collections",
             json={"name": "t", "dimensions": 384})
        docs = ["the hungry cat eats", "stock market news today",
                "a cat and a dog", "rain in the forecast", ""]
        for i, doc in enumerate(docs):
            post(f"text_{i}", "/collections/t/texts",
                 json={"text": doc, "id": f"t{i}", "metadata": {"i": i}})
        post("search_text", "/collections/t/search",
             json={"text": "hungry cats", "k": 3})
        post("search_texts", "/collections/t/search/batch",
             json={"texts": ["dog", "market"], "k": 2})
        post("embed", "/embeddings/embed", json={"text": "hello world"})
        post("embed_batch", "/embeddings/embed-batch",
             json={"texts": ["a b", "c"]})
        post("search_text_dims", "/collections/pl2/search",
             json={"text": "hello", "k": 2})
        # graph CRUD, traversal, Cypher
        for nid, name, age in (("ada", "Ada", 36), ("bob", "Bob", 41),
                               ("cy", "Cy", 29), ("dee", "Dee", 52)):
            post(f"node_{nid}", "/graph/nodes", json={
                "labels": ["Person"], "properties": {"name": name,
                                                     "age": age},
                "id": nid})
        post("node_dup", "/graph/nodes", json={"labels": ["X"], "id": "ada"})
        for eid, (s, t, ty) in enumerate((("ada", "bob", "KNOWS"),
                                          ("bob", "cy", "KNOWS"),
                                          ("cy", "dee", "WORKS_WITH"),
                                          ("ada", "dee", "MANAGES"))):
            post(f"edge_{eid}", "/graph/edges", json={
                "source": s, "target": t, "type": ty, "id": f"e{eid}"})
        post("edge_bad", "/graph/edges", json={"source": "ada",
                                                "target": "ghost",
                                                "type": "KNOWS"})
        rec("get_node", c.get("/graph/nodes/ada"))
        rec("get_node_404", c.get("/graph/nodes/ghost"))
        rec("find_nodes", c.get("/graph/nodes", params={"label": "Person"}))
        rec("find_props", c.get("/graph/nodes", params={
            "properties": '{"age": 41}'}))
        rec("find_badjson", c.get("/graph/nodes",
                                  params={"properties": "{"}))
        rec("get_edge", c.get("/graph/edges/e1"))
        rec("neighbors", c.get("/graph/neighbors/bob",
                               params={"direction": "both"}))
        rec("neighbors_404", c.get("/graph/neighbors/ghost"))
        rec("update_node", c.put("/graph/nodes/ada", json={
            "properties": {"age": 37}, "add_labels": ["Boss"]}))
        post("traverse", "/graph/traverse",
             json={"start": "ada", "max_depth": 3})
        post("traverse_typed", "/graph/traverse",
             json={"start": "ada", "max_depth": 2, "edge_type": "KNOWS",
                   "direction": "out"})
        post("shortest", "/graph/shortest-path",
             json={"source": "ada", "target": "cy"})
        post("shortest_none", "/graph/shortest-path",
             json={"source": "dee", "target": "ada",
                   "edge_type": "KNOWS"})
        for i, cy in enumerate((
                "MATCH (n:Person) WHERE n.age > 30 RETURN n.name",
                "MATCH (a:Person)-[:KNOWS]->(b:Person) RETURN a.name, b.name",
                "MATCH (n:Boss) RETURN n.name, n.age",
                "MATCH (a:Person)-[:KNOWS]->(b:Person) WHERE b.age < 45 "
                "RETURN a.name, b.name LIMIT 1",
                "THIS IS NOT CYPHER")):
            post(f"cypher_{i}", "/graph/query", json={"query": cy})
        post("hyperedge", "/graph/hyperedges", json={
            "nodes": ["ada", "bob", "cy"], "type": "TEAM", "id": "team"})
        post("hyperedge_bad", "/graph/hyperedges", json={
            "nodes": ["ada", "ghost"], "type": "TEAM"})
        rec("hyperedges_of", c.get("/graph/nodes/bob/hyperedges"))
        rec("graph_stats", c.get("/graph/stats"))
        rec("delete_edge", c.delete("/graph/edges/e0"))
        rec("delete_edge_404", c.delete("/graph/edges/e0"))
        rec("delete_node", c.delete("/graph/nodes/dee"))
        rec("delete_hyperedge", c.delete("/graph/hyperedges/team"))
        post("traverse_after", "/graph/traverse",
             json={"start": "ada", "max_depth": 3})
        # admission control: a full backlog is a 503 with Retry-After
        app["state"]["batcher"].max_queue = 0
        post("search_503", "/collections/p/search",
             json={"vector": q[0].tolist(), "k": 3})
        out.append(("retry_after", 0, c.post(
            "/collections/p/search", json={"vector": q[0].tolist(), "k": 3}
        ).headers.get("Retry-After")))
        app["state"]["batcher"].max_queue = 4 * 256
        rec("delete_collection", c.delete("/collections/pl2"))
        rec("delete_collection_404", c.delete("/collections/pl2"))
    return out


_VOLATILE = ("took_ms", "uptime_s")


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in _VOLATILE}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _compare_step(step, a, b):
    kind_a, body_a = a
    kind_b, body_b = b
    assert kind_a == kind_b, step
    if kind_a == "msgpack" and "scores" in body_a:
        _same_raw(body_a, body_b)
        return
    if kind_a == "json" and isinstance(body_a, dict) \
            and "results" in body_a:
        res_a, res_b = body_a["results"], body_b["results"]
        if res_a and isinstance(res_a[0], list):
            assert len(res_a) == len(res_b)
            for ha, hb in zip(res_a, res_b):
                _same_hits(ha, hb)
        else:
            _same_hits(res_a, res_b)
        return
    if step == "get":
        np.testing.assert_allclose(body_b.pop("vector"),
                                   body_a.pop("vector"), atol=1e-6)
    if step in ("embed", "embed_batch"):
        key = "embedding" if step == "embed" else "embeddings"
        np.testing.assert_allclose(body_b.pop(key), body_a.pop(key),
                                   atol=1e-6)
    if step == "index_ivf":
        # k-means draws its seeds from each package's own generator; the
        # layout may differ, the index's shape may not
        for k in ("cmax", "cells_bytes", "overflow_rows", "cell_balance"):
            body_a["info"].pop(k)
            body_b["info"].pop(k)
    assert _strip(body_a) == _strip(body_b), step


def test_request_script_parity_with_the_jax_app(jax_server, parity_server):
    want = _request_script(f"http://127.0.0.1:{jax_server.port}",
                           jax_server.app)
    got = _request_script(f"http://127.0.0.1:{parity_server.port}",
                          parity_server.app)
    assert [s for s, _, _ in got] == [s for s, _, _ in want]
    for (step, st_a, body_a), (_, st_b, body_b) in zip(want, got):
        assert st_a == st_b, (step, st_a, st_b, body_a, body_b)
        if step == "retry_after":
            assert body_a == body_b == "1"
            continue
        _compare_step(step, body_a, body_b)
