"""The port's binary (msgpack + raw-f32) serving path (the cases of
``tests/test_wire.py``): the wire codec, the server fast path, the
batcher's raw buckets, and the router's binary fan-out + merge.  The
binary results must be IDENTICAL in content to the JSON path — only the
encoding differs.  Parity: the port's codec and the JAX package's read the
same request bytes the same way and write the same response bytes."""

import asyncio
import socket
import threading

import numpy as np
import pytest

aiohttp = pytest.importorskip("aiohttp")
msgpack = pytest.importorskip("msgpack")
httpx = pytest.importorskip("httpx")

from fastpyvectordb_tpu_torch.http_client import VectorDBClient
from fastpyvectordb_tpu_torch.server import wire
from fastpyvectordb_tpu_torch.server.app import create_app
from fastpyvectordb_tpu_torch.server.router import create_router_app
from fastpyvectordb_tpu.server import wire as jax_wire

D = 16


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class AppThread:
    def __init__(self, app_factory):
        self.port = free_port()
        self.loop = asyncio.new_event_loop()
        self.started = threading.Event()
        self._factory = app_factory
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        assert self.started.wait(20), "server failed to start"

    def _run(self):
        asyncio.set_event_loop(self.loop)
        from aiohttp import web
        app = self._factory()
        runner = web.AppRunner(app)
        self.loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", self.port)
        self.loop.run_until_complete(site.start())
        self.started.set()
        self.loop.run_forever()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.port}"


# ----------------------------------------------------------------------
# codec unit tests
# ----------------------------------------------------------------------
def test_decode_matrix_roundtrip():
    v = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = wire.decode_matrix(v.tobytes(), 4)
    np.testing.assert_array_equal(out, v)
    out = wire.decode_matrix(v.tolist(), 4)
    np.testing.assert_array_equal(out, v)
    with pytest.raises(ValueError):
        wire.decode_matrix(v.tobytes(), 5)  # not a whole number of rows
    with pytest.raises(ValueError):
        wire.decode_matrix([[1.0, 2.0]], 4)  # wrong dims


def test_decode_vector_rejects_batch():
    v = np.zeros((2, 4), dtype=np.float32)
    with pytest.raises(ValueError):
        wire.decode_vector(v.tobytes(), 4)
    np.testing.assert_array_equal(wire.decode_vector(v[0].tobytes(), 4),
                                  v[0])


def _response_cases():
    rng = np.random.default_rng(9)
    ids = np.array([["a", "b", None], ["c", None, None]], dtype=object)
    scores = rng.standard_normal((2, 3)).astype(np.float32)
    scores[ids == None] = np.inf  # noqa: E711
    meta = [[{"g": 1, "s": "x"}, {}, None], [{"f": 0.5}, None, None]]
    return [(ids, scores, 1.23456, None, False),
            (ids, scores, 0.0, meta, False),
            (ids[:1], scores[:1], 7.0, meta[:1], True),
            (ids[:1], scores[:1], 7.0, None, True)]


@pytest.mark.parametrize("case", range(4))
def test_response_bytes_equal_the_jax_packages(case):
    args = _response_cases()[case]
    assert wire.search_response(*args) == jax_wire.search_response(*args)
    assert wire.pack({"ids": list(args[0][0]), "detail": "x"}) == \
        jax_wire.pack({"ids": list(args[0][0]), "detail": "x"})


@pytest.mark.parametrize("raw", [True, False])
def test_request_bytes_decode_as_in_the_jax_package(raw):
    rng = np.random.default_rng(10)
    v = rng.standard_normal((5, D)).astype(np.float32)
    body = msgpack.packb({
        "vectors": v.tobytes() if raw else v.tolist(),
        "vector": v[0].tobytes() if raw else v[0].tolist(),
        "k": 7, "mode": "quantized", "where": {"g": 2},
        "filter_tree": {"type": "cond", "op": "eq", "field": "g",
                        "value": 1}, "include_metadata": True},
        use_bin_type=True)
    ours, theirs = wire.unpack(body), jax_wire.unpack(body)
    assert ours == theirs
    np.testing.assert_array_equal(wire.decode_matrix(ours["vectors"], D),
                                  jax_wire.decode_matrix(theirs["vectors"], D))
    np.testing.assert_array_equal(wire.decode_vector(ours["vector"], D),
                                  jax_wire.decode_vector(theirs["vector"], D))
    for bad in (msgpack.packb([1, 2]), ):
        with pytest.raises(ValueError):
            wire.unpack(bad)
        with pytest.raises(ValueError):
            jax_wire.unpack(bad)


def test_served_response_decodes_in_the_jax_codec(srv):
    """A response the port's server wrote reads back through the JAX
    package's client-side decoding unchanged (ids, scores, metadata)."""
    c, vecs = srv
    r = httpx.post(c.base_url + "/collections/bin/search/batch",
                   content=wire.pack({"vectors": vecs[:3].tobytes(), "k": 4,
                                      "include_metadata": True}),
                   headers={"Content-Type": "application/msgpack"},
                   timeout=30)
    body = jax_wire.unpack(r.content)
    assert r.status_code == 200
    assert [row[0] for row in body["ids"]] == ["b0", "b1", "b2"]
    sc = np.frombuffer(body["scores"], "<f4").reshape(3, 4)
    assert np.all(np.diff(sc, axis=1) >= 0)
    assert body["metadata"][1][0] == {"g": 1}
    assert jax_wire.pack(body) == r.content


# ----------------------------------------------------------------------
# single-server binary path
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def srv(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wire")
    app = AppThread(lambda: create_app(db_path=str(tmp / "db"), full=False, device="cpu",
                                       batch_window_ms=1.0))
    with VectorDBClient(app.url) as c:
        c.create_collection("bin", D, metric="cosine")
        rng = np.random.default_rng(3)
        vecs = rng.standard_normal((64, D)).astype(np.float32)
        ids = c.insert_batch_binary(
            "bin", vecs, [f"b{i}" for i in range(64)],
            [{"g": i % 4} for i in range(64)])
        assert len(ids) == 64
        yield c, vecs


def test_binary_search_matches_json(srv):
    c, vecs = srv
    jj = c.search("bin", vector=vecs[9], k=5)
    bb = c.search_binary("bin", vecs[9], k=5)
    assert [h["id"] for h in jj["results"]] == bb["ids"]
    np.testing.assert_allclose(
        [h["score"] for h in jj["results"]], bb["scores"], atol=1e-5)


def test_binary_batch_matches_json(srv):
    c, vecs = srv
    q = vecs[[4, 11, 30]]
    jj = c.search_batch("bin", vectors=q, k=3)
    bb = c.search_batch_binary("bin", q, k=3)
    assert [[h["id"] for h in hits] for hits in jj["results"]] == bb["ids"]
    assert bb["scores"].shape == (3, 3)


def test_binary_metadata_and_filter(srv):
    c, vecs = srv
    bb = c.search_batch_binary("bin", vecs[[8]], k=4, where={"g": 0},
                               include_metadata=True)
    assert bb["ids"][0][0] == "b8"
    assert all(m["g"] == 0 for m in bb["metadata"][0] if m is not None)


def test_binary_short_results_padded(srv):
    """k beyond the live count: ids pad with None, scores with +inf."""
    c, vecs = srv
    bb = c.search_binary("bin", vecs[0], k=5, where={"g": 99})
    assert bb["ids"] == [None] * 5
    assert np.all(np.isinf(bb["scores"]))


def test_binary_bad_requests(srv):
    c, _ = srv
    with pytest.raises(httpx.HTTPStatusError, match="400"):
        c.search_binary("bin", np.zeros(D + 1, dtype=np.float32), k=5)
    with pytest.raises(httpx.HTTPStatusError, match="400"):
        c._post_binary("/collections/bin/search", {"vector": b"abc", "k": 5})
    with pytest.raises(httpx.HTTPStatusError, match="400"):
        c._post_binary("/collections/bin/search",
                       {"vector": np.zeros(D, "<f4").tobytes(), "k": 0})
    with pytest.raises(httpx.HTTPStatusError, match="400"):
        c._post_binary("/collections/bin/search",
                       {"vector": np.zeros(D, "<f4").tobytes(),
                        "mode": "warp"})


def test_binary_quantized_mode(srv):
    c, vecs = srv
    bb = c.search_binary("bin", vecs[2], k=3, mode="quantized")
    assert bb["ids"][0] == "b2"


# ----------------------------------------------------------------------
# router binary fan-out
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def bin_cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wire_router")
    shards = [AppThread(lambda i=i: create_app(
        db_path=str(tmp / f"s{i}"), full=False, device="cpu")) for i in range(2)]
    router = AppThread(
        lambda: create_router_app([s.url for s in shards]))
    rng = np.random.default_rng(7)
    vecs = rng.standard_normal((48, D)).astype(np.float32)
    with VectorDBClient(router.url) as c:
        c.create_collection("rb", D, metric="l2")
        c.insert_batch_binary("rb", vecs, [f"r{i}" for i in range(48)],
                              [{"g": i % 2} for i in range(48)])
        yield c, vecs


def test_router_binary_merged_search(bin_cluster):
    c, vecs = bin_cluster
    jj = c.search("rb", vector=vecs[17], k=6)
    bb = c.search_binary("rb", vecs[17], k=6)
    assert bb["ids"][0] == "r17" and bb["shards_ok"] == 2
    assert [h["id"] for h in jj["results"]] == bb["ids"]
    np.testing.assert_allclose(
        [h["score"] for h in jj["results"]], bb["scores"], atol=1e-5)


def test_router_binary_batch_and_metadata(bin_cluster):
    c, vecs = bin_cluster
    bb = c.search_batch_binary("rb", vecs[[3, 40]], k=4,
                               include_metadata=True)
    assert bb["ids"][0][0] == "r3" and bb["ids"][1][0] == "r40"
    assert bb["metadata"][0][0]["g"] == 1
    assert np.all(np.diff(bb["scores"], axis=1) >= -1e-6)


def test_router_binary_insert_requires_ids(bin_cluster):
    c, vecs = bin_cluster
    with pytest.raises(httpx.HTTPStatusError, match="400"):
        c._post_binary("/collections/rb/vectors/batch",
                       {"vectors": vecs[:2].tobytes()})
