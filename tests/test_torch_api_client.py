"""The port's ChromaDB-style embedded client (the cases of
``tests/test_api_client.py``: lifecycle/add/query/get/update/delete, on
``device="cpu"``), with a parity case against the JAX package's client."""

import numpy as np
import pytest

from fastpyvectordb_tpu_torch.api import Client


@pytest.fixture()
def client(tmp_path):
    c = Client(path=str(tmp_path / "db"), embedding_provider="mock",
               device="cpu")
    yield c


@pytest.fixture()
def col(client):
    return client.create_collection("docs")


class TestClientLifecycle:
    def test_create_get_delete(self, client):
        col = client.create_collection("a")
        assert col.name == "a" and client.list_collections() == ["a"]
        got = client.get_collection("a")
        assert got.name == "a"
        assert client.delete_collection("a")
        assert client.list_collections() == []

    def test_get_or_create(self, client):
        c1 = client.get_or_create_collection("x")
        c1.add(documents=["d"], ids=["1"])
        c2 = client.get_or_create_collection("x")
        assert c2.count == 1

    def test_heartbeat_and_reset(self, client):
        assert client.heartbeat() > 0
        client.create_collection("a")
        client.create_collection("b")
        client.reset()
        assert client.list_collections() == []

    def test_dims_mismatch_rejected(self, client):
        from fastpyvectordb_tpu_torch.embeddings import MockEmbedder
        client.create_collection("a")  # mock default 384
        # a different-dims embedder cannot open the collection
        client._embedders["mock:small"] = MockEmbedder(16)
        with pytest.raises(ValueError):
            client.get_collection("a", embedding_provider="mock",
                                  embedding_model="small")


class TestCollection:
    def test_add_documents_auto_ids(self, col):
        ids = col.add(documents=["hello world", "goodbye world"])
        assert len(ids) == 2 and col.count == 2

    def test_add_with_embeddings(self, col):
        vecs = np.random.default_rng(0).standard_normal((3, 384)).tolist()
        col.add(embeddings=vecs, ids=["a", "b", "c"])
        assert col.count == 3

    def test_add_requires_docs_or_embeddings(self, col):
        with pytest.raises(ValueError):
            col.add()

    def test_query_by_text(self, col):
        col.add(documents=["alpha", "beta", "gamma"], ids=["1", "2", "3"],
                metadatas=[{"k": i} for i in range(3)])
        res = col.query("alpha", n_results=2)
        assert res.ids[0][0] == "1"  # MockEmbedder is deterministic per text
        assert res.documents[0][0] == "alpha"
        assert res.distances[0][0] == pytest.approx(0.0, abs=1e-3)
        # underscore-prefixed metadata is stripped from results
        assert all(not k.startswith("_")
                   for m in res.metadatas[0] for k in m)

    def test_query_where_filter(self, col):
        col.add(documents=[f"doc {i}" for i in range(10)],
                ids=[str(i) for i in range(10)],
                metadatas=[{"group": "even" if i % 2 == 0 else "odd"}
                           for i in range(10)])
        res = col.query("doc 3", n_results=10, where={"group": "odd"})
        assert len(res.ids[0]) == 5
        assert all(m["group"] == "odd" for m in res.metadatas[0])

    def test_query_include_embeddings(self, col):
        col.add(documents=["x"], ids=["1"])
        res = col.query("x", n_results=1,
                        include=["documents", "metadatas", "distances",
                                 "embeddings"])
        assert res.embeddings[0][0].shape == (384,)

    def test_get_flat(self, col):
        col.add(documents=["a", "b"], ids=["1", "2"],
                metadatas=[{"t": 1}, {"t": 2}])
        res = col.get(ids=["2", "1"])
        assert set(res.ids) == {"1", "2"}
        res = col.get(where={"t": 2})
        assert res.ids == ["2"] and res.documents == ["b"]

    def test_get_limit_offset(self, col):
        col.add(documents=[f"d{i}" for i in range(10)],
                ids=[f"{i:02d}" for i in range(10)])
        res = col.get(limit=3, offset=4)
        assert len(res.ids) == 3

    def test_update_metadata_and_document(self, col):
        col.add(documents=["original"], ids=["1"], metadatas=[{"v": 1}])
        col.update("1", metadatas=[{"v": 2}])
        assert col.get(ids="1").metadatas[0]["v"] == 2
        col.update("1", documents=["changed"])
        got = col.get(ids="1")
        assert got.documents[0] == "changed"
        # re-embedded: querying new text finds it at ~0 distance
        res = col.query("changed", n_results=1)
        assert res.distances[0][0] == pytest.approx(0.0, abs=1e-3)

    def test_update_missing_raises(self, col):
        with pytest.raises(ValueError):
            col.update("nope", metadatas=[{}])

    def test_upsert(self, col):
        col.upsert(documents=["v1"], ids=["1"])
        col.upsert(documents=["v2"], ids=["1"])
        assert col.count == 1 and col.get(ids="1").documents == ["v2"]

    def test_delete_by_ids_and_where(self, col):
        col.add(documents=["a", "b", "c"], ids=["1", "2", "3"],
                metadatas=[{"g": 0}, {"g": 1}, {"g": 1}])
        col.delete(ids="1")
        assert col.count == 2
        deleted = col.delete(where={"g": 1})
        assert sorted(deleted) == ["2", "3"] and col.count == 0

    def test_peek(self, col):
        col.add(documents=[f"d{i}" for i in range(20)],
                ids=[str(i) for i in range(20)])
        assert len(col.peek(limit=5).ids) == 5


def test_persistence_roundtrip(tmp_path):
    with Client(path=str(tmp_path / "db"), embedding_provider="mock",
               device="cpu") as c:
        col = c.create_collection("persisted")
        col.add(documents=["remember me"], ids=["1"], metadatas=[{"x": 9}])
    c2 = Client(path=str(tmp_path / "db"), embedding_provider="mock",
               device="cpu")
    col2 = c2.get_collection("persisted")
    assert col2.count == 1
    res = col2.query("remember me", n_results=1)
    assert res.ids[0] == ["1"] and res.metadatas[0][0]["x"] == 9


def test_hashing_embedder_semantic_overlap(tmp_path):
    c = Client(path=None, embedding_provider="hashing", device="cpu")
    col = c.create_collection("bow")
    col.add(documents=["the quick brown fox", "machine learning models",
                       "deep learning neural networks"],
            ids=["fox", "ml", "dl"])
    res = col.query("learning with neural networks", n_results=3)
    assert res.ids[0][0] == "dl"  # shares most tokens


def test_delete_empty_where_rejected(col):
    col.add(documents=["x"], ids=["1"])
    with pytest.raises(ValueError):
        col.delete(where={})
    assert col.count == 1


def test_update_bad_embedding_keeps_document(col):
    col.add(documents=["safe doc"], ids=["keep"])
    import numpy as np
    import pytest
    with pytest.raises(ValueError):
        col.update(ids=["keep"], embeddings=[np.zeros(3, np.float32)])
    got = col.get(ids=["keep"])
    assert got.ids == ["keep"]  # the old delete-then-insert lost it


def test_get_ids_and_where_compose(col):
    col.add(documents=["en doc", "fr doc"], ids=["e", "f"],
            metadatas=[{"lang": "en"}, {"lang": "fr"}])
    got = col.get(ids=["e", "f"], where={"lang": "en"})
    assert got.ids == ["e"]


def test_default_device_is_the_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        assert Client(path=None, embedding_provider="mock"
                      )._db.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            Client(path=None, embedding_provider="mock")


def test_same_answers_as_the_jax_client(tmp_path):
    from fastpyvectordb_tpu.api import Client as JClient
    docs = ["the quick brown fox", "machine learning models",
            "deep learning neural networks", "a brown dog", "stock news",
            "neural nets learn", "fox and dog", "models of markets"]
    metas = [{"g": i % 3, "len": len(d)} for i, d in enumerate(docs)]
    out = []
    for cl in (Client(path=str(tmp_path / "t"), embedding_provider="hashing",
                      device="cpu"),
               JClient(path=str(tmp_path / "j"),
                       embedding_provider="hashing")):
        col = cl.create_collection("c")
        col.add(documents=docs, ids=[f"d{i}" for i in range(len(docs))],
                metadatas=metas)
        col.update(ids=["d1"], documents=["machine learning on cards"])
        col.upsert(documents=["brand new doc"], ids=["d9"])
        col.delete(where={"g": 2})
        q = col.query(["learning networks", "brown fox"], n_results=4,
                      where={"g": {"$lt": 2}})
        g = col.get(where={"g": 0})
        out.append((q.ids, q.documents, q.metadatas, q.distances,
                    g.ids, g.documents, g.metadatas, col.count,
                    col.peek(3).ids))
        cl.persist()
    (qi, qd, qm, qdist, *rest_t), (ji, jd, jm, jdist, *rest_j) = out
    np.testing.assert_allclose(np.asarray(qdist), np.asarray(jdist),
                               atol=1e-5)
    # bag-of-words distances tie (texts sharing no token are all at 1.0):
    # the hits must agree wherever a distance is clear of the others
    for b in range(len(qi)):
        rows_t = dict(zip(qi[b], zip(qd[b], qm[b])))
        rows_j = dict(zip(ji[b], zip(jd[b], jm[b])))
        for i, dist in enumerate(jdist[b]):
            if sum(abs(dist - x) <= 1e-5 for x in jdist[b]) == 1:
                assert qi[b][i] == ji[b][i]
        for rid in set(rows_t) & set(rows_j):
            assert rows_t[rid] == rows_j[rid]
    assert rest_t == rest_j
