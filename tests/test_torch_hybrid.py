"""The port's BM25 hybrid collection (fastpyvectordb_tpu_torch/hybrid/):
the cases of tests/test_hybrid.py on the port, then parity with the JAX
package's HybridCollection on the same seeded documents and vectors
(keyword scores, fused hybrid results for several weights, filters and
the DOT metric, reindexing on delete / update) and its ``bm25.fpvt``
moving between the packages both ways."""

import math

import numpy as np
import pytest

import fastpyvectordb_tpu as J
import fastpyvectordb_tpu_torch as T
from fastpyvectordb_tpu.hybrid import HybridCollection as JHybrid
from fastpyvectordb_tpu_torch import native
from fastpyvectordb_tpu_torch.embeddings import HashingEmbedder
from fastpyvectordb_tpu_torch.hybrid import (BM25Config, BM25Index,
                                             HybridCollection)
from torch_parity import jax_native

DOCS = {
    "d1": "machine learning with neural networks",
    "d2": "deep neural networks for vision",
    "d3": "cooking pasta with tomato sauce",
    "d4": "the stock market crashed today",
    "d5": "neural style transfer for images",
}


@pytest.fixture()
def bm25():
    idx = BM25Index()
    for k, v in DOCS.items():
        idx.add_document(k, v)
    return idx


class TestBM25:
    def test_exact_term_ranks_first(self, bm25):
        hits = bm25.search("pasta sauce", k=3)
        assert hits[0][0] == "d3" and hits[0][1] > 0

    def test_common_term_ranks_all_matching(self, bm25):
        ids = [h[0] for h in bm25.search("neural networks", k=5)]
        assert set(ids) == {"d1", "d2", "d5"}
        assert ids[0] in ("d1", "d2")

    def test_unknown_term_empty(self, bm25):
        assert bm25.search("xylophone", k=3) == []

    def test_idf_rare_beats_common(self, bm25):
        assert bm25.idf("pasta") > bm25.idf("neural")
        assert bm25.idf("neverseen") == 0.0

    def test_remove_document(self, bm25):
        assert bm25.remove_document("d3")
        assert not bm25.remove_document("d3")
        assert bm25.search("pasta", k=3) == []
        assert bm25.n_docs == 4

    def test_score_matches_formula(self, bm25):
        k1, b = bm25.config.k1, bm25.config.b
        df, n = 1, 5
        idf = math.log((n - df + 0.5) / (df + 0.5) + 1)
        dl, avgdl = 5, bm25.avg_doc_len
        want = idf * (k1 + 1) / (1 + k1 * (1 - b + b * dl / avgdl))
        assert bm25.score("pasta", "d3") == pytest.approx(want, rel=1e-9)

    def test_serialization_roundtrip(self, bm25):
        idx2 = BM25Index.from_dict(bm25.to_dict())
        assert idx2.search("neural networks", 5) == bm25.search(
            "neural networks", 5)
        assert idx2.avg_doc_len == bm25.avg_doc_len


@pytest.fixture()
def hybrid(tmp_path):
    emb = HashingEmbedder(128)
    col = HybridCollection(
        T.CollectionConfig(name="h", dimensions=128, metric="cosine"),
        base_path=tmp_path / "h", text_fields=["text"], device="cpu")
    ids = list(DOCS)
    vecs = np.stack([emb.embed(DOCS[i]) for i in ids])
    col.insert_batch(vecs, ids, [{"text": DOCS[i], "n": j}
                                 for j, i in enumerate(ids)])
    return col, emb


class TestHybridCollection:
    def test_keyword_search(self, hybrid):
        col, _ = hybrid
        assert col.keyword_search("tomato pasta", k=2)[0].id == "d3"

    def test_keyword_search_with_filter(self, hybrid):
        col, _ = hybrid
        hits = col.keyword_search("neural", k=5, filter=T.Filter.gt("n", 1))
        assert {h.id for h in hits} == {"d5"}

    def test_hybrid_fusion_beats_single_system(self, hybrid):
        col, emb = hybrid
        q = "neural networks for images"
        res = col.hybrid_search(emb.embed(q), q, k=3, alpha=0.5)
        assert res[0].id in ("d5", "d2")
        assert all(0 <= r.vector_score <= 1 and 0 <= r.keyword_score <= 1
                   for r in res)
        for r in res:
            assert r.score == pytest.approx(
                0.5 * r.vector_score + 0.5 * r.keyword_score, abs=1e-9)

    def test_alpha_extremes(self, hybrid):
        col, emb = hybrid
        assert col.hybrid_search(emb.embed("pasta"), "pasta", k=1,
                                 alpha=0.0)[0].id == "d3"
        assert col.hybrid_search(emb.embed(DOCS["d4"]), "pasta", k=1,
                                 alpha=1.0)[0].id == "d4"

    def test_weight_override(self, hybrid):
        col, emb = hybrid
        res = col.hybrid_search(emb.embed("pasta"), "pasta", k=1,
                                vector_weight=0.0, keyword_weight=1.0)
        assert res[0].id == "d3" and res[0].score == res[0].keyword_score

    def test_delete_removes_from_bm25(self, hybrid):
        col, _ = hybrid
        col.delete("d3")
        assert col.keyword_search("pasta", k=3) == []

    def test_update_metadata_reindexes(self, hybrid):
        col, _ = hybrid
        col.update_metadata("d4", {"text": "quantum computing breakthrough"},
                            merge=False)
        hits = col.keyword_search("quantum", k=2)
        assert hits and hits[0].id == "d4"

    def test_persistence_roundtrip(self, hybrid):
        col, emb = hybrid
        col.save()
        col2 = HybridCollection(T.CollectionConfig(name="h", dimensions=128),
                                base_path=col.base_path, device="cpu")
        assert col2.text_fields == ["text"]
        assert col2.keyword_search("pasta", k=1)[0].id == "d3"
        assert col2.hybrid_search(emb.embed("neural"), "neural", k=2)


def test_wal_recovery_keeps_bm25_for_replayed_docs(tmp_path):
    """The BM25 snapshot loads BEFORE WAL replay: documents recovered from
    the log stay keyword-searchable after a crash."""
    cfg = lambda: T.CollectionConfig(name="h", dimensions=8,  # noqa: E731
                                     durability="wal")
    rng = np.random.default_rng(0)
    col = HybridCollection(cfg(), base_path=tmp_path / "h",
                           text_fields=["text"], device="cpu")
    col.insert(rng.standard_normal(8).astype(np.float32), "a",
               {"text": "alpha document about pelicans"})
    col.save()
    col.insert(rng.standard_normal(8).astype(np.float32), "b",
               {"text": "beta document about walruses"})
    col2 = HybridCollection(cfg(), base_path=tmp_path / "h",
                            text_fields=["text"], device="cpu")
    assert col2.count() == 2
    assert any(h.id == "b" for h in col2.keyword_search("walruses", k=3))
    assert any(h.id == "a" for h in col2.keyword_search("pelicans", k=3))


def test_update_metadata_empty_text_unindexes():
    col = HybridCollection(T.CollectionConfig(name="u", dimensions=4),
                           text_fields=["title"], device="cpu")
    col.insert(np.ones(4, np.float32), "x", {"title": "ancient scrolls"})
    assert col.keyword_search("scrolls", k=2)
    col.update_metadata("x", {"title": ""}, merge=False)
    assert not col.keyword_search("scrolls", k=2)


def test_hybrid_search_dot_metric_normalized():
    col = HybridCollection(T.CollectionConfig(name="d", dimensions=4,
                                              metric="ip"),
                           text_fields=["text"], device="cpu")
    col.insert_batch(np.eye(4, dtype=np.float32) * [[3], [2], [1], [0.5]],
                     ["a", "b", "c", "d"],
                     [{"text": t} for t in ("aa", "bb", "cc", "dd")])
    res = col.hybrid_search(np.ones(4, np.float32), "aa", k=4, alpha=0.5)
    vs = {r.id: r.vector_score for r in res}
    assert all(0.0 <= v <= 1.0 for v in vs.values()), vs
    assert res[0].id == "a"


def test_native_engine_is_the_default_and_blob_persists(tmp_path):
    if not native.available():
        pytest.skip("no C++ toolchain")
    from fastpyvectordb_tpu_torch.persist.format import load_container
    cfg = lambda: T.CollectionConfig(name="h", dimensions=8,  # noqa: E731
                                     metric="cosine")
    col = HybridCollection(cfg(), base_path=tmp_path / "h", device="cpu")
    assert isinstance(col._bm25, native.NativeBM25)
    rng = np.random.default_rng(0)
    texts = ["neural networks win", "pasta sauce recipe",
             "market crash report", "vision transformers"]
    col.insert_batch(rng.standard_normal((4, 8)).astype(np.float32),
                     [f"d{i}" for i in range(4)],
                     [{"text": t} for t in texts])
    col.save()
    c = load_container(tmp_path / "h" / "bm25.fpvt")
    assert c.read("bm25").get("blob") and "bm25_blob" in c.keys()
    col2 = HybridCollection(cfg(), base_path=tmp_path / "h",
                            bm25_impl="native", device="cpu")
    assert col2._bm25.search("pasta recipe", 2) == \
        col._bm25.search("pasta recipe", 2)
    col3 = HybridCollection(cfg(), base_path=tmp_path / "h",
                            bm25_impl="python", device="cpu")
    assert isinstance(col3._bm25, BM25Index)
    assert [x[0] for x in col._bm25.search("market crash", 2)] == \
        [x[0] for x in col3._bm25.search("market crash", 2)]


# ---------------------------------------------------------------------------
# parity with the JAX package's HybridCollection
# ---------------------------------------------------------------------------

def _corpus(seed=0, n=300, d=16, vocab=400):
    """Seeded texts of 4-24 Zipf-drawn words and clustered vectors."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    ranks = np.minimum(rng.zipf(1.3, size=n * 24) - 1, vocab - 1)
    lens = rng.integers(4, 25, n)
    texts, at = [], 0
    for ln in lens:
        texts.append(" ".join(words[r] for r in ranks[at:at + ln]))
        at += ln
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((6, d)).astype(np.float32)
    metas = [{"text": t, "n": i % 7} for i, t in enumerate(texts)]
    return v, q, metas, words


def _pair(metric="cosine", impl="auto", base=None):
    if impl != "python":
        # both packages must pick their native engine, whichever worker
        # built the JAX package's library
        jax_native()
    v, q, metas, words = _corpus()
    ids = [f"r{i}" for i in range(len(metas))]
    cfg = dict(name="h", dimensions=v.shape[1], metric=metric)
    jc = JHybrid(J.CollectionConfig(**cfg), text_fields=["text"],
                 bm25_impl=impl,
                 base_path=None if base is None else base / "j")
    tc = HybridCollection(T.CollectionConfig(**cfg), text_fields=["text"],
                          bm25_impl=impl, device="cpu",
                          base_path=None if base is None else base / "t")
    for c in (jc, tc):
        c.insert_batch(v, ids, metas)
    return jc, tc, q, words


def _same_hits(jh, th, tol=1e-5):
    assert [h.id for h in th] == [h.id for h in jh]
    for a, b in zip(jh, th):
        assert b.score == pytest.approx(a.score, abs=tol)
        assert b.vector_score == pytest.approx(a.vector_score, abs=tol)
        assert b.keyword_score == pytest.approx(a.keyword_score, abs=tol)
        assert b.metadata == a.metadata


QUERIES = ["w0 w3", "w1 w7 w20", "w5", "w2 w2 w9 w40", "w100 w1", "zzz"]


@pytest.mark.parametrize("impl", ["auto", "python"])
def test_keyword_search_matches_jax(impl):
    jc, tc, _, _ = _pair(impl=impl)
    assert type(tc._bm25).__name__ == type(jc._bm25).__name__
    for text in QUERIES:
        jh, th = jc.keyword_search(text, k=10), tc.keyword_search(text, k=10)
        assert [h.id for h in th] == [h.id for h in jh]
        np.testing.assert_allclose([h.score for h in th],
                                   [h.score for h in jh], rtol=1e-6)
    jf, tf = J.Filter.eq("n", 3), T.Filter.eq("n", 3)
    _same_hits(jc.keyword_search("w0 w1", k=8, filter=jf),
               tc.keyword_search("w0 w1", k=8, filter=tf))


def test_a_lost_library_build_race_still_compares_native_engines():
    """A test worker whose JAX loader met a half-written library (another
    worker's g++ was rewriting it) keeps that failure for the process; the
    parity pair must still put the two native engines side by side."""
    from fastpyvectordb_tpu import native as jnative
    if jax_native() is None:
        pytest.skip("no C++ toolchain")
    jnative._lib, jnative._build_failed = None, True   # as a lost race
    assert not jnative.available()
    jc, tc, _, _ = _pair(impl="auto")
    assert type(jc._bm25).__name__ == type(tc._bm25).__name__ == \
        "NativeBM25"
    for text in QUERIES:
        assert [h.id for h in tc.keyword_search(text, k=10)] == \
            [h.id for h in jc.keyword_search(text, k=10)]


@pytest.mark.parametrize("metric", ["cosine", "l2", "ip"])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_hybrid_search_matches_jax(metric, alpha):
    jc, tc, q, _ = _pair(metric=metric)
    for qi, text in enumerate(QUERIES):
        _same_hits(jc.hybrid_search(q[qi], text, k=10, alpha=alpha),
                   tc.hybrid_search(q[qi], text, k=10, alpha=alpha))
    jf, tf = J.Filter.lt("n", 3), T.Filter.lt("n", 3)
    _same_hits(jc.hybrid_search(q[0], "w0 w4", k=10, alpha=alpha, filter=jf),
               tc.hybrid_search(q[0], "w0 w4", k=10, alpha=alpha, filter=tf))
    _same_hits(jc.hybrid_search(q[1], "w1", k=5, vector_weight=0.3,
                                keyword_weight=0.9),
               tc.hybrid_search(q[1], "w1", k=5, vector_weight=0.3,
                                keyword_weight=0.9))


def test_delete_and_update_reindex_alike():
    jc, tc, q, _ = _pair()
    for c in (jc, tc):
        c.delete_batch(["r0", "r1", "r2"])
        c.update_metadata("r5", {"text": "w0 w0 w0 unique"}, merge=True)
        c.update_metadata("r6", {"n": 1}, merge=False)   # no text: unindexed
    for text in ("w0", "unique", "w1 w2"):
        _same_hits(jc.keyword_search(text, k=10), tc.keyword_search(text,
                                                                    k=10))
        _same_hits(jc.hybrid_search(q[0], text, k=10),
                   tc.hybrid_search(q[0], text, k=10))
    assert tc.keyword_search("unique", k=3)[0].id == "r5"
    assert tc._bm25.n_docs == jc._bm25.n_docs


@pytest.mark.parametrize("impl", ["auto", "python"])
def test_bm25_sidecar_moves_both_ways(tmp_path, impl):
    jc, tc, q, _ = _pair(impl=impl, base=tmp_path)
    jc.save()
    tc.save()
    # a JAX-written directory opens in the port, a port-written one in JAX
    t_from_j = HybridCollection(T.CollectionConfig(name="h", dimensions=16),
                                base_path=tmp_path / "j", device="cpu",
                                bm25_impl=impl)
    j_from_t = JHybrid(J.CollectionConfig(name="h", dimensions=16),
                       base_path=tmp_path / "t", bm25_impl=impl)
    assert t_from_j.text_fields == j_from_t.text_fields == ["text"]
    for text in QUERIES[:4]:
        _same_hits(jc.keyword_search(text, k=10),
                   t_from_j.keyword_search(text, k=10))
        _same_hits(tc.keyword_search(text, k=10),
                   j_from_t.keyword_search(text, k=10))
        _same_hits(jc.hybrid_search(q[1], text, k=10),
                   t_from_j.hybrid_search(q[1], text, k=10))
    # the sidecar bytes are the same from either package
    assert (tmp_path / "j" / "bm25.fpvt").read_bytes() == \
        (tmp_path / "t" / "bm25.fpvt").read_bytes()


def test_bm25_config_carried_and_card_by_default():
    import torch
    col = HybridCollection(T.CollectionConfig(name="c", dimensions=4),
                           bm25_config=BM25Config(k1=1.2, b=0.5),
                           bm25_impl="python", device="cpu")
    assert (col._bm25.config.k1, col._bm25.config.b) == (1.2, 0.5)
    cfg = T.CollectionConfig(name="c", dimensions=4)
    if torch.cuda.is_available():
        assert HybridCollection(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            HybridCollection(cfg)
