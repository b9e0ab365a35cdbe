"""The port's native C++ layer (the cases of ``tests/test_native.py``):
``bm25.cpp`` builds with g++ into ``build/native`` and agrees bit for bit
with the JAX package's pure-Python BM25 (``hybrid/bm25.py``, the
reference) on scores and rankings;
``graph.cpp``'s CSR traversal answers as the JAX package's build of it."""

import numpy as np
import pytest

from fastpyvectordb_tpu.hybrid.bm25 import BM25Index
from fastpyvectordb_tpu_torch import native


@pytest.fixture(autouse=True)
def _toolchain():
    if not native.available():
        pytest.skip("no C++ toolchain")

DOCS = {
    "d1": "machine learning with neural networks",
    "d2": "deep neural networks for vision",
    "d3": "cooking pasta with tomato sauce",
    "d4": "the stock market crashed today",
    "d5": "Neural style transfer; for IMAGES!",
}


@pytest.fixture()
def pair():
    py = BM25Index()
    nat = native.NativeBM25()
    for k, v in DOCS.items():
        py.add_document(k, v)
        nat.add_document(k, v)
    return py, nat


def test_tokenizer_matches_python(pair):
    from fastpyvectordb_tpu.hybrid.bm25 import tokenize
    _, nat = pair
    for text in list(DOCS.values()) + ["ALL-CAPS and under_scores 123 éé"]:
        assert nat.tokenize(text) == tokenize(text)


def test_stats_match(pair):
    py, nat = pair
    assert nat.n_docs == py.n_docs
    assert nat.avg_doc_len == pytest.approx(py.avg_doc_len)


def test_idf_and_score_match(pair):
    py, nat = pair
    for term in ("neural", "pasta", "the", "missing"):
        assert nat.idf(term) == pytest.approx(py.idf(term), rel=1e-12)
    for q in ("neural networks", "tomato pasta", "stock today", "zzz"):
        for d in DOCS:
            assert nat.score(q, d) == pytest.approx(py.score(q, d),
                                                    rel=1e-12)


def test_search_matches(pair):
    py, nat = pair
    for q in ("neural networks", "pasta", "market neural", ""):
        a = nat.search(q, 5)
        b = py.search(q, 5)
        assert [x[0] for x in a] == [x[0] for x in b]
        np.testing.assert_allclose([x[1] for x in a], [x[1] for x in b],
                                   rtol=1e-12)


def test_remove_and_replace(pair):
    py, nat = pair
    for idx in (py, nat):
        assert idx.remove_document("d3")
        assert not idx.remove_document("d3")
    assert nat.search("pasta", 3) == py.search("pasta", 3) == []
    for idx in (py, nat):
        idx.add_document("d1", "completely new content here")
    assert nat.search("networks", 5) == py.search("networks", 5)
    assert nat.search("completely new", 2)[0][0] == "d1"


def test_serialization_replay():
    nat = native.NativeBM25(k1=1.2, b=0.5)
    for k, v in DOCS.items():
        nat.add_document(k, v)
    nat2 = native.NativeBM25.from_dict(nat.to_dict())
    assert nat2.search("neural networks", 5) == nat.search(
        "neural networks", 5)
    assert nat2.k1 == 1.2 and nat2.b == 0.5


def test_scales_to_many_docs():
    nat = native.NativeBM25()
    rng = np.random.default_rng(0)
    vocab = [f"w{i}" for i in range(500)]
    import time
    t0 = time.perf_counter()
    for i in range(5_000):
        words = " ".join(vocab[j] for j in rng.integers(0, 500, 20))
        nat.add_document(f"doc{i}", words)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(100):
        nat.search("w1 w2 w3", 10)
    search_s = (time.perf_counter() - t0) / 100
    assert nat.n_docs == 5_000
    assert build_s < 10.0 and search_s < 0.05


def test_native_bm25_unicode_parity():
    """Native and Python backends must tokenize Unicode identically
    ('École—Bar' lowercases and splits on the em-dash)."""
    import pytest
    from fastpyvectordb_tpu_torch import native
    from fastpyvectordb_tpu.hybrid.bm25 import BM25Index
    if not native.available():
        pytest.skip("native unavailable")
    nat, py = native.NativeBM25(), BM25Index()
    for idx in (nat, py):
        idx.add_document("d1", "École—Bar serves café food")
        idx.add_document("d2", "a completely different document")
    from fastpyvectordb_tpu.hybrid.bm25 import tokenize
    assert nat.tokenize("École—Bar") == tokenize("École—Bar")
    for q in ("école", "bar", "café"):
        nhits = nat.search(q, k=2)
        phits = py.search(q, k=2)
        assert [h[0] for h in nhits] == [h[0] for h in phits], q
        for (ni, ns), (pi, ps) in zip(nhits, phits):
            assert abs(ns - ps) < 1e-9


def test_native_bm25_tie_break_parity():
    import pytest
    from fastpyvectordb_tpu_torch import native
    from fastpyvectordb_tpu.hybrid.bm25 import BM25Index
    if not native.available():
        pytest.skip("native unavailable")
    nat, py = native.NativeBM25(), BM25Index()
    for idx in (nat, py):
        idx.add_document("z", "same words here")
        idx.add_document("a", "same words here")
    assert nat.search("same words", k=1) == pytest.approx(
        py.search("same words", k=1)) or \
        [h[0] for h in nat.search("same words", k=1)] == \
        [h[0] for h in py.search("same words", k=1)]
    assert nat.search("same", k=1)[0][0] == "a"  # doc-id tie-break


def test_blob_export_import_roundtrip(pair):
    """C-ABI binary state: import must reproduce searches exactly, with
    no tokenization on the load path."""
    _, nat = pair
    blob = nat.export_blob()
    nat2 = native.NativeBM25.from_blob(blob, nat.doc_ids,
                                       nat.k1, nat.b)
    for q in ("neural networks", "pasta", "stock market today"):
        assert nat2.search(q, 5) == nat.search(q, 5)
    assert nat2.stats() == nat.stats()


def test_blob_python_codec_matches_native(pair):
    """The pure-Python blob decoder (toolchain-free fallback) sees the
    same postings the C++ engine wrote."""
    py, nat = pair
    postings, doc_len = native.decode_bm25_blob(nat.export_blob())
    ids = nat.doc_ids
    d = {"config": {"k1": nat.k1, "b": nat.b},
         "postings": {t: {ids[u]: tf for u, tf in p.items()}
                      for t, p in postings.items()},
         "doc_len": {ids[u]: dl for u, dl in doc_len.items()}}
    py2 = BM25Index.from_dict(d)
    for q in ("neural networks", "vision images"):
        a, b = py.search(q, 5), py2.search(q, 5)
        assert [x[0] for x in a] == [x[0] for x in b]
        np.testing.assert_allclose([x[1] for x in a], [x[1] for x in b],
                                   rtol=1e-12)
    # and the encoder round-trips back into the C++ engine
    blob2 = native.encode_bm25_blob(postings, doc_len)
    nat2 = native.NativeBM25.from_blob(blob2, ids, nat.k1, nat.b)
    assert nat2.search("neural networks", 5) == nat.search(
        "neural networks", 5)


def test_from_dict_accepts_legacy_texts():
    legacy = {"config": {"k1": 1.3, "b": 0.6}, "native": True,
              "texts": dict(DOCS)}
    idx = native.NativeBM25.from_dict(legacy)
    assert idx.n_docs == len(DOCS) and idx.k1 == 1.3
    assert idx.search("pasta", 1)[0][0] == "d3"


def test_blob_survives_remove_and_readd(pair):
    _, nat = pair
    nat.remove_document("d2")
    nat.add_document("d6", "fresh document about markets")
    nat2 = native.NativeBM25.from_blob(nat.export_blob(), nat.doc_ids,
                                       nat.k1, nat.b)
    assert nat2.search("markets", 3) == nat.search("markets", 3)
    assert nat2.search("vision", 3) == nat.search("vision", 3)


def test_libraries_build_under_build_native():
    from pathlib import Path
    root = Path(native.__file__).resolve().parents[2]
    assert native.graph_available()
    for src in (native._SRC, native._GRAPH_SRC):
        so = native._so_path(src)
        assert so.exists() and so.parent == root / "build" / "native"
    assert not list(Path(native.__file__).parent.glob("*.so"))


def test_failed_build_makes_the_library_unavailable(monkeypatch, tmp_path):
    # g++ missing (or failing): available() is False, nothing raises
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "_graph_lib", None)
    monkeypatch.setattr(native, "_graph_build_failed", False)
    assert not native.available() and not native.graph_available()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csr_traversal_equals_the_jax_packages(seed):
    from fastpyvectordb_tpu import native as jnative
    if not jnative.graph_available():
        pytest.skip("the JAX package's graph library did not build")
    rng = np.random.default_rng(seed)
    n, m = 400, 1600
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    order = np.argsort(src, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    indices = dst[order].astype(np.int32)
    ours = native.NativeCSRGraph(indptr, indices)
    theirs = jnative.NativeCSRGraph(indptr, indices)
    seeds = rng.integers(0, n, 5)
    for hops in (0, 1, 3):
        for a, b in zip(ours.bfs(seeds, hops), theirs.bfs(seeds, hops)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ours.bfs_attributed(seeds, hops),
                        theirs.bfs_attributed(seeds, hops)):
            np.testing.assert_array_equal(a, b)
    for s_, t_ in rng.integers(0, n, (10, 2)):
        a, b = ours.shortest_path(s_, t_), theirs.shortest_path(s_, t_)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
