"""The port's embedders (the cases of ``tests/test_embeddings.py``,
offline providers only) and the ``TransformerEmbedder`` held against the
JAX package's ``JaxTransformerEmbedder``: the same random init for a seed,
the same embeddings with weights carried across (``from_numpy``) or read
from an FPVT file either package wrote."""

import jax
import numpy as np
import pytest

from fastpyvectordb_tpu.embeddings import JaxTransformerEmbedder
from fastpyvectordb_tpu_torch.embeddings import (
    CachedEmbedder,
    HashingEmbedder,
    MockEmbedder,
    TransformerEmbedder,
    get_embedder,
)

# the small config of these tests (the defaults are d 384, 2 layers,
# 6 heads, vocab 32,768, max_len 128)
SMALL = dict(dimensions=48, n_layers=2, n_heads=4, vocab_size=512,
             max_len=16)


def test_mock_deterministic_and_normalized():
    e = MockEmbedder(64)
    a, b = e.embed("hello"), e.embed("hello")
    np.testing.assert_array_equal(a, b)
    assert np.linalg.norm(a) == pytest.approx(1.0, abs=1e-5)
    assert not np.allclose(a, e.embed("other"))
    assert e.embed_batch(["x", "y"]).shape == (2, 64)


def test_hashing_embedder_similarity_ordering():
    e = HashingEmbedder(128)
    a = e.embed("neural networks learn representations")
    b = e.embed("deep neural networks")
    c = e.embed("cooking pasta recipes")
    assert a @ b > a @ c


def test_cached_embedder(tmp_path):
    calls = {"n": 0}

    class Counting(MockEmbedder):
        def embed_batch(self, texts, batch_size=32):
            calls["n"] += len(texts)
            return super().embed_batch(texts, batch_size)

    e = CachedEmbedder(Counting(32), cache_dir=str(tmp_path))
    v1 = e.embed("a")
    v2 = e.embed("a")
    np.testing.assert_array_equal(v1, v2)
    assert calls["n"] == 1
    # batch path partitions cached vs uncached
    out = e.embed_batch(["a", "b", "c"])
    assert calls["n"] == 3 and out.shape == (3, 32)
    # fresh instance reads the disk cache
    e2 = CachedEmbedder(Counting(32), cache_dir=str(tmp_path))
    e2.embed("a")
    assert calls["n"] == 3


def test_transformer_embedder():
    e = TransformerEmbedder(dimensions=48, n_layers=1, n_heads=4,
                            max_len=16, device="cpu")
    out = e.embed_batch(["hello world", "hello world", "different text"])
    assert out.shape == (3, 48)
    np.testing.assert_allclose(out[0], out[1], atol=1e-5)  # deterministic
    assert not np.allclose(out[0], out[2])
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-4)
    # shared-token texts are closer than disjoint ones
    a = e.embed("machine learning rocks")
    b = e.embed("machine learning tools")
    c = e.embed("zebra crossing stripes")
    assert a @ b > a @ c


def test_transformer_embedder_save_load(tmp_path):
    e = TransformerEmbedder(dimensions=32, n_layers=1, n_heads=4,
                            max_len=8, seed=3, device="cpu")
    e.save(tmp_path / "enc.fpvt")
    e2 = TransformerEmbedder.load(tmp_path / "enc.fpvt", device="cpu")
    np.testing.assert_allclose(e.embed("same text"), e2.embed("same text"),
                               atol=1e-5)


def _jax_params(emb):
    return jax.tree.map(np.asarray, emb.params)


@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_random_init_equals_the_jax_packages(seed):
    want = _jax_params(JaxTransformerEmbedder(seed=seed, **SMALL))
    got = TransformerEmbedder(seed=seed, device="cpu", **SMALL).params_numpy()
    np.testing.assert_allclose(got["tok"], want["tok"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=0, atol=1e-6)
    assert len(got["layers"]) == len(want["layers"])
    for g, w in zip(got["layers"], want["layers"]):
        assert g.keys() == w.keys()
        for name in w:
            assert g[name].shape == w[name].shape
            np.testing.assert_allclose(g[name], w[name], rtol=0, atol=1e-6)


def test_jax_random_draws_equal_jax():
    from fastpyvectordb_tpu_torch.embeddings import (
        jax_normal, jax_prng_key, jax_split)
    for seed in (0, 7):
        keys = jax.random.split(jax.random.PRNGKey(seed), 5)
        ours = jax_split(jax_prng_key(seed), 5)
        np.testing.assert_array_equal(np.asarray(keys), np.asarray(ours))
        for k, o in zip(keys, ours):
            np.testing.assert_allclose(
                jax_normal(o, (700, 3)),
                np.asarray(jax.random.normal(k, (700, 3))), rtol=0,
                atol=1e-6)


def _texts(n=64):
    rng = np.random.default_rng(2)
    words = ["alpha", "beta", "gamma", "delta", "vector", "search",
             "graph", "node", "Card", "x1", "über", "naïve"]
    out = [" ".join(rng.choice(words, size=int(rng.integers(1, 30))))
           for _ in range(n - 2)]
    return out + ["", "!!! ..."]   # no tokens at all: zero embeddings


def test_embeddings_equal_the_jax_packages_through_from_numpy():
    jemb = JaxTransformerEmbedder(seed=4, **SMALL)
    temb = TransformerEmbedder.from_numpy(_jax_params(jemb),
                                          n_heads=SMALL["n_heads"],
                                          device="cpu")
    texts = _texts()
    want, got = jemb.embed_batch(texts), temb.embed_batch(texts)
    assert got.shape == (64, 48) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[-2:], 0.0)


def test_embeddings_through_files_either_package_wrote(tmp_path):
    jemb = JaxTransformerEmbedder(seed=6, **SMALL)
    jemb.save(tmp_path / "jax.fpvt")
    temb = TransformerEmbedder.load(tmp_path / "jax.fpvt", device="cpu")
    texts = _texts()
    want = jemb.embed_batch(texts)
    np.testing.assert_allclose(temb.embed_batch(texts), want, rtol=0,
                               atol=1e-5)
    temb.save(tmp_path / "port.fpvt")
    # the same weights and meta: the same bytes, and the JAX package
    # reads the port's file with the same embeddings
    assert (tmp_path / "port.fpvt").read_bytes() == \
        (tmp_path / "jax.fpvt").read_bytes()
    back = JaxTransformerEmbedder.load(tmp_path / "port.fpvt")
    np.testing.assert_allclose(back.embed_batch(texts), want, rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="embedder"):
        from fastpyvectordb_tpu_torch.persist.format import save_container
        save_container(tmp_path / "other.fpvt", {"x": np.zeros(3)},
                       meta={"kind": "graph"})
        TransformerEmbedder.load(tmp_path / "other.fpvt", device="cpu")


def test_concurrent_embeds_equal_sequential_ones():
    # a server embeds each request on its own executor thread
    import sys
    from concurrent.futures import ThreadPoolExecutor
    emb = TransformerEmbedder(seed=2, device="cpu", **SMALL)
    texts = _texts(48)
    want = emb.embed_batch(texts)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(12) as ex:
            got = list(ex.map(emb.embed, texts))
    finally:
        sys.setswitchinterval(interval)
    np.testing.assert_allclose(np.stack(got), want, rtol=0, atol=1e-6)


def test_transformer_default_device_is_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda-marked test covers it")
    with pytest.raises(RuntimeError, match="cuda"):
        TransformerEmbedder(**SMALL)
    with pytest.raises(RuntimeError, match="cuda"):
        get_embedder("jax", **SMALL)
    assert get_embedder("jax", device="cpu", **SMALL).device.type == "cpu"
    assert get_embedder("jax", model="m", device="cpu",
                        **SMALL).model_name == "m"


@pytest.mark.cuda
def test_cuda_embeddings_equal_the_cpus():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = TransformerEmbedder(seed=1, device="cpu")
    card = TransformerEmbedder(seed=1)
    assert card.tok.device.type == "cuda"
    texts = _texts(256)
    np.testing.assert_allclose(card.embed_batch(texts),
                               cpu.embed_batch(texts), rtol=0, atol=1e-4)


def test_factory(tmp_path):
    assert get_embedder("mock").model_name.startswith("mock")
    assert get_embedder("hashing").dimensions == 384
    with pytest.raises(ValueError):
        get_embedder("nope")
    cached = get_embedder("mock", cache=True, cache_dir=str(tmp_path))
    assert isinstance(cached, CachedEmbedder)


def test_embedding_collection():
    from fastpyvectordb_tpu_torch import Collection, CollectionConfig
    from fastpyvectordb_tpu_torch.embeddings import EmbeddingCollection
    ec = EmbeddingCollection(
        Collection(CollectionConfig(name="e", dimensions=64), device="cpu"),
        HashingEmbedder(64))
    ec.add_text("solar panels on rooftops", id="solar")
    ec.add_texts(["wind turbines spin", "tidal energy generators"],
                 ids=["wind", "tidal"], metadatas=[{"k": 1}, {"k": 2}])
    assert ec.count() == 3
    hits = ec.search_text("tidal generators", k=1)
    assert hits[0].id == "tidal" and hits[0].metadata["_text"]
    assert ec.get_text("solar") == "solar panels on rooftops"
    assert ec.get_text("nope") is None
    with pytest.raises(ValueError):
        EmbeddingCollection(
            Collection(CollectionConfig(name="x", dimensions=32), device="cpu"),
            HashingEmbedder(64))
