"""The port's out-of-core tier (fastpyvectordb_tpu_torch/core/outofcore.py)
on the CPU.

The JAX package's own tests (tests/test_outofcore.py) run on both
packages; then parity with the JAX searchers on the same seeded corpora,
the same tile size and a ragged last tile: the exact searcher (3 metrics,
f32 and bf16 compute, a mask) to rtol 1e-5 with the same ids up to ties;
each codec where the candidate pool covers every row to the same (exact
f32 host) scores and ids up to ties, and with a pool that cuts to a mean
top-k overlap of 0.98 (Hamming counts and folded int8 scores tie, and
``torch.topk`` breaks ties in no promised order); codes files with their
``.stats.npz`` moved between the packages both ways (pq's codebooks come
across that way: the packages' k-means draw different rows); the host
encoders against the port's device encoders bit for bit.  Then the
staging order of ``TileStager`` under an emulation of the card's two
streams (worker threads, events), with slow consumers and slow copies,
and, on a card only, many small tiles through the real streams."""

import threading
import time
import types
import queue

import numpy as np
import pytest
import torch

from fastpyvectordb_tpu.core import outofcore as jooc
from fastpyvectordb_tpu.persist.format import (StreamingVectorReader,
                                               StreamingVectorWriter)
from fastpyvectordb_tpu_torch.core import outofcore as tooc
from torch_parity import assert_same_topk, mean_overlap

RTOL = 1e-5
CODECS = ["int8", "int4", "binary", "pq"]
# re-rank depths whose pool cuts the 2,100-row parity corpus but holds its
# exact top-10 (recall 1.0 in both packages): a 40-bit Hamming count ties
# across whole bands of rows, and a cut inside a band (binary at 16 x k:
# recall 0.86) keeps different rows of it in each package
CUT_RERANK = {"int8": 8, "int4": 8, "binary": 32, "pq": 32}


def _package(name):
    if name == "jax":
        return types.SimpleNamespace(
            name=name, OutOfCoreSearcher=jooc.OutOfCoreSearcher,
            QuantizedOutOfCoreSearcher=jooc.QuantizedOutOfCoreSearcher)
    return types.SimpleNamespace(
        name=name,
        OutOfCoreSearcher=lambda *a, **kw: tooc.OutOfCoreSearcher(
            *a, device="cpu", **kw),
        QuantizedOutOfCoreSearcher=lambda *a, **kw:
            tooc.QuantizedOutOfCoreSearcher(*a, device="cpu", **kw))


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _package(request.param)


# ---- the JAX package's tests (tests/test_outofcore.py) on both packages ---

@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(21)
    return rng.standard_normal((1000, 16)).astype(np.float32), \
        rng.standard_normal((4, 16)).astype(np.float32)


@pytest.mark.parametrize("metric", ["cosine", "l2", "ip"])
def test_matches_in_memory_exact(pkg, corpus, metric):
    v, q = corpus
    s = pkg.OutOfCoreSearcher(v, metric=metric, tile_rows=256)
    vals, rows = s.search(q, k=7)
    if metric == "cosine":
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        vn = v / np.linalg.norm(v, axis=1, keepdims=True)
        d = 1 - qn @ vn.T
    elif metric == "l2":
        d = np.linalg.norm(q[:, None] - v[None], axis=-1)
    else:
        d = -(q @ v.T)
    want_rows = np.argsort(d, axis=1, kind="stable")[:, :7]
    for got, want, dd in zip(rows, want_rows, d):
        assert set(got.tolist()) == set(want.tolist()) or np.allclose(
            sorted(dd[got]), sorted(dd[want]), atol=1e-4)


def test_mask(pkg, corpus):
    v, q = corpus
    mask = np.zeros(len(v), dtype=bool)
    mask[300:400] = True
    s = pkg.OutOfCoreSearcher(v, metric="l2", tile_rows=128)
    _, rows = s.search(q, k=20, mask=mask)
    assert ((rows >= 300) & (rows < 400)).all()


def test_streaming_file_backend(pkg, corpus, tmp_path):
    v, q = corpus
    path = tmp_path / "big.fpvs"
    with StreamingVectorWriter(path, dims=16) as w:
        w.append_batch(v)
    with StreamingVectorReader(path) as r:
        s = pkg.OutOfCoreSearcher(r._mm, metric="cosine", tile_rows=512)
        vals, rows = s.search(q[:1], k=1)
    qn = q[0] / np.linalg.norm(q[0])
    vn = v / np.linalg.norm(v, axis=1, keepdims=True)
    assert rows[0, 0] == int(np.argmax(vn @ qn))


def test_k_larger_than_corpus(pkg):
    rng = np.random.default_rng(0)
    v = rng.standard_normal((10, 8)).astype(np.float32)
    s = pkg.OutOfCoreSearcher(v, metric="l2", tile_rows=8)
    vals, rows = s.search(v[:2], k=50)
    assert vals.shape == (2, 10)
    assert rows[0, 0] == 0 and rows[1, 0] == 1


def test_memmap_backed_corpus_matches(pkg, tmp_path, corpus):
    v, q = corpus
    path = tmp_path / "corpus.f32"
    mm = np.memmap(path, np.float32, "w+", shape=v.shape)
    mm[:] = v
    mm.flush()
    ro = np.memmap(path, np.float32, "r", shape=v.shape)
    vr, rr = pkg.OutOfCoreSearcher(v, metric="l2", tile_rows=256).search(q, 5)
    vm, rm = pkg.OutOfCoreSearcher(ro, metric="l2", tile_rows=256).search(q, 5)
    np.testing.assert_allclose(vm, vr, atol=1e-5)
    np.testing.assert_array_equal(rm, rr)


@pytest.fixture(scope="module")
def qcorpus():
    rng = np.random.default_rng(7)
    v = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    plant = np.array([17, 503, 1024, 2047, 2999])
    v[plant] = q   # exact copies of the queries: top-1 is unambiguous
    return v, q, plant


@pytest.mark.parametrize("codec", CODECS)
def test_quantized_planted_top1(pkg, qcorpus, codec):
    v, q, plant = qcorpus
    s = pkg.QuantizedOutOfCoreSearcher(v, metric="cosine", codec=codec,
                                       tile_rows=512, rerank=32)
    vals, rows = s.search(q, k=3)
    np.testing.assert_array_equal(rows[:, 0], plant)
    np.testing.assert_allclose(vals[:, 0], 0.0, atol=1e-4)


def test_quantized_pq_beats_binary_recall(pkg, qcorpus):
    v, q, _ = qcorpus
    _, erows = pkg.OutOfCoreSearcher(v, metric="cosine",
                                     tile_rows=1024).search(q, k=10)

    def overlap(codec):
        s = pkg.QuantizedOutOfCoreSearcher(v, metric="cosine", codec=codec,
                                           tile_rows=1024, rerank=8)
        return mean_overlap(s.search(q, k=10)[1], erows)

    r_pq, r_bin = overlap("pq"), overlap("binary")
    assert r_pq >= 0.8, r_pq
    assert r_pq >= r_bin, (r_pq, r_bin)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_quantized_int8_metrics_match_exact(pkg, qcorpus, metric):
    v, q, _ = qcorpus
    s = pkg.QuantizedOutOfCoreSearcher(v, metric=metric, codec="int8",
                                       tile_rows=1024, rerank=16)
    vals, rows = s.search(q, k=10)
    evals, erows = pkg.OutOfCoreSearcher(v, metric=metric,
                                         tile_rows=1024).search(q, k=10)
    assert (rows[:, 0] == erows[:, 0]).all()
    assert mean_overlap(rows, erows) >= 0.9
    np.testing.assert_allclose(vals[:, 0], evals[:, 0], atol=1e-3)


def test_quantized_mask(pkg, qcorpus):
    v, q, _ = qcorpus
    mask = np.zeros(len(v), dtype=bool)
    mask[1000:1500] = True
    s = pkg.QuantizedOutOfCoreSearcher(v, metric="l2", codec="int8",
                                       tile_rows=512, rerank=8)
    vals, rows = s.search(q, k=15, mask=mask)
    assert ((rows >= 1000) & (rows < 1500)).all()
    assert np.isfinite(vals).all()


class Guard:
    """Corpus proxy that forbids contiguous tile reads (the train /
    re-encode access pattern); candidate gathers use fancy indexing."""

    def __init__(self, arr):
        self._arr = arr
        self.shape = arr.shape

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            raise AssertionError("re-encoded despite codes_reuse")
        return self._arr[idx]


@pytest.mark.parametrize("codec", ["int8", "int4", "pq"])
def test_quantized_codes_memmap_reuse(pkg, qcorpus, tmp_path, codec):
    v, q, _ = qcorpus
    cp = str(tmp_path / f"codes_{codec}.npy")
    s1 = pkg.QuantizedOutOfCoreSearcher(v, metric="cosine", codec=codec,
                                        tile_rows=512, rerank=32,
                                        codes_path=cp)
    v1, r1 = s1.search(q, k=5)
    s2 = pkg.QuantizedOutOfCoreSearcher(Guard(v), metric="cosine",
                                        codec=codec, tile_rows=512,
                                        rerank=32, codes_path=cp,
                                        codes_reuse=True)
    v2, r2 = s2.search(q, k=5)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_allclose(v1, v2, atol=1e-6)


def test_quantized_k_larger_than_corpus(pkg):
    rng = np.random.default_rng(3)
    v = rng.standard_normal((12, 8)).astype(np.float32)
    s = pkg.QuantizedOutOfCoreSearcher(v, metric="l2", codec="int8",
                                       tile_rows=8, rerank=4, train_rows=12)
    vals, rows = s.search(v[:2], k=40)
    assert vals.shape == (2, 12)
    assert rows[0, 0] == 0 and rows[1, 0] == 1


def _clustered(seed, n, d=32, spread=0.2, nq=6):
    rng = np.random.default_rng(seed)
    centers = 2.0 * rng.standard_normal((8, d)).astype(np.float32)
    v = (centers[rng.integers(0, 8, n)]
         + spread * rng.standard_normal((n, d)).astype(np.float32))
    q = (centers[rng.integers(0, 8, nq)]
         + spread * rng.standard_normal((nq, d)).astype(np.float32))
    return v, q


def test_quantized_tune_rerank_clustered(pkg):
    v, q = _clustered(4, 4000)
    s = pkg.QuantizedOutOfCoreSearcher(v, metric="cosine", codec="pq",
                                       tile_rows=1024, rerank=2)
    rr = s.tune_rerank(q, k=10, target_recall=0.95)
    assert rr >= 2 and s.rerank == rr
    _, truth = pkg.OutOfCoreSearcher(v, metric="cosine",
                                     tile_rows=1024).search(q, k=10)
    _, rows = s.search(q, k=10)  # tuned depth is now the default
    assert mean_overlap(rows, truth) >= 0.95


@pytest.mark.parametrize("codec", ["int8", "int4", "binary"])
def test_host_encode_matches_device(pkg, qcorpus, codec):
    v, q, plant = qcorpus
    sh = pkg.QuantizedOutOfCoreSearcher(v, metric="cosine", codec=codec,
                                        tile_rows=700, rerank=16,
                                        encode_on="host")
    sd = pkg.QuantizedOutOfCoreSearcher(v, metric="cosine", codec=codec,
                                        tile_rows=700, rerank=16,
                                        encode_on="device")
    ch, cd = np.asarray(sh._codes), np.asarray(sd._codes)
    assert ch.dtype == cd.dtype and ch.shape == cd.shape
    if pkg.name == "torch":   # the same f32 operations: bit for bit
        np.testing.assert_array_equal(ch, cd)
    else:                     # XLA may fuse; <= 0.01% boundary flips
        assert np.mean(ch != cd) <= 1e-4
    if codec in ("int8", "int4"):
        np.testing.assert_allclose(sh._vsq, sd._vsq, rtol=1e-4)
        np.testing.assert_allclose(sh._rinv, sd._rinv, rtol=1e-4)
    for s in (sh, sd):
        np.testing.assert_array_equal(s.search(q, k=5)[1][:, 0], plant)


# ---- parity with the JAX searchers ------------------------------------

@pytest.fixture(scope="module")
def pcorpus():
    # 2,100 rows in tiles of 512: four full tiles and a ragged one of 52
    return _clustered(9, 2100, d=40, spread=0.5, nq=8)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["cosine", "l2", "ip"])
def test_exact_searcher_matches_jax(pcorpus, metric, compute):
    v, q = pcorpus
    mask = np.arange(len(v)) % 7 != 3
    for m in (None, mask):
        jd, jr = jooc.OutOfCoreSearcher(
            v, metric=metric, tile_rows=512,
            compute_dtype=compute).search(q, k=12, mask=m)
        s = tooc.OutOfCoreSearcher(v, metric=metric, tile_rows=512,
                                   compute_dtype=compute, device="cpu")
        td, tr = s.search(q, k=12, mask=m)
        assert td.dtype == np.float32 and tr.dtype == np.int32
        assert_same_topk(jd, jr, td, tr, rtol=RTOL, atol=1e-5)
        wire = 2 if compute == "bfloat16" else 4
        assert s.last_link_bytes == len(v) * (40 * wire + (m is not None))


@pytest.mark.parametrize("metric", ["cosine", "l2", "ip"])
@pytest.mark.parametrize("codec", ["int8", "int4", "binary"])
def test_codec_searchers_match_jax(pcorpus, codec, metric):
    v, q = pcorpus
    mask = np.arange(len(v)) % 5 != 0
    for rerank, m in ((400, None), (400, mask), (CUT_RERANK[codec], None)):
        kw = dict(metric=metric, codec=codec, tile_rows=512, rerank=rerank)
        jd, jr = jooc.QuantizedOutOfCoreSearcher(v, **kw).search(q, 10,
                                                                 mask=m)
        td, tr = tooc.QuantizedOutOfCoreSearcher(v, device="cpu",
                                                 **kw).search(q, 10, mask=m)
        if rerank * 10 >= len(v):   # the pool covers every row: exact
            assert_same_topk(jd, jr, td, tr, rtol=RTOL, atol=1e-5)
        else:
            assert mean_overlap(jr, tr) >= 0.98


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("codec", CODECS)
def test_codes_files_move_between_the_packages(pcorpus, tmp_path, codec,
                                               writer):
    v, q = pcorpus
    cp = str(tmp_path / "codes.npy")
    kw = dict(metric="cosine", codec=codec, tile_rows=512,
              rerank=CUT_RERANK[codec], codes_path=cp)
    w, r = (jooc, tooc) if writer == "jax" else (tooc, jooc)
    dev = lambda mod: {"device": "cpu"} if mod is tooc else {}  # noqa: E731
    src = w.QuantizedOutOfCoreSearcher(v, **kw, **dev(w))
    dst = r.QuantizedOutOfCoreSearcher(Guard(v), codes_reuse=True, **kw,
                                       **dev(r))
    np.testing.assert_array_equal(np.asarray(dst._codes),
                                  np.asarray(src._codes))
    sd, sr = src.search(q, k=10)
    dd, dr = dst.search(q, k=10)
    if codec in ("binary", "pq"):   # tied coarse scores cut differently
        assert mean_overlap(sr, dr) >= 0.98
        np.testing.assert_allclose(np.sort(dd, 1)[:, 0], np.sort(sd, 1)[:, 0],
                                   rtol=RTOL, atol=1e-5)
    else:
        assert_same_topk(sd, sr, dd, dr, rtol=RTOL, atol=1e-5)


def test_pq_with_the_jax_codebooks_matches_jax(pcorpus, tmp_path):
    # the same codebooks and codes (carried in the codes file): with the
    # pool covering every row, the same exact scores and ids up to ties
    v, q = pcorpus
    cp = str(tmp_path / "codes.npy")
    kw = dict(metric="l2", codec="pq", tile_rows=512, rerank=400,
              codes_path=cp)
    js = jooc.QuantizedOutOfCoreSearcher(v, **kw)
    ts = tooc.QuantizedOutOfCoreSearcher(Guard(v), codes_reuse=True,
                                         device="cpu", **kw)
    jd, jr = js.search(q, k=10)
    td, tr = ts.search(q, k=10)
    assert_same_topk(jd, jr, td, tr, rtol=RTOL, atol=1e-5)
    for rr in (2, 4):
        assert mean_overlap(js.search(q, k=10, rerank=rr)[1],
                            ts.search(q, k=10, rerank=rr)[1]) >= 0.98


def test_block_sample_and_host_encoders_match_jax(pcorpus):
    v, _ = pcorpus
    for n, tr in ((2100, 512), (2100, 100), (7, 512)):
        np.testing.assert_array_equal(tooc.block_sample(v, n, tr),
                                      jooc.block_sample(v, n, tr))
    for codec in ("int8", "int4", "binary"):
        js = jooc.QuantizedOutOfCoreSearcher(v[:, :39], codec=codec,
                                             tile_rows=512)
        ts = tooc.QuantizedOutOfCoreSearcher(v[:, :39], codec=codec,
                                             tile_rows=512, device="cpu")
        np.testing.assert_array_equal(ts._codes, np.asarray(js._codes))
        if codec != "binary":
            np.testing.assert_array_equal(ts._vsq, js._vsq)
            np.testing.assert_array_equal(ts._rinv, js._rinv)


# ---- the staging order --------------------------------------------------

class ThreadStreams:
    """The card's ordering emulated on the CPU: a copy stream and a compute
    stream, each a worker thread running its queue in order, and events
    that one stream records and the other (or the host) waits on."""

    pinned = False
    device = torch.device("cpu")

    def __init__(self, copy_delay=0.0):
        self.copy_delay = copy_delay
        self.copy_q, self.compute_q = queue.Queue(), queue.Queue()
        self.errors = []
        self._threads = [threading.Thread(target=self._run, args=(qq,),
                                          daemon=True)
                         for qq in (self.copy_q, self.compute_q)]
        for t in self._threads:
            t.start()

    def _run(self, qq):
        while True:
            fn = qq.get()
            if fn is None:
                return
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - reported by the test
                self.errors.append(e)

    def begin(self):
        # the compute queue is empty here: nothing to wait for
        pass

    def upload(self, dsts, srcs, after):
        done = threading.Event()

        def work():
            if after is not None:
                after.wait()
            time.sleep(self.copy_delay)
            for d, s in zip(dsts, srcs):
                d.copy_(s)
            done.set()

        self.copy_q.put(work)
        self.compute_q.put(done.wait)
        return done

    def consumed(self):
        ev = threading.Event()
        self.compute_q.put(ev.set)
        return ev

    def compute(self, fn):
        self.compute_q.put(fn)

    @staticmethod
    def wait(ev):
        if ev is not None:
            ev.wait()

    def close(self):
        done = threading.Event()
        self.compute_q.put(done.set)
        assert done.wait(60)
        for qq in (self.copy_q, self.compute_q):
            qq.put(None)
        for t in self._threads:
            t.join(60)
            assert not t.is_alive()


@pytest.mark.parametrize("consumer_delay,copy_delay",
                         [(0.0, 0.0), (0.004, 0.0), (0.0, 0.004),
                          (0.002, 0.002)])
def test_staging_puts_every_tile_in_place(consumer_delay, copy_delay):
    # 2 buffers, tiles of 64 rows (the last ragged); the compute stream
    # reads each tile late (a slow consumer) or the copies lag: a buffer
    # reused before its copy finished, or a device buffer overwritten
    # before the compute stream read it, shows as a wrong tile
    rng = np.random.default_rng(1)
    corpus = rng.standard_normal((64 * 23 + 9, 5)).astype(np.float32)
    streams = ThreadStreams(copy_delay)
    stager = tooc.TileStager(streams, [((64, 5), torch.float32),
                                       ((64,), torch.int64)], nbuf=2)
    seen = {}
    for start in range(0, len(corpus), 64):
        stop = min(start + 64, len(corpus))

        def fill(tile, rows, s=start, e=stop):
            tile.copy_(torch.from_numpy(corpus[s:e]))
            rows.copy_(torch.arange(s, e))

        tile, rows = stager.stage(stop - start, fill)

        def read(tile=tile, rows=rows, s=start):
            time.sleep(consumer_delay)
            seen[s] = (tile.clone(), rows.clone())

        streams.compute(read)
    streams.close()
    assert not streams.errors
    assert sorted(seen) == list(range(0, len(corpus), 64))
    for s, (tile, rows) in seen.items():
        e = min(s + 64, len(corpus))
        np.testing.assert_array_equal(tile.numpy(), corpus[s:e])
        np.testing.assert_array_equal(rows.numpy(), np.arange(s, e))
    assert stager.bytes == corpus.nbytes + 8 * len(corpus)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["int8", "int4", "binary"])
def test_cuda_host_encoders_equal_the_card_encoders(qcorpus, codec):
    # encode_on="auto" encodes the scalar codecs on the host: its codes must
    # be the card's encoders' bit for bit, and the row stats agree
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    v, q, plant = qcorpus
    kw = dict(metric="cosine", codec=codec, tile_rows=700, rerank=16,
              device="cuda")
    sh = tooc.QuantizedOutOfCoreSearcher(v, encode_on="host", **kw)
    sd = tooc.QuantizedOutOfCoreSearcher(v, encode_on="device", **kw)
    np.testing.assert_array_equal(sh._codes, sd._codes)
    if codec != "binary":
        np.testing.assert_allclose(sh._vsq, sd._vsq, rtol=1e-5)
        np.testing.assert_allclose(sh._rinv, sd._rinv, rtol=1e-5)
    np.testing.assert_array_equal(sh.search(q, k=5)[1][:, 0], plant)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", [None] + CODECS)
def test_cuda_many_small_tiles_equal_the_in_memory_search(codec):
    # 64 tiles of 128 rows through the real copy stream and events: a
    # buffer reused too early would change the hits
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    v, q = _clustered(12, 128 * 64 - 5, d=64, spread=0.5, nq=33)
    mask = np.arange(len(v)) % 9 != 0
    if codec is None:
        for metric in ("cosine", "l2", "ip"):
            got = tooc.OutOfCoreSearcher(v, metric=metric, tile_rows=128,
                                         device="cuda").search(q, 10, mask)
            want = tooc.OutOfCoreSearcher(v, metric=metric,
                                          tile_rows=len(v),
                                          device="cpu").search(q, 10, mask)
            assert_same_topk(*want, *got, rtol=1e-4, atol=1e-4)
        return
    kw = dict(metric="cosine", codec=codec, rerank=CUT_RERANK[codec])
    host = tooc.QuantizedOutOfCoreSearcher(v, tile_rows=128, device="cpu",
                                           **kw)
    card = tooc.QuantizedOutOfCoreSearcher(v, tile_rows=128, device="cuda",
                                           **kw)
    if codec == "pq":   # the same codebooks and codes on both sides
        card._qz.codebooks = host._qz.codebooks.cuda()
        card._codes = host._codes
    np.testing.assert_array_equal(card._codes, host._codes)
    whole = tooc.QuantizedOutOfCoreSearcher(v, tile_rows=len(v),
                                            device="cuda", **kw)
    for key in ("_qz", "_codes", "_vsq", "_rinv"):
        setattr(whole, key, getattr(card, key))
    for m in (None, mask):
        gd, gr = card.search(q, 10, mask=m)
        wd, wr = whole.search(q, 10, mask=m)
        hd, _ = host.search(q, 10, mask=m)
        # against the one-tile search on the card; the CPU's coarse top-c
        # breaks the codes' ties otherwise, so only its best hit is held,
        # and not for binary: 64-bit Hamming counts tie at the cut, and a
        # true nearest row can fall on either side of it
        assert mean_overlap(gr, wr) >= 0.98
        np.testing.assert_allclose(gd[:, 0], wd[:, 0], rtol=1e-5, atol=1e-6)
        if codec != "binary":
            np.testing.assert_allclose(gd[:, 0], hd[:, 0], rtol=1e-5,
                                       atol=1e-6)
