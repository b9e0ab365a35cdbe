"""The port's copy of the streaming vector file and the lossy vector
compression (fastpyvectordb_tpu_torch/persist/format.py): the JAX package's
own streaming and compression tests run against the port, and files written
by one package are read by the other and compared byte for byte."""

import numpy as np
import pytest

from fastpyvectordb_tpu.persist import format as jfmt
from fastpyvectordb_tpu_torch.persist import format as tfmt
from fastpyvectordb_tpu_torch.persist.format import (
    StreamingVectorReader,
    StreamingVectorWriter,
    compress_vectors,
    decompress_vectors,
)


def test_streaming_roundtrip(tmp_path, rng):
    path = tmp_path / "stream.fpvs"
    vecs = rng.standard_normal((12, 6)).astype(np.float32)
    with StreamingVectorWriter(path, dims=6) as w:
        for i in range(4):
            w.append(vecs[i], id=f"v{i}", metadata={"i": i})
        w.append_batch(vecs[4:], ids=[f"v{i}" for i in range(4, 12)])
    with StreamingVectorReader(path) as r:
        assert len(r) == 12 and r.dims == 6
        np.testing.assert_allclose(r.load_batch(3, 5), vecs[3:8], rtol=1e-6)
        assert r.ids[:4] == ["v0", "v1", "v2", "v3"]
        rows = list(r)
        np.testing.assert_allclose(np.stack(rows), vecs, rtol=1e-6)


def test_streaming_header_consistent_prefix(tmp_path, rng):
    # header count must always describe fully-written data
    path = tmp_path / "s.fpvs"
    w = StreamingVectorWriter(path, dims=4)
    w.append_batch(rng.standard_normal((3, 4)).astype(np.float32))
    # simulate crash: no close()
    r = StreamingVectorReader(path)
    assert len(r) == 3


def test_streaming_crash_preserves_ids_and_metadata(tmp_path, rng):
    """Sidecars flush per-append: a crash (no close) must not lose them."""
    path = tmp_path / "c.fpvs"
    vecs = rng.standard_normal((5, 4)).astype(np.float32)
    w = StreamingVectorWriter(path, dims=4)
    w.append_batch(vecs, ids=[f"v{i}" for i in range(5)],
                   metadatas=[{"i": i} for i in range(5)])
    # simulate crash: no close()
    r = StreamingVectorReader(path)
    assert r.ids == [f"v{i}" for i in range(5)]
    assert r.metadata == [{"i": i} for i in range(5)]


def test_streaming_resume_appends_to_existing(tmp_path, rng):
    path = tmp_path / "r.fpvs"
    vecs = rng.standard_normal((8, 4)).astype(np.float32)
    with StreamingVectorWriter(path, dims=4) as w:
        w.append_batch(vecs[:5], ids=[f"a{i}" for i in range(5)])
    # reopen and continue where we left off
    with StreamingVectorWriter(path, dims=4) as w:
        assert w.n_rows == 5 and w.ids[:5] == [f"a{i}" for i in range(5)]
        w.append_batch(vecs[5:], ids=[f"b{i}" for i in range(3)])
    with StreamingVectorReader(path) as r:
        assert len(r) == 8
        np.testing.assert_allclose(np.stack(list(r)), vecs, rtol=1e-6)
        assert r.ids == [f"a{i}" for i in range(5)] + \
            [f"b{i}" for i in range(3)]


def test_streaming_resume_rejects_dims_mismatch(tmp_path, rng):
    path = tmp_path / "m.fpvs"
    with StreamingVectorWriter(path, dims=4) as w:
        w.append_batch(rng.standard_normal((2, 4)).astype(np.float32))
    with pytest.raises(ValueError, match="dims mismatch"):
        StreamingVectorWriter(path, dims=8)


def test_streaming_reader_rejects_garbage(tmp_path):
    p = tmp_path / "bad.fpvs"
    p.write_bytes(b"NOTAMAGICFILE" + b"\0" * 32)
    with pytest.raises(ValueError, match="FPVS"):
        StreamingVectorReader(p)


@pytest.mark.parametrize("method,ratio", [("none", 1), ("fp16", 2), ("int8", 4)])
def test_compression(rng, method, ratio):
    v = rng.standard_normal((100, 32)).astype(np.float32)
    payload, params = compress_vectors(v, method)
    assert v.nbytes / payload.nbytes == pytest.approx(ratio, rel=0.01)
    back = decompress_vectors(payload, params)
    tol = {"none": 1e-7, "fp16": 1e-2, "int8": 0.05}[method]
    np.testing.assert_allclose(back, v, atol=tol * np.abs(v).max())


@pytest.mark.parametrize("method", ["none", "fp16", "int8"])
def test_compression_equals_the_jax_package(rng, method):
    v = rng.standard_normal((64, 24)).astype(np.float32)
    want, want_params = jfmt.compress_vectors(v, method)
    got, got_params = tfmt.compress_vectors(v, method)
    assert got_params == want_params and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    # either package decompresses the other's payload
    np.testing.assert_array_equal(tfmt.decompress_vectors(want, want_params),
                                  jfmt.decompress_vectors(got, got_params))
    with pytest.raises(ValueError, match="unknown compression"):
        tfmt.compress_vectors(v, "zip")


def _write_stream(fmt, path, vecs):
    with fmt.StreamingVectorWriter(path, dims=vecs.shape[1]) as w:
        w.append(vecs[0], id="first", metadata={"n": np.int64(1)})
        w.append_batch(vecs[1:6], ids=[f"v{i}" for i in range(1, 6)],
                       metadatas=[{"i": i, "tag": {"b", "a"}}
                                  for i in range(1, 6)])
        w.append_batch(vecs[6:])                     # no ids, no metadata


def _stream_files(path):
    return [path, type(path)(str(path) + ".ids.jsonl"),
            type(path)(str(path) + ".meta.jsonl")]


def test_streaming_files_are_byte_identical_and_cross_readable(tmp_path, rng):
    vecs = rng.standard_normal((9, 5)).astype(np.float32)
    jpath, tpath = tmp_path / "j.fpvs", tmp_path / "t.fpvs"
    _write_stream(jfmt, jpath, vecs)
    _write_stream(tfmt, tpath, vecs)
    for jf, tf in zip(_stream_files(jpath), _stream_files(tpath)):
        assert jf.read_bytes() == tf.read_bytes(), jf.name
    # the port reads the JAX package's file, and the other way round
    for fmt, path in ((tfmt, jpath), (jfmt, tpath)):
        with fmt.StreamingVectorReader(path) as r:
            assert len(r) == 9 and r.dims == 5
            np.testing.assert_array_equal(r.load_batch(0, 9), vecs)
            assert r.ids == ["first"] + [f"v{i}" for i in range(1, 6)] \
                + [None] * 3
            assert r.metadata[0] == {"n": 1}
            assert r.metadata[2] == {"i": 2, "tag": ["a", "b"]}
            assert r.metadata[6:] == [None] * 3
    # each package resumes the other's file; the results stay identical
    more = rng.standard_normal((2, 5)).astype(np.float32)
    with tfmt.StreamingVectorWriter(jpath, dims=5) as w:
        assert w.n_rows == 9
        w.append_batch(more, ids=["x", "y"])
    with jfmt.StreamingVectorWriter(tpath, dims=5) as w:
        assert w.n_rows == 9
        w.append_batch(more, ids=["x", "y"])
    for jf, tf in zip(_stream_files(jpath), _stream_files(tpath)):
        assert jf.read_bytes() == tf.read_bytes(), jf.name
    with tfmt.StreamingVectorReader(tpath) as r:
        assert len(r) == 11 and r.ids[-2:] == ["x", "y"]
        np.testing.assert_array_equal(r.load_batch(9, 2), more)


def test_crash_orphaned_sidecar_lines_are_trimmed_on_resume(tmp_path, rng):
    # lines past the committed row count (a crash between the sidecar flush
    # and the header update) are ignored by the reader and cut on reopen
    path = tmp_path / "o.fpvs"
    vecs = rng.standard_normal((4, 3)).astype(np.float32)
    with StreamingVectorWriter(path, dims=3) as w:
        w.append_batch(vecs[:3], ids=["a", "b", "c"])
    ids_file = tmp_path / "o.fpvs.ids.jsonl"
    ids_file.write_text(ids_file.read_text() + '"orphan"\n')
    with StreamingVectorReader(path) as r:
        assert r.ids == ["a", "b", "c"]
    with StreamingVectorWriter(path, dims=3) as w:
        assert w.ids == ["a", "b", "c"]
        w.append(vecs[3], id="d")
    assert ids_file.read_text() == '"a"\n"b"\n"c"\n"d"\n'
