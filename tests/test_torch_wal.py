"""Write-ahead-log durability of the port (fastpyvectordb_tpu_torch/
persist/wal.py and the WAL wiring of core/collection.py) on the CPU.

The JAX package's own WAL tests (tests/test_wal.py) run on both packages;
then parity: the same operations give byte-identical ``wal.log`` files in
both packages, a log written by either replays in the other to the same
ids, metadata, vectors and search results, a bf16-storage collection logs
the caller's f32 rows, a snapshot-durability open leaves a log unread in
both, and a writer SIGKILLed after acknowledged writes (no ``save()``)
loses none of them."""

import os
import signal
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

import fastpyvectordb_tpu as J
import fastpyvectordb_tpu_torch as T
from fastpyvectordb_tpu.persist import format as jformat
from fastpyvectordb_tpu.persist import wal as jwal
from fastpyvectordb_tpu_torch.persist import format as tformat
from fastpyvectordb_tpu_torch.persist import wal as twal
from torch_parity import assert_same_topk


def _package(name):
    if name == "jax":
        return types.SimpleNamespace(
            name=name, Filter=J.Filter, CollectionConfig=J.CollectionConfig,
            Collection=J.Collection, VectorDB=J.VectorDB, wal=jwal,
            fmt=jformat)
    return types.SimpleNamespace(
        name=name, Filter=T.Filter, CollectionConfig=T.CollectionConfig,
        Collection=lambda cfg, base_path=None: T.Collection(
            cfg, base_path=base_path, device="cpu"),
        VectorDB=lambda path: T.VectorDB(path, device="cpu"), wal=twal,
        fmt=tformat)


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _package(request.param)


def wal_col(pkg, path, **kw):
    return pkg.Collection(pkg.CollectionConfig(name="w", dimensions=8,
                                               durability="wal", **kw),
                          base_path=path)


# ---- the JAX package's tests (tests/test_wal.py) on both packages --------

def test_mutations_survive_without_save(pkg, tmp_path):
    p = tmp_path / "c1"
    col = wal_col(pkg, p)
    v = np.eye(8, dtype=np.float32)
    col.insert_batch(v[:4], ["a", "b", "c", "d"],
                     [{"i": i} for i in range(4)])
    col.delete("b")
    col.update_metadata("c", {"j": 9})
    col._wal.close()  # simulate crash: NO save()

    col2 = wal_col(pkg, p)
    assert col2.count() == 3
    assert col2.get("b") is None
    assert col2.get("c")["metadata"] == {"i": 2, "j": 9}
    hits = col2.search(v[0], k=1)
    assert hits[0].id == "a"


def test_save_truncates_log(pkg, tmp_path):
    p = tmp_path / "c2"
    col = wal_col(pkg, p)
    col.insert_batch(np.random.rand(16, 8).astype(np.float32),
                     [f"v{i}" for i in range(16)])
    assert col._wal.size_bytes() > 0
    col.save()
    assert col._wal.size_bytes() == 0
    col2 = wal_col(pkg, p)
    assert col2.count() == 16


def test_replay_is_idempotent_after_partial_save(pkg, tmp_path):
    p = tmp_path / "c3"
    col = wal_col(pkg, p)
    v = np.random.rand(6, 8).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(6)])
    wal = col._wal
    col._wal = None
    col.save()  # snapshot WITHOUT truncating the log (a torn save)
    col._wal = wal
    col._wal.close()

    col2 = wal_col(pkg, p)
    assert col2.count() == 6
    assert sorted(col2.all_ids()) == sorted(f"v{i}" for i in range(6))


def test_torn_tail_record_is_discarded(pkg, tmp_path):
    p = tmp_path / "c4"
    col = wal_col(pkg, p)
    v = np.random.rand(4, 8).astype(np.float32)
    col.insert_batch(v[:2], ["a", "b"])
    col.insert_batch(v[2:], ["c", "d"])
    col._wal.close()
    log = p / "wal.log"
    raw = log.read_bytes()
    log.write_bytes(raw[:-7])  # tear the last record mid-payload

    col2 = wal_col(pkg, p)
    assert sorted(col2.all_ids()) == ["a", "b"]  # prefix-consistent
    col2.insert(v[2], id="c2")
    col2._wal.close()
    col3 = wal_col(pkg, p)
    assert sorted(col3.all_ids()) == ["a", "b", "c2"]


def test_wal_raw_framing_roundtrip(pkg, tmp_path):
    w = pkg.wal.WriteAheadLog(tmp_path / "x.log")
    vecs = np.arange(12, dtype=np.float32).reshape(2, 6)
    w.log_insert(["p", "q"], [None, {"z": 1}], vecs)
    w.log_delete(["p"])
    recs = list(w.replay())
    assert [r[0] for r in recs] == [pkg.wal.OP_INSERT, pkg.wal.OP_DELETE]
    np.testing.assert_array_equal(recs[0][2], vecs)
    assert recs[0][1]["metadatas"] == [None, {"z": 1}]
    assert recs[1][1]["ids"] == ["p"]
    w.close()


def test_container_crc_verify(pkg, tmp_path):
    p = tmp_path / "c.fpvt"
    pkg.fmt.save_container(p, {"arr": np.arange(64, dtype=np.float32),
                               "doc": {"a": 1}})
    c = pkg.fmt.load_container(p)
    assert c.verify()
    raw = bytearray(p.read_bytes())
    off = c._data_start + c.sections["arr"]["offset"] + 5
    raw[off] ^= 0xFF
    p.write_bytes(bytes(raw))
    c2 = pkg.fmt.load_container(p)
    with pytest.raises(ValueError, match="CRC32"):
        c2.verify()


def test_snapshot_mode_unaffected(pkg, tmp_path):
    col = pkg.Collection(pkg.CollectionConfig(name="s", dimensions=8),
                         base_path=tmp_path / "s")
    col.insert(np.ones(8, np.float32), id="x")
    assert col._wal is None
    assert not (tmp_path / "s" / "wal.log").exists()


def test_enable_wal_on_existing_snapshot_collection(pkg, tmp_path):
    p = tmp_path / "c5"
    col = pkg.Collection(pkg.CollectionConfig(name="w", dimensions=8),
                         base_path=p)
    col.insert(np.ones(8, np.float32), id="a")
    col.save()
    col2 = wal_col(pkg, p)
    assert col2._wal is not None
    col2.insert(np.zeros(8, np.float32), id="b")
    col2._wal.close()  # crash without save
    col3 = wal_col(pkg, p)
    assert sorted(col3.all_ids()) == ["a", "b"]


def test_zero_row_insert_does_not_poison_log(pkg, tmp_path):
    p = tmp_path / "c6"
    col = wal_col(pkg, p)
    col.insert_batch(np.zeros((0, 8), np.float32))  # accepted, no-op
    col.insert(np.ones(8, np.float32), id="x")
    col._wal.close()
    col2 = wal_col(pkg, p)
    assert col2.all_ids() == ["x"]


def test_numpy_metadata_survives_replay_numerically(pkg, tmp_path):
    p = tmp_path / "c7"
    col = wal_col(pkg, p)
    col.insert(np.ones(8, np.float32), id="n",
               metadata={"score": np.float64(2.5), "count": np.int64(7)})
    col._wal.close()
    col2 = wal_col(pkg, p)
    hits = col2.search(np.ones(8, np.float32), k=1,
                       filter=pkg.Filter.gt("score", 2.0))
    assert hits and hits[0].id == "n"


def test_wal_zero_filled_torn_tail(pkg, tmp_path):
    p = tmp_path / "t.wal"
    wal = pkg.wal.WriteAheadLog(p)
    wal.log_insert(["a"], [{}], np.ones((1, 4), np.float32))
    wal.close()
    size = p.stat().st_size
    with open(p, "ab") as f:
        f.write(b"\x00" * 64)  # zero-filled torn tail
    wal2 = pkg.wal.WriteAheadLog(p)
    recs = list(wal2.replay())
    assert len(recs) == 1 and recs[0][0] == pkg.wal.OP_INSERT
    assert p.stat().st_size == size
    wal2.close()


def test_vectordb_restart_replays_wal_and_keeps_durability(pkg, tmp_path):
    db = pkg.VectorDB(str(tmp_path))
    col = db.create_collection("w", 8, durability="wal")
    col.insert(np.ones(8, np.float32), "a")
    db2 = pkg.VectorDB(str(tmp_path))   # no save(): the row is in the log
    assert "w" in db2.list_collections()
    col2 = db2.get_collection("w")
    assert col2.count() == 1 and col2.get("a") is not None
    assert col2.config.durability == "wal" and col2._wal is not None
    col2.insert(np.zeros(8, np.float32), "b")  # must be logged too
    db3 = pkg.VectorDB(str(tmp_path))
    assert db3.get_collection("w").count() == 2


# ---- parity between the packages ------------------------------------------

D = 24


def _ops(col, rng, storage_bf16=False):
    """A fixed sequence of logged operations: inserts with numpy and
    nested metadata (and None), deletes of live and missing ids, merged and
    replaced metadata updates, an upsert and a zero-row insert."""
    v = rng.standard_normal((40, D)).astype(np.float32)
    col.insert_batch(v[:16], [f"a{i}" for i in range(16)],
                     [{"i": i, "f": np.float32(i / 3), "tags": ["x", i],
                       "nested": {"k": np.int64(i)}} if i % 3 else None
                      for i in range(16)])
    col.insert_batch(v[16:30], [f"b{i}" for i in range(14)])
    col.delete_batch(["a3", "nope", "b5", "a3"])
    col.update_metadata("a4", {"j": 9.5})
    col.update_metadata("b1", {"only": True}, merge=False)
    col.update_metadata("missing", {"j": 1})
    col.upsert(v[30], "a7", {"up": 1})
    col.insert_batch(np.zeros((0, D), np.float32))
    col.insert(v[31], "c0", {"s": "text"})
    return v


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_the_same_operations_write_byte_identical_logs(tmp_path, storage):
    logs = []
    for name in ("jax", "torch"):
        pkg = _package(name)
        col = pkg.Collection(pkg.CollectionConfig(
            name="w", dimensions=D, durability="wal", storage_dtype=storage),
            base_path=tmp_path / name)
        _ops(col, np.random.default_rng(5))
        col._wal.close()
        logs.append((tmp_path / name / "wal.log").read_bytes())
    assert len(logs[0]) > 0 and logs[0] == logs[1]


def _state(col):
    ids = col.all_ids()
    got = col.get_batch(ids, include_vectors=True)
    return ids, [g["metadata"] for g in got], np.stack([g["vector"]
                                                        for g in got])


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_a_log_written_by_one_package_replays_in_the_other(
        tmp_path, writer, reader, storage):
    w, r = _package(writer), _package(reader)
    cfg = dict(name="w", dimensions=D, durability="wal",
               storage_dtype=storage, metric="cosine")
    src = w.Collection(w.CollectionConfig(**cfg), base_path=tmp_path / "c")
    v = _ops(src, np.random.default_rng(11))
    src._wal.close()   # a crash: no save()
    dst = r.Collection(r.CollectionConfig(**cfg), base_path=tmp_path / "c")
    ids, metas, vecs = _state(src)
    ids2, metas2, vecs2 = _state(dst)
    assert ids2 == ids and metas2 == metas
    np.testing.assert_array_equal(vecs2, vecs)   # bf16 rows round alike
    q = v[32:]
    (sid, sd, sr), (did, dd, dr) = src.search_arrays(q, k=5), \
        dst.search_arrays(q, k=5)
    assert_same_topk(sd, sr, dd, dr, rtol=1e-5)
    np.testing.assert_array_equal(sid, did)


def test_snapshot_durability_leaves_a_log_unread_in_both(tmp_path):
    jc = wal_col(_package("jax"), tmp_path / "c")
    jc.insert(np.ones(8, np.float32), "a")
    jc.save()
    jc.insert(np.zeros(8, np.float32), "b")   # logged only
    jc._wal.close()
    for name in ("jax", "torch"):
        pkg = _package(name)
        col = pkg.Collection(pkg.CollectionConfig(name="w", dimensions=8),
                             base_path=tmp_path / "c")
        assert col._wal is None and col.all_ids() == ["a"], name
    assert (tmp_path / "c" / "wal.log").stat().st_size > 0


_WRITER = textwrap.dedent("""
    import sys
    import numpy as np
    import fastpyvectordb_tpu_torch as T
    path, batches = sys.argv[1], int(sys.argv[2])
    col = T.VectorDB(path, device="cpu").create_collection(
        "w", dimensions=16, durability="wal", wal_fsync=True)
    rng = np.random.default_rng(3)
    for b in range(batches):
        v = rng.standard_normal((50, 16)).astype(np.float32)
        ids = [f"r{b}_{i}" for i in range(50)]
        col.insert_batch(v, ids, [{"b": b, "i": i} for i in range(50)])
        col.delete_batch(ids[:2])
        col.update_metadata(ids[2], {"touched": b})
        print(f"ack {b}", flush=True)
    print("done", flush=True)
    import time
    time.sleep(600)   # killed here, with no save()
""")


def test_a_killed_writer_loses_no_acknowledged_write(tmp_path):
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root)}
    proc = subprocess.Popen([sys.executable, "-c", _WRITER,
                             str(tmp_path / "db"), "6"],
                            stdout=subprocess.PIPE, text=True, cwd=root,
                            env=env)
    acked = []
    try:
        for line in proc.stdout:
            if line.startswith("ack"):
                acked.append(int(line.split()[1]))
            if line.startswith("done"):
                break
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    assert acked == list(range(6))
    col = T.VectorDB(tmp_path / "db", device="cpu")["w"]
    rng = np.random.default_rng(3)
    assert col.count() == 6 * 48 and col.config.durability == "wal"
    for b in acked:
        v = rng.standard_normal((50, 16)).astype(np.float32)
        got = col.get_batch([f"r{b}_{i}" for i in range(50)], True)
        assert got[0] is None and got[1] is None
        np.testing.assert_array_equal(np.stack([g["vector"]
                                                for g in got[2:]]), v[2:])
        assert got[2]["metadata"] == {"b": b, "i": 2, "touched": b}
        assert [g["metadata"] for g in got[3:]] == [
            {"b": b, "i": i} for i in range(3, 50)]
