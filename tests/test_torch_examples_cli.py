"""The examples on the port (examples_torch/): every case of
tests/test_examples_cli.py against the port's copies, on the CPU, and a
RAG database directory written by the JAX package's example opening in
the port's example (and the other way round) with the same hits."""

import importlib.util
import re
import runpy
import sys
from pathlib import Path

import pytest

from torch_parity import jax_native

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples_torch"
sys.path.insert(0, str(REPO))


def _run(script: str, monkeypatch, *args):
    monkeypatch.setattr(sys, "argv", [script, *args, "--device", "cpu"])
    runpy.run_path(str(EXAMPLES / script), run_name="__main__")


def _jax_rag_cli():
    """The JAX package's examples/rag_cli.py, under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "jax_examples_rag_cli", REPO / "examples" / "rag_cli.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_retrieval_quality_noninteractive(capsys, monkeypatch):
    _run("retrieval_quality.py", monkeypatch)
    out = capsys.readouterr().out
    assert "RETRIEVAL TESTS" in out
    assert "retrieval accuracy:" in out
    # the hashing embedder clears at least 4/6 on this corpus
    m = re.search(r"retrieval accuracy: (\d+)/(\d+)", out)
    assert m and int(m.group(1)) >= 4
    assert "FILTERED RETRIEVAL" in out
    assert "category=Cooking" in out


def test_rag_cli_sample_ask_persist(tmp_path, capsys, monkeypatch):
    # the LLM path must not fire in tests even if a key is in the env
    monkeypatch.delenv("ANTHROPIC_API_KEY", raising=False)
    from examples_torch import rag_cli
    db = str(tmp_path / "ragdb")
    rag_cli.main(["sample", "--db", db, "--device", "cpu"])
    out1 = capsys.readouterr().out
    assert "ingested" in out1
    # fresh invocation reloads the persisted index from disk
    rag_cli.main(["ask", "what is the MXU made of?", "--db", db,
                  "--device", "cpu"])
    out2 = capsys.readouterr().out
    assert "retrieved:" in out2
    assert "tpu.md#0" in out2
    assert "extractive answer" in out2


def test_rag_cli_reingest_replaces(tmp_path, capsys):
    from examples_torch import rag_cli
    db = str(tmp_path / "ragdb2")
    rag_cli.main(["sample", "--db", db, "--device", "cpu"])
    before = capsys.readouterr().out
    rag_cli.main(["sample", "--db", db], device="cpu")  # no duplicates
    capsys.readouterr()
    store = rag_cli.RagStore(db, device="cpu")
    n = store.col.count()
    m = re.search(r"ingested (\d+) chunks", before)
    assert n == int(m.group(1))


def test_rag_chunker_overlap():
    from examples_torch.rag_cli import chunk_text
    text = " ".join(f"word{i}" for i in range(200))
    chunks = chunk_text(text, size=120, overlap=30)
    assert len(chunks) > 2
    # consecutive chunks share their boundary words (the overlap tail)
    for a, b in zip(chunks, chunks[1:]):
        assert a.split()[-1] in b.split()[:8]
    # nothing lost: every word appears somewhere
    joined = set(" ".join(chunks).split())
    assert all(f"word{i}" in joined for i in range(200))


def test_production_ops_example(capsys, monkeypatch):
    """The ops walkthrough (WAL / CRC / IVF-PQ / tune_rerank / router)
    must run end-to-end offline."""
    _run("production_ops.py", monkeypatch)
    out = capsys.readouterr().out
    assert "recovered 99 rows" in out
    assert "corrupted file detected" in out
    assert "python -m fastpyvectordb_tpu_torch.prime" in out
    assert "All production-ops demos passed." in out


def test_prime_tool_small(tmp_path, capsys, monkeypatch):
    from fastpyvectordb_tpu_torch import buildroot
    from fastpyvectordb_tpu_torch.prime import main as prime_main
    monkeypatch.setattr(buildroot, "_root", None)   # put back afterwards
    prime_main(["--dims", "16", "--rows", "512", "--max-batch", "16",
                "--modes", "exact", "--k", "5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert '"done": true' in out and '"batch_bucket": 16' in out


def test_demo_tour_selected(capsys, monkeypatch):
    """The guided tour's fast sections (catalog filters, graph traversal,
    hybrid fusion, persistence) run end-to-end offline with their inline
    sanity assertions."""
    _run("demo.py", monkeypatch, "1", "2", "3", "6")
    out = capsys.readouterr().out
    assert "Filtered search: footwear under $100" in out
    assert "shortest path alice -> diana" in out
    assert "ALL 4 DEMOS COMPLETE" in out


def test_hybrid_demo_comparison(capsys, monkeypatch):
    """The hybrid comparison demo proves each retrieval mode wins its
    predicted query class (its sanity() asserts that mechanically)."""
    _run("hybrid_demo.py", monkeypatch)
    out = capsys.readouterr().out
    assert "sanity checks passed" in out
    assert "KEY INSIGHTS" in out


def test_rag_app_demo(capsys, monkeypatch):
    """The full RAG application (synthetic corpus, multi-method search,
    graph expansion, in-app benchmark) runs end-to-end offline."""
    _run("rag_app.py", monkeypatch, "--docs", "200")
    out = capsys.readouterr().out
    assert "Graph-expanded retrieval" in out
    assert "expanded" in out
    assert "mean_ms" in out
    assert "DEMO COMPLETE" in out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rag_cli_database_opens_in_the_other_package(tmp_path, capsys,
                                                      monkeypatch, writer):
    """``rag_cli sample --db DIR`` in one package, ``ask`` in the other:
    the same chunks, and the same fused hits for each question."""
    monkeypatch.delenv("ANTHROPIC_API_KEY", raising=False)
    jax_native()   # both packages on their native BM25 engines
    from examples_torch import rag_cli as port_cli
    jax_cli = _jax_rag_cli()
    db = str(tmp_path / "ragdb")
    if writer == "jax":
        jax_cli.main(["sample", "--db", db])
    else:
        port_cli.main(["sample", "--db", db, "--device", "cpu"])
    capsys.readouterr()
    theirs = jax_cli.RagStore(db)
    ours = port_cli.RagStore(db, device="cpu")
    assert ours.col.count() == theirs.col.count() > 0
    for q in ("what is the MXU made of?", "how do I cook pasta?",
              "what does jit do?", "index funds"):
        th, oh = theirs.retrieve(q, k=4), ours.retrieve(q, k=4)
        assert [h.id for h in oh] == [h.id for h in th], q
        for a, b in zip(th, oh):
            assert b.score == pytest.approx(a.score, abs=1e-5)
    port_cli.main(["ask", "what is the MXU made of?", "--db", db,
                   "--device", "cpu"])
    assert "tpu.md#0" in capsys.readouterr().out
