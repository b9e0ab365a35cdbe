"""The news-intelligence example on the port
(examples_torch/news_intelligence/): the cases of
tests/test_news_example.py on the CPU, and a database that the JAX
package's example built opening in the port's query CLI with the same
hits."""

import argparse
import sys
from pathlib import Path

import pytest

from torch_parity import jax_native

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


@pytest.fixture(scope="module")
def db_path(tmp_path_factory):
    return str(tmp_path_factory.mktemp("news") / "db")


def test_demo_all_phases(db_path, capsys):
    from examples_torch.news_intelligence.demo import main
    main(["--articles", "400", "--db-path", db_path, "--fresh",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "DEMO COMPLETE" in out
    assert "SEARCH DEMONSTRATIONS" in out
    assert "KNOWLEDGE GRAPH DEMONSTRATIONS" in out
    assert "TRENDING" in out.upper()
    assert "PERSISTENCE ROUNDTRIP" in out
    assert "search works: True" in out


def test_query_cli_scripted(db_path, capsys):
    from examples_torch.news_intelligence.query_cli import main
    main(["--db-path", db_path, "--device", "cpu", "--commands",
          "search chip supply;read 1;entity Northwind Compute;"
          "trending;stats;keyword fusion;hybrid storage;quit"])
    out = capsys.readouterr().out
    assert "search: 'chip supply'" in out
    assert "ENTITY: Northwind Compute" in out
    assert "TRENDING ENTITIES" in out
    assert "CATEGORY STATISTICS" in out
    assert "bye" in out


def test_cli_read_by_number_and_id(db_path, capsys):
    from examples_torch.news_intelligence.query_cli import (
        NewsQueryInterface, ensure_platform)
    ns = argparse.Namespace(db_path=db_path, articles=400, device="cpu")
    qi = NewsQueryInterface(ensure_platform(ns))
    hits = qi.search("earnings guidance", k=5)
    assert hits
    rid = qi.resolve("1")
    assert rid == hits[0].id
    art = qi.read_article(rid)
    assert art and art["metadata"]["headline"]
    assert qi.resolve("99") is None
    assert qi.resolve(rid) == rid


def test_jax_built_database_opens_in_the_port(tmp_path, capsys):
    """The JAX example builds and saves its database; the port's query CLI
    loads it (no rebuild) and answers with the same hits."""
    jax_native()   # both packages on their native BM25 engines
    from examples.news_intelligence.query_cli import (
        NewsQueryInterface as JQuery, ensure_platform as jax_ensure)
    from examples_torch.news_intelligence.query_cli import (
        NewsQueryInterface, ensure_platform)
    db = str(tmp_path / "db")
    theirs = JQuery(jax_ensure(argparse.Namespace(db_path=db, articles=400)))
    capsys.readouterr()
    ours = NewsQueryInterface(ensure_platform(argparse.Namespace(
        db_path=db, articles=400, device="cpu")))
    assert "loaded 400 articles" in capsys.readouterr().out
    for q in ("earnings guidance", "chip supply", "storage"):
        for method in ("search", "keyword", "hybrid"):
            th = getattr(theirs, method)(q, k=5)
            oh = getattr(ours, method)(q, k=5)
            assert [h.id for h in oh] == [h.id for h in th], (method, q)
            for a, b in zip(th, oh):
                assert b.score == pytest.approx(a.score, abs=1e-5)
    assert ours.p.graph.stats() == theirs.p.graph.stats()
