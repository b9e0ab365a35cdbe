"""The port's cold-start primer (fastpyvectordb_tpu_torch/prime.py): the
JAX primer's test on the port, the same JSON lines as the JAX primer on
the same arguments, ``--cache`` moving the build root (where a serving
process finds the same libraries) and ``--device cpu`` never calling
``nvcc``; ``--device cuda`` without a card or without ``nvcc`` raises."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fastpyvectordb_tpu_torch import buildroot, native
from fastpyvectordb_tpu_torch.prime import _bucket_batches, build
from fastpyvectordb_tpu_torch.prime import main as prime_main

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--dims", "16", "--rows", "512", "--max-batch", "16",
         "--modes", "exact,int8,binary", "--k", "5", "--k", "10"]


@pytest.fixture()
def fresh_root(monkeypatch):
    """Restores the build root and the port's loaded native libraries
    after a test that moves them."""
    monkeypatch.setattr(buildroot, "_root", None)
    for name, value in (("_lib", None), ("_build_failed", False),
                        ("_graph_lib", None), ("_graph_build_failed", False)):
        monkeypatch.setattr(native, name, value)


def _lines(out: str):
    return [json.loads(line) for line in out.splitlines() if line.strip()]


def test_prime_tool_small(tmp_path, capsys, fresh_root):
    prime_main(["--dims", "16", "--rows", "512", "--max-batch", "16",
                "--modes", "exact", "--k", "5",
                "--cache", str(tmp_path / "cache"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert '"done": true' in out and '"batch_bucket": 16' in out


def test_same_lines_as_the_jax_primer(tmp_path, capsys, fresh_root):
    import jax
    from fastpyvectordb_tpu.prime import main as jax_prime
    old = jax.config.jax_compilation_cache_dir
    try:
        jax_prime(SMALL + ["--cache", str(tmp_path / "jax")])
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    theirs = _lines(capsys.readouterr().out)
    prime_main(SMALL + ["--cache", str(tmp_path / "port"),
                        "--device", "cpu"])
    ours = _lines(capsys.readouterr().out)
    assert set(ours[0]) == {"built", "loaded", "s"}
    ours = ours[1:]

    def strip(lines):
        return [{k: v for k, v in ln.items() if k not in ("s", "cache")}
                for ln in lines]

    assert strip(ours) == strip(theirs)
    assert [list(ln) for ln in ours] == [list(ln) for ln in theirs]
    assert [ln["primed"]["batch_bucket"] for ln in ours if "primed" in ln] \
        == [8, 16]
    assert ours[-1] == {"cache": str((tmp_path / "port").resolve()),
                        "done": True}


@pytest.mark.parametrize("max_batch,want", [(8, [8]), (1000, [8, 16, 32, 64,
                                                               128, 256,
                                                               512]),
                                            (1024, [8, 16, 32, 64, 128, 256,
                                                    512, 1024])])
def test_batch_buckets_as_the_jax_primer(max_batch, want):
    from fastpyvectordb_tpu.prime import _bucket_batches as jax_buckets
    assert _bucket_batches(max_batch) == jax_buckets(max_batch) == want


def test_cache_moves_the_native_libraries_and_cpu_never_calls_nvcc(
        tmp_path, capsys, monkeypatch, fresh_root):
    from fastpyvectordb_tpu_torch.kernels import cuda_build
    calls = []

    def no_nvcc():
        calls.append("nvcc")
        raise AssertionError("nvcc called on --device cpu")

    monkeypatch.setattr(cuda_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(cuda_build, "build_all",
                        lambda *a: calls.append("build_all"))
    cache = tmp_path / "cache"
    prime_main(["--dims", "8", "--rows", "64", "--max-batch", "8",
                "--modes", "exact", "--cache", str(cache),
                "--device", "cpu"])
    first = _lines(capsys.readouterr().out)[0]
    assert calls == []
    assert not (cache / "kernels").exists()
    if not native.available():     # no C++ toolchain: nothing to build
        assert first["built"] == first["loaded"] == []
        return
    assert first["built"] == first["loaded"] == ["bm25.cpp", "graph.cpp"]
    for src in (native._SRC, native._GRAPH_SRC):
        so = native._so_path(src)
        assert so.parent == cache.resolve() / "native" and so.exists()
    # a second process on the same root (a server given it through the
    # environment) finds them and builds nothing
    env = dict(os.environ, **{buildroot.ENV: str(cache)})
    out = subprocess.run(
        [sys.executable, "-m", "fastpyvectordb_tpu_torch.prime", "--dims",
         "8", "--rows", "64", "--max-batch", "8", "--modes", "exact",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    again = _lines(out.stdout)
    assert again[0]["built"] == [] and again[0]["loaded"] == [
        "bm25.cpp", "graph.cpp"]
    assert again[-1] == {"cache": str(cache), "done": True}


def test_build_root_defaults_to_the_repo_and_follows_the_environment(
        monkeypatch, tmp_path, fresh_root):
    monkeypatch.delenv(buildroot.ENV, raising=False)
    assert buildroot.root() == REPO / "build"
    monkeypatch.setenv(buildroot.ENV, str(tmp_path / "env"))
    assert buildroot.path("native") == tmp_path / "env" / "native"
    buildroot.set_root(tmp_path / "set")
    assert buildroot.path("kernels") == (tmp_path / "set" / "kernels"
                                         ).resolve()
    from fastpyvectordb_tpu_torch.kernels import quant_kernels
    assert quant_kernels.SOURCE._so().parent == buildroot.path("kernels")


def test_cuda_without_nvcc_raises(monkeypatch, tmp_path, fresh_root):
    # the build step of --device cuda: no fall back to the CPU when the
    # kernels cannot be built
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has nvcc")
    monkeypatch.setenv("PATH", str(tmp_path))
    buildroot.set_root(tmp_path / "root")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build(torch.device("cuda"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="this host has a card")
def test_cuda_without_a_card_exits_non_zero():
    out = subprocess.run(
        [sys.executable, "-m", "fastpyvectordb_tpu_torch.prime", "--dims",
         "16", "--rows", "512", "--max-batch", "8"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert '"done"' not in out.stdout
