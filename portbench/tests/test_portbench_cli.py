"""The command prints no result where it cannot run: without a card, and
in a directory that holds only the benchmark's own files."""

import shutil
import subprocess
import sys

import pytest
import torch

from portbench import spec

ARGS = ["-m", "portbench.run", "--workload", "int8-b1", "--seed",
        str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"]


def command(cwd):
    return subprocess.run([sys.executable] + ARGS, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = command(spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_only_the_benchmarks_files_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
