"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program."""

import ast
import subprocess
import sys
import types
from pathlib import Path

from portbench import harness, spec

HERE = spec.HERE
PROGRAM = "fastpyvectordb_tpu_torch"
# the yardstick and the reference: none of them may import the program
PLAIN = ("reference.py", "checks.py", "data.py", "roofline.py", "spec.py")


def run_python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_cpu_run_loads_no_jax_and_not_the_jax_package():
    code = (
        "import time\n"
        "from portbench import harness, run, calibrate, spec, faults\n"
        "for m in spec.manifest()['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "over = {'config': {'rows': 4000, 'dims': 32,\n"
        "                   'data': {'centers': 16},\n"
        "                   'fill': {'batch': 1000, 'capacity_rows': 4096},\n"
        "                   'index': {'expect': {'nlist': 126, 'cmax': 128}}},\n"
        "        'traffic': {'pool_queries': 512, 'eval_queries': 64,\n"
        "                    'sample_answers': 16, 'batch': 64}}\n"
        "harness.run('ivf-b1024', 3, 0.2, True, t_start=time.perf_counter(),\n"
        "            device='cpu', overrides=over)\n"
        "import sys\n"
        "print(harness.foreign_modules(), 'fastpyvectordb_tpu_torch' in sys.modules)\n")
    assert run_python(code) == "[] True"


def test_foreign_names_are_compared_whole(monkeypatch):
    for name in ("fastpyvectordb_tpu_torch_extra", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "jax", None)    # blocked, not loaded
    assert harness.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "fastpyvectordb_tpu.core",
                        types.ModuleType("fastpyvectordb_tpu.core"))
    assert harness.foreign_modules() == ["fastpyvectordb_tpu"]


def imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_the_reference_imports_nothing_of_the_program():
    for name in PLAIN:
        tops = {m.split(".")[0] for m in imported(HERE / name)}
        assert not tops & {PROGRAM, "fastpyvectordb_tpu", "jax"}, name
        assert not {m for m in imported(HERE / name)} & {".harness",
                                                         ".tracing"}, name
    code = (f"import sys; sys.modules[{PROGRAM!r}] = None\n"
            "import portbench.reference, portbench.checks, portbench.data\n"
            "import portbench.roofline\n"
            f"print(sorted(m for m in sys.modules if m.startswith({PROGRAM!r})"
            " and sys.modules[m] is not None))\n")
    assert run_python(code) == "[]"
