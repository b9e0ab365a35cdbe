"""The port's IVF-PQ index against the benchmark's plain reference
(``portbench/reference_ivfpq.py``), on the CPU at a small size: seeded
clustered rows, 20,000 x 64, M = 8 subspaces, 64 cells, a tight cell cap
so the overflow block is scored too.  Both dispatches (grouped: the plain
version of the grouped ADC kernel over a bf16 table; query-major: a float32
table), cosine and l2, and a grouped batch whose cells are saturated.  The
comparison holds the answers and the candidates the port re-ranks to the
reference within tolerances worked out from the table's rounding, and a
table in fp8 or with half its subspaces left out fails it."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fastpyvectordb_tpu_torch import Collection, CollectionConfig
from portbench import reference_ivfpq as ref
from tools.ivfpq_check import candidates, fault as planted

ROWS, DIMS, CENTRES, QUERIES = 20_000, 64, 64, 256
NLIST, NPROBE, K = 64, 8, 10
ROOT = Path(__file__).resolve().parents[1]


def clustered(seed: int):
    """Rows a centre plus unit noise, normalised; queries a centre plus half
    that noise (the benchmark's generator, in numpy)."""
    g = np.random.default_rng(seed)
    c = 2.0 * g.standard_normal((CENTRES, DIMS)).astype(np.float32)
    x = c[g.integers(0, CENTRES, ROWS)] + g.standard_normal(
        (ROWS, DIMS)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = c[g.integers(0, CENTRES, QUERIES)] + 0.5 * g.standard_normal(
        (QUERIES, DIMS)).astype(np.float32)
    return x, q.astype(np.float32)


@pytest.fixture(scope="module", params=["cosine", "l2"])
def built(request):
    x, q = clustered(7)
    col = Collection(CollectionConfig(name="pq", dimensions=DIMS,
                                      metric=request.param), device="cpu")
    col.insert_batch(x, [f"v{i}" for i in range(ROWS)])
    col.build_ann("ivfpq", nlist=NLIST, nprobe=NPROBE, tune=False,
                  max_cell_factor=1.1, spill_choices=2)
    ann = col._ann
    assert ann.stats()["m"] == 8 and ann.stats()["overflow_rows"] > 0
    sections, _ = ann.export_sections()
    return {"metric": request.param, "ann": ann, "corpus": x, "queries": q,
            "index": ref.Index(sections, "cpu")}


def compared(b, grouped, qcap=None, fault=None):
    seen: list = []
    with planted(fault), candidates(seen):
        _, rows = b["ann"].search(b["queries"], K, grouped=grouped, qcap=qcap)
    scores = np.concatenate([s for s, _ in seen]).astype(np.float64)
    if b["metric"] == "l2" and not grouped:
        scores = scores ** 2   # the query-major dispatch's roots, squared
    program = {"rows": rows, "cand_rows": np.concatenate([r for _, r in seen]),
               "cand_scores": scores}
    return ref.compare(b["index"], b["corpus"], b["queries"], b["metric"], K,
                       NPROBE, b["ann"].rerank, program, grouped=grouped,
                       qcap=b["ann"].last_qcap if qcap else None,
                       table_bits=ref.BF16_BITS if grouped else None)


@pytest.mark.parametrize("grouped", [True, False],
                         ids=["grouped", "query_major"])
def test_the_port_keeps_to_the_plain_reference(built, grouped):
    got = compared(built, grouped)
    assert ref.passes(got), got
    assert got["missed"] <= got["missed_explained"]
    # the per-query dispatch's float32 table leaves nothing to explain
    assert grouped or got["missed"] == 0.0


def test_a_saturated_grouped_batch_sheds_as_the_reference_does(built):
    got = compared(built, True, qcap=8)
    assert built["ann"].last_dropped > 0
    assert ref.passes(got), got


@pytest.mark.parametrize("fault", ["fp8_tables", "half_subspaces"])
@pytest.mark.parametrize("grouped", [True, False],
                         ids=["grouped", "query_major"])
def test_a_coarser_or_partial_table_fails_the_comparison(built, grouped,
                                                         fault):
    got = compared(built, grouped, fault=fault)
    assert not ref.passes(got), got
    assert got["adc_excess"] > 4.0


def test_the_reference_is_the_exact_search_where_it_sees_every_row(built):
    """Every cell probed, a re-rank as deep as the corpus: the reference's
    answers are the exact top k."""
    b = built
    q = b["queries"][:32]
    got = ref.search(b["index"], b["corpus"], q, K, b["metric"], NLIST,
                     ROWS // K, grouped=False)
    d = ref._exact(torch.as_tensor(q), torch.as_tensor(b["corpus"])[None]
                   .expand(len(q), -1, -1), b["metric"])
    want = torch.topk(d, K, dim=1, largest=False).indices.numpy()
    assert (np.sort(got["rows"], 1) == np.sort(want, 1)).mean() >= 0.999


def test_the_reference_imports_neither_jax_nor_the_port():
    path = ROOT / "portbench" / "reference_ivfpq.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or "").split(".")[0])
    assert names <= {"__future__", "contextlib", "typing", "numpy", "torch"}
    code = ("import sys\n"
            "for name in ('jax', 'fastpyvectordb_tpu', "
            "'fastpyvectordb_tpu_torch'):\n"
            "    sys.modules[name] = None\n"
            "import portbench.reference_ivfpq\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'fastpyvectordb_tpu', "
            "'fastpyvectordb_tpu_torch') and sys.modules[m] is not None))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
