"""The port's quantized-scan kernels (fastpyvectordb_tpu_torch/kernels/
quant_kernels.py) against the JAX package's Pallas ``sq_scores`` /
``int4_scores`` run in interpret mode, on the same seeded inputs.

On the CPU the port's wrappers run their plain PyTorch versions (a CPU
tensor is the only thing that selects them); the CUDA kernels themselves
are held against those plain versions by the ``cuda``-marked test at the
end, which runs only where a card is present."""

import numpy as np
import pytest
import torch

from fastpyvectordb_tpu.quant.int4 import Int4Quantizer as JInt4
from fastpyvectordb_tpu.quant.scalar import ScalarQuantizer as JScalar
from fastpyvectordb_tpu_torch.core.types import DistanceMetric
from fastpyvectordb_tpu_torch.kernels import quant_kernels as qk

METRICS = ["cosine", "l2", "ip"]
# (B, N, D): non-multiples of the Pallas tiles (B 8, N 1024, D 128), an odd
# D for int4 (one phantom dim)
SHAPES = [(5, 300, 40), (13, 1100, 41)]


def _data(b, n, d, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32))


def _tol(want):
    # both sides round the same f32 operands to bf16 and sum the exact
    # products in f32; only the summation order differs.  Measured gap
    # <= 7e-7 of max(|want|, 1) over these cases; the JAX tests allow 2e-2.
    return 1e-5 * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("metric", METRICS)
def test_sq_scores_matches_pallas(shape, metric):
    b, n, d = shape
    v, q = _data(b, n, d)
    jq = JScalar().train(v)
    codes = np.array(jq.encode(v))
    # the Pallas kernel in interpret mode (mode="pallas" off the TPU)
    want = np.asarray(jq.distances(q, codes, metric, mode="pallas"))
    got = qk.sq_scores(torch.as_tensor(q), torch.as_tensor(codes),
                       torch.as_tensor(np.array(jq.vmin)),
                       torch.as_tensor(np.array(jq.scale)),
                       metric=metric).numpy()
    assert got.shape == want.shape == (b, n)
    np.testing.assert_allclose(got, want, atol=_tol(want), rtol=0)
    # top-1 consistency
    assert (got.argmin(1) == want.argmin(1)).all()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("metric", METRICS)
def test_int4_scores_matches_pallas(shape, metric):
    b, n, d = shape
    v, q = _data(b, n, d, seed=9)
    jq = JInt4().train(v)
    packed = np.array(jq.encode(v))
    want = np.asarray(jq.distances(q, packed, metric, mode="pallas"))
    qe = np.pad(q, ((0, 0), (0, jq._de - d)))   # phantom dim for odd D
    got = qk.int4_scores(torch.as_tensor(qe), torch.as_tensor(packed),
                         torch.as_tensor(np.array(jq.vmin)),
                         torch.as_tensor(np.array(jq.scale)),
                         metric=metric).numpy()
    assert got.shape == want.shape == (b, n)
    np.testing.assert_allclose(got, want, atol=_tol(want), rtol=0)
    assert (got.argmin(1) == want.argmin(1)).all()


def test_plain_versions_round_operands_to_bf16():
    # the plain scan must not return bf16-rounded scores (torch.matmul of
    # bf16 tensors would) and must round its operands (an f32 product
    # would not): compare with a float64 product of the bf16 operands
    v, q = _data(7, 50, 33, seed=3)
    codes = torch.as_tensor(np.array(JScalar().train(v).encode(v)))
    vmin, scale = torch.zeros(33), torch.full((33,), 2.0)
    got = qk.sq_scores_plain(torch.as_tensor(q), codes, vmin, scale,
                             metric="ip")
    vv = ((codes.double() + 128.0) * (2.0 / 255.0)).float()
    want = -(torch.as_tensor(q).bfloat16().double()
             @ vv.bfloat16().double().T)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-5)


def test_cpu_tensors_use_plain_version_and_count_nothing():
    v, q = _data(3, 20, 8)
    jq = JScalar().train(v)
    before = dict(qk.LAUNCHES)
    qk.sq_scores(torch.as_tensor(q), torch.as_tensor(np.array(
        jq.encode(v))), torch.as_tensor(np.array(jq.vmin)),
        torch.as_tensor(np.array(jq.scale)), metric="l2")
    assert qk.LAUNCHES == before


@pytest.mark.parametrize("fn", [qk.sq_scores, qk.int4_scores])
def test_non_cpu_tensor_never_falls_back(fn):
    # a tensor that is not on the CPU reaches the kernel path, which
    # refuses what is not a CUDA tensor instead of computing elsewhere
    dtype = torch.int8 if fn is qk.sq_scores else torch.uint8
    codes = torch.empty((4, 8), dtype=dtype, device="meta")
    de = 8 if fn is qk.sq_scores else 16
    with pytest.raises(ValueError, match="CUDA"):
        fn(torch.zeros((2, de)), codes, torch.zeros(de), torch.ones(de),
           metric="cosine")


def _emulate_kernel(kind, q_in, qsq, codes, rscale, vmin, metric):
    """The CUDA kernel's arithmetic, K position by K position, from the
    wrapper's tables.  The codes are read as the producer reads them:
    int8 position p is byte p (+128); int4 position p is nibble p % 2 of
    byte p // 2 (K step j = bytes 32j .. 32j + 31).  Bytes past the row
    read 0."""
    width = codes.shape[1]
    dims = qk.kernel_dims(kind, width)
    qk_ = qk.kernel_query(q_in, dims)
    sv = qk.kernel_scales(rscale, vmin, dims)
    p = torch.arange(dims.numel())
    byte = p if kind == "int8" else p // 2
    raw = codes.view(torch.uint8)[:, byte.clamp(max=width - 1)].int()
    raw = torch.where(byte[None, :] < width, raw, 0)
    code = (raw ^ 0x80) if kind == "int8" else (raw >> (4 * (p % 2))) & 0xF
    v = code.float() * sv[:, 0] + sv[:, 1]
    cross = qk_.float() @ v.bfloat16().float().T
    return qk._epilogue(cross, v, qsq, DistanceMetric.parse(metric))


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("d", [41, 64, 130])
def test_kernel_tables_pad_and_order_dims(kind, d):
    """``kernel_dims`` / ``kernel_query`` / ``kernel_scales``: every true
    dim once, zero padding to a multiple of the K step, and the kernel's
    reading of the codes in that order gives the plain version's scores
    (which the tests above hold against the Pallas kernels)."""
    v, q = _data(13, 300, d, seed=d)
    jq = (JScalar if kind == "int8" else JInt4)().train(v)
    codes = torch.as_tensor(np.array(jq.encode(v)))
    de = d if kind == "int8" else 2 * codes.shape[1]
    dims = qk.kernel_dims(kind, codes.shape[1])
    assert dims.numel() % qk.KSTEP == 0 and 0 <= dims.numel() - de < qk.KSTEP
    assert torch.equal(dims[dims >= 0].sort().values, torch.arange(de))
    qe = torch.as_tensor(np.pad(q, ((0, 0), (0, de - d))))
    qcopy = qk.kernel_query(qe, dims)
    assert qcopy.dtype == torch.bfloat16 and qcopy.shape == (13, dims.numel())
    assert (qcopy[:, dims < 0] == 0).all()
    assert torch.equal(qcopy[:, dims >= 0], qe[:, dims[dims >= 0]].bfloat16())
    vmin = torch.as_tensor(np.array(jq.vmin))
    scale = torch.as_tensor(np.array(jq.scale))
    rscale = scale / (255.0 if kind == "int8" else 15.0)
    assert (qk.kernel_scales(rscale, vmin, dims)[dims < 0] == 0).all()
    plain = qk.sq_scores_plain if kind == "int8" else qk.int4_scores_plain
    for metric in METRICS:
        want = plain(qe, codes, vmin, scale, metric=metric).numpy()
        q_in, qsq = qk._prep_queries(qe, DistanceMetric.parse(metric))
        got = _emulate_kernel(kind, q_in, qsq, codes, rscale, vmin,
                              metric).numpy()
        np.testing.assert_allclose(got, want, atol=_tol(want), rtol=0)


# (B, N, D) on the card: B 1 / 13 / 70 / 200 (one and two query tiles),
# N off the 128-row tile, D 41 / 130 / 1500 (odd W = 21, 65 for int4, and
# a second pass of the 2-stage scale table)
CUDA_SHAPES = [(37, 2100, 41), (1, 64, 16), (13, 1000, 41), (70, 3001, 130),
               (200, 1000, 1500)]


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_cuda_kernels_match_plain(metric):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for b, n, d in CUDA_SHAPES:
        v, q = _data(b, n, d)
        for name, kern, plain in (("sq_scores", qk.sq_scores,
                                   qk.sq_scores_plain),
                                  ("int4_scores", qk.int4_scores,
                                   qk.int4_scores_plain)):
            jq = (JScalar if name == "sq_scores" else JInt4)().train(v)
            codes = torch.as_tensor(np.array(jq.encode(v))).cuda()
            de = 2 * codes.shape[1] if name == "int4_scores" else d
            qc = torch.as_tensor(np.pad(q, ((0, 0), (0, de - d)))).cuda()
            vmin = torch.as_tensor(np.array(jq.vmin)).cuda()
            scale = torch.as_tensor(np.array(jq.scale)).cuda()
            n0 = qk.LAUNCHES[name]
            got = kern(qc, codes, vmin, scale, metric=metric)
            want = plain(qc, codes, vmin, scale, metric=metric)
            torch.cuda.synchronize()
            assert qk.LAUNCHES[name] == n0 + 1
            # same bf16 operands, f32 sums in another order
            tol = 1e-3 * max(want.abs().max().item(), 1.0)
            assert (got - want).abs().max().item() <= tol, (name, b, n, d)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(3, 500, 41), (40, 501, 64),
                                   (33, 512, 64)])
def test_cuda_int8mm_pads_for_int_mm(b, n, d):
    # the int8mm mode's product is the s8_scores kernel, which takes small
    # batches, odd dims and odd row counts as they are (the library call it
    # replaced wanted them padded): no padding copy is made, and the integer
    # products must equal the CPU's exactly
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
    from fastpyvectordb_tpu_torch.quant.scalar import (ScalarQuantizer,
                                                       int8_cross)
    rng = np.random.default_rng(b + n + d)
    qi = torch.as_tensor(rng.integers(-127, 128, (b, d), dtype=np.int8))
    ci = torch.as_tensor(rng.integers(-128, 128, (n, d), dtype=np.int8))
    before = s8.LAUNCHES["s8_scores"]
    got_i = int8_cross(qi.cuda(), ci.cuda())
    assert s8.LAUNCHES["s8_scores"] == before + 1
    assert got_i.shape == (b, n) and torch.equal(got_i.cpu(),
                                                 int8_cross(qi, ci))
    v, q = _data(b, n, d, seed=13)
    cpu = ScalarQuantizer(device="cpu").train(v)
    gpu = ScalarQuantizer(device="cuda").train(v)
    want = cpu.distances(q, cpu.encode(v), "l2", mode="int8mm")
    got = gpu.distances(q, gpu.encode(v), "l2", mode="int8mm").cpu()
    # same codes and integer products; the f32 epilogue may differ by
    # rounding only
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_concurrent_first_loads_share_one_build(tmp_path, monkeypatch):
    """Eight threads that make their first launch of one source at once
    (a server's executor, the batcher's waves) wait for one compiler run
    and all get the same loaded library.  ``nvcc`` is a stub on PATH that
    sleeps, then builds a small library with g++."""
    import os
    import shutil
    import sys
    import threading
    from fastpyvectordb_tpu_torch.kernels import cuda_build
    if shutil.which("g++") is None:
        pytest.skip("the stub compiler needs g++")
    stub_src = tmp_path / "stub.cpp"
    stub_src.write_text('extern "C" int fpv_stub(int x) { return x + 1; }\n')
    runs = tmp_path / "runs"
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo run >> "{runs}"\n'
        "sleep 0.5\n"
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        f'exec g++ -shared -fPIC -o "$out" "{stub_src}"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    src = cuda_build.CudaSource("quant_scores", {"fpv_stub": [cuda_build.I]})
    barrier = threading.Barrier(8)
    libs, errors = [None] * 8, []

    def first_launch(i):
        try:
            barrier.wait(10)
            libs[i] = src.load()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_launch, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert runs.read_text().splitlines() == ["run"]
    assert all(lib is libs[0] for lib in libs)
    assert libs[0].fpv_stub(41) == 42
