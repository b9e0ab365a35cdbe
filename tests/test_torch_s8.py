"""The port's exact int8 corpus scans (fastpyvectordb_tpu_torch/kernels/
s8_kernels.py) against the Pallas kernels ``pallas_s8`` / ``pallas_s8_tn``
of ``benchmarks/int8_mxu_lab.py`` run in interpret mode, on the same seeded
int8 inputs.  Integer products are exact: every comparison is bit for bit.

On the CPU the port's wrappers run their plain PyTorch versions (a CPU
tensor is the only thing that selects them); the CUDA kernels themselves
are held against those plain versions by the ``cuda``-marked tests at the
end, which run only where a card is present."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fastpyvectordb_tpu_torch.kernels import s8_kernels as s8
from fastpyvectordb_tpu_torch.quant.scalar import int8_cross

_LAB = Path(__file__).resolve().parents[1] / "benchmarks" / "int8_mxu_lab.py"
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def lab():
    """``benchmarks/int8_mxu_lab.py`` loaded by path (``benchmarks/`` is no
    package).  Its import points jax's compilation cache elsewhere: the
    two settings are restored afterwards."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    spec = importlib.util.spec_from_file_location("int8_mxu_lab", _LAB)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _data(b, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (b, d), dtype=np.int8),
            rng.integers(-128, 128, (n, d), dtype=np.int8))


# (B, N, D, tn) with N % tn == 0, as the Pallas grid requires
PALLAS_SHAPES = [(8, 1024, 64, 512), (5, 2048, 768, 1024),
                 (16, 2048, 128, 2048)]


@pytest.mark.parametrize("b,n,d,tn", PALLAS_SHAPES)
def test_s8_scores_matches_pallas(lab, b, n, d, tn):
    q, c = _data(b, n, d, seed=n + d)
    want = np.asarray(lab.pallas_s8(q, c, tn=tn, interpret=True))
    assert want.dtype == np.int32 and want.shape == (b, n)
    tq, tc = torch.as_tensor(q), torch.as_tensor(c)
    assert np.array_equal(s8.s8_scores_plain(tq, tc).numpy(), want)
    assert np.array_equal(s8.s8_scores(tq, tc).numpy(), want)
    assert np.array_equal(int8_cross(tq, tc).numpy(), want)


@pytest.mark.parametrize("b,n,d,tn", PALLAS_SHAPES)
def test_s8_scores_tn_matches_pallas(lab, b, n, d, tn):
    q, c = _data(b, n, d, seed=n + d + 1)
    ct = np.ascontiguousarray(c.T)
    want = np.asarray(lab.pallas_s8_tn(q, ct, tn=tn, interpret=True))
    assert want.dtype == np.int32 and want.shape == (b, n)
    # the two Pallas kernels compute the same function
    assert np.array_equal(
        want, np.asarray(lab.pallas_s8(q, c, tn=tn, interpret=True)))
    tq, tct = torch.as_tensor(q), torch.as_tensor(ct)
    assert np.array_equal(s8.s8_scores_tn_plain(tq, tct).numpy(), want)
    assert np.array_equal(s8.s8_scores_tn(tq, tct).numpy(), want)


def test_lab_import_leaves_the_compilation_cache_settings(lab):
    assert jax.config.jax_compilation_cache_dir != "/tmp/jax_bench_cache"


# any B, N, D: off every tile of either machine
RAGGED = [(1, 1, 1), (3, 130, 48), (17, 1001, 100), (33, 257, 129),
          (2, 515, 768)]


@pytest.mark.parametrize("b,n,d", RAGGED)
def test_plain_versions_are_exact_at_any_shape(b, n, d):
    q, c = _data(b, n, d, seed=b + n + d)
    want = q.astype(np.int64) @ c.astype(np.int64).T
    tq, tc = torch.as_tensor(q), torch.as_tensor(c)
    for got in (s8.s8_scores(tq, tc), int8_cross(tq, tc),
                s8.s8_scores_tn(tq, tc.T.contiguous())):
        assert got.dtype == torch.int32 and got.shape == (b, n)
        assert np.array_equal(got.numpy().astype(np.int64), want)


def _swizzled_word(tn, r, wi):
    """csrc/s8_scores.cu ``S8Op::word_off`` / 4: where 4-byte word ``wi`` of
    corpus row ``r`` of a tile lies in the stage."""
    key = (r & 7) ^ ((r >> 4) & 7) if tn else r & 7
    return r * 32 + (((wi >> 2) ^ key) << 2) + (wi & 3)


def _emulate_kernel(qi, codes, tn):
    """The CUDA kernel's data path on the CPU: the wrapper's query copy, K
    step by K step; each (128-row, 128-byte) corpus tile laid into the
    stage through the layout's swizzle as the producer lays it (the (D, N)
    layout in transposed 4 x 4 byte blocks) and read back a fragment word
    at a time as the consumers read it."""
    qk = s8.kernel_query(qi).numpy().astype(np.int64)
    c = codes.numpy()
    n, d = (c.shape[1], c.shape[0]) if tn else c.shape
    out = np.zeros((qi.shape[0], n), dtype=np.int64)
    for n0 in range(0, n, 128):
        for k in range(qk.shape[1] // s8.KSTEP):
            stage = np.zeros(128 * 32, dtype=np.uint32)
            tile = np.zeros((128, 128), dtype=np.uint8)   # [row][byte]
            rows = min(128, n - n0)
            cols = max(0, min(128, d - 128 * k))
            blk = c[128 * k:128 * k + cols, n0:n0 + rows].T if tn \
                else c[n0:n0 + rows, 128 * k:128 * k + cols]
            tile[:rows, :cols] = blk.view(np.uint8)
            words = tile.view(np.uint32)                  # [row][word]
            for r in range(128):
                for wi in range(32):
                    stage[_swizzled_word(tn, r, wi)] = words[r, wi]
            back = np.empty((128, 32), dtype=np.uint32)
            for r in range(128):
                for wi in range(32):
                    back[r, wi] = stage[_swizzled_word(tn, r, wi)]
            a = back.view(np.int8).astype(np.int64)[:rows]
            out[:, n0:n0 + rows] += qk[:, 128 * k:128 * k + 128] @ a.T
    return out


@pytest.mark.parametrize("tn", [False, True])
@pytest.mark.parametrize("d", [48, 100, 128, 300])
def test_kernel_query_pads_and_swizzles_cover_the_tile(tn, d):
    """``kernel_query``: zero past D up to a multiple of the K step, no
    more than one step of padding; and the stage layouts of both entries
    are permutations of the tile (every word has one place), whose bank
    pattern is conflict-free for a warp's fragment loads and, in the (D, N)
    layout, for its transposed stores."""
    q, c = _data(13, 300, d, seed=d)
    tq, tc = torch.as_tensor(q), torch.as_tensor(c)
    qk = s8.kernel_query(tq)
    assert qk.dtype == torch.int8 and qk.is_contiguous()
    assert qk.shape[1] % s8.KSTEP == 0 and 0 <= qk.shape[1] - d < s8.KSTEP
    assert torch.equal(qk[:, :d], tq) and (qk[:, d:] == 0).all()
    places = {_swizzled_word(tn, r, wi) for r in range(128)
              for wi in range(32)}
    assert places == set(range(128 * 32))
    # a warp's fragment load: rows base + 0..7, words w0 + 0..3
    for base in range(0, 128, 8):
        for w0 in range(0, 32, 4):
            banks = {_swizzled_word(tn, base + g, w0 + x) % 32
                     for g in range(8) for x in range(4)}
            assert len(banks) == 32
    if tn:
        # a warp's transposed store: corpus rows 16 (lane % 8) + j of the
        # four d-blocks w0 + lane // 8
        for j in range(16):
            for w0 in range(0, 32, 4):
                banks = {_swizzled_word(True, 16 * (lane % 8) + j,
                                        w0 + lane // 8) % 32
                         for lane in range(32)}
                assert len(banks) == 32
    want = s8.s8_scores_plain(tq, tc).numpy()
    codes = tc.T.contiguous() if tn else tc
    assert np.array_equal(_emulate_kernel(tq, codes, tn), want)


def test_cpu_tensors_use_plain_version_and_count_nothing():
    q, c = _data(3, 20, 8)
    before = dict(s8.LAUNCHES)
    s8.s8_scores(torch.as_tensor(q), torch.as_tensor(c))
    s8.s8_scores_tn(torch.as_tensor(q), torch.as_tensor(c.T.copy()))
    int8_cross(torch.as_tensor(q), torch.as_tensor(c))
    assert s8.LAUNCHES == before


@pytest.mark.parametrize("fn", [s8.s8_scores, s8.s8_scores_tn, int8_cross])
def test_non_cpu_tensor_never_falls_back(fn):
    # a tensor that is not on the CPU reaches the kernel path, which
    # refuses what is not a CUDA tensor instead of computing elsewhere
    codes = torch.empty((8, 8), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fn(torch.zeros((2, 8), dtype=torch.int8), codes)


# on the card: B of 1, 17, 1024, 1025 (one to five query tiles); N off the
# multiples of 4, 8 and 128; D of 48, 100, 768
CUDA_SHAPES = [(1, 64, 48), (17, 1001, 100), (1024, 4096, 768),
               (1025, 130, 48), (33, 2050, 100), (70, 3004, 768),
               (5, 515, 129)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", CUDA_SHAPES)
def test_cuda_s8_kernels_match_plain(b, n, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, c = _data(b, n, d, seed=b + n + d)
    tq, tc = torch.as_tensor(q).cuda(), torch.as_tensor(c).cuda()
    tct = tc.T.contiguous()
    before = dict(s8.LAUNCHES)
    got = s8.s8_scores(tq, tc)
    got_tn = s8.s8_scores_tn(tq, tct)
    torch.cuda.synchronize()
    assert s8.LAUNCHES["s8_scores"] == before["s8_scores"] + 1
    assert s8.LAUNCHES["s8_scores_tn"] == before["s8_scores_tn"] + 1
    want = s8.s8_scores_plain(tq.cpu(), tc.cpu()).cuda()
    assert torch.equal(got, want), (b, n, d)
    assert torch.equal(got_tn, want), (b, n, d)
    # the plain versions on the card (float64 blocks) are exact too
    assert torch.equal(s8.s8_scores_plain(tq, tc), want)
    assert torch.equal(s8.s8_scores_tn_plain(tq, tct), want)
    assert torch.equal(int8_cross(tq, tc), want)
    if b > 16 and d % 8 == 0 and n % 8 == 0:
        assert torch.equal(torch._int_mm(tq, tct), want)


@pytest.mark.cuda
def test_cuda_s8_kernels_take_a_misaligned_base():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, n, d = 19, 777, 64
    q, c = _data(b, n, d, seed=4)
    tq = torch.as_tensor(q).cuda()
    want = s8.s8_scores_plain(torch.as_tensor(q), torch.as_tensor(c)).cuda()
    for off in (1, 4):
        buf = torch.zeros(n * d + 16, dtype=torch.int8, device="cuda")
        codes = buf[off:off + n * d].view(n, d)
        codes.copy_(torch.as_tensor(c))
        assert torch.equal(s8.s8_scores(tq, codes), want)
        codes_t = buf[off:off + n * d].view(d, n)
        codes_t.copy_(torch.as_tensor(np.ascontiguousarray(c.T)))
        assert torch.equal(s8.s8_scores_tn(tq, codes_t), want)
