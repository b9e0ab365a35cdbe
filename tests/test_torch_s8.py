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


def _swizzled_word(r, wi):
    """csrc/s8_scores.cu ``S8Op::word_off`` / 4: where 4-byte word ``wi`` of
    row ``r`` of a stage's corpus tile lies, in words.  TMA's 128-byte
    swizzle, in which the producer's byte-by-byte path lays rows too.  A
    tile row is a corpus row's 128 code bytes of a K step for (N, D) codes
    and a d-row of the step over the tile's 128 corpus rows for (D, N)."""
    return r * 32 + (((wi >> 2) ^ (r & 7)) << 2) + (wi & 3)


_LANE = np.arange(32)


def _ldmatrix_offsets(chunk):
    """``S8Op<true>::fragment``: the byte offset in the stage's (D, N) tile,
    at slice 0, of the matrix row that each lane hands ``ldmatrix.x4``, for
    the warp whose 16 corpus rows are 16-byte chunk ``chunk`` of every
    d-row (slice kk adds 32 kk d-rows)."""
    m, j = _LANE // 8, _LANE % 8
    qq = j // 2
    e = 16 * (m >> 1) + 4 * qq + 2 * ((m & 1) ^ (qq >> 1)) + (j & 1)
    return e * 128 + ((chunk ^ (e & 7)) << 4)


def _ldmatrix_x4_trans(stage, offs):
    """``ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16``: row j of matrix m
    is the 16 bytes at ``offs[8 m + j]``; lane (i = lane / 4, q = lane % 4)
    gets in register m 16-bit word i of rows 2q (low half) and 2q + 1."""
    rows = stage[offs[:, None] + np.arange(16)].view(np.uint16)   # (32, 8)
    i, q = _LANE // 4, _LANE % 4
    return [rows[8 * m + 2 * q, i].astype(np.uint32)
            | (rows[8 * m + 2 * q + 1, i].astype(np.uint32) << 16)
            for m in range(4)]


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm(x, y, sel)`` a lane each (selectors < 8)."""
    src = [(x >> (8 * t)) & 0xFF for t in range(4)] + \
          [(y >> (8 * t)) & 0xFF for t in range(4)]
    src = np.stack(src, axis=1)                                    # (32, 8)
    out = np.zeros(32, dtype=np.uint32)
    for t in range(4):
        out |= src[_LANE, (sel >> (4 * t)) & 7] << (8 * t)
    return out


def _tn_fragments(stage, chunk, kk):
    """``S8Op<true>::fragment``: each lane's four A registers of slice kk,
    (32, 4) uint32."""
    r0, r1, r2, r3 = _ldmatrix_x4_trans(
        stage, _ldmatrix_offsets(chunk) + 32 * kk * 128)
    swap = (_LANE % 4) >= 2
    even = np.where(swap, 0x2064, 0x6420)
    odd = np.where(swap, 0x3175, 0x7531)
    return np.stack([_byte_perm(r0, r1, even), _byte_perm(r0, r1, odd),
                     _byte_perm(r2, r3, even), _byte_perm(r2, r3, odd)], 1)


def _acc_row(tn, w, lane, e):
    """csrc/hopper_scan.cuh ``acc_row``: the corpus row, of a consumer
    warpgroup's 64, of accumulator register 4i + e (``PAIRED_ROWS`` for
    (D, N))."""
    return (16 * w + 2 * (lane // 4) + (e >> 1) if tn
            else 16 * w + lane // 4 + 8 * (e >> 1))


def _emulate_kernel(qi, codes, tn):
    """The CUDA kernel's data path on the CPU: the wrapper's query copy, K
    step by K step; each step's (128-row, 128-byte) corpus tile laid into
    the stage through TMA's swizzle (for (D, N) codes the raw tile: d-rows
    over corpus rows), and read back as the consumers read it: a fragment
    word a register for (N, D); for (D, N) the ldmatrix.x4.trans gathers
    and byte permutes of each lane, whose fragment rows +0 / +8 are the
    corpus rows the epilogue writes them to."""
    qk = s8.kernel_query(qi).numpy().astype(np.int64)
    c = codes.numpy()
    n, d = (c.shape[1], c.shape[0]) if tn else c.shape
    out = np.zeros((qi.shape[0], n), dtype=np.int64)
    r, wi = np.meshgrid(np.arange(128), np.arange(32), indexing="ij")
    places = _swizzled_word(r, wi)
    for n0 in range(0, n, 128):
        rows = min(128, n - n0)
        for k in range(qk.shape[1] // s8.KSTEP):
            tile = np.zeros((128, 128), dtype=np.uint8)   # [tile row][byte]
            cols = max(0, min(128, d - 128 * k))
            if tn:
                tile[:cols, :rows] = c[128 * k:128 * k + cols,
                                       n0:n0 + rows].view(np.uint8)
            else:
                tile[:rows, :cols] = c[n0:n0 + rows,
                                       128 * k:128 * k + cols].view(np.uint8)
            stage = np.zeros(128 * 32, dtype=np.uint32)
            stage[places] = tile.view(np.uint32)
            if not tn:
                a = stage[places].view(np.int8).reshape(128, 128)
            else:
                # a[corpus row][k byte], from each warp's fragments
                a = np.zeros((128, 128), dtype=np.int8)
                for g in range(2):
                    for w in range(4):
                        for kk in range(4):
                            frag = _tn_fragments(stage.view(np.uint8),
                                                 4 * g + w, kk).view(np.int8)
                            frag = frag.reshape(32, 4, 4)   # lane, reg, byte
                            for lane in range(32):
                                q = lane % 4
                                for reg in range(4):
                                    row = 64 * g + _acc_row(True, w, lane,
                                                            2 * (reg % 2))
                                    k0 = 32 * kk + 16 * (reg // 2) + 4 * q
                                    a[row, k0:k0 + 4] = frag[lane, reg]
            out[:, n0:n0 + rows] += (qk[:, 128 * k:128 * k + 128]
                                     @ a[:rows].astype(np.int64).T)
    return out


@pytest.mark.parametrize("tn", [False, True])
@pytest.mark.parametrize("d", [48, 100, 128, 300])
def test_kernel_query_pads_and_swizzles_cover_the_tile(tn, d):
    """``kernel_query``: zero past D up to a multiple of the K step, no
    more than one step of padding; and the stage layout (TMA's swizzle) is
    a permutation of the tile (every word has one place), whose bank
    pattern is conflict-free for the producer's byte-by-byte row stores
    and the consumers' fragment loads: a warp's 4-byte words for (N, D),
    each 8 x 8 matrix of ldmatrix.x4.trans for (D, N).  The emulated data
    path rebuilds the kernel's output bit for bit."""
    q, c = _data(13, 300, d, seed=d)
    tq, tc = torch.as_tensor(q), torch.as_tensor(c)
    qk = s8.kernel_query(tq)
    assert qk.dtype == torch.int8 and qk.is_contiguous()
    assert qk.shape[1] % s8.KSTEP == 0 and 0 <= qk.shape[1] - d < s8.KSTEP
    assert torch.equal(qk[:, :d], tq) and (qk[:, d:] == 0).all()
    places = {_swizzled_word(r, wi) for r in range(128) for wi in range(32)}
    assert places == set(range(128 * 32))
    # the producer's ragged path: thread r stores 16-byte chunk c of tile
    # row r; a phase of eight lanes covers the 32 banks
    for c0 in range(8):
        for base in range(0, 128, 8):
            banks = {(_swizzled_word(base + x, 4 * c0) + t) % 32
                     for x in range(8) for t in range(4)}
            assert len(banks) == 32
    if tn:
        for chunk in range(8):
            offs = _ldmatrix_offsets(chunk)
            for m in range(4):
                banks = {(o // 4 + t) % 32 for o in offs[8 * m:8 * m + 8]
                         for t in range(4)}
                assert len(banks) == 32, (chunk, m)
    else:
        # a warp's fragment load: rows base + 0..7, words w0 + 0..3
        for base in range(0, 128, 8):
            for w0 in range(0, 32, 4):
                banks = {_swizzled_word(base + g, w0 + x) % 32
                         for g in range(8) for x in range(4)}
                assert len(banks) == 32
    want = s8.s8_scores_plain(tq, tc).numpy()
    codes = tc.T.contiguous() if tn else tc
    assert np.array_equal(_emulate_kernel(tq, codes, tn), want)


def test_tn_fragments_are_the_transposed_tile():
    """On a tile of distinct bytes, each lane's (D, N) fragment register
    holds the four d-bytes of its corpus row that wgmma's A layout asks
    for: register j of lane (i, q) in warp w row 16 w + 2i + j % 2, d-rows
    32 kk + 16 (j // 2) + 4q .. + 3 (the bytes differ from the (N, D)
    layout's only by the tile's transpose)."""
    rng = np.random.default_rng(7)
    tile = rng.integers(0, 256, (128, 128), dtype=np.uint8)   # [d][corpus]
    r, wi = np.meshgrid(np.arange(128), np.arange(32), indexing="ij")
    stage = np.zeros(128 * 32, dtype=np.uint32)
    stage[_swizzled_word(r, wi)] = tile.view(np.uint32)
    for chunk in range(8):
        for kk in range(4):
            frag = _tn_fragments(stage.view(np.uint8), chunk, kk)
            for lane in range(32):
                i, q = lane // 4, lane % 4
                for j in range(4):
                    col = 16 * chunk + 2 * i + j % 2
                    d0 = 32 * kk + 16 * (j // 2) + 4 * q
                    want = tile[d0:d0 + 4, col].copy().view(np.uint32)[0]
                    assert frag[lane, j] == want, (chunk, kk, lane, j)


@pytest.mark.parametrize("w", range(4))
def test_tn_epilogue_pair_stores_cover_the_box_conflict_free(w):
    """csrc/hopper_scan.cuh, ``PAIRED_ROWS``: a consumer warp stores the
    accumulator registers e, e + 2 of a query as one 8-byte word at corpus
    rows col, col + 1 of the staging box; over a round's four register
    groups and two query parities each (query, row) of the warp's 32 x 16
    lands once, and each half-warp's store covers the 32 banks."""
    out_box = 32 * 32 * 4
    seen = set()
    for ii in range(4):
        for e in range(2):
            words = []
            for lane in range(32):
                qr = 8 * ii + 2 * (lane % 4) + e
                col = _acc_row(True, w, lane, 0)
                assert col % 2 == 0 and _acc_row(True, w, lane, 2) == col + 1
                off = ((col // 32) * out_box + qr * 128
                       + ((((col % 32) // 4) ^ (qr & 7)) << 4)
                       + 4 * (col % 4))
                words.append(off // 4)
                seen |= {(qr, col), (qr, col + 1)}
            for half in (words[:16], words[16:]):
                banks = {(x + t) % 32 for x in half for t in range(2)}
                assert len(banks) == 32, (ii, e)
    assert seen == {(qr, 16 * w + x) for qr in range(32) for x in range(16)}


def test_tn_library_is_int_mm_on_the_dn_codes():
    """``s8_tn_library``, B9's library yardstick: ``torch._int_mm`` on the
    contiguous (D, N) codes where that layout is taken, equal to the plain
    version."""
    q, c = _data(32, 64, 64, seed=9)
    tq, tct = torch.as_tensor(q), torch.as_tensor(c.T.copy())
    call, label, refusal = s8.s8_tn_library(tq, tct)
    assert label == s8.S8_TN_LIBRARY and refusal is None
    assert torch.equal(call(), s8.s8_scores_tn_plain(tq, tct))


def test_tn_library_falls_back_to_the_nearest_call(monkeypatch):
    """Where ``torch._int_mm`` refuses the contiguous (D, N) codes, the
    yardstick is the transposing copy and ``torch._int_mm`` on its (D, N)
    view, labelled so, with the refusal's first line."""
    q, c = _data(32, 64, 64, seed=10)
    tq, tct = torch.as_tensor(q), torch.as_tensor(c.T.copy())
    int_mm = torch._int_mm

    def refusing(a, b):
        if b.is_contiguous():
            raise RuntimeError("CUBLAS_STATUS_NOT_SUPPORTED\nmore")
        return int_mm(a, b)

    monkeypatch.setattr(torch, "_int_mm", refusing)
    call, label, refusal = s8.s8_tn_library(tq, tct)
    assert label == s8.S8_TN_NEAREST
    assert refusal == "CUBLAS_STATUS_NOT_SUPPORTED"
    assert torch.equal(call(), s8.s8_scores_tn_plain(tq, tct))


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
