"""Out-of-core search: corpora larger than device memory, streamed tile by
tile (port of ``fastpyvectordb_tpu/core/outofcore.py``).

The corpus stays on the host (any array-like: an ndarray, an ``np.memmap``,
the ``_mm`` of a ``persist.format.StreamingVectorReader``) and crosses the
host-device link one fixed-size tile at a time, while the device keeps a
running top-k (exact) or top-c (quantized coarse scan):

    for each tile: host -> pinned buffer | copy to the card | score | merge

Every tile crosses the link once a search, so the design problem is to
overlap the copies with the scoring.  The JAX package got that from async
dispatch; here ``TileStager`` builds it from two pinned host buffers and two
device buffers allocated once per search, a copy stream with an event per
tile that the compute (current) stream waits on, and an event per tile that
the compute stream has finished reading.  The host waits on a buffer's
copy event before it refills it, and the copy stream waits on the compute
stream's event before it overwrites a device buffer still being read.  The
device buffers are allocated on the compute stream, and the copy stream
then waits for everything the compute stream had queued before its first
copy, so memory the caching allocator hands them is no longer in use.

The last tile goes through at its own size: its top-c is min(c, rows)
wide and the merge takes parts of different widths.

Tile steps, on the card (the plain versions on the CPU):

  exact   ``kernels/distances.py`` scores + ``smallest_k`` (the JAX step
          is ``jnp.dot`` + ``lax.top_k``, outside any Pallas kernel);
          bf16 compute ships bf16 tiles, demoted on the host
  int8    the fused ``s8_topc`` kernel (B8's redesign) on the tile's codes,
          row stat and mask; no (B, tile) block is written
  int4    the folded int4 product of ``quant/int4.py`` on the unpacked
          tile, run by the same ``s8_topc``
  binary  ``hamming_mxu_scores`` (B5) + masked top-c
  pq      the one-hot bf16 product (K <= 32) or the table gather
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.distances import (MASKED, host_exact_scores, mm_f32,
                                 scores as exact_scores, smallest_k)
from ..kernels.hamming_kernels import hamming_mxu_scores
from ..kernels.quant_kernels import unpack_int4
from ..kernels.s8_kernels import s8_topc
from ..utils import resolve_device
from .types import DistanceMetric


# ---------------------------------------------------------------------------
# staging: pinned host buffers -> device buffers, overlapped with compute
# ---------------------------------------------------------------------------

class CudaStreams:
    """The stager's ordering on a card: copies on a side stream, each
    followed by an event the compute (current) stream waits on, and an
    event per tile the compute stream has finished reading."""

    pinned = True

    def __init__(self, device: torch.device):
        self.device = device
        self.compute = torch.cuda.current_stream(device)
        self.copy = torch.cuda.Stream(device)

    def begin(self) -> None:
        """Called once the device buffers are allocated (on the compute
        stream): their memory may have been another tensor's, still in use
        by work queued before, so the copy stream waits for all of it."""
        self.copy.wait_stream(self.compute)

    def upload(self, dsts, srcs, after):
        """Copy ``srcs`` (pinned) into ``dsts`` on the copy stream once the
        compute stream has passed ``after``; returns the copy's event."""
        with torch.cuda.stream(self.copy):
            if after is not None:
                self.copy.wait_event(after)
            for d, s in zip(dsts, srcs):
                d.copy_(s, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.copy)
        self.compute.wait_event(done)
        return done

    def consumed(self):
        """An event after the work the compute stream has queued so far."""
        ev = torch.cuda.Event()
        ev.record(self.compute)
        return ev

    @staticmethod
    def wait(ev) -> None:
        if ev is not None:
            ev.synchronize()


class HostStreams:
    """The same order on the CPU, where every step completes at once."""

    pinned = False
    device = torch.device("cpu")

    @staticmethod
    def begin() -> None:
        pass

    @staticmethod
    def upload(dsts, srcs, after):
        for d, s in zip(dsts, srcs):
            d.copy_(s)
        return None

    @staticmethod
    def consumed():
        return None

    @staticmethod
    def wait(ev) -> None:
        pass


def streams_for(device: torch.device):
    return CudaStreams(device) if device.type == "cuda" else HostStreams()


class TileStager:
    """Double-buffered host -> device staging of row tiles.

    ``specs`` lists each array of a tile as ((max_rows, *tail), dtype).
    ``stage(rows, fill)`` waits until the host buffer of its slot is free,
    calls ``fill(*host_views)`` to write the tile's first ``rows`` rows,
    queues the copy and returns the device views, which the compute stream
    may read as soon as work is queued after this call.  ``bytes`` counts
    what crossed the link."""

    def __init__(self, streams, specs, nbuf: int = 2):
        self.streams = streams
        self.nbuf = nbuf
        self._host = [[torch.empty(shape, dtype=dt, pin_memory=streams.pinned)
                       for shape, dt in specs] for _ in range(nbuf)]
        self._dev = [[torch.empty(shape, dtype=dt, device=streams.device)
                      for shape, dt in specs] for _ in range(nbuf)]
        self._copied = [None] * nbuf   # the last copy out of each host slot
        self._read = [None] * nbuf     # compute done with each device slot
        self._n = 0
        self.bytes = 0
        streams.begin()

    def stage(self, rows: int, fill):
        if self._n:   # the previous tile's work is queued by now
            self._read[(self._n - 1) % self.nbuf] = self.streams.consumed()
        slot = self._n % self.nbuf
        self._n += 1
        # refilling a host buffer whose copy is still in flight would
        # corrupt the tile it carries
        self.streams.wait(self._copied[slot])
        hv = [h[:rows] for h in self._host[slot]]
        fill(*hv)
        dv = [d[:rows] for d in self._dev[slot]]
        self._copied[slot] = self.streams.upload(dv, hv, self._read[slot])
        self.bytes += sum(h.numel() * h.element_size() for h in hv)
        return dv


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A tensor over a host array without copying it (a read-only memmap
    included: the tensor is only read)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(arr))


def _merge(best, vals, rows, c: int):
    """Fold a tile's (vals, rows) into the running best (None at first):
    the c smallest, ascending; parts may have different widths."""
    if best is not None:
        vals = torch.cat([best[0], vals], dim=1)
        rows = torch.cat([best[1], rows], dim=1)
    top, pos = smallest_k(vals, min(c, vals.shape[1]))
    return top, torch.take_along_dim(rows, pos, dim=1)


def _mask_tile(s: torch.Tensor, tile_mask) -> torch.Tensor:
    if tile_mask is not None:
        s.masked_fill_(~tile_mask[None, :], float(MASKED))
    return s


def _as_queries(queries) -> np.ndarray:
    q = np.ascontiguousarray(queries, dtype=np.float32)
    return q[None, :] if q.ndim == 1 else q


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# exact
# ---------------------------------------------------------------------------

def _tile_step(q, tile, tile_mask, *, metric: DistanceMetric, k: int,
               compute_dtype: str):
    """Score one tile; its top-k (vals, tile rows).  The row statistics come
    from the tile itself, in f32.  In f32, the k winners' squared L2
    distances are computed again from their differences: the expansion
    ||q||^2 + ||v||^2 - 2 q.v leaves a few ulps of ||q||^2 where a row
    equals the query (a distance of ~3e-3 after the square root)."""
    s = exact_scores(q, tile, metric, compute_dtype=compute_dtype)
    vals, rows = smallest_k(_mask_tile(s, tile_mask), min(k, tile.shape[0]))
    if metric == DistanceMetric.L2 and compute_dtype == "float32":
        diff = q.float()[:, None, :] - tile[rows].float()
        vals = torch.where(vals < MASKED * 0.5, (diff * diff).sum(dim=2),
                           vals)
    return vals, rows


class OutOfCoreSearcher:
    """Streamed exact search over a host-resident (N, D) array-like."""

    def __init__(self, corpus, metric: "DistanceMetric | str" = "cosine",
                 tile_rows: int = 262_144, compute_dtype: str = "float32",
                 device=None):
        self.device = resolve_device(device)
        self.corpus = corpus
        self.n = corpus.shape[0]
        self.dims = corpus.shape[1]
        self.metric = DistanceMetric.parse(metric)
        self.tile_rows = tile_rows
        self.compute_dtype = compute_dtype
        self.last_link_bytes = 0

    def search(self, queries: np.ndarray, k: int = 10,
               mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (dists (B, k), rows (B, k)) over the full corpus."""
        q = _as_queries(queries)
        qd = torch.from_numpy(q).to(self.device)
        kk = min(k, self.n)
        t = min(self.tile_rows, self.n)
        # bf16 compute ships bf16 tiles, demoted on the host: the copies,
        # not the product, bound a streamed search
        wire = torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32
        specs = [((t, self.dims), wire)]
        if mask is not None:
            specs.append(((t,), torch.bool))
        stager = TileStager(streams_for(self.device), specs)
        best = None
        for start in range(0, self.n, t):
            stop = min(start + t, self.n)

            def fill(tile, tmask=None):
                tile.copy_(_host_tensor(np.asarray(self.corpus[start:stop],
                                                   dtype=np.float32)))
                if tmask is not None:
                    tmask.copy_(_host_tensor(mask[start:stop]))

            tile, *tmask = stager.stage(stop - start, fill)
            vals, rows = _tile_step(qd, tile, tmask[0] if tmask else None,
                                    metric=self.metric, k=kk,
                                    compute_dtype=self.compute_dtype)
            best = _merge(best, vals, rows + start, kk)
        self.last_link_bytes = stager.bytes
        vals = best[0].cpu().numpy()
        if self.metric == DistanceMetric.L2:
            good = vals < MASKED / 2
            vals = np.where(good, np.sqrt(np.maximum(vals, 0.0)), vals)
        return vals, best[1].to(torch.int32).cpu().numpy()


# ---------------------------------------------------------------------------
# quantized: host codes streamed, exact re-rank from the host corpus
# ---------------------------------------------------------------------------

def block_sample(corpus, n: int, train_rows: int) -> np.ndarray:
    """Deterministic quantizer-training sample: contiguous blocks spread
    over the file — memmap-friendly (16 sequential reads) yet covering
    the corpus distribution (a single head slice would mis-train on
    row-ordered corpora).  Bit for bit the JAX package's sample, so codes
    written by either package over one corpus agree."""
    blocks = min(16, max(1, n // max(train_rows, 1)))
    per = max(1, train_rows // blocks)
    starts = np.linspace(0, max(n - per, 0), blocks).astype(np.int64)
    return np.concatenate([
        np.asarray(corpus[int(s):int(s) + per], dtype=np.float32)
        for s in starts], axis=0)


def _host_encode_tile(codec: str, qz, tile_np: np.ndarray) -> np.ndarray:
    """Numpy mirror of the scalar codecs' device encoders.

    Bit-compatible with quant/scalar.py:_encode, quant/int4.py:_encode and
    quant/binary.py:_encode (the same f32 arithmetic; numpy and torch both
    round half to even); used at build time so encoding never ships the
    full f32 corpus across the host-device link.
    """
    if codec == "int8":
        vmin = _np(qz.vmin).astype(np.float32)
        scale = _np(qz.scale).astype(np.float32)
        q = np.clip(np.round((tile_np - vmin) / scale * np.float32(255.0)),
                    0.0, 255.0)
        return (q - np.float32(128.0)).astype(np.int8)
    if codec == "int4":
        vmin = _np(qz.vmin).astype(np.float32)
        scale = _np(qz.scale).astype(np.float32)
        de = vmin.shape[0]
        if tile_np.shape[1] != de:  # odd-D phantom dim (halves layout)
            tile_np = np.pad(tile_np, ((0, 0), (0, de - tile_np.shape[1])))
        c = np.clip(np.round((tile_np - vmin) / scale * np.float32(15.0)),
                    0.0, 15.0).astype(np.uint8)
        w = de // 2
        return c[:, :w] | (c[:, w:] << 4)
    # binary: packed sign bits, 32 dims per uint32 word
    thr = _np(qz.thresholds).astype(np.float32)
    dims = int(thr.shape[0])
    w = (dims + 31) // 32
    bits = (tile_np[:, :dims] > thr).astype(np.uint32)
    pad = w * 32 - dims
    if pad:
        bits = np.pad(bits, ((0, 0), (0, pad)))
    shifts = np.arange(32, dtype=np.uint32)
    return (bits.reshape(-1, w, 32) << shifts).sum(
        axis=-1, dtype=np.uint32)


def _host_row_stats(codec: str, qz, enc_np: np.ndarray):
    """(vsq, rinv) of the dequantized tile — numpy mirror of
    ``quant/scalar.py:row_stats`` with the int8 and int4 dequantisers."""
    vmin = _np(qz.vmin).astype(np.float32)
    scale = _np(qz.scale).astype(np.float32)
    if codec == "int8":
        v = ((enc_np.astype(np.float32) + np.float32(128.0))
             / np.float32(255.0) * scale + vmin)
    else:  # int4 halves layout: low nibbles | high nibbles
        c = np.concatenate([enc_np & 0xF, enc_np >> 4], axis=-1)
        v = c.astype(np.float32) / np.float32(15.0) * scale + vmin
    sq = np.einsum("nd,nd->n", v, v, dtype=np.float32)
    rinv = np.where(sq > 0,
                    1.0 / np.sqrt(np.maximum(sq, np.float32(1e-30))),
                    0.0).astype(np.float32)
    return sq.astype(np.float32), rinv


_CODE_DTYPE = {"int8": np.int8, "int4": np.uint8, "pq": np.uint8,
               "binary": np.uint32}
# the device dtype of each codec's tile (binary words as int32: the same
# bits, which the Hamming kernels take)
_TILE_DTYPE = {"int8": torch.int8, "int4": torch.uint8, "pq": torch.uint8,
               "binary": torch.int32}


class QuantizedOutOfCoreSearcher:
    """Streamed *quantized* coarse scan + exact re-rank over a host corpus.

    The tier above BigCollection: BigCollection keeps the codes on the
    device, which caps corpus size at device memory over the code bytes;
    here the codes live on the host too and stream tile by tile, so corpus
    size is bounded only by host storage.  A search moves N x D bytes
    (int8, 4x less than the exact streamer), N x D/2 (int4), N x M (pq,
    16x at the m=D/4 default; cosine rides the normalized-L2 equivalence
    so the coarse order matches the metric) or N x D/8 (binary, 32x) over
    the link for the coarse pass; the B x C candidate rows of the exact
    re-rank are gathered from the host corpus in sorted order and scored
    on the host.

    One full-precision pass over the corpus at build time trains the
    quantizer (block-sampled) and encodes the host codes; ``codes_path``
    memmaps them to disk with a ``.stats.npz`` sidecar, and
    ``codes_reuse=True`` adopts a matching pair written earlier (by either
    package) without touching the corpus.  ``encode_on="auto"`` encodes
    the scalar codecs on the host (numpy mirrors of the device encoders, so
    the f32 corpus never crosses the link for it) and pq on the device.
    """

    def __init__(self, corpus, metric: "DistanceMetric | str" = "cosine",
                 codec: str = "int8", tile_rows: int = 262_144,
                 train_rows: int = 262_144, rerank: int = 16,
                 codes_path: Optional[str] = None,
                 codes_reuse: bool = False,
                 pq_m: Optional[int] = None, pq_k: int = 16,
                 encode_on: str = "auto", device=None):
        if codec not in ("int8", "int4", "binary", "pq"):
            raise ValueError(f"unknown codec {codec!r}")
        if encode_on not in ("auto", "host", "device"):
            raise ValueError(f"unknown encode_on {encode_on!r}")
        self.device = resolve_device(device)
        self._encode_on = ("device" if codec == "pq"
                           else "host" if encode_on == "auto" else encode_on)
        self.corpus = corpus
        self.n = int(corpus.shape[0])
        self.dims = int(corpus.shape[1])
        self.metric = DistanceMetric.parse(metric)
        self.codec = codec
        self.tile_rows = int(tile_rows)
        self.rerank = int(rerank)
        # the last search's link bytes and seconds to its coarse candidates
        # on the host (the rest is the host gather and exact re-rank)
        self.last_link_bytes = 0
        self.last_coarse_s = 0.0
        if codec == "pq":
            # 4 dims a subspace with 16 centroids by default: codes the
            # one-hot product handles (K <= 32), dims/4 bytes a row
            if pq_m is None:
                pq_m = (self.dims // 4 if self.dims % 4 == 0
                        else self.dims // 2 if self.dims % 2 == 0
                        else self.dims)
            if self.dims % pq_m != 0:
                raise ValueError(f"dims {self.dims} not divisible by "
                                 f"pq_m={pq_m}")
            self._pq_m, self._pq_k = int(pq_m), int(pq_k)
            # cosine rides the normalized-L2 equivalence (1 - cos =
            # ||qn - vn||^2 / 2): train, encode and query all normalize
            self._pq_normalize = self.metric == DistanceMetric.COSINE
        if codes_path is not None and codes_reuse \
                and self._try_reuse(codes_path):
            return  # codes + quantizer stats loaded; no corpus pass needed
        self._train(min(int(train_rows), self.n))
        self._encode_all(codes_path)

    # ------------------------------------------------------------------
    def _new_quantizer(self, dims=None):
        from ..quant.binary import BinaryQuantizer
        from ..quant.int4 import Int4Quantizer
        from ..quant.product import ProductQuantizer
        from ..quant.scalar import ScalarQuantizer
        if self.codec == "pq":
            return ProductQuantizer(dims, m=self._pq_m, k=self._pq_k,
                                    device=self.device)
        cls = {"int8": ScalarQuantizer, "int4": Int4Quantizer,
               "binary": BinaryQuantizer}[self.codec]
        return cls(dims, device=self.device)

    def _train(self, train_rows: int) -> None:
        sample = block_sample(self.corpus, self.n, train_rows)
        if self.codec == "pq" and self._pq_normalize:
            sample = sample / np.maximum(
                np.linalg.norm(sample, axis=1, keepdims=True), 1e-30)
        self._qz = self._new_quantizer().train(sample)

    def _try_reuse(self, codes_path: str) -> bool:
        """Adopt an on-disk codes file + quantizer stats written by an
        earlier run over the same corpus; True on success."""
        if not (os.path.exists(codes_path)
                and os.path.exists(self._stats_path(codes_path))):
            return False
        codes = np.lib.format.open_memmap(codes_path, mode="r")
        if (codes.ndim != 2 or codes.shape[0] != self.n
                or codes.dtype != np.dtype(_CODE_DTYPE[self.codec])):
            return False
        self._qz = self._new_quantizer(self.dims)
        if codes.shape[1] != self._code_width() \
                or not self._load_stats(codes_path):
            return False
        self._codes = codes
        return True

    def _code_width(self) -> int:
        """Bytes (int8, int4, pq) or words (binary) of a row's codes."""
        if self.codec == "int8":
            return self.dims
        if self.codec == "pq":
            return self._pq_m
        return self._qz.n_words   # int4 / binary: packed

    def _encode_all(self, codes_path: Optional[str]) -> None:
        shape, dtype = (self.n, self._code_width()), _CODE_DTYPE[self.codec]
        if codes_path is not None:
            codes = np.lib.format.open_memmap(
                codes_path, mode="w+", dtype=dtype, shape=shape)
        else:
            codes = np.empty(shape, dtype=dtype)
        # int8 / int4 re-rank stats: ||dequant(c)||^2 and 1/||.|| per row
        # (8 host bytes a row), which the folded product needs
        needs_stats = self.codec in ("int8", "int4")
        self._vsq = np.empty((self.n,), np.float32) if needs_stats else None
        self._rinv = np.empty((self.n,), np.float32) if needs_stats else None
        for start in range(0, self.n, self.tile_rows):
            stop = min(start + self.tile_rows, self.n)
            tile_np = np.asarray(self.corpus[start:stop], dtype=np.float32)
            if self.codec == "pq":
                if self._pq_normalize:
                    tile_np = tile_np / np.maximum(np.linalg.norm(
                        tile_np, axis=1, keepdims=True), 1e-30)
                codes[start:stop] = self._qz.encode(tile_np).cpu().numpy()
                continue
            if self._encode_on == "host":
                enc_np = _host_encode_tile(self.codec, self._qz, tile_np)
                codes[start:stop] = enc_np
                if needs_stats:
                    vsq, rinv = _host_row_stats(self.codec, self._qz, enc_np)
                    self._vsq[start:stop] = vsq
                    self._rinv[start:stop] = rinv
                continue
            enc = self._qz.encode(tile_np)
            if self.codec == "binary":
                codes[start:stop] = enc.cpu().numpy().view(np.uint32)
                continue
            codes[start:stop] = enc.cpu().numpy()
            vsq, rinv = self._qz.corpus_stats(enc)
            self._vsq[start:stop] = vsq.cpu().numpy()
            self._rinv[start:stop] = rinv.cpu().numpy()
        if codes_path is not None:
            if hasattr(codes, "flush"):
                codes.flush()
            self._save_stats(codes_path)
        self._codes = codes

    def _stats_path(self, codes_path: str) -> str:
        return codes_path + ".stats.npz"

    def _save_stats(self, codes_path: str) -> None:
        payload = {"codec": self.codec}
        if self.codec in ("int8", "int4"):
            payload.update(vmin=_np(self._qz.vmin), scale=_np(self._qz.scale),
                           vsq=self._vsq, rinv=self._rinv)
        elif self.codec == "pq":
            payload.update(codebooks=_np(self._qz.codebooks))
        else:
            payload.update(thresholds=_np(self._qz.thresholds))
        np.savez(self._stats_path(codes_path), **payload)

    def _load_stats(self, codes_path: str) -> bool:
        self._vsq = self._rinv = None
        z = np.load(self._stats_path(codes_path))

        def dev(a):
            return torch.from_numpy(np.array(a, dtype=np.float32)).to(
                self.device)

        if str(z["codec"]) != self.codec:
            return False
        if self.codec in ("int8", "int4"):
            if z["vsq"].shape != (self.n,):
                return False
            self._qz.vmin, self._qz.scale = dev(z["vmin"]), dev(z["scale"])
            self._vsq = np.ascontiguousarray(z["vsq"])
            self._rinv = np.ascontiguousarray(z["rinv"])
        elif self.codec == "pq":
            cb = z["codebooks"]
            if cb.shape != (self._pq_m, self._pq_k,
                            self.dims // self._pq_m):
                return False
            self._qz.codebooks = dev(cb)
        else:
            if z["thresholds"].shape != (self.dims,):
                return False
            self._qz.thresholds = dev(z["thresholds"])
        self._qz.dims = self.dims
        return True

    # ------------------------------------------------------------------
    def tune_rerank(self, queries: np.ndarray, k: int = 10,
                    target_recall: float = 0.95,
                    max_rerank: int = 512) -> int:
        """Find (and install) the smallest rerank factor whose recall@k
        against the exact streamed path clears ``target_recall``, doubling
        from the current one.  Costs one exact streamed pass for ground
        truth plus one coarse pass a doubling; leaves ``max_rerank``
        installed (and returns it) if even that misses the target."""
        q = _as_queries(queries)
        exact = OutOfCoreSearcher(self.corpus, metric=self.metric,
                                  tile_rows=self.tile_rows,
                                  device=self.device)
        _, truth = exact.search(q, k=k)
        rr = max(self.rerank, 1)
        while True:
            _, rows = self.search(q, k=k, rerank=rr)
            rec = float(np.mean([
                len(set(a) & set(b)) / k
                for a, b in zip(rows.tolist(), truth.tolist())]))
            if rec >= target_recall or rr >= max_rerank:
                self.rerank = rr
                return rr
            rr = min(rr * 2, max_rerank)

    def _coarse_step(self, q: np.ndarray):
        """The query side of the coarse scan, computed once a search, and
        the tile step: step(tile_codes, tile_stat, tile_mask, c) -> the
        tile's top-c (vals, tile rows).  ``tile_stat`` is rinv (cosine) or
        vsq (l2) of the int8 / int4 rows, else None."""
        from ..quant.int4 import _pad_queries
        from ..quant.product import _adc, _lut
        from ..quant.scalar import _int8_rs_bias, fold_queries
        from ..quant.scan import _masked_candidates
        qz, metric = self._qz, self.metric
        qd = torch.from_numpy(q).to(self.device)
        if self.codec in ("int8", "int4"):
            if self.codec == "int8":
                rs, bias = _int8_rs_bias(qz.vmin, qz.scale)
            else:
                qd = _pad_queries(qd, 2 * qz.n_words)
                rs, bias = (qz.scale / 15.0).float(), qz.vmin
            qi, qscale, const, qstat = fold_queries(qd, rs, bias, metric)
            unpack = self.codec == "int4"

            def step(tile, stat, tmask, c):
                codes = unpack_int4(tile).to(torch.int8) if unpack else tile
                return s8_topc(qi, codes, qscale, const, qstat, stat, tmask,
                               c=c, metric=metric)
            return step
        if self.codec == "binary":
            qcodes = qz.encode(qd)

            def step(tile, stat, tmask, c):
                return _masked_candidates(hamming_mxu_scores(qcodes, tile),
                                          tmask, c=c)
            return step
        if self._pq_normalize:   # on the host, as the JAX package does
            qd = torch.from_numpy(q / np.maximum(np.linalg.norm(
                q, axis=1, keepdims=True), 1e-30)).to(self.device)
        lut = _lut(qd, qz.codebooks)                  # (B, M, K)
        kk = self._pq_k
        if kk <= 32:
            # the table sum as one bf16 product with the tile's one-hot
            # codes (the JAX package's formulation, outside any kernel)
            lut16 = lut.reshape(lut.shape[0], -1).bfloat16()
            iota = torch.arange(kk, dtype=torch.uint8, device=self.device)

        def step(tile, stat, tmask, c):
            if kk <= 32:
                onehot = (tile[..., None] == iota).to(torch.bfloat16)
                s = mm_f32(lut16, onehot.reshape(tile.shape[0], -1))
            else:
                s = _adc(lut, tile, chunk=min(16384, tile.shape[0]))
            return _masked_candidates(s, tmask, c=c)
        return step

    def search(self, queries: np.ndarray, k: int = 10,
               rerank: Optional[int] = None,
               mask: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (dists (B, k), rows (B, k)); exact re-ranked top-k."""
        t0 = time.perf_counter()
        q = _as_queries(queries)
        b = q.shape[0]
        kk = min(k, self.n)
        c = min(max(kk * (rerank or self.rerank), kk), self.n)
        step = self._coarse_step(q)
        t = min(self.tile_rows, self.n)
        width = self._codes.shape[1]
        stat = None
        if self.codec in ("int8", "int4") and self.metric != DistanceMetric.DOT:
            stat = self._rinv if self.metric == DistanceMetric.COSINE \
                else self._vsq
        specs = [((t, width), _TILE_DTYPE[self.codec])]
        if stat is not None:
            specs.append(((t,), torch.float32))
        if mask is not None:
            specs.append(((t,), torch.bool))
        stager = TileStager(streams_for(self.device), specs)
        best = None
        for start in range(0, self.n, t):
            stop = min(start + t, self.n)
            parts = [np.asarray(self._codes[start:stop])]
            if self.codec == "binary":
                parts[0] = parts[0].view(np.int32)
            if stat is not None:
                parts.append(stat[start:stop])
            if mask is not None:
                parts.append(mask[start:stop])

            def fill(*views):
                for v, p in zip(views, parts):
                    v.copy_(_host_tensor(p))

            dv = stager.stage(stop - start, fill)
            tile = dv[0]
            tstat = dv[1] if stat is not None else None
            tmask = dv[-1] if mask is not None else None
            vals, rows = step(tile, tstat, tmask, min(c, stop - start))
            best = _merge(best, vals, rows + start, c)
        self.last_link_bytes = stager.bytes
        cvals = best[0].cpu().numpy()
        crows = best[1].cpu().numpy()
        self.last_coarse_s = time.perf_counter() - t0
        # exact re-rank: gather candidate f32 rows from the host corpus in
        # sorted order (one ascending pass; memmaps reward locality), then
        # scatter them back per query
        safe = np.clip(crows, 0, self.n - 1)
        flat = safe.reshape(-1)
        order = np.argsort(flat, kind="stable")
        gathered = np.asarray(self.corpus[flat[order]], dtype=np.float32)
        cand = np.empty_like(gathered)
        cand[order] = gathered
        cand = cand.reshape(b, c, self.dims)
        ok = cvals < MASKED * 0.5  # masked coarse picks: clipped rows lie
        if mask is not None:
            ok &= np.take(mask, safe)
        dists = host_exact_scores(q, cand, self.metric)
        dists = np.where(ok, dists, np.inf)
        top = np.argsort(dists, axis=1)[:, :kk]
        return (np.take_along_axis(dists, top, axis=1),
                np.take_along_axis(safe, top, axis=1).astype(np.int32))
