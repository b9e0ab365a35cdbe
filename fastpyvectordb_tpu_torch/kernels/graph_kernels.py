"""The graph index's beam rounds (``ann/graph_ann.py``'s search).

Two versions of the same rounds:

  * the hand-written CUDA kernel in ``csrc/graph_beam.cu``
    (``fpv_graph_beam``): every round of a search in one launch, one thread
    block a query, the beam and its merges in shared memory;
  * a plain PyTorch version (``graph_beam_plain``): the rounds as a Python
    loop of small ops, ~59 launches a round on the card.

It replaces no Pallas kernel: the JAX package runs the rounds as a
``lax.scan`` of XLA ops (``fastpyvectordb_tpu/ann/graph_ann.py``).  On the
card a search at one query is bound by the T dependent rounds of row
gathers (each round's rows are known only once the last one has sorted):
the plain loop spent them launching, the kernel waits only on memory, and
reads each gathered row once (the plain version reads it twice, once for
its norm and once for the cross term).

The wrapper runs the plain rounds on the CPU, and on the card launches
the kernel for every search whose shapes it takes (``kernel_takes``):
1 <= W, E <= W and W + E x R <= ``MAX_ENTRIES`` (5,120: the merge ranks
W + E x R keys in shared memory, so a beam widened to 4,096 by
``k > beam``, or by a filter's ``k x overfetch``, fits with E x R up to
1,024); f32, bf16 or f16 rows; f32 or bf16 compute; any B, D and metric.
A search on the card past that rule raises ``ValueError``: the plain
rounds never run on CUDA tensors.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..core.types import DistanceMetric
from ..profiling import annotate
from .cuda_build import CudaSource, I, P, current_stream
from .distances import MASKED
from .ivf_kernels import bmm_f32
from .quant_kernels import METRIC_CODE, check_cuda

LAUNCHES = {"graph_beam": 0}

MAX_ENTRIES = 5120      # W + E x R: the merge's keys in shared memory
# the rows' dtype -> the kernel's code for it
_STORE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_COMPUTE = ("float32", "bfloat16")
SOURCE = CudaSource("graph_beam", {"fpv_graph_beam": [P] * 7 + [I] * 11
                                   + [P]})

_MASKED = float(MASKED)


def _scores_vs_rows(q: torch.Tensor, vecs: torch.Tensor, metric,
                    compute_dtype: str) -> torch.Tensor:
    """q (B, D) f32, vecs (B, C, D) any dtype -> (B, C) f32 scores (lower =
    closer), in the norm-expansion form.  The rows' squared norms are
    summed in f32 from the gathered rows in their storage dtype; the cross
    term is an f32-output batched product of ``compute_dtype`` operands,
    never rounded to bf16."""
    metric = DistanceMetric.parse(metric)
    cd = getattr(torch, compute_dtype)
    qf = q.float()
    b, c, d = vecs.shape
    flat = vecs.reshape(b * c, 1, d)
    vsq = bmm_f32(flat, flat).reshape(b, c)
    cross = bmm_f32(qf.to(cd)[:, None, :], vecs.to(cd))[:, 0, :]
    if metric == DistanceMetric.COSINE:
        qinv = 1.0 / torch.clamp(torch.linalg.norm(qf, dim=1, keepdim=True),
                                 min=1e-30)
        rinv = torch.rsqrt(torch.clamp(vsq, min=1e-30))
        return 1.0 - cross * qinv * rinv
    if metric == DistanceMetric.L2:
        qsq = (qf * qf).sum(dim=1)
        return torch.clamp(qsq[:, None] + vsq - 2.0 * cross, min=0.0)
    return -cross


def _ascending(s: torch.Tensor, n: int) -> torch.Tensor:
    """Positions of the ``n`` smallest entries of each row, ties to the
    lower position (``lax.top_k`` of the negated scores)."""
    return torch.argsort(s, dim=1, stable=True)[:, :n]


def kernel_takes(vectors: torch.Tensor, beam: int, expand: int, r: int,
                 compute_dtype: str) -> bool:
    """Whether ``fpv_graph_beam`` takes a search of these shapes: the rule
    of the module docstring, from shapes and dtypes alone."""
    return (1 <= beam and 0 <= expand <= beam
            and beam + expand * r <= MAX_ENTRIES
            and vectors.dtype in _STORE and compute_dtype in _COMPUTE)


def graph_beam_plain(q: torch.Tensor, vectors: torch.Tensor,
                     neighbors: torch.Tensor, init_ids: torch.Tensor,
                     init_live: torch.Tensor, *, beam: int, expand: int,
                     iters: int, metric, compute_dtype: str
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ``graph_beam``: the entry points' scores, then ``iters``
    rounds, each a chain of small ops; every selection a stable ascending
    sort (ties as ``lax.top_k``), the dedup key int64."""
    metric = DistanceMetric.parse(metric)
    b, e0 = init_ids.shape
    r = neighbors.shape[1]
    w = beam
    qf = q.float()

    def gather_scores(rows):  # (B, C) int64 -> (B, C) f32
        s = _scores_vs_rows(qf, vectors[rows.clamp(min=0)], metric,
                            compute_dtype)
        # tombstoned targets are already -1 in the neighbour table
        return torch.where(rows >= 0, s, _MASKED)

    init_ids = init_ids.long()
    init_scores = torch.where(init_live, gather_scores(init_ids), _MASKED)
    ids = F.pad(init_ids, (0, w - e0), value=-1)
    scores = F.pad(init_scores, (0, w - e0), value=_MASKED)
    expanded = torch.zeros((b, w), dtype=torch.bool, device=q.device)
    fresh = torch.zeros((b, expand * r), dtype=torch.bool, device=q.device)
    first = torch.zeros((b, 1), dtype=torch.bool, device=q.device)
    invalid_key = 2 * neighbors.shape[0] + 2
    for _ in range(iters):
        # pick the E best unexpanded entries and mark them expanded
        sel = torch.where(expanded | (ids < 0), _MASKED, scores)
        pos = _ascending(sel, expand)                    # (B, E)
        exp_ids = ids.gather(1, pos)
        expanded = expanded.scatter(1, pos, True)
        # gather neighbour lists; invalid expansion rows contribute nothing
        nb = neighbors[exp_ids.clamp(min=0)].long()      # (B, E, R)
        cand = torch.where((exp_ids < 0)[:, :, None], -1, nb).reshape(
            b, expand * r)
        cand_scores = gather_scores(cand)
        # merge beam + candidates
        all_ids = torch.cat([ids, cand], dim=1)
        all_scores = torch.cat([scores, cand_scores], dim=1)
        all_exp = torch.cat([expanded, fresh], dim=1)
        # dedup by id: composite key 2*id + (1 - expanded), so the expanded
        # copy of a node sorts first and survives (int64: no overflow)
        real = (all_ids >= 0) & (all_scores < _MASKED * 0.5)
        id_key = torch.where(real, all_ids * 2 + (~all_exp).long(),
                             invalid_key)
        order = torch.argsort(id_key, dim=1, stable=True)
        s_ids = all_ids.gather(1, order)
        s_scores = all_scores.gather(1, order)
        s_exp = all_exp.gather(1, order)
        dup = torch.cat([first, s_ids[:, 1:] == s_ids[:, :-1]], dim=1)
        s_scores = torch.where(dup, _MASKED, s_scores)
        # keep the best W by score
        keep = _ascending(s_scores, w)
        ids = s_ids.gather(1, keep)
        scores = s_scores.gather(1, keep)
        expanded = s_exp.gather(1, keep)
        ids = torch.where(scores >= _MASKED * 0.5, -1, ids)
    return ids.int(), scores


def _launch(q, vectors, neighbors, init_ids, init_live, w, expand, iters,
            metric, compute_dtype):
    b, d = q.shape
    n, r = neighbors.shape
    e0 = init_ids.shape[1]
    check_cuda("q", torch.float32, q, (b, d))
    check_cuda("vectors", vectors.dtype, vectors, (vectors.shape[0], d))
    check_cuda("neighbors", torch.int32, neighbors, (n, r))
    check_cuda("init_ids", torch.int32, init_ids, (b, e0))
    check_cuda("init_live", torch.bool, init_live, (b, e0))
    dev = vectors.device
    if any(t.device != dev for t in (q, neighbors, init_ids, init_live)):
        raise ValueError("graph_beam: operands on different devices")
    if e0 > w:
        raise ValueError(f"graph_beam: {e0} entry points past a beam of {w}")
    # one allocation for both outputs: (ids, scores' bits)
    out = torch.empty((2, b, w), dtype=torch.int32, device=dev)
    ids, scores = out[0], out[1].view(torch.float32)
    if b == 0:
        return ids, scores
    lib = SOURCE.load()

    def launch():
        return lib.fpv_graph_beam(
            q.data_ptr(), vectors.data_ptr(), neighbors.data_ptr(),
            init_ids.data_ptr(), init_live.data_ptr(), ids.data_ptr(),
            scores.data_ptr(), b, d, n, r, e0, w, expand, iters,
            METRIC_CODE[metric], _STORE[vectors.dtype],
            int(compute_dtype == "bfloat16"), current_stream(dev))

    # a one-query search pays each microsecond here: enter the device's
    # context only where it is not the current one
    if dev.index == torch.cuda.current_device():
        rc = launch()
    else:
        with torch.cuda.device(dev):
            rc = launch()
    if rc != 0:
        raise RuntimeError(f"graph_beam launch failed: CUDA error {rc}")
    LAUNCHES["graph_beam"] += 1
    return ids, scores


def graph_beam(q: torch.Tensor, vectors: torch.Tensor,
               neighbors: torch.Tensor, init_ids: torch.Tensor,
               init_live: torch.Tensor, *, beam: int, expand: int, iters: int,
               metric, compute_dtype: str
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The beam after ``iters`` rounds: (ids (B, beam) int32, -1 where
    empty; scores (B, beam) f32, ``MASKED`` where empty), in the order the
    search's finish takes.

    q (B, D) f32; vectors (cap, D) the store; neighbors (N, R) int32 with
    tombstoned targets already -1; init_ids (B, e0) int32 the routed entry
    points and init_live (B, e0) bool their liveness (e0 <= beam).  On
    the card, shapes past ``kernel_takes`` raise ``ValueError``."""
    metric = DistanceMetric.parse(metric)
    if not vectors.is_cuda:
        return graph_beam_plain(q, vectors, neighbors, init_ids, init_live,
                                beam=beam, expand=expand, iters=iters,
                                metric=metric, compute_dtype=compute_dtype)
    r = neighbors.shape[1]
    if not kernel_takes(vectors, beam, expand, r, compute_dtype):
        raise ValueError(
            f"graph search on the card: beam W {beam}, expand E {expand}, "
            f"degree R {r}, {vectors.dtype} rows, {compute_dtype} compute; "
            f"the beam kernel takes 1 <= W, E <= W, W + E x R <= "
            f"{MAX_ENTRIES}, f32 / bf16 / f16 rows and f32 / bf16 compute "
            "(a k past the beam widens W to the power of two >= k, or "
            ">= k x overfetch under a filter)")
    with annotate("fpv.kernel.graph_beam"):
        return _launch(q.float().contiguous(), vectors, neighbors,
                       init_ids.int().contiguous(), init_live.contiguous(),
                       beam, expand, iters, metric, compute_dtype)
