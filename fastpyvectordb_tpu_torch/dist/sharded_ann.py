"""Multi-card ANN and quantized search (port of
``fastpyvectordb_tpu/dist/sharded_ann.py``).

The exact sharded scan (dist/sharded.py) row-shards the raw corpus; this
module shards the index structures themselves:

  * **ShardedIVF** — the IVF cell tensor (nlist, cmax, D), row table and
    centroids are split along the cell axis.  Every shard routes each query
    within its own centroids (probing ``ceil(nprobe/ndev)`` cells, doubled
    for recall headroom since the global best cells may cluster on one
    shard), scores its probed cells — large batches cell-major through
    ``ann/ivf_grouped.py grouped_cell_candidates``, which runs the
    ``grouped_cell_scores`` (bf16 cells) or ``grouped_cell_scores_i8``
    (int8 cells) kernel — and the per-shard top-k partials are
    all-gathered and merged; the row table holds *global* row ids.  With
    ``rerank > 0`` the merged candidates are re-scored exactly against the
    row-sharded corpus and assembled with ``pmin``.
  * **ShardedIVFPQ** — cell-sharded ADC scoring (cell-major through the
    ``grouped_cell_scores_pq`` kernel for large batches), merged
    candidates, and the row-sharded exact re-rank.
  * **ShardedInt8** — the int8 (or packed int4) codes, row stats and the
    re-rank corpus are row-sharded.  Each shard runs the single-card
    two-stage route: one fused ``s8_topc`` scan (int8) or ``int4_scores``
    plus ``torch.topk`` (int4), then the gather and exact re-rank of its
    own candidates; only the (B, k) partials are merged.

The merges go through ``dist/collectives.py``: the same body runs over the
shards of one process and over ``torch.distributed``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.types import DistanceMetric
from ..kernels.distances import MASKED, corpus_stats, mm_f32, smallest_k
from ..kernels.ivf_kernels import bmm_f32
from ..kernels.topk import merge_top_k
from .mesh import (DATA_AXIS, Mesh, ShardedArray, as_tensor as _t,
                   on_devices, replicate, shard_blocks)


def _interleave_overflow(ndev, mains, extras, pad_values):
    """Lay out per-shard overflow cells so block sharding works.

    Splitting the cell axis into ``ndev`` contiguous blocks would strand
    overflow cells appended at the end on the last shard.  This interleaves
    them: each tensor in ``mains`` (leading axis nlist0) is re-laid-out to
    leading axis ``ndev*(bs+1)`` with per-shard blocks of ``bs`` main cells
    followed by exactly one overflow cell from ``extras`` (leading axis
    ndev).  Returns ``(outs, cent_valid, cent_boost)`` where cent_boost
    marks the one always-probed overflow cell per shard."""
    nlist0 = mains[0].shape[0]
    bs = -(-nlist0 // ndev)
    outs = []
    for a, e, pv in zip(mains, extras, pad_values):
        a, e = _t(a), _t(e).to(_t(a).device)
        out = torch.full((ndev * (bs + 1),) + tuple(a.shape[1:]), pv,
                         dtype=a.dtype, device=a.device)
        for i in range(ndev):
            blk = a[i * bs:(i + 1) * bs]
            out[i * (bs + 1):i * (bs + 1) + blk.shape[0]] = blk
            out[i * (bs + 1) + bs] = e[i]
        outs.append(out)
    cent_valid = torch.zeros(ndev * (bs + 1), dtype=torch.bool)
    cent_boost = torch.zeros(ndev * (bs + 1), dtype=torch.bool)
    for i in range(ndev):
        n_real = max(0, min(bs, nlist0 - i * bs))
        cent_valid[i * (bs + 1):i * (bs + 1) + n_real] = True
        cent_valid[i * (bs + 1) + bs] = True
        cent_boost[i * (bs + 1) + bs] = True
    return outs, cent_valid, cent_boost


def _merge_over_data_axis(coll, g, vals, gidx, k, *, sqrt_l2=False):
    """All-gather per-shard (B, kk) partials and take the global top-k."""
    vals_g = coll.all_gather(g, vals)                  # (ndev, B, kk)
    idx_g = coll.all_gather(g, gidx)
    out_vals, rows = merge_top_k(vals_g, idx_g,
                                 min(k, vals_g.shape[0] * vals_g.shape[2]))
    if sqrt_l2:
        out_vals = torch.where(out_vals >= float(MASKED), out_vals,
                               torch.sqrt(torch.clamp(out_vals, min=0.0)))
    return out_vals, rows


def _metric_scores(metric, cross, vsq, qsq, qinv, *, sqrt_l2: bool):
    """Scores from a cross term and squared norms; qsq / qinv (B, 1)."""
    if metric == DistanceMetric.COSINE:
        return 1.0 - cross * qinv * torch.rsqrt(torch.clamp(vsq, min=1e-30))
    if metric == DistanceMetric.L2:
        d2 = torch.clamp(qsq + vsq - 2.0 * cross, min=0.0)
        return torch.sqrt(d2) if sqrt_l2 else d2
    return -cross


def _qstats(qf):
    qsq = (qf * qf).sum(dim=1, keepdim=True)
    return qsq, 1.0 / torch.clamp(torch.sqrt(qsq), min=1e-30)


# rows x candidates x dims of one re-rank gather (bounds its transient)
_RERANK_ELEMS = 1 << 28


def _exact_own(qf, grows, gok, vectors, lo, metric, cd):
    """The exact metric of the merged candidates this shard owns (rows
    ``lo .. lo + shard_rows``), ``MASKED`` elsewhere: the phase whose
    per-shard results a ``pmin`` assembles.  Query blocks keep the gather
    of (B, cg, D) candidate rows bounded."""
    shard_rows = vectors.shape[0]
    b, cg = grows.shape
    d = vectors.shape[1]
    out = torch.empty((b, cg), dtype=torch.float32, device=qf.device)
    step = max(1, _RERANK_ELEMS // max(cg * d, 1))
    for s in range(0, b, step):
        gr = grows[s:s + step]
        own = (gr >= lo) & (gr < lo + shard_rows) & gok[s:s + step]
        lrow = torch.clamp(gr - lo, 0, shard_rows - 1)
        cv = vectors[lrow]                                 # (b', cg, D)
        vsq = (cv.float() ** 2).sum(dim=2)
        q = qf[s:s + step]
        cross = bmm_f32(q.to(cd)[:, None, :], cv.to(cd))[:, 0, :]
        qsq, qinv = _qstats(q)
        es = _metric_scores(metric, cross, vsq, qsq, qinv, sqrt_l2=True)
        out[s:s + step] = es.masked_fill_(~own, float(MASKED))
    return out


def _exact_rows(qf, rows, ok, vectors, lo, metric, cd):
    """``_exact_own`` for one row list every query shares (the overflow
    rows): one (B, D) x (L, D) product instead of a per-query gather."""
    shard_rows = vectors.shape[0]
    own = (rows >= lo) & (rows < lo + shard_rows) & ok
    cv = vectors[torch.clamp(rows - lo, 0, shard_rows - 1)]     # (L, D)
    vsq = (cv.float() ** 2).sum(dim=1)
    qsq, qinv = _qstats(qf)
    es = _metric_scores(metric, mm_f32(qf.to(cd), cv.to(cd)), vsq[None, :],
                        qsq, qinv, sqrt_l2=True)
    return es.masked_fill_(~own[None, :], float(MASKED))


def _shard_tensor(mesh, a, rows=None) -> ShardedArray:
    return shard_blocks(mesh, _t(a), rows)


def _first_row(mesh) -> int:
    """ANN searches take the whole batch in one query row: the query axis
    of a 2-D mesh only holds replicas for them (the JAX package's
    replicated query spec)."""
    return mesh.local_rows()[0]


# ---------------------------------------------------------------------------
# Sharded IVF
# ---------------------------------------------------------------------------

def build_sharded_ivf_search(mesh: Mesh, *, metric: DistanceMetric, k: int,
                             nprobe_local: int,
                             compute_dtype: str = "bfloat16",
                             allow_grouped: bool = True,
                             has_boost: bool = False,
                             rerank: int = 0,
                             shard_rows: int = 1):
    """The sharded IVF search: ``fn(q, centroids, cells, row_table,
    cent_valid, cent_boost, ok_cells, vmin, scale, cell_norms, vectors,
    overflow=None)`` -> ``(dists (B, k), rows (B, k), dropped)``.  Cell-axis
    tensors are ``ShardedArray``s, vmin / scale ``Replicated``, vectors
    row-sharded; ``overflow`` (vecs, norms, rows, ok), row-split a block a
    shard, are overflow rows each shard scans exactly for every query
    beside its boost cell (``ShardedIVF.from_index`` puts them there
    rather than widen every cell to the boost cell's width).
    With ``rerank > 0`` the merged quantized top ``rerank * k`` is re-scored
    exactly against the row-sharded corpus: each shard scores the
    candidates it owns, the others report ``MASKED``, and a ``pmin``
    assembles the exact scores (int8 cell scores scramble the top-k order
    without it)."""
    from ..ann.ivf_grouped import (grouped_cell_candidates, grouped_qcap,
                                   probe_cells)
    metric = DistanceMetric.parse(metric)
    cd = getattr(torch, compute_dtype)
    coll = mesh.collectives
    # local candidates kept per shard before the merge
    c_sel = k if rerank <= 0 else max(k, k * rerank)

    def route(qf, centroids, cent_valid, cent_boost):
        if metric == DistanceMetric.COSINE:
            qn = qf / torch.clamp(torch.linalg.norm(qf, dim=1, keepdim=True),
                                  min=1e-30)
            cn = centroids / torch.clamp(
                torch.linalg.norm(centroids, dim=1, keepdim=True), min=1e-30)
            croute = -(qn @ cn.T)
        elif metric == DistanceMetric.DOT:
            croute = -(qf @ centroids.T)
        else:
            csq = (centroids * centroids).sum(dim=1)
            croute = csq[None, :] - 2.0 * (qf @ centroids.T)
        croute = croute.masked_fill_(~cent_valid[None, :], float(MASKED))
        # overflow cells are ALWAYS probed on the shard that owns them
        # (the single-card index scans overflow exactly on every query)
        return croute.masked_fill_(cent_boost[None, :], -float(MASKED))

    def block_scores(qf, vecs, norms, ok, vmin, scale, sqrt_l2):
        """Exact scores of a block of rows (L, D) for every query: the
        shard's always-probed overflow cell, or its overflow rows."""
        if vecs.dtype == torch.int8:
            rs = scale / 255.0
            const = qf @ (128.0 * rs + vmin)
            cross = mm_f32((qf * rs[None, :]).to(cd), vecs.to(cd)) \
                + const[:, None]
        else:
            cross = mm_f32(qf.to(cd), vecs)
        qsq, qinv = _qstats(qf)
        s = _metric_scores(metric, cross, norms[None, :], qsq, qinv,
                           sqrt_l2=sqrt_l2)
        return s.masked_fill_(~ok[None, :], float(MASKED))

    def local(qf, centroids, cells, row_table, cent_valid, cent_boost,
              ok_cells, vmin, scale, cell_norms, ovf):
        b, d = qf.shape
        cmax = cells.shape[1]
        croute = route(qf, centroids, cent_valid, cent_boost)
        nlist_l = centroids.shape[0]
        npl = min(nprobe_local, nlist_l)
        zero = torch.zeros((), dtype=torch.int64, device=qf.device)
        # large batches go cell-major within the shard, as the single-card
        # auto-dispatch does: each local cell is read once per batch
        if allow_grouped and b * npl >= nlist_l:
            # the per-query path spends one probe slot on the boost cell;
            # the grouped branch scans that cell separately below, so it
            # probes one fewer normal cell to keep the candidates alike
            npl_g = max(1, npl - 1) if has_boost else npl
            qcap = grouped_qcap(b, npl_g, nlist_l, cmax)
            # the boost cell would be probed by EVERY query and saturate
            # qcap: route it as inf (past even the MASKED padding cells;
            # the construction guard nprobe_local < local cells keeps it
            # unprobed) and scan it exactly for all queries instead
            croute_nb = croute.masked_fill(cent_boost[None, :],
                                           float("inf"))
            cand_vals, cand, dropped = grouped_cell_candidates(
                qf, croute_nb, cells, row_table, ok_cells, vmin, scale,
                cell_norms, metric=metric, nprobe=npl_g, qcap=int(qcap))
            # the boost cell, exactly (without a boost cell the block is all
            # MASKED, as in the JAX package, where it then fills the slots
            # no candidate takes), then the shard's overflow rows
            cand_vals = torch.cat([cand_vals, block_scores(
                qf, cells[-1], cell_norms[-1], ok_cells[-1] & cent_boost[-1],
                vmin, scale, False)], dim=1)
            cand = torch.cat([cand.long(),
                              row_table[-1][None].expand(b, cmax).long()],
                             dim=1)
            if ovf is not None:
                cand_vals = torch.cat([cand_vals, block_scores(
                    qf, ovf[0], ovf[1], ovf[3], vmin, scale, False)], dim=1)
                cand = torch.cat([cand, ovf[2][None].expand(
                    b, ovf[2].shape[0]).long()], dim=1)
            vals, pos = smallest_k(cand_vals, min(c_sel, cand_vals.shape[1]))
            if metric == DistanceMetric.L2:    # candidates are squared
                vals = torch.where(vals >= float(MASKED) * 0.5, vals,
                                   torch.sqrt(torch.clamp(vals, min=0.0)))
            return (vals, torch.take_along_dim(cand, pos, dim=1),
                    dropped.to(torch.int64))
        probe = probe_cells(croute, npl)                  # (B, npl) local
        vecs = cells[probe].reshape(b, npl * cmax, d)
        cand = row_table[probe].reshape(b, -1).long()     # global ids
        ok = ok_cells[probe].reshape(b, -1)
        qsq, qinv = _qstats(qf)
        if cells.dtype == torch.int8:
            # int8 cells: codes stay codes, dequantised norms
            rs = scale / 255.0
            const = qf @ (128.0 * rs + vmin)
            cross = bmm_f32((qf * rs[None, :]).to(cd)[:, None, :],
                            vecs.to(cd))[:, 0, :] + const[:, None]
            vsq = cell_norms[probe].reshape(b, -1)
        else:
            vsq = (vecs.float() ** 2).sum(dim=2)
            cross = bmm_f32(qf.to(cd)[:, None, :], vecs.to(cd))[:, 0, :]
        s = _metric_scores(metric, cross, vsq, qsq, qinv, sqrt_l2=True)
        s = s.masked_fill_(~ok, float(MASKED))
        if ovf is not None:   # the boost cell is always probed here
            s = torch.cat([s, block_scores(qf, ovf[0], ovf[1], ovf[3], vmin,
                                           scale, True)], dim=1)
            cand = torch.cat([cand, ovf[2][None].expand(
                b, ovf[2].shape[0]).long()], dim=1)
        vals, pos = smallest_k(s, min(c_sel, s.shape[1]))
        return vals, torch.take_along_dim(cand, pos, dim=1), zero

    def fn(q, centroids, cells, row_table, cent_valid, cent_boost, ok_cells,
           vmin, scale, cell_norms, vectors, overflow=None):
        g = _first_row(mesh)
        qfs = on_devices(_t(q).float(), mesh, g)
        parts = []
        for j in coll.axis_index(g):
            dev = qfs[j].device
            parts.append(local(
                qfs[j], centroids.block(g, j), cells.block(g, j),
                row_table.block(g, j), cent_valid.block(g, j),
                cent_boost.block(g, j), ok_cells.block(g, j), vmin.on(dev),
                scale.on(dev), cell_norms.block(g, j),
                None if overflow is None
                else [a.block(g, j) for a in overflow]))
        dropped = coll.psum(g, [p[2] for p in parts])
        if rerank <= 0:
            dv, dr = _merge_over_data_axis(coll, g, [p[0] for p in parts],
                                           [p[1] for p in parts], k)
            return dv, dr, dropped
        gv, grows = _merge_over_data_axis(coll, g, [p[0] for p in parts],
                                          [p[1] for p in parts], c_sel)
        es = coll.pmin(g, [
            _exact_own(qfs[j], grows.to(qfs[j].device),
                       ((grows >= 0) & (gv < float(MASKED) * 0.5)).to(
                           qfs[j].device),
                       vectors.block(g, j), j * shard_rows, metric, cd)
            for j in coll.axis_index(g)])
        vals, pos = smallest_k(es, min(k, grows.shape[1]))
        return vals, torch.take_along_dim(grows, pos, dim=1), dropped

    return fn


class ShardedIVF:
    """A single-card IVFIndex re-laid-out across a mesh."""

    def __init__(self, mesh: Mesh, centroids, cells, row_table, cent_valid,
                 validmask, vmin=None, scale=None, cell_norms=None,
                 cent_boost=None, vectors=None, *,
                 metric: DistanceMetric, nprobe: int,
                 compute_dtype: str = "bfloat16", rerank: int = 0,
                 overflow=None):
        """``overflow``: optional (vecs (ndev*per, D) in the cells' dtype,
        dequantised squared norms (ndev*per,), global rows (ndev*per,), -1
        padding), ``per`` rows a shard, scanned exactly by their shard for
        every query (each shard must have its boost cell)."""
        self.mesh = mesh
        self.metric = DistanceMetric.parse(metric)
        self.nprobe = nprobe
        self.compute_dtype = compute_dtype
        ndev = mesh.shape[DATA_AXIS]
        centroids, cells, row_table = _t(centroids), _t(cells), _t(row_table)
        cent_valid = _t(cent_valid).bool()
        local_cells = centroids.shape[0] // ndev
        # 2x headroom: the global best-nprobe cells may cluster on one shard
        self.nprobe_local = max(1, min(-(-nprobe // ndev) * 2, local_cells))
        cb = (torch.zeros(cent_valid.shape, dtype=torch.bool)
              if cent_boost is None else _t(cent_boost).bool().cpu())
        if cb.any():
            # the always-probed overflow cell eats one probe slot per
            # shard; keep at least one slot for normal routing
            self.nprobe_local = min(local_cells, max(2, self.nprobe_local))
        # the grouped branch needs each shard's boost cell at its LAST local
        # position and a free probe slot, so that the excluded boost cell
        # can never be picked by the grouped router
        bpos = torch.nonzero(cb).reshape(-1)
        self._allow_grouped = bool(
            (not cb.any())
            or (((bpos % local_cells) == local_cells - 1).all()
                and bpos.numel() == ndev
                and self.nprobe_local < local_cells))
        self.has_boost = bool(cb.any())
        shard = lambda a: _shard_tensor(mesh, a)  # noqa: E731
        self.centroids = shard(centroids.float())
        self.cells = shard(cells)
        self.row_table = shard(row_table)
        self.cent_valid = shard(cent_valid)
        self.cent_boost = shard(cb)
        # per-slot liveness, once: the layout is an immutable snapshot
        vm = _t(validmask).bool().to(row_table.device)
        self.ok_cells = shard((row_table >= 0)
                              & vm[torch.clamp(row_table, min=0).long()])
        d = centroids.shape[1]
        self.vmin = replicate(mesh, (_t(vmin) if vmin is not None
                                     else torch.zeros((d,))).float())
        self.scale = replicate(mesh, (_t(scale) if scale is not None
                                      else torch.ones((d,))).float())
        if cell_norms is None:
            if cells.dtype == torch.int8:
                # norms of raw codes would silently skew every distance
                raise ValueError(
                    "int8 cells require the dequantized cell_norms")
            nl, cmax = row_table.shape
            sq = corpus_stats(cells.reshape(-1, d))["sq"].reshape(nl, cmax)
            cell_norms = torch.where(row_table >= 0, sq, 0.0)
        self.cell_norms = shard(_t(cell_norms).float())
        self.overflow = None
        if overflow is not None:
            if bpos.numel() != ndev:
                raise ValueError("overflow rows need one boost cell a shard")
            ovecs, onorms, orows = (_t(a) for a in overflow)
            ook = (orows >= 0) & vm.to(orows.device)[
                torch.clamp(orows, min=0).long()]
            self.overflow = [shard(ovecs), shard(onorms.float()),
                             shard(orows), shard(ook)]
        # the exact re-rank corpus, row-sharded
        if rerank > 0 and vectors is None:
            raise ValueError("rerank > 0 requires the re-rank corpus")
        self.rerank = int(rerank)
        if vectors is not None:
            vectors = _t(vectors)
            pad = (-vectors.shape[0]) % ndev
            if pad:
                vectors = torch.nn.functional.pad(vectors, (0, 0, 0, pad))
            self.shard_rows = vectors.shape[0] // ndev
            self.vectors = shard(vectors)
        else:
            self.shard_rows = 1
            # unused placeholder (rerank == 0 never reads it)
            self.vectors = shard(torch.zeros((ndev, d)))
        self.last_dropped = 0

    @classmethod
    def from_index(cls, mesh: Mesh, ivf, validmask=None) -> "ShardedIVF":
        """Shard an ann.ivf.IVFIndex's tables across ``mesh``.

        The cell axis is padded to a multiple of the data-axis size; padded
        centroids are masked out of routing (``cent_valid``).  Overflow rows
        are interleaved as one always-probed extra cell per shard block
        (``cent_boost``), as the single-card index scans overflow exactly
        on every query."""
        ndev = mesh.shape[DATA_AXIS]
        centroids = ivf.centroids.float()
        cells = ivf.cells
        table = ivf.row_table
        quantized = ivf.quantizer is not None
        # the index's per-slot norms (dequantised for int8 cells)
        norms = ivf._cell_norms_cached()
        nlist, cmax, d = cells.shape
        dev = cells.device
        pad = (-nlist) % ndev
        orows_all = ivf.overflow_rows
        keep = orows_all >= 0
        orows = orows_all[keep]
        ovecs_all = ivf.overflow_vecs.float()[keep]
        cent_boost = None
        overflow = None
        if orows.numel():
            # one always-probed boost cell a shard, interleaved into each
            # shard's contiguous block (block sharding would strand
            # appended cells on the last shard).  The JAX package writes a
            # shard's overflow rows into its boost cell and widens every
            # cell to fit them; here the boost cells stay empty and the
            # rows ride beside the cells, ``per`` a shard, scanned exactly
            # as the boost cell is (at 1M rows and 37,848 overflow rows the
            # widening took cmax from 640 to 9,462)
            per = -(-orows.numel() // ndev)
            if quantized:
                # int8 cells: ENCODE the f32 overflow rows (a raw write of
                # floats into int8 would truncate them to garbage)
                from ..quant.scalar import _dequant, _encode, row_stats
                qz = ivf.quantizer
                ovecs = _encode(ovecs_all, qz.vmin, qz.scale)
                onorms = row_stats(ovecs, qz.vmin, qz.scale, _dequant)[0]
            else:
                ovecs = ovecs_all.to(cells.dtype)
                onorms = (ovecs_all * ovecs_all).sum(dim=1)
            tail = ndev * per - orows.numel()
            F = torch.nn.functional
            overflow = (F.pad(ovecs, (0, 0, 0, tail)), F.pad(onorms, (0, tail)),
                        F.pad(orows, (0, tail), value=-1))
            empty = [centroids.mean(dim=0, keepdim=True).expand(ndev, d),
                     torch.zeros((ndev, cmax, d), dtype=cells.dtype,
                                 device=dev),
                     torch.zeros((ndev, cmax), device=dev),
                     torch.full((ndev, cmax), -1, dtype=table.dtype,
                                device=dev)]
            (centroids, cells, norms, table), cent_valid, cent_boost = \
                _interleave_overflow(ndev, [centroids, cells, norms, table],
                                     empty, [0, 0, 0, -1])
        else:
            if pad:
                centroids = torch.nn.functional.pad(centroids, (0, 0, 0, pad))
                cells = torch.nn.functional.pad(cells, (0, 0, 0, 0, 0, pad))
                norms = torch.nn.functional.pad(norms, (0, 0, 0, pad))
                table = torch.nn.functional.pad(table, (0, 0, 0, pad),
                                                value=-1)
            cent_valid = torch.ones((centroids.shape[0],), dtype=torch.bool)
            if pad:
                cent_valid[-pad:] = False
        store = ivf._collection._store
        vm = store.valid if validmask is None else _t(validmask)
        cfg = ivf._collection.config
        rr = int(getattr(ivf, "rerank", 0))
        return cls(mesh, centroids, cells, table, cent_valid, vm,
                   vmin=ivf.quantizer.vmin if quantized else None,
                   scale=ivf.quantizer.scale if quantized else None,
                   cell_norms=norms, cent_boost=cent_boost,
                   vectors=store.vectors if rr > 0 else None,
                   metric=cfg.metric, nprobe=ivf.nprobe,
                   compute_dtype=cfg.compute_dtype, rerank=rr,
                   overflow=overflow)

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        fn = build_sharded_ivf_search(
            self.mesh, metric=self.metric, k=k,
            nprobe_local=self.nprobe_local, compute_dtype=self.compute_dtype,
            allow_grouped=self._allow_grouped, has_boost=self.has_boost,
            rerank=self.rerank, shard_rows=self.shard_rows)
        d, r, dropped = fn(
            np.ascontiguousarray(queries, dtype=np.float32)
            if not isinstance(queries, torch.Tensor) else queries,
            self.centroids, self.cells, self.row_table, self.cent_valid,
            self.cent_boost, self.ok_cells, self.vmin, self.scale,
            self.cell_norms, self.vectors, self.overflow)
        # qcap saturation observability, as the single-card index reports
        self.last_dropped = int(dropped)
        return d.cpu().numpy(), r.to(torch.int32).cpu().numpy()


# ---------------------------------------------------------------------------
# Sharded IVF-PQ
# ---------------------------------------------------------------------------

def build_sharded_ivfpq_search(mesh: Mesh, *, metric: DistanceMetric, k: int,
                               c: int, nprobe_local: int, shard_rows: int,
                               rerank_dtype: str = "bfloat16",
                               allow_grouped: bool = True):
    """The sharded IVF-PQ search: cell-sharded ADC scoring, then a
    row-sharded exact re-rank.

    Phase 1 (cell axis): each shard routes within its own centroids,
    ADC-scores its probed cells (cell-major through the
    ``grouped_cell_scores_pq`` kernel for large batches, the per-query
    table gather ``_adc_sum`` otherwise) and contributes its top-c with
    *global* row ids.  Phase 2 (row axis): the merged candidates, plus the
    overflow rows (which bypass ADC, as the single-card index scores them
    exactly), are re-scored exactly by the shard owning each row and
    assembled with ``pmin``.  ``fn(q, centroids, codebooks, codes,
    codes_t, norms, row_table, cent_valid, orow_ids, vectors, validmask,
    ok_cells)`` -> ``(dists, rows, dropped)``."""
    from ..ann.ivf_grouped import grouped_qcap, probe_cells
    from ..ann.ivfpq import _adc_sum, _grouped_pq_candidates, _query_luts
    metric = DistanceMetric.parse(metric)
    cd2 = getattr(torch, rerank_dtype)
    coll = mesh.collectives

    def local(qf, centroids, codebooks, codes, codes_t, norms, row_table,
              cent_valid, ok_cells):
        b, d = qf.shape
        nlist_l, cmax, m = codes.shape
        kk_cb = codebooks.shape[1]
        qc = qf @ centroids.T
        if metric == DistanceMetric.COSINE:
            cn = torch.clamp(torch.linalg.norm(centroids, dim=1), min=1e-30)
            rt = qc / cn[None, :]
        elif metric == DistanceMetric.DOT:
            rt = qc
        else:
            csq = (centroids * centroids).sum(dim=1)
            rt = -(csq[None, :] - 2.0 * qc)
        rt = rt.masked_fill(~cent_valid[None, :], -float(MASKED))
        npl = min(nprobe_local, nlist_l)
        probe = probe_cells(-rt, npl)
        dropped = torch.zeros((), dtype=torch.int64, device=qf.device)
        if allow_grouped and b * npl >= nlist_l:
            # cell-major: each probed cell's codes are scored once per batch
            # for every query probing it (no boost cell here: overflow rows
            # ride the row-id side channel into phase 2)
            qcap = grouped_qcap(b, npl, nlist_l, cmax)
            s, cand, dropped = _grouped_pq_candidates(
                qf, qc, probe, codes_t, codebooks, norms, row_table,
                ok_cells, metric=metric, qcap=int(qcap))
            dropped = dropped.to(torch.int64)
        else:
            lut = _query_luts(qf, codebooks)
            adc = _adc_sum(lut, codes[probe], m, kk_cb, b, npl, cmax)
            cross = (torch.take_along_dim(qc, probe, dim=1)[:, :, None]
                     + adc).reshape(b, -1)
            cand = row_table[probe].reshape(b, -1)
            ok = ok_cells[probe].reshape(b, -1)
            qsq, qinv = _qstats(qf)
            s = _metric_scores(metric, cross, norms[probe].reshape(b, -1),
                               qsq, qinv, sqrt_l2=False)
            s = s.masked_fill_(~ok, float(MASKED))
        safe = torch.clamp(cand, min=0).long()
        vals, cpos = smallest_k(s, min(c, s.shape[1]))
        crows = torch.take_along_dim(safe, cpos, dim=1)
        crows = torch.where(vals < float(MASKED) * 0.5, crows, -1)
        return vals, crows, dropped

    def fn(q, centroids, codebooks, codes, codes_t, norms, row_table,
           cent_valid, orow_ids, vectors, validmask, ok_cells):
        g = _first_row(mesh)
        qfs = on_devices(_t(q).float(), mesh, g)
        parts = []
        for j in coll.axis_index(g):
            dev = qfs[j].device
            parts.append(local(
                qfs[j], centroids.block(g, j), codebooks.on(dev),
                codes.block(g, j), codes_t.block(g, j), norms.block(g, j),
                row_table.block(g, j), cent_valid.block(g, j),
                ok_cells.block(g, j)))
        dropped = coll.psum(g, [p[2] for p in parts])
        # merge the candidates of the (disjoint) cell shards
        vals_g = coll.all_gather(g, [p[0] for p in parts])   # (ndev, B, cc)
        rows_g = coll.all_gather(g, [p[1] for p in parts])
        b = vals_g.shape[1]
        _, grows = merge_top_k(vals_g, rows_g,
                               min(c, vals_g.shape[0] * vals_g.shape[2]))
        # overflow rows go straight to the exact phase (-1 padded): PQ
        # codebooks trained on in-cell residuals can encode far-out rows
        # arbitrarily badly
        of_g = coll.all_gather(g, [orow_ids.block(g, j) for j in
                                   coll.axis_index(g)]).reshape(-1).long()

        def exact(j):
            dev = qfs[j].device
            vm = validmask.on(dev)
            gr, og = grows.to(dev), of_g.to(dev)
            return torch.cat([
                _exact_own(qfs[j], gr, (gr >= 0) & vm[torch.clamp(gr, min=0)],
                           vectors.block(g, j), j * shard_rows, metric, cd2),
                _exact_rows(qfs[j], og, (og >= 0) & vm[torch.clamp(og, min=0)],
                            vectors.block(g, j), j * shard_rows, metric,
                            cd2)], dim=1)

        es = coll.pmin(g, [exact(j) for j in coll.axis_index(g)])
        grows = torch.cat([grows, of_g[None, :].to(grows.device).expand(
            b, of_g.shape[0])], dim=1)
        vals, pos = smallest_k(es, min(k, grows.shape[1]))
        return vals, torch.take_along_dim(grows, pos, dim=1), dropped

    return fn


class ShardedIVFPQ:
    """An ann.ivfpq.IVFPQIndex re-laid-out across a mesh: cells on the cell
    axis, the exact re-rank corpus on the row axis."""

    def __init__(self, mesh: Mesh, centroids, codebooks, codes, norms,
                 row_table, cent_valid, vectors, validmask,
                 orow_ids=None, *,
                 metric: DistanceMetric, nprobe: int, rerank: int,
                 rerank_dtype: str = "bfloat16"):
        self.mesh = mesh
        self.metric = DistanceMetric.parse(metric)
        self.nprobe = nprobe
        self.rerank = rerank
        self.rerank_dtype = rerank_dtype
        ndev = mesh.shape[DATA_AXIS]
        centroids, codes, row_table = _t(centroids), _t(codes), _t(row_table)
        vectors = _t(vectors)
        self.shard_rows = vectors.shape[0] // ndev
        local_cells = centroids.shape[0] // ndev
        self.nprobe_local = max(1, min(-(-nprobe // ndev) * 2, local_cells))
        shard = lambda a: _shard_tensor(mesh, a)  # noqa: E731
        self.centroids = shard(centroids.float())
        self.codebooks = replicate(mesh, _t(codebooks).float())
        self.codes = shard(codes)
        # (nlist, M, cmax) transposed codes for the cell-major dispatch:
        # PQ codes are ~D/M-fold compressed, so the second copy costs far
        # less than the re-rank corpus shard
        self.codes_t = shard(codes.transpose(1, 2).contiguous())
        self._allow_grouped = True
        self.norms = shard(_t(norms).float())
        self.row_table = shard(row_table)
        self.cent_valid = shard(_t(cent_valid).bool())
        if orow_ids is None:
            orow_ids = torch.full((ndev,), -1, dtype=torch.int32)
        self.orow_ids = shard(_t(orow_ids).to(torch.int32))
        self.vectors = shard(vectors)
        vm = _t(validmask).bool()
        self.validmask = replicate(mesh, vm)
        # per-slot liveness, once over the immutable layout
        vmt = vm.to(row_table.device)
        self.ok_cells = shard((row_table >= 0)
                              & vmt[torch.clamp(row_table, min=0).long()])
        self.last_dropped = 0

    @classmethod
    def from_index(cls, mesh: Mesh, idx, validmask=None) -> "ShardedIVFPQ":
        """Shard an ann.ivfpq.IVFPQIndex across ``mesh``.  Overflow rows
        (which the single-card index scores exactly on every query) ride a
        row-id side channel into the exact re-rank phase."""
        ndev = mesh.shape[DATA_AXIS]
        centroids = idx.centroids.float()
        codes, norms, table = idx.codes, idx.norms, idx.row_table
        nlist = codes.shape[0]
        orows_all = idx.overflow_rows.cpu()
        orows = orows_all[orows_all >= 0]
        per = max(1, -(-int(orows.numel()) // ndev))
        orow_ids = torch.full((ndev * per,), -1, dtype=torch.int32)
        orow_ids[:orows.numel()] = orows.to(torch.int32)
        pad = (-nlist) % ndev
        if pad:
            centroids = torch.nn.functional.pad(centroids, (0, 0, 0, pad))
            codes = torch.nn.functional.pad(codes, (0, 0, 0, 0, 0, pad))
            norms = torch.nn.functional.pad(norms, (0, 0, 0, pad))
            table = torch.nn.functional.pad(table, (0, 0, 0, pad), value=-1)
        cent_valid = torch.ones((centroids.shape[0],), dtype=torch.bool)
        if pad:
            cent_valid[-pad:] = False
        store = idx._collection._store
        cfg = idx._collection.config
        n = store.count
        dtype_name = ("bfloat16" if cfg.compute_dtype == "bfloat16"
                      else "float32")
        vecs = store.vectors[:n].to(getattr(torch, dtype_name))
        vm = (store.valid[:n] if validmask is None
              else _t(validmask)[:n]).bool()
        rpad = (-n) % ndev
        if rpad:
            vecs = torch.nn.functional.pad(vecs, (0, 0, 0, rpad))
        vmask = torch.zeros((store.capacity,), dtype=torch.bool,
                            device=vm.device)
        vmask[:n] = vm
        return cls(mesh, centroids, idx.codebooks, codes, norms, table,
                   cent_valid, vecs, vmask, orow_ids, metric=cfg.metric,
                   nprobe=idx.nprobe, rerank=idx.rerank,
                   rerank_dtype=dtype_name)

    def search(self, queries, k: int, rerank: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        rr = rerank if rerank is not None else self.rerank
        fn = build_sharded_ivfpq_search(
            self.mesh, metric=self.metric, k=k, c=max(k * max(rr, 1), k),
            nprobe_local=self.nprobe_local, shard_rows=self.shard_rows,
            rerank_dtype=self.rerank_dtype,
            allow_grouped=self._allow_grouped)
        d, r, dropped = fn(
            np.ascontiguousarray(queries, dtype=np.float32)
            if not isinstance(queries, torch.Tensor) else queries,
            self.centroids, self.codebooks, self.codes, self.codes_t,
            self.norms, self.row_table, self.cent_valid, self.orow_ids,
            self.vectors, self.validmask, self.ok_cells)
        self.last_dropped = int(dropped)
        return d.cpu().numpy(), r.to(torch.int32).cpu().numpy()


# ---------------------------------------------------------------------------
# Sharded int8 / int4 two-stage scan
# ---------------------------------------------------------------------------

def build_sharded_int8_search(mesh: Mesh, *, metric: DistanceMetric, k: int,
                              c: int, rerank_dtype: str = "bfloat16",
                              codec: str = "int8"):
    """The sharded two-stage scan: ``fn(q, codes, vmin, scale, vsq, rinv,
    vectors, valid)`` -> ``(dists (B, k), rows (B, k))``.  Each shard runs
    the single-card route over its own rows — int8: one fused ``s8_topc``
    scan (no (B, N_shard) score block); int4: ``int4_scores`` and a masked
    top-c — then gathers and exactly re-ranks its own candidates; only the
    (B, k) partials are merged."""
    from ..quant.scan import _int4_coarse_topk, _int8_coarse_topk, \
        gather_rerank
    metric = DistanceMetric.parse(metric)
    coll = mesh.collectives

    def local(q, codes, vmin, scale, vsq, rinv, vectors, valid, j):
        shard_rows = codes.shape[0]
        cc = min(c, shard_rows)
        if codec == "int4":
            cvals, crows = _int4_coarse_topk(q, codes, vmin, scale, valid,
                                             metric=metric, k=cc)
        else:
            cvals, crows = _int8_coarse_topk(q, codes, vmin, scale, vsq, rinv,
                                             valid, metric=metric, k=cc)
        vals, rows = gather_rerank(q, cvals, crows, vectors, metric,
                                   min(k, cc), rerank_dtype)
        return vals, rows + j * shard_rows

    def fn(q, codes, vmin, scale, vsq, rinv, vectors, valid):
        g = _first_row(mesh)
        qd = on_devices(_t(q).float(), mesh, g)
        parts = []
        for j in coll.axis_index(g):
            dev = qd[j].device
            parts.append(local(qd[j], codes.block(g, j), vmin.on(dev),
                               scale.on(dev), vsq.block(g, j),
                               rinv.block(g, j), vectors.block(g, j),
                               valid.block(g, j), j))
        return _merge_over_data_axis(coll, g, [p[0] for p in parts],
                                     [p[1] for p in parts], k)

    return fn


class ShardedInt8:
    """A quant.scan int8 / int4 snapshot re-laid-out across a mesh."""

    def __init__(self, mesh: Mesh, codes, vmin, scale, vsq, rinv, vectors,
                 valid, *, metric: DistanceMetric,
                 rerank_dtype: str = "bfloat16", codec: str = "int8"):
        self.mesh = mesh
        self.metric = DistanceMetric.parse(metric)
        self.rerank_dtype = rerank_dtype
        self.codec = codec
        ndev = mesh.shape[DATA_AXIS]
        n = codes.shape[0]
        if n % ndev:
            raise ValueError(f"rows {n} not divisible by data axis {ndev}; "
                             "pad to a power-of-two bucket first")
        shard = lambda a: _shard_tensor(mesh, a)  # noqa: E731
        self.codes = shard(codes)
        self.vsq, self.rinv = shard(_t(vsq).float()), shard(_t(rinv).float())
        self.vectors = shard(vectors)
        self.valid = shard(_t(valid).bool())
        self.vmin = replicate(mesh, _t(vmin).float())
        self.scale = replicate(mesh, _t(scale).float())

    @classmethod
    def from_scan(cls, mesh: Mesh, scan) -> "ShardedInt8":
        """Shard a quant.scan.QuantizedScan (kind int8 / int4) across
        ``mesh``: the int4 rows move half the per-shard coarse bytes."""
        if scan.kind not in ("int8", "int4"):
            raise ValueError(f"ShardedInt8 requires an int8/int4 scan, "
                             f"got {scan.kind!r}")
        vsq, rinv = scan._stats()
        n = scan.codes.shape[0]
        store = scan._store
        ndev = mesh.shape[DATA_AXIS]
        pad = (-n) % ndev
        codes = scan.codes
        vecs = store.vectors[:n]
        valid = store.valid[:n]
        # rows appended AFTER the snapshot build carry garbage codes
        # (QuantizedScan.search masks them too)
        if scan.built_count < n:
            valid = valid.clone()
            valid[scan.built_count:] = False
        if pad:
            F = torch.nn.functional
            codes = F.pad(codes, (0, 0, 0, pad))
            vecs = F.pad(vecs, (0, 0, 0, pad))
            valid = F.pad(valid, (0, pad))
            vsq, rinv = F.pad(vsq, (0, pad)), F.pad(rinv, (0, pad))
        dtype_name = ("bfloat16"
                      if getattr(scan, "compute_dtype", "float32")
                      == "bfloat16" else "float32")
        return cls(mesh, codes, scan.quantizer.vmin, scan.quantizer.scale,
                   vsq, rinv, vecs.to(getattr(torch, dtype_name)), valid,
                   metric=scan.metric, rerank_dtype=dtype_name,
                   codec=scan.kind)

    def search(self, queries, k: int, rerank: int = 4
               ) -> Tuple[np.ndarray, np.ndarray]:
        fn = build_sharded_int8_search(
            self.mesh, metric=self.metric, k=k, c=max(k * max(rerank, 1), k),
            rerank_dtype=self.rerank_dtype, codec=self.codec)
        d, r = fn(
            np.ascontiguousarray(queries, dtype=np.float32)
            if not isinstance(queries, torch.Tensor) else queries,
            self.codes, self.vmin, self.scale, self.vsq, self.rinv,
            self.vectors, self.valid)
        return d.cpu().numpy(), r.to(torch.int32).cpu().numpy()
