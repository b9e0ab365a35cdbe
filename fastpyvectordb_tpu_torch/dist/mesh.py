"""Device meshes for multi-card sharded search (port of
``fastpyvectordb_tpu/dist/mesh.py``).

A ``Mesh`` is a grid of ``torch.device``s with named axes: ``"data"``
(corpus rows are split over it) and, on a 2-D mesh, ``"query"`` (query
batches are split over it; each query row of the grid holds a replica of
the data shards).  It is the counterpart of a ``jax.sharding.Mesh``.  A mesh
is driven either by one process, which runs every shard in turn and merges
the partials itself (``Mesh(devices, axes)``, ``make_mesh``), or by one
process per rank over ``torch.distributed`` (``dist/multihost.py``
``global_mesh``), where each process holds only its own shards.  The
sharded searchers (``dist/sharded.py``, ``dist/sharded_ann.py``) are
written once against ``dist/collectives.py``, which both kinds provide.

A mesh built from an explicit device list may name one device several
times: four logical shards on one card run one after another there.  On
the CPU ``make_mesh(device="cpu")`` gives ``CPU_SHARDS`` logical shards, as
the JAX test suite forces eight host devices.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils import resolve_device

DATA_AXIS = "data"     # corpus rows
QUERY_AXIS = "query"   # query batch
CPU_SHARDS = 8         # logical shards of make_mesh(device="cpu")


class Mesh:
    """A 1-D ``(data,)`` or 2-D ``(query, data)`` grid of torch devices.

    ``owner`` gives the process rank that drives each grid position (all
    0 for a single-process mesh); positions another process drives hold
    ``None`` in ``devices``.  ``collectives`` is the backend that merges
    the shards' partials (dist/collectives.py)."""

    def __init__(self, devices, axis_names: Sequence[str] = (DATA_AXIS,), *,
                 owner=None, rank: int = 0, collectives=None):
        grid = np.empty(np.shape(np.asarray(devices, dtype=object)),
                        dtype=object)
        for pos, dev in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[pos] = None if dev is None else torch.device(dev)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or axis_names[-1] != DATA_AXIS or (
                grid.ndim == 2 and axis_names[0] != QUERY_AXIS) \
                or grid.ndim not in (1, 2) or grid.size == 0:
            raise ValueError(f"a mesh is ({DATA_AXIS!r},) or ({QUERY_AXIS!r}, "
                             f"{DATA_AXIS!r}); got axes {axis_names} over a "
                             f"grid of shape {grid.shape}")
        self.devices = grid
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, grid.shape))
        self._grid = grid.reshape(-1, grid.shape[-1])     # (query, data)
        self.owner = (np.zeros(self._grid.shape, dtype=np.int64)
                      if owner is None
                      else np.asarray(owner).reshape(self._grid.shape))
        self.rank = int(rank)
        if collectives is None:
            from .collectives import InProcess
            collectives = InProcess(self)
        self.collectives = collectives

    @property
    def n_query(self) -> int:
        return int(self._grid.shape[0])

    @property
    def n_data(self) -> int:
        return int(self._grid.shape[1])

    def local_rows(self) -> List[int]:
        """The query rows in which this process drives any position."""
        return [g for g in range(self.n_query)
                if (self.owner[g] == self.rank).any()]

    def local_data(self, g: int) -> List[int]:
        """The data indices this process drives in query row ``g``."""
        return [int(j) for j in np.flatnonzero(self.owner[g] == self.rank)]

    def device(self, g: int, j: int) -> torch.device:
        dev = self._grid[g, j]
        if dev is None:
            raise ValueError(f"mesh position ({g}, {j}) is driven by rank "
                             f"{int(self.owner[g, j])}, not {self.rank}")
        return dev

    def out_device(self, g: Optional[int] = None) -> torch.device:
        """Where merged results land: the first local shard's device (of
        query row ``g``, else of the first local row)."""
        g = self.local_rows()[0] if g is None else g
        return self.device(g, self.local_data(g)[0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank})"


def make_mesh(n_devices: Optional[int] = None, query_parallel: int = 1,
              device=None) -> Mesh:
    """1-D corpus mesh, or 2-D (query, data) when ``query_parallel > 1``.

    ``device=None`` means the CUDA cards (raising on a host without one,
    as every entry point of the package does); ``device="cpu"`` gives up to
    ``CPU_SHARDS`` logical CPU shards.  More devices than there are raises,
    as does a ``query_parallel`` that does not divide the count."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if dev.index is None else [dev])
    else:
        devices = [dev] * CPU_SHARDS
    n = n_devices or len(devices)
    if n > len(devices):
        # a silent [:n] truncation would hand back fewer shards than the
        # caller planned capacity for
        raise ValueError(f"requested {n} devices, only {len(devices)} "
                         "available")
    return _grid_mesh(devices[:n], query_parallel)


def _grid_mesh(devices, query_parallel: int) -> Mesh:
    n = len(devices)
    if n % query_parallel:
        raise ValueError(
            f"{n} devices not divisible by query_parallel={query_parallel}")
    if query_parallel > 1:
        grid = np.empty((query_parallel, n // query_parallel), dtype=object)
        for i, d in enumerate(devices):
            grid[i // grid.shape[1], i % grid.shape[1]] = d
        return Mesh(grid, (QUERY_AXIS, DATA_AXIS))
    return Mesh(devices, (DATA_AXIS,))


def logical_mesh(n: int, query_parallel: int = 1, device=None) -> Mesh:
    """``n`` logical shards laid round-robin over the devices of one type
    (``device=None``: the CUDA cards): four shards on one card, or more
    CPU shards than ``CPU_SHARDS``.  The shards of a card run one after
    another; a device with an index (``"cuda:0"``) takes every shard."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(n)]
    else:
        devices = [dev] * n
    return _grid_mesh(devices, query_parallel)


def on_devices(t: torch.Tensor, mesh: Mesh, g: int) -> Dict[int, torch.Tensor]:
    """``t`` on the device of each local data shard of query row ``g``:
    one copy a device, however many shards share it."""
    out, copies = {}, {}
    for j in mesh.local_data(g):
        dev = mesh.device(g, j)
        if dev not in copies:
            copies[dev] = t.to(dev)
        out[j] = copies[dev]
    return out


def as_tensor(a) -> torch.Tensor:
    """Tensors pass through; arrays become tensors on the CPU (read-only
    arrays, such as JAX's, are copied)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.require(a, requirements=["C", "W"]))


class ShardedArray:
    """An array row-split over a mesh's data axis: ``block(g, j)`` is data
    shard ``j``'s block on the device of grid position ``(g, j)`` (the
    blocks of every query row are replicas).  Only the positions this
    process drives are held."""

    def __init__(self, mesh: Mesh, blocks: Dict[tuple, torch.Tensor],
                 shape: tuple):
        self.mesh = mesh
        self.blocks = blocks
        self.shape = tuple(shape)

    def block(self, g: int, j: int) -> torch.Tensor:
        return self.blocks[(g, j)]

    def full(self) -> torch.Tensor:
        """The whole array on the mesh's output device (the blocks of the
        first local query row, gathered over the data axis)."""
        g = self.mesh.local_rows()[0]
        parts = [self.blocks[(g, j)] for j in self.mesh.local_data(g)]
        out = self.mesh.collectives.all_gather(g, parts)
        return out.reshape(self.shape)

    def __array__(self, dtype=None, copy=None):
        a = self.full().cpu().numpy()
        return a if dtype is None else a.astype(dtype)


class Replicated:
    """An array every shard reads whole: one copy per device."""

    def __init__(self, mesh: Mesh, tensor: torch.Tensor):
        self.mesh = mesh
        self._copies = {tensor.device: tensor}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._copies.get(device)
        if t is None:
            t = next(iter(self._copies.values())).to(device)
            self._copies[device] = t
        return t


def shard_blocks(mesh: Mesh, a, rows: Optional[int] = None) -> ShardedArray:
    """Split ``a`` (N, ...) into ``mesh``'s data blocks of ``rows`` rows
    (default N / n_data) and place each local block on its device.  The
    blocks are views of ``a`` where it already lies on that device."""
    t = as_tensor(a)
    ndata = mesh.n_data
    if rows is None:
        if t.shape[0] % ndata:
            raise ValueError(f"rows {t.shape[0]} not divisible by data axis "
                             f"{ndata}; pad to a power-of-two bucket first")
        rows = t.shape[0] // ndata
    blocks = {}
    for g in mesh.local_rows():
        for j in mesh.local_data(g):
            blocks[(g, j)] = t[j * rows:(j + 1) * rows].to(mesh.device(g, j))
    return ShardedArray(mesh, blocks, (rows * ndata, *t.shape[1:]))


def shard_corpus(mesh: Mesh, *arrays):
    """Place arrays row-sharded along the mesh's data axis.  Row counts must
    be divisible by the data-axis size (pad first: core/store.py buckets are
    powers of two, so any pow2 mesh divides them)."""
    out = [a if isinstance(a, ShardedArray) else shard_blocks(mesh, a)
           for a in arrays]
    return tuple(out) if len(out) != 1 else out[0]


def replicate(mesh: Mesh, *arrays):
    out = [a if isinstance(a, Replicated)
           else Replicated(mesh, as_tensor(a)) for a in arrays]
    return tuple(out) if len(out) != 1 else out[0]
