"""Multi-process runtime (port of ``fastpyvectordb_tpu/dist/multihost.py``).

One process per rank over ``torch.distributed``: ``initialize`` joins the
process group (``tcp://`` rendezvous; NCCL for shards on CUDA, gloo for
shards on the CPU), ``global_mesh`` lays a data axis over every rank's
local devices, and ``shard_local_corpus`` keeps each rank's block of rows
on its own devices, so no process ever holds the whole corpus.  The
sharded searchers run over such a mesh unchanged: its collectives are
``dist/collectives.py Distributed``.

NCCL refuses two ranks on one card, so on a single card a job has one
rank; gloo carries CPU tensors only.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils import resolve_device
from .mesh import DATA_AXIS, QUERY_AXIS, Mesh, ShardedArray, as_tensor

# set after the first successful init_process_group in this process
_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device=None,
               timeout: float = 120.0) -> None:
    """Join the job's process group (a no-op for a single process).

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous;
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` /
    ``RANK`` from the environment.  ``device=None`` means the CUDA cards
    (NCCL; rank r uses card r modulo the host's count) and raises on a host
    without one; ``device="cpu"`` uses gloo.  ``timeout`` (seconds) bounds
    the rendezvous and every collective, so a missing peer fails instead of
    hanging.  Idempotent: a second call in the same process returns."""
    global _initialized
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if not (coordinator_address or num_processes):
        return  # one process: nothing to wire
    if _initialized:
        return
    import torch.distributed as dist
    if dist.is_initialized():   # joined outside this module
        _initialized = True
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    rank = int(process_id or 0)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes or 1), rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    _initialized = True


def local_devices():
    """This rank's device: its card under NCCL, the CPU under gloo."""
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cpu")]


def global_mesh(query_parallel: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over every rank's local devices (``devices``, default
    ``local_devices()``), rank-major along the data axis.  Every rank must
    bring the same number of devices.  With ``query_parallel > 1`` the grid
    is (query, data) and each rank must lie within one query row; each row
    gets its own process group for the data-axis collectives."""
    import torch.distributed as dist
    from .collectives import Distributed
    if not dist.is_initialized():
        from .mesh import make_mesh
        return make_mesh(query_parallel=query_parallel, device=(
            None if devices is None else torch.device(devices[0]).type))
    devs = list(devices) if devices is not None else local_devices()
    world, rank = dist.get_world_size(), dist.get_rank()
    counts = torch.tensor([len(devs), -len(devs)], dtype=torch.int64)
    if dist.get_backend() == "nccl":
        counts = counts.cuda()
    dist.all_reduce(counts, op=dist.ReduceOp.MAX)
    if int(counts[0]) != -int(counts[1]):
        raise ValueError("every rank must bring the same number of devices")
    n_local = len(devs)
    n = world * n_local
    if n % query_parallel:
        raise ValueError(
            f"{n} devices not divisible by query_parallel={query_parallel}")
    cols = n // query_parallel
    if cols % n_local:
        raise ValueError(f"a rank's {n_local} devices must lie in one query "
                         f"row of {cols}")
    owner = np.repeat(np.arange(world), n_local).reshape(query_parallel,
                                                         cols)
    grid = np.empty((query_parallel, cols), dtype=object)
    for i, d in enumerate(devs):
        p = rank * n_local + i
        grid[p // cols, p % cols] = torch.device(d)
    groups = {}
    for g in range(query_parallel):
        ranks = sorted(set(owner[g].tolist()))
        # every rank takes part in creating every group, in one order
        pg = dist.new_group(ranks) if query_parallel > 1 else None
        if rank in ranks:
            groups[g] = pg
    axes = (QUERY_AXIS, DATA_AXIS) if query_parallel > 1 else (DATA_AXIS,)
    mesh = Mesh(grid if query_parallel > 1 else grid[0], axes, owner=owner,
                rank=rank, collectives=None)
    mesh.collectives = Distributed(mesh, groups)
    return mesh


def shard_local_corpus(mesh: Mesh, local_rows) -> ShardedArray:
    """A globally row-sharded array from each rank's own (n_local, ...)
    block: the block is split over the rank's local data shards and stays
    on its devices; no process holds the others' rows.  Every rank passes
    the same n_local."""
    t = as_tensor(local_rows)
    blocks = {}
    for g in mesh.local_rows():
        js = mesh.local_data(g)
        if t.shape[0] % len(js):
            raise ValueError(f"local rows {t.shape[0]} not divisible by "
                             f"this rank's {len(js)} shards")
        per = t.shape[0] // len(js)
        for i, j in enumerate(js):
            blocks[(g, j)] = t[i * per:(i + 1) * per].to(mesh.device(g, j))
        rows = per * mesh.n_data
    return ShardedArray(mesh, blocks, (rows, *t.shape[1:]))
