"""Collectives over a mesh's data axis: the one interface the sharded
searchers are written against (the counterpart of ``jax.lax.all_gather`` /
``psum`` / ``pmin`` / ``axis_index`` inside ``shard_map``).

Every method takes the query row ``g`` and ``parts``, the list of partials
of the data shards this process drives in that row (in ``local_data(g)``
order), and returns the merged tensor, the same on every participant:

  * ``all_gather`` -> (n_data, *part.shape), ordered by data index;
  * ``psum`` / ``pmin`` -> part.shape, the elementwise sum / minimum;
  * ``axis_index(g)`` -> the data indices of the local shards;
  * ``join_queries(outs)`` -> the per-query-row outputs concatenated along
    the batch axis, for searches that split queries over the query axis.

Two backends: ``InProcess`` (one process drives every shard: partials move
to the row's output device and are stacked) and ``Distributed``
(``torch.distributed``: ``all_gather_into_tensor`` and ``all_reduce`` with
``SUM`` / ``MIN`` within the row's process group; NCCL for CUDA tensors,
gloo for CPU tensors only).
"""

from __future__ import annotations

from typing import List, Sequence

import torch


class InProcess:
    """The shards of one process."""

    def __init__(self, mesh):
        self.mesh = mesh

    def axis_index(self, g: int) -> List[int]:
        return self.mesh.local_data(g)

    def all_gather(self, g: int, parts: Sequence[torch.Tensor]
                   ) -> torch.Tensor:
        dev = self.mesh.out_device(g)
        return torch.stack([p.to(dev) for p in parts])

    def psum(self, g: int, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.all_gather(g, parts).sum(dim=0)

    def pmin(self, g: int, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.all_gather(g, parts).amin(dim=0)

    def join_queries(self, outs: Sequence[tuple]) -> tuple:
        dev = self.mesh.out_device()
        return tuple(torch.cat([o[i].to(dev) for o in outs])
                     for i in range(len(outs[0])))


def _gather_into(out, inp, group) -> None:
    import torch.distributed as dist
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp, group=group)


class Distributed:
    """One process per rank over ``torch.distributed``.  ``groups[g]`` is
    the process group of query row ``g`` (``None``: the whole world)."""

    def __init__(self, mesh, groups: dict):
        self.mesh = mesh
        self.groups = groups

    def _check(self, t: torch.Tensor, group) -> None:
        import torch.distributed as dist
        if t.is_cuda and dist.get_backend(group) == "gloo":
            raise ValueError("the gloo backend carries CPU tensors only; "
                             "shards on CUDA need NCCL")

    def axis_index(self, g: int) -> List[int]:
        return self.mesh.local_data(g)

    def all_gather(self, g: int, parts: Sequence[torch.Tensor]
                   ) -> torch.Tensor:
        import torch.distributed as dist
        group = self.groups.get(g)
        local = torch.stack(list(parts))
        self._check(local, group)
        is_bool = local.dtype == torch.bool
        if is_bool:   # NCCL has no bool
            local = local.to(torch.uint8)
        world = dist.get_world_size(group)
        out = torch.empty((world * local.shape[0], *local.shape[1:]),
                          dtype=local.dtype, device=local.device)
        _gather_into(out, local.contiguous(), group)
        return out.bool() if is_bool else out

    def _reduce(self, g, t: torch.Tensor, op) -> torch.Tensor:
        import torch.distributed as dist
        group = self.groups.get(g)
        self._check(t, group)
        t = t.contiguous().clone()
        dist.all_reduce(t, op=op, group=group)
        return t

    def psum(self, g: int, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        import torch.distributed as dist
        return self._reduce(g, torch.stack(list(parts)).sum(dim=0),
                            dist.ReduceOp.SUM)

    def pmin(self, g: int, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        import torch.distributed as dist
        return self._reduce(g, torch.stack(list(parts)).amin(dim=0),
                            dist.ReduceOp.MIN)

    def join_queries(self, outs: Sequence[tuple]) -> tuple:
        """Every rank lies in one query row (``global_mesh`` enforces it):
        gather every rank's row output over the world and keep the first
        rank's of each row."""
        import torch.distributed as dist
        if self.mesh.n_query == 1:
            return tuple(outs[0])
        firsts = [int(self.mesh.owner[g].min())
                  for g in range(self.mesh.n_query)]
        joined = []
        for t in outs[0]:
            self._check(t, None)
            world = dist.get_world_size()
            out = torch.empty((world * t.shape[0], *t.shape[1:]),
                              dtype=t.dtype, device=t.device)
            _gather_into(out, t.contiguous(), None)
            out = out.reshape(world, *t.shape)
            joined.append(torch.cat([out[r] for r in firsts]))
        return tuple(joined)
