"""Meshes over a ``torch.distributed`` process group (counterpart of
cerebro_tpu/parallel/mesh.py).

A JAX mesh is one process driving n devices. Its PyTorch counterpart is
one process per device, the processes joined in a process group
(``parallel.multihost.init_multihost``): a ``Mesh`` here names the axes
over the group's ranks and holds, for the calling rank, its process group
along each axis and its index there. Every stage that shards (the
descriptor DB's history, the pose graph's edges, the training batch) does
so against the same axis names:

  ``db``  — the descriptor-history axis, and the data-parallel batch axis
            of training: one axis, two roles, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The ranks of a process group laid out on named axes, row-major:
    world rank ``r`` of a (s0, s1) mesh sits at (r // s1, r % s1). Holds
    the calling rank's view: along each axis, the group of the ranks that
    differ from it only there, and its index in that group."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    groups: Tuple[object, ...]  # a ProcessGroup per axis
    coords: Tuple[int, ...]  # this rank's index along each axis
    device: torch.device  # the device the group's collectives take tensors on

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes are {self.axis_names}, not {axis!r}")
        return self.axis_names.index(axis)

    def group(self, axis: str):
        return self.groups[self._axis(axis)]

    def rank(self, axis: str) -> int:
        return self.coords[self._axis(axis)]


def _world() -> Tuple[int, int, torch.device]:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call cerebro_tpu_torch.parallel.multihost.init_multihost first"
        )
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return dist.get_world_size(), dist.get_rank(), device


def make_mesh(num_devices: Optional[int] = None, axis: str = "db") -> Mesh:
    """A 1-D mesh over every rank of the process group (which may be one
    rank). ``num_devices``, if given, must be the group's size."""
    n, rank, device = _world()
    if num_devices is not None and num_devices != n:
        raise ValueError(f"a mesh covers the process group's {n} ranks, not {num_devices}")
    return Mesh((axis,), (n,), (dist.group.WORLD,), (rank,), device)


def make_mesh_2d(shape: tuple, axes: tuple = ("dp", "db")) -> Mesh:
    """2-D mesh: data parallelism on one axis, DB-history sharding on the
    other (hosts x devices on a cluster). ``shape[0] * shape[1]`` must be
    the group's size. Every rank creates every axis group, in one order,
    as ``torch.distributed.new_group`` asks."""
    n, rank, device = _world()
    s0, s1 = shape
    if s0 * s1 != n:
        raise ValueError(f"a {s0}x{s1} mesh needs {s0 * s1} ranks, the group has {n}")
    i, j = divmod(rank, s1)
    rows = [[a * s1 + b for b in range(s1)] for a in range(s0)]  # along axis 1
    cols = [[a * s1 + b for a in range(s0)] for b in range(s1)]  # along axis 0
    mine = {}
    for name, lists, own in ((0, cols, j), (1, rows, i)):
        for k, ranks in enumerate(lists):
            g = dist.new_group(ranks)
            if k == own:
                mine[name] = g
    return Mesh(tuple(axes), (s0, s1), (mine[0], mine[1]), (i, j), device)


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """(n, *t.shape): every rank's ``t`` along ``axis``, in rank order. It
    crosses as bytes, so any dtype crosses any backend."""
    b = t.contiguous().view(torch.uint8)
    out = [torch.empty_like(b) for _ in range(mesh.shape[axis])]
    dist.all_gather(out, b, group=mesh.group(axis))
    return torch.stack(out).view(t.dtype)


def all_reduce_sum(tree: Dict[str, torch.Tensor], mesh: Mesh, axis: str) -> Dict[str, torch.Tensor]:
    """A dict of float tensors summed over the ranks of ``axis``: one
    ``all_reduce`` of one buffer, the tensors flattened in the dict's order."""
    names = list(tree)
    flat = torch.cat([tree[k].reshape(-1) for k in names])
    dist.all_reduce(flat, group=mesh.group(axis))
    out, i = {}, 0
    for k in names:
        n = tree[k].numel()
        out[k] = flat[i : i + n].reshape(tree[k].shape)
        i += n
    return out
