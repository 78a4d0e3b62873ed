"""Named process meshes — the port of :mod:`distkeras_tpu.parallel.mesh`.

The reference lays its devices out as a ``jax.sharding.Mesh`` with named
axes (``dp`` data, ``sp`` sequence, ...) and addresses collectives to
axis names inside ``shard_map``. Here each mesh position is one process
of the initialized ``torch.distributed`` world (one card each, or one
CPU process for the gloo tests): :func:`make_mesh` lays the world's
ranks out row-major over the axes (the last axis varies fastest, as in
the reference's device grid) and builds the process group of each axis
and of the whole mesh. A :class:`Mesh` holds this rank's coordinates and
those groups.

A mesh of one position needs no process group: its groups are ``None``
and every collective on them is the identity, so one program covers one
card and many. Inside ``with mesh:`` the mesh is bound, as names are
bound inside ``shard_map``: the model's ``attention='ring'`` reads its
sequence group and shard index from it.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Optional

import numpy as np
import torch.distributed as dist

# the meshes bound by `with mesh:`, innermost last, per thread
_local = threading.local()


def _bound() -> list:
    if not hasattr(_local, "meshes"):
        _local.meshes = []
    return _local.meshes


class Mesh:
    """This rank's view of a named process mesh: ``shape`` (axis ->
    size), ``coords`` (axis -> this rank's index along it) and the
    process groups along each axis and over the whole mesh (``None``
    where the group is this rank alone)."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int],
                 groups: Dict[tuple, object]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.coords = dict(coords)
        self._groups = dict(groups)

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        return self.coords[axis]

    def group(self, *axes: str):
        """The process group spanning ``axes`` through this rank (all of
        the mesh's axes when none are named), or ``None`` when that group
        is this rank alone."""
        key = tuple(a for a in self.axis_names if a in (axes or
                                                        self.axis_names))
        unknown = set(axes) - set(self.axis_names)
        if unknown:
            raise ValueError(f"mesh {self.axis_names} has no axes "
                             f"{sorted(unknown)}")
        if int(np.prod([self.shape[a] for a in key], dtype=np.int64)) == 1:
            return None
        return self._groups[key]

    def __enter__(self):
        _bound().append(self)
        return self

    def __exit__(self, *exc):
        _bound().pop()
        return False

    def __repr__(self):
        return f"Mesh({self.shape}, coords={self.coords})"


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh bound by ``with mesh:`` in this thread, or
    ``None``."""
    meshes = _bound()
    return meshes[-1] if meshes else None


def local_mesh(axes: Dict[str, int]) -> Mesh:
    """A mesh of one position (every axis of size 1) that needs no
    ``torch.distributed`` world."""
    if any(s != 1 for s in axes.values()):
        raise ValueError(f"a local mesh has axes of size 1; got {axes}")
    return Mesh(axes, {a: 0 for a in axes}, {})


def make_mesh(axes: Dict[str, int]) -> Mesh:
    """A mesh with named ``axes`` (insertion order = major -> minor) over
    the initialized ``torch.distributed`` world, whose size must equal
    ``prod(axes.values())``; a mesh of one position also works without a
    world. The world is the caller's: ``init_process_group`` with
    ``"nccl"`` for CUDA ranks (one card each, ``torch.cuda.set_device``
    first) or ``"gloo"`` for CPU ranks; the groups built here take the
    world's backend.

    Every rank must call this with the same axes, in the same order
    relative to its other collectives: building process groups is itself
    collective."""
    sizes = [int(s) for s in axes.values()]
    if not sizes or any(s < 1 for s in sizes):
        raise ValueError(f"mesh axes need positive sizes; got {axes}")
    need = int(np.prod(sizes))
    world = dist.get_world_size() if (dist.is_available()
                                      and dist.is_initialized()) else 1
    if need != world:
        raise ValueError(
            f"mesh axes {axes} need {need} processes; the torch.distributed "
            f"world has {world} (init_process_group with world_size={need} "
            f"first)")
    if world == 1:
        return local_mesh(axes)
    names = tuple(axes)
    rank = dist.get_rank()
    grid = np.arange(world).reshape(sizes)
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank,
                                                               sizes))))
    groups = {}
    # every subset of axes, in one fixed order on every rank: one group
    # per setting of the other axes' coordinates
    for r in range(1, len(names) + 1):
        for key in itertools.combinations(names, r):
            keep = [names.index(a) for a in key]
            rest = [i for i in range(len(names)) if i not in keep]
            moved = np.moveaxis(grid, rest, list(range(len(rest))))
            for members in moved.reshape(-1, int(np.prod(
                    [sizes[i] for i in keep]))):
                ranks = [int(m) for m in members]
                g = dist.new_group(ranks) if len(ranks) > 1 else None
                if rank in ranks:
                    groups[key] = g
    return Mesh(axes, coords, groups)


def replica_groups(mesh: Mesh, batch_axis: str = "dp"):
    """``(group index of this process, number of groups)``: the processes
    grouped by their ``batch_axis`` coordinate, the data-feed unit of
    multi-process streaming (reference: parallel/mesh.py ·
    replica_groups). Processes of one group (their sequence shards span
    processes) are batch REPLICAS and must feed identical rows; groups
    feed disjoint rows, group ``g`` the ``g``-th block of the global
    batch. Each mesh position here is one process, so the group is the
    process's coordinate along ``batch_axis``."""
    if batch_axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no '{batch_axis}' "
                         f"axis")
    return mesh.index(batch_axis), mesh.axis_size(batch_axis)
