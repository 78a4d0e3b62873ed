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

Beside the groups a collective of the model runs on, a mesh hands out a
**control group** (:meth:`Mesh.control_group`): gloo over CPU tensors
with a timeout of its own, for the small host-side records and tensors
that keep several processes in lock step (the tensor-parallel serving
loop's step records, pushed weights, migrated KV blocks). It never
carries a model collective, and a model collective never rides it: on
two ranks sharing one card the tp group is gloo on CUDA tensors, which
serves only ``all_reduce`` and ``broadcast``.
"""

from __future__ import annotations

import datetime
import itertools
import threading
from typing import Dict, Optional

import numpy as np
import torch.distributed as dist

# the meshes bound by `with mesh:`, innermost last, per thread
_local = threading.local()

# seconds a control-group collective waits for a peer that never joins
CONTROL_TIMEOUT_S = 60.0


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
        # axis -> this rank's control group
        self._control: Dict[str, object] = {}

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

    def control_group(self, axis: str):
        """The gloo group over CPU tensors spanning ``axis`` through this
        rank, with a timeout of its own (:data:`CONTROL_TIMEOUT_S`): a
        collective on it that a peer never joins raises after that long,
        and one whose peer died raises at once. ``None`` where the group
        is this rank alone. Building it is collective: every rank of the
        world calls this with the same axis, in the same order relative
        to its other group constructions (the group is then cached on
        the mesh)."""
        if self.group(axis) is None:  # also validates the axis
            return None
        if axis not in self._control:
            timeout = datetime.timedelta(seconds=CONTROL_TIMEOUT_S)
            sizes = [self.shape[a] for a in self.axis_names]
            mine = None
            for ranks in _member_lists(sizes, [self.axis_names.index(axis)]):
                g = dist.new_group(ranks, timeout=timeout, backend="gloo")
                if dist.get_rank() in ranks:
                    mine = g
            self._control[axis] = mine
        return self._control[axis]

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


def _world_size() -> int:
    """The initialized ``torch.distributed`` world's size (1 without
    one)."""
    return dist.get_world_size() if (dist.is_available()
                                     and dist.is_initialized()) else 1


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
    world = _world_size()
    if need != world:
        raise ValueError(
            f"mesh axes {axes} need {need} processes; the torch.distributed "
            f"world has {world} (init_process_group with world_size={need} "
            f"first)")
    if world == 1:
        return local_mesh(axes)
    names = tuple(axes)
    rank = dist.get_rank()
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank,
                                                               sizes))))
    groups = {}
    # every subset of axes, in one fixed order on every rank: one group
    # per setting of the other axes' coordinates
    for r in range(1, len(names) + 1):
        for key in itertools.combinations(names, r):
            for ranks in _member_lists(sizes, [names.index(a)
                                               for a in key]):
                g = dist.new_group(ranks) if len(ranks) > 1 else None
                if rank in ranks:
                    groups[key] = g
    return Mesh(axes, coords, groups)


def default_mesh(num_workers: Optional[int] = None) -> Mesh:
    """The 1-D data-parallel mesh ``{"dp": n}`` over the
    ``torch.distributed`` world (reference: parallel/mesh.py ·
    default_mesh), ``n`` = ``num_workers`` or the world's size; a world
    of one needs no process group. The reference takes the first ``n``
    of more devices; a position here is a process, so ``n`` must equal
    the world's size."""
    world = _world_size()
    n = num_workers or world
    if n != world:
        raise ValueError(
            f"num_workers={n} but the torch.distributed world has {world} "
            f"process(es); a mesh position is a process")
    return make_mesh({"dp": n})


def _member_lists(sizes, keep):
    """The world ranks of each group spanning the axes at indexes
    ``keep`` of a row-major grid of ``sizes``: one list per setting of
    the other axes' coordinates, in one fixed order."""
    grid = np.arange(int(np.prod(sizes))).reshape(sizes)
    rest = [i for i in range(len(sizes)) if i not in keep]
    moved = np.moveaxis(grid, rest, list(range(len(rest))))
    return [[int(m) for m in members] for members in moved.reshape(
        -1, int(np.prod([sizes[i] for i in keep])))]


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
