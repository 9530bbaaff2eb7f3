"""Device mesh management.

Counterpart of ``mxnet_tpu/parallel/mesh.py``.  The JAX package is a
single controller: one process owns a ``jax.sharding.Mesh`` of devices.
The port runs one process per card, so a JAX mesh device is a RANK of
the process group here, and ``mesh.size`` is the number of ranks the
mesh spans.  The mesh keeps the JAX package's axis names and order
(``dp, fsdp, tp, pp, sp, ep``; ``shape`` maps each to its width,
``devices`` is the rank array in that shape), and holds a
``torch.distributed.device_mesh.DeviceMesh`` over its ranks, whose ``dp``
group carries the trainer's collectives.  Only ``dp`` is wider than one
in this package: the model axes (``tp``, ``pp``, ``sp``, ``ep``,
``fsdp``) raise until the slice that shards the model.

A mesh may span a subset of the ranks (``devices=[0, 1]`` in a world of
four), as an elastic job that shrinks or grows needs; every rank of the
world builds it (the group creation is collective), and on a rank
outside it ``is_member`` is False and ``rank`` None.  A lone process
without a process group has the one-rank mesh with no group.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from ..base import MXNetError
from . import distributed

__all__ = ["make_mesh", "current_mesh", "mesh_scope", "replicated",
           "batch_sharded", "Mesh", "Sharding", "AXES"]

AXES = ("dp", "fsdp", "tp", "pp", "sp", "ep")

_CURRENT = []
# one DeviceMesh (and so one group) per rank set and device type: group
# creation is collective, and every rank makes the same calls in the same
# order, so the cache stays consistent across the world
_DEVICE_MESHES = {}


class Mesh:
    """Named mesh over ranks (see the module docstring); ``device`` is
    this rank's ``torch.device`` when the mesh was made."""

    def __init__(self, ranks, shape, device_mesh=None):
        self.axis_names = AXES
        self.shape = {a: int(shape[a]) for a in AXES}
        self.ranks = [int(r) for r in ranks]
        self.devices = np.asarray(self.ranks).reshape(
            [self.shape[a] for a in AXES])
        self.device_mesh = device_mesh
        self.device = distributed.device()
        me = distributed.rank()
        self.rank = self.ranks.index(me) if me in self.ranks else None

    @property
    def size(self):
        return len(self.ranks)

    @property
    def is_member(self):
        return self.rank is not None

    @property
    def group(self):
        """The ``dp`` process group, or None (no group is up, or this
        rank is outside the mesh)."""
        if self.device_mesh is None or not self.is_member:
            return None
        return self.device_mesh.get_group("dp")

    def __repr__(self):
        return "Mesh(%s; ranks %s)" % (
            "x".join("%s=%d" % (a, self.shape[a]) for a in AXES),
            self.ranks)


def make_mesh(dp=None, tp=1, pp=1, sp=1, ep=1, fsdp=1, devices=None):
    """A named mesh over ``devices`` (ranks; default every rank of the
    world).  Unspecified ``dp`` takes them all, so ``make_mesh()`` is
    pure data parallelism over every card.  A process that has not joined
    its world joins it first (``init_distributed`` from the launcher's
    environment; a lone process stays a world of one)."""
    distributed.init_distributed()
    for name, width in (("tp", tp), ("pp", pp), ("sp", sp), ("ep", ep),
                        ("fsdp", fsdp)):
        if int(width) != 1:
            raise MXNetError(
                "mesh axis %s=%d: this package shards only the batch (dp); "
                "model-axis sharding (tp, fsdp, pp, sp, ep) comes with the "
                "next multi-GPU slice" % (name, width))
    world = distributed.num_workers()
    ranks = list(range(world)) if devices is None else [int(d)
                                                       for d in devices]
    if not ranks or len(set(ranks)) != len(ranks) \
            or min(ranks) < 0 or max(ranks) >= world:
        raise MXNetError("mesh devices %s are not distinct ranks of a "
                         "world of %d" % (ranks, world))
    n = len(ranks)
    if dp is None:
        dp = n
    if int(dp) != n:
        raise MXNetError("mesh size %d != device count %d" % (dp, n))
    shape = dict.fromkeys(AXES, 1)
    shape["dp"] = n
    device_mesh = None
    if distributed._group_up():
        from torch.distributed.device_mesh import DeviceMesh
        dev_type = "cuda" if distributed.device().type == "cuda" else "cpu"
        key = (dev_type, tuple(ranks))
        device_mesh = _DEVICE_MESHES.get(key)
        if device_mesh is None:
            device_mesh = DeviceMesh(dev_type, torch.tensor(ranks),
                                     mesh_dim_names=("dp",))
            _DEVICE_MESHES[key] = device_mesh
    return Mesh(ranks, shape, device_mesh)


def current_mesh():
    if _CURRENT:
        return _CURRENT[-1]
    return None


@contextmanager
def mesh_scope(mesh):
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


class Sharding:
    """How an array lies on a mesh: ``spec`` is the JAX package's
    PartitionSpec as a tuple, one entry per leading dim (``None`` for
    whole, an axis name for split)."""

    def __init__(self, mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def shard_shape(self, shape):
        """This rank's part of an array of ``shape``."""
        out = list(shape)
        for i, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            f = 1
            for a in axes:
                f *= self.mesh.shape[a]
            out[i] //= f
        return tuple(out)

    def local(self, x):
        """This rank's part of the global tensor ``x`` (contiguous equal
        blocks along each split dim, in mesh rank order)."""
        if not self.mesh.is_member:
            raise MXNetError("rank %d is outside %r"
                             % (distributed.rank(), self.mesh))
        for i, entry in enumerate(self.spec):
            if entry is None:
                continue
            if x.shape[i] % self.mesh.size:
                raise MXNetError(
                    "dim %d of %s does not divide the %d-way mesh"
                    % (i, tuple(x.shape), self.mesh.size))
            rows = x.shape[i] // self.mesh.size
            x = x.narrow(i, self.mesh.rank * rows, rows)
        return x

    def __repr__(self):
        return "Sharding(%r, spec=%s)" % (self.mesh, self.spec)


def replicated(mesh):
    """Sharding for fully-replicated arrays (params in pure DP)."""
    return Sharding(mesh, ())


def batch_sharded(mesh, axis=0, axes=("dp",)):
    """Sharding that splits dim ``axis`` across the given mesh axes."""
    spec = [None] * (axis + 1)
    spec[axis] = tuple(axes) if len(axes) > 1 else axes[0]
    return Sharding(mesh, spec)
