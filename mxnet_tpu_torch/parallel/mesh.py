"""Device mesh management.

Counterpart of ``mxnet_tpu/parallel/mesh.py``.  The JAX package is a
single controller: one process owns a ``jax.sharding.Mesh`` of devices.
The port runs one process per card, so a JAX mesh device is a RANK of
the process group here, and ``mesh.size`` is the number of ranks the
mesh spans.  The mesh keeps the JAX package's axis names and order
(``dp, fsdp, tp, pp, sp, ep``; ``shape`` maps each to its width,
``devices`` is the rank array in that shape, row-major), so rank
``devices[c]`` has the coordinates ``c`` of the JAX package's device at
the same position, and its shard of an array is the one that device
holds.

Collectives run on one process group per axis, ``group(axis)``, taken
from a ``torch.distributed.device_mesh.DeviceMesh`` over the mesh's axes
wider than one (in the JAX order), and on one group per set of such
axes, ``group(("dp", "fsdp"))`` (the ranks that share every other
coordinate), made with ``new_group`` when the mesh is; ``group()`` is
the whole mesh.  An axis of width one needs no group: ``group`` gives
None there (but for a one-rank mesh, which keeps its one-rank group), as
it does on a mesh without a process group.

A mesh may span a subset of the ranks (``devices=[0, 1]`` in a world of
four), as an elastic job that shrinks or grows needs; every rank of the
world builds it (the group creation is collective), and on a rank
outside it ``is_member`` is False and ``rank`` None.  A lone process
without a process group has the one-rank mesh with no group.
"""
from __future__ import annotations

import itertools
from contextlib import contextmanager

import numpy as np
import torch

from ..base import MXNetError
from . import distributed

__all__ = ["make_mesh", "current_mesh", "mesh_scope", "replicated",
           "batch_sharded", "Mesh", "Sharding", "AXES"]

AXES = ("dp", "fsdp", "tp", "pp", "sp", "ep")

_CURRENT = []
# the process groups of each (device type, ranks, shape): group creation
# is collective, and every rank makes the same calls in the same order,
# so the cache stays consistent across the world
_DEVICE_MESHES = {}


def _axes_tuple(axes):
    if axes is None:
        return AXES
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Named mesh over ranks (see the module docstring); ``device`` is
    this rank's ``torch.device`` when the mesh was made."""

    def __init__(self, ranks, shape, groups=None):
        self.axis_names = AXES
        self.shape = {a: int(shape[a]) for a in AXES}
        self.ranks = [int(r) for r in ranks]
        self.devices = np.asarray(self.ranks).reshape(
            [self.shape[a] for a in AXES])
        self.device_mesh, self._groups = groups or (None, {})
        self.device = distributed.device()
        me = distributed.rank()
        self.rank = self.ranks.index(me) if me in self.ranks else None
        self.coords = None
        if self.rank is not None:
            c = np.unravel_index(self.rank, self.devices.shape)
            self.coords = {a: int(i) for a, i in zip(AXES, c)}

    @property
    def size(self):
        return len(self.ranks)

    @property
    def is_member(self):
        return self.rank is not None

    def axis_size(self, axes=None):
        """The product of the widths of ``axes`` (a name or names;
        default every axis)."""
        return int(np.prod([self.shape[a] for a in _axes_tuple(axes)]))

    def axis_index(self, axes=None):
        """This rank's row-major index over ``axes``: its position in
        ``group(axes)``, and the block of a dim split over them that it
        holds."""
        if not self.is_member:
            raise MXNetError("rank %d is outside %r"
                             % (distributed.rank(), self))
        idx = 0
        for a in _axes_tuple(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes=None):
        """The process group of the ranks that share every coordinate but
        those on ``axes`` (an axis name or a tuple; default every axis,
        the whole mesh) with this one; None where those axes are all of
        width one, where no group is up, or outside the mesh."""
        if self.device_mesh is None or not self.is_member:
            return None
        wide = tuple(a for a in AXES if a in _axes_tuple(axes)
                     and self.shape[a] > 1)
        if not wide:
            # a one-rank mesh keeps its one-rank group, so that a run on
            # one card issues (and measures) the collectives of a wider one
            return self.device_mesh.get_group("dp") if self.size == 1 \
                else None
        if len(wide) == 1:
            return self.device_mesh.get_group(wide[0])
        return self._groups[wide]

    def __repr__(self):
        return "Mesh(%s; ranks %s)" % (
            "x".join("%s=%d" % (a, self.shape[a]) for a in AXES),
            self.ranks)


def _make_groups(ranks, shape):
    """The DeviceMesh over the axes of ``shape`` wider than one (``dp``
    alone when none is) and a group per set of two or more of them."""
    from torch.distributed.device_mesh import DeviceMesh
    import torch.distributed as dist
    dev_type = "cuda" if distributed.device().type == "cuda" else "cpu"
    wide = [a for a in AXES if shape[a] > 1] or ["dp"]
    key = (dev_type, tuple(ranks), tuple(shape[a] for a in AXES))
    if key in _DEVICE_MESHES:
        return _DEVICE_MESHES[key]
    full = np.asarray(ranks).reshape([shape[a] for a in AXES])
    dm = DeviceMesh(dev_type, torch.tensor(full.reshape(
        [shape[a] for a in wide])), mesh_dim_names=tuple(wide))
    me = distributed.rank()
    combos = {}
    for k in range(2, len(wide) + 1):
        for axes in itertools.combinations(wide, k):
            # the cells: fix every other axis, vary these
            moved = np.moveaxis(full, [AXES.index(a) for a in axes],
                                list(range(-k, 0)))
            for cell in moved.reshape(-1, int(np.prod(
                    [shape[a] for a in axes]))):
                members = sorted(int(r) for r in cell)
                g = dist.new_group(ranks=members)
                if me in members:
                    combos[axes] = g
    _DEVICE_MESHES[key] = (dm, combos)
    return dm, combos


def make_mesh(dp=None, tp=1, pp=1, sp=1, ep=1, fsdp=1, devices=None):
    """A named mesh over ``devices`` (ranks; default every rank of the
    world), with the JAX package's checks and messages: the model axes
    must divide the device count, and an unspecified ``dp`` takes the
    rest, so ``make_mesh()`` is pure data parallelism over every card.
    A mesh the ranks cannot hold raises; it does not shrink.  A process
    that has not joined its world joins it first (``init_distributed``
    from the launcher's environment; a lone process stays a world of
    one)."""
    distributed.init_distributed()
    world = distributed.num_workers()
    ranks = list(range(world)) if devices is None else [int(d)
                                                       for d in devices]
    if not ranks or len(set(ranks)) != len(ranks) \
            or min(ranks) < 0 or max(ranks) >= world:
        raise MXNetError("mesh devices %s are not distinct ranks of a "
                         "world of %d" % (ranks, world))
    n = len(ranks)
    fixed = int(tp) * int(pp) * int(sp) * int(ep) * int(fsdp)
    if dp is None:
        if n % fixed != 0:
            raise MXNetError(
                "mesh axes tp*pp*sp*ep*fsdp=%d do not divide device count "
                "%d" % (fixed, n))
        dp = n // fixed
    if int(dp) * fixed != n:
        raise MXNetError("mesh size %d != device count %d"
                         % (int(dp) * fixed, n))
    shape = dict(dp=int(dp), fsdp=int(fsdp), tp=int(tp), pp=int(pp),
                 sp=int(sp), ep=int(ep))
    if fixed > 1 and ranks != sorted(ranks):
        # a group orders its members by rank: the coordinates along an
        # axis must too
        raise MXNetError("a mesh with model axes takes its devices in "
                         "increasing rank order; got %s" % ranks)
    groups = None
    if distributed._group_up():
        groups = _make_groups(ranks, shape)
    return Mesh(ranks, shape, groups)


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
    whole, an axis name or a tuple of names for split)."""

    def __init__(self, mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def shard_shape(self, shape):
        """This rank's part of an array of ``shape``."""
        out = list(shape)
        for i, entry in enumerate(self.spec):
            if entry is not None:
                out[i] //= self.mesh.axis_size(entry)
        return tuple(out)

    def local(self, x):
        """This rank's part of the global tensor ``x``: along each split
        dim, the block of the axes named in its entry at this rank's
        row-major index over them (the JAX package's device layout)."""
        if not self.mesh.is_member:
            raise MXNetError("rank %d is outside %r"
                             % (distributed.rank(), self.mesh))
        for i, entry in enumerate(self.spec):
            if entry is None:
                continue
            f = self.mesh.axis_size(entry)
            if x.shape[i] % f:
                raise MXNetError(
                    "dim %d of %s does not divide mesh axes %s (=%d)"
                    % (i, tuple(x.shape), "x".join(_axes_tuple(entry)), f))
            rows = x.shape[i] // f
            x = x.narrow(i, self.mesh.axis_index(entry) * rows, rows)
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
