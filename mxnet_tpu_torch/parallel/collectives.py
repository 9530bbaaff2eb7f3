"""Bucketed gradient collectives: the plan, the wire model and the ops.

Counterpart of ``mxnet_tpu/parallel/collectives.py`` (the MPI-embedding
paper, PAPERS.md: issue each bucket's reduce as its backward segment
finishes instead of one barrier all-reduce at the end):

- :func:`build_bucket_plan` — partition the trainable parameters into
  size-capped flat fp32 buckets, REVERSE registration order, a smaller
  first bucket; :func:`flatten_bucket` / :func:`unflatten_bucket` — the
  padded 1-D buffer of one bucket and its per-parameter views.  The
  executor's fused optimizer step and ``ParallelTrainer`` both keep
  their weights in such buckets;
- :func:`comm_stats` — the per-step per-device wire model (ring
  collectives) behind ``mxnet_collective_{ops,bytes}_total``, the JAX
  package's numbers exactly;
- :func:`all_reduce`, :func:`reduce_scatter`, :func:`all_gather` — the
  per-bucket operations on a mesh's ``dp`` group (``torch.distributed``:
  NCCL on the card, gloo on the CPU), each counted in
  :func:`collective_calls` where it is issued;
- :func:`global_batch_stats` — makes training-mode BatchNorm take its
  moments over the whole data-parallel batch (a differentiable SUM
  all-reduce of the per-rank sums), which is what the JAX package's
  step, traced on the global array, computes;
- the differentiable edges and exchanges of a sharded region, each an
  autograd ``Function`` whose backward is the exact transpose of its
  forward, as JAX differentiates a ``shard_map``: :func:`take_block`
  (this rank's block of a dim; backward zero-pads), :func:`gather_blocks`
  (the blocks of every rank; backward reduce-scatters, a SUM),
  :func:`sum_over` (a SUM all-reduce; backward the same),
  :func:`all_to_all` (``lax.all_to_all(tiled=True)``; backward the
  inverse exchange) and :func:`shift` (``lax.ppermute`` by a fixed
  offset; backward the reverse shift).  Because each is the exact
  transpose, a rank's gradients are its share of the global one, and
  summing every gradient over the ranks that hold a copy or a part of
  it gives the JAX package's gradient (``ParallelTrainer``'s rule).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["Bucket", "build_bucket_plan", "flatten_bucket",
           "unflatten_bucket", "comm_stats", "ring_all_reduce_bytes",
           "ring_shard_bytes", "all_reduce", "reduce_scatter", "all_gather",
           "broadcast", "collective_calls", "reset_collective_calls",
           "record_comm", "global_batch_stats", "take_block",
           "gather_blocks", "sum_over", "all_to_all", "shift"]


class Bucket:
    """One bucket: a contiguous 1-D buffer over a fixed list of
    parameters, padded to ``pad_multiple`` elements."""

    __slots__ = ("index", "names", "shapes", "sizes", "offsets",
                 "n", "padded_n")

    def __init__(self, index, names, shapes, pad_multiple):
        self.index = index
        self.names = list(names)
        self.shapes = [tuple(s) for s in shapes]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.offsets = np.cumsum([0] + self.sizes).tolist()
        self.n = int(self.offsets[-1])
        pad = (-self.n) % max(int(pad_multiple), 1)
        self.padded_n = self.n + pad

    @property
    def nbytes(self):
        """Unpadded fp32 payload bytes of this bucket."""
        return 4 * self.n

    def to_dict(self):
        """Plain-data form (``ParallelTrainer.plan_spec``)."""
        return {"index": self.index, "names": list(self.names),
                "shapes": [list(s) for s in self.shapes],
                "sizes": list(self.sizes),
                "offsets": list(self.offsets),
                "n": self.n, "padded_n": self.padded_n}

    def __repr__(self):
        return "Bucket(%d: %d params, %d elems, %d padded)" % (
            self.index, len(self.names), self.n, self.padded_n)


def build_bucket_plan(names, shapes, bucket_bytes, first_bucket_bytes=None,
                      pad_multiple=1):
    """Partition ``names`` (registration order) into buckets of at most
    ``bucket_bytes``, walking in reverse so bucket 0 holds the parameters
    whose gradients a backward pass finishes first.  ``bucket_bytes <= 0``
    gives one bucket of everything."""
    names = list(names)
    shapes = [tuple(s) for s in shapes]
    if not names:
        return []
    bucket_bytes = int(bucket_bytes)
    if bucket_bytes <= 0:
        groups = [list(range(len(names)))[::-1]]
    else:
        first = int(first_bucket_bytes or bucket_bytes)
        groups, cur, cur_bytes = [], [], 0
        cap = max(first, 4)
        for i in reversed(range(len(names))):
            sz = 4 * (int(np.prod(shapes[i])) if shapes[i] else 1)
            if cur and cur_bytes + sz > cap:
                groups.append(cur)
                cur, cur_bytes = [], 0
                cap = max(bucket_bytes, 4)
            cur.append(i)
            cur_bytes += sz
        if cur:
            groups.append(cur)
    return [Bucket(bi, [names[i] for i in idxs],
                   [shapes[i] for i in idxs], pad_multiple)
            for bi, idxs in enumerate(groups)]


def flatten_bucket(values, bucket):
    """One bucket's tensors (in ``bucket.names`` order) as its padded
    1-D fp32 buffer (a new tensor)."""
    if values:
        flat = torch.cat([v.reshape(-1).to(torch.float32) for v in values])
    else:
        flat = torch.zeros((0,), dtype=torch.float32)
    if bucket.padded_n != bucket.n:
        flat = torch.cat([flat, flat.new_zeros(bucket.padded_n - bucket.n)])
    return flat


def unflatten_bucket(flat, bucket):
    """``{name: view}``: each parameter's slice of ``flat`` in its shape
    (views, so writing into ``flat`` writes into them)."""
    out = {}
    for name, shape, off, sz in zip(bucket.names, bucket.shapes,
                                    bucket.offsets, bucket.sizes):
        out[name] = flat[off:off + sz].view(shape)
    return out


def ring_all_reduce_bytes(nbytes, n):
    """Per-device wire bytes of a ring all-reduce over ``n`` members:
    reduce-scatter + all-gather phases, each moving (n-1)/n of the
    payload."""
    if n <= 1:
        return 0
    return 2 * int(nbytes) * (n - 1) // n


def ring_shard_bytes(nbytes, n):
    """Per-device wire bytes of one reduce-scatter OR all-gather."""
    if n <= 1:
        return 0
    return int(nbytes) * (n - 1) // n


def comm_stats(plan, mesh_size, zero, codec=None, sharded_bytes=(),
               param_bytes=None):
    """The static per-step per-device collective cost of one trainer
    configuration, ``{kind: {"ops": N, "bytes": B}}`` plus the summary
    columns, as the JAX package models it:

    - ``all_reduce``     — zero<=1 gradient reduction, 2 x payload x
      (n-1)/n per bucket (+ the reduction of each per-parameter
      gradient, ``sharded_bytes`` pairs of ``(local_bytes,
      replication)``);
    - ``reduce_scatter`` — zero=2 gradient reduction, payload x (n-1)/n;
    - ``all_gather``     — zero>=1 parameter re-broadcast after the
      sharded update, fp32 parameter bytes x (n-1)/n.

    ``payload`` is the codec's wire size when compression is on (the
    modeled size: see ``gradient_compression``)."""
    n = max(int(mesh_size), 1)
    kinds = {"all_reduce": {"ops": 0, "bytes": 0},
             "reduce_scatter": {"ops": 0, "bytes": 0},
             "all_gather": {"ops": 0, "bytes": 0}}
    grad_reduce = 0
    param_bytes = int(param_bytes if param_bytes is not None
                      else sum(4 * b.padded_n for b in plan))
    for b in plan:
        wire = codec.wire_bytes(b.padded_n) if codec is not None \
            else 4 * b.padded_n
        if zero >= 2:
            cost = ring_shard_bytes(wire, n)
            kinds["reduce_scatter"]["ops"] += 1
            kinds["reduce_scatter"]["bytes"] += cost
        else:
            cost = ring_all_reduce_bytes(wire, n)
            kinds["all_reduce"]["ops"] += 1
            kinds["all_reduce"]["bytes"] += cost
        grad_reduce += cost
    if zero >= 1 and plan:
        ag = ring_shard_bytes(param_bytes, n)
        kinds["all_gather"]["ops"] += len(plan)
        kinds["all_gather"]["bytes"] += ag
    for local_bytes, repl in sharded_bytes:
        if repl > 1:
            kinds["all_reduce"]["ops"] += 1
            cost = ring_all_reduce_bytes(int(local_bytes), int(repl))
            kinds["all_reduce"]["bytes"] += cost
            grad_reduce += cost
    total = sum(k["bytes"] for k in kinds.values())
    return {"kinds": kinds, "grad_reduce_bytes": int(grad_reduce),
            "total_bytes": int(total), "mesh_size": n, "zero": int(zero),
            "codec": codec.name if codec is not None else None,
            "buckets": len(plan)}


def record_comm(comm):
    """Advance ``mxnet_collective_{ops,bytes}_total{kind}`` by one step of
    the wire model ``comm`` (a :func:`comm_stats` result), while
    telemetry is on."""
    from .. import telemetry
    if not telemetry.enabled():
        return
    ops = telemetry.counter(
        "mxnet_collective_ops_total",
        "compiled-step collective operations by kind "
        "(reduce_scatter/all_gather/all_reduce; ring wire model, "
        "docs/faq/parallel.md)")
    byt = telemetry.counter(
        "mxnet_collective_bytes_total",
        "per-device collective wire bytes by kind (ring model; "
        "compressed buckets count the codec payload)")
    for kind, cost in comm["kinds"].items():
        if cost["ops"]:
            ops.labels(kind=kind).inc(cost["ops"])
            byt.labels(kind=kind).inc(cost["bytes"])


# -- the operations -----------------------------------------------------------
_CALLS_LOCK = threading.Lock()
_CALLS = dict.fromkeys(  # guarded-by: _CALLS_LOCK
    ("all_reduce", "reduce_scatter", "all_gather", "broadcast"), 0)


def _count(kind):
    with _CALLS_LOCK:
        _CALLS[kind] += 1


def collective_calls():
    """``{kind: calls}`` issued through this module since the last
    :func:`reset_collective_calls`, whatever the group's size."""
    with _CALLS_LOCK:
        return dict(_CALLS)


def reset_collective_calls():
    with _CALLS_LOCK:
        for k in _CALLS:
            _CALLS[k] = 0


def all_reduce(t, group, async_op=False):
    """SUM ``t`` in place over ``group``; a handle with ``async_op``."""
    import torch.distributed as dist
    _count("all_reduce")
    return dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group,
                           async_op=async_op)


def reduce_scatter(out, t, group, async_op=False):
    """``out`` = this rank's contiguous 1/n of the SUM of ``t`` over
    ``group``."""
    import torch.distributed as dist
    _count("reduce_scatter")
    # reduce_scatter_tensor was renamed reduce_scatter_single in newer torch
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    return fn(out, t, op=dist.ReduceOp.SUM, group=group, async_op=async_op)


def all_gather(out, t, group, async_op=False):
    """``out`` = the ranks' ``t`` concatenated in rank order."""
    import torch.distributed as dist
    _count("all_gather")
    # all_gather_into_tensor was renamed all_gather_single in newer torch
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    return fn(out, t, group=group, async_op=async_op)


def broadcast(t, src, group):
    """Overwrite ``t`` with global rank ``src``'s value."""
    import torch.distributed as dist
    _count("broadcast")
    return dist.broadcast(t, src=src, group=group)


class _SumAllReduce(torch.autograd.Function):
    """SUM all-reduce whose backward is the SUM all-reduce of the
    gradient (each rank's output feeds that rank's loss)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce(g, ctx.group)
        return g, None


@contextmanager
def global_batch_stats(group, size):
    """Inside, training-mode BatchNorm on this thread normalises with the
    moments of the whole batch of the ``size`` ranks of ``group``: the
    per-rank sums and squared deviations are all-reduced (differentiably)
    and divided by the global count; ranks hold equal shares.  A
    ``size`` of one changes nothing."""
    from ..ops import nn as _nn
    if group is None or size <= 1:
        yield
        return

    def reduce(t):
        return _SumAllReduce.apply(t, group)

    prev = getattr(_nn._BATCH_STATS, "reduce", None)
    _nn._BATCH_STATS.reduce = (reduce, int(size))
    try:
        yield
    finally:
        _nn._BATCH_STATS.reduce = prev


# -- the differentiable exchanges of a sharded region -------------------------
def _group_size(group):
    import torch.distributed as dist
    return 1 if group is None else dist.get_world_size(group)


def _gather_dim(x, dim, group):
    """Every rank's ``x`` of ``group`` concatenated along ``dim``, in group
    order (which is coordinate order: see ``mesh``)."""
    n = _group_size(group)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    all_gather(out, xt, group)
    return out.movedim(0, dim)


def _scatter_sum_dim(g, dim, group):
    """This rank's block along ``dim`` of the SUM of ``g`` over
    ``group``."""
    n = _group_size(group)
    if n == 1:
        return g
    gt = g.movedim(dim, 0).contiguous()
    out = gt.new_empty((gt.shape[0] // n,) + tuple(gt.shape[1:]))
    reduce_scatter(out, gt, group)
    return out.movedim(0, dim)


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, idx, n):
        ctx.dim, ctx.idx, ctx.size = dim, idx, x.shape[dim]
        rows = x.shape[dim] // n
        return x.narrow(dim, idx * rows, rows).contiguous()

    @staticmethod
    def backward(ctx, g):
        shape = list(g.shape)
        shape[ctx.dim] = ctx.size
        out = g.new_zeros(shape)
        rows = g.shape[ctx.dim]
        out.narrow(ctx.dim, ctx.idx * rows, rows).copy_(g)
        return out, None, None, None


def take_block(x, dim, mesh, axes):
    """This rank's block of ``x`` along ``dim`` split over mesh ``axes``
    (the JAX package's ``device_put`` scatter onto a sharded layout);
    its backward puts the gradient in place among zeros."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise MXNetError("dim %d of %s does not divide mesh axes %s (=%d)"
                         % (dim, tuple(x.shape), axes, n))
    return _TakeBlock.apply(x, dim, mesh.axis_index(axes), n)


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum_dim(g, ctx.dim, ctx.group), None, None


def gather_blocks(x, dim, mesh, axes):
    """The blocks of every rank of mesh ``axes`` joined along ``dim``
    into the global array (the JAX package's gather of a sharded result);
    its backward is the reduce-scatter of the gradient."""
    group = mesh.group(axes)
    if mesh.axis_size(axes) == 1:
        return x
    return _GatherBlocks.apply(x, dim, group)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        all_reduce(g, ctx.group)
        return g, None


def sum_over(x, mesh, axes):
    """``lax.psum`` over mesh ``axes``: the SUM over their ranks, whose
    backward is the same SUM of the gradient."""
    if mesh.axis_size(axes) == 1:
        return x
    return _SumOver.apply(x, mesh.group(axes))


def _all_to_all(x, split_dim, concat_dim, group, n):
    import torch.distributed as dist
    y = x.movedim(split_dim, 0)
    rows = y.shape[0] // n
    send = y.reshape((n, rows) + tuple(y.shape[1:])).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    c = concat_dim + 1 if concat_dim < split_dim else concat_dim
    out = torch.cat(list(recv.unbind(0)), dim=c)
    return out.movedim(0, split_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group, n):
        ctx.args = (split_dim, concat_dim, group, n)
        return _all_to_all(x, split_dim, concat_dim, group, n)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, group, n = ctx.args
        return (_all_to_all(g.contiguous(), concat_dim, split_dim, group, n),
                None, None, None, None)


def all_to_all(x, split_dim, concat_dim, mesh, axis):
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    ``x`` cut into n blocks along ``split_dim``, block j to the j-th
    rank of ``axis``, the blocks received joined along ``concat_dim`` in
    source order; its backward is the inverse exchange."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, mesh.group(axis), n)


def _shift(x, offset, group, wrap):
    """Send ``x`` to the rank ``offset`` places on in ``group`` and take
    the one from ``offset`` places back (zeros where, without ``wrap``,
    there is none): every send paired with its receive in one
    ``batch_isend_irecv``."""
    import torch.distributed as dist
    members = dist.get_process_group_ranks(group)
    n = len(members)
    i = members.index(dist.get_rank())
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    dst, src = i + offset, i - offset
    if wrap:
        dst, src = dst % n, src % n
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, x, members[dst], group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, out, members[src], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, group, wrap):
        ctx.args = (offset, group, wrap)
        return _shift(x, offset, group, wrap)

    @staticmethod
    def backward(ctx, g):
        offset, group, wrap = ctx.args
        return _shift(g, -offset, group, wrap), None, None, None


def shift(x, mesh, axis, offset=1, wrap=True):
    """``lax.ppermute`` along mesh ``axis``: every rank's ``x`` moves
    ``offset`` places on (around the ring with ``wrap``; else off the
    end, the first ranks receiving zeros); its backward moves the
    gradient back the other way."""
    if mesh.axis_size(axis) == 1:
        return x if wrap or offset == 0 else torch.zeros_like(x)
    return _Shift.apply(x, offset, mesh.group(axis), wrap)
