"""Pipeline parallelism over the ``pp`` mesh axis.

Counterpart of ``mxnet_tpu/parallel/pipeline.py`` (``stack_stages``,
``pipeline_apply``).  The JAX package compiles the GPipe schedule into
one program (``shard_map`` over ``pp``, ``lax.scan`` over the M + S - 1
steps, ``lax.ppermute`` to the next stage).  Here each rank of the ``pp``
axis is one stage, in its own process, and runs the same schedule
eagerly: at step t stage s runs microbatch t - s (stage 0 feeds it from
the batch, every other stage takes what the stage before sent at the
step before), then sends its activation on by point-to-point calls
(every send paired with its receive in one ``batch_isend_irecv``; a
stage outside its M steps sends zeros and runs nothing).  The last stage
keeps the outputs, and a SUM over ``pp`` (the JAX package's ``psum``)
hands the global (B, ...) result to every rank.

The backward runs the schedule in reverse inside one autograd
``Function`` (``_Pipeline``): at each step, from the last, every stage
sends its input's cotangent to the stage before and takes its output's
from the stage after (the transpose of the forward's exchange, made by
every stage at every step, so the calls pair up whatever each stage
computes; left to torch's autograd, the stages' differently shaped
graphs would order their exchanges differently), then runs its stage's
backward for that step.  The SUM's backward sums the ranks' output
gradients into the last stage's, and a stage's slice of the stacked
parameters takes its gradient in its own row.  Summed over the ranks,
the gradients of the stacked parameters and of ``x`` are the sequential
apply's (``ParallelTrainer``'s rule: see ``collectives``).

Constraints (the homogeneous-pipeline contract): every stage maps an
activation of one fixed shape to the same shape, and the stage
parameters are stacked on a leading stage axis (``stack_stages``).
``stage_fn(params, act)`` takes a pytree of tensors (dicts, lists and
tuples of them).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .collectives import sum_over, take_block

__all__ = ["pipeline_apply", "stack_stages"]


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (and the same places of
    the ``rest`` trees): dicts, lists and tuples are walked, anything
    else is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def stack_stages(param_trees):
    """Stack per-stage (or, in ``moe``, per-expert) parameter trees on a
    new leading axis."""
    first, rest = param_trees[0], param_trees[1:]
    return tree_map(lambda *leaves: torch.stack(leaves), first, *rest)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


class _Pipeline(torch.autograd.Function):
    """One stage's part of the GPipe schedule, forward and backward, with
    every point-to-point exchange made by every stage at every step (so
    each send meets its receive whatever a stage computes): forward
    ``(mbs, *param leaves) -> outs`` (the last stage's outputs, zeros on
    the others); backward the reverse schedule, the cotangent of each
    activation going back to the stage before."""

    @staticmethod
    def forward(ctx, mbs, sched, *leaves):
        stage_fn, tree, mesh, axis, S, M, idx = sched
        params = _rebuild(tree, [p.detach().requires_grad_(p.requires_grad)
                                 for p in leaves])
        ctx.sched, ctx.params = sched, params
        ctx.steps = []
        buf = torch.zeros_like(mbs[0])
        outs = []
        group = mesh.group(axis)
        for t in range(M + S - 1):
            mb = t - idx
            if 0 <= mb < M:
                inp = (mbs[mb] if idx == 0 else buf).detach() \
                    .requires_grad_(True)
                with torch.enable_grad():
                    out = stage_fn(params, inp)
                ctx.steps.append((t, mb, inp, out))
                if idx == S - 1:
                    outs.append(out.detach())
                send = out.detach()
            else:
                send = torch.zeros_like(buf)
            if t != M + S - 2:
                buf = _shift_raw(send, group, S)
        return torch.stack(outs) if outs else torch.zeros_like(mbs)

    @staticmethod
    def backward(ctx, g_outs):
        stage_fn, tree, mesh, axis, S, M, idx = ctx.sched
        del stage_fn, tree
        group = mesh.group(axis)
        leaves = _leaves(ctx.params)
        wants = [p for p in leaves if p.requires_grad]
        g_params = [torch.zeros_like(p) for p in wants]
        g_mbs = torch.zeros((M,) + tuple(g_outs.shape[1:]),
                            dtype=g_outs.dtype, device=g_outs.device)
        by_step = {t: (mb, inp, out) for t, mb, inp, out in ctx.steps}
        g_buf = torch.zeros_like(g_mbs[0])
        for t in reversed(range(M + S - 1)):
            # the transpose of step t's send: this stage's input cotangent
            # of step t + 1 back to the stage before, the cotangent of its
            # own step-t output from the stage after
            g_out = torch.zeros_like(g_buf) if t == M + S - 2 \
                else _shift_raw(g_buf, group, S, back=True)
            g_buf = torch.zeros_like(g_out)
            if t not in by_step:
                continue
            mb, inp, out = by_step[t]
            if idx == S - 1:
                g_out = g_out + g_outs[mb]
            grads = torch.autograd.grad(out, [inp] + wants, g_out,
                                        allow_unused=True)
            for acc, g in zip(g_params, grads[1:]):
                if g is not None:
                    acc += g
            if idx == 0:
                g_mbs[mb] += grads[0]
            else:
                g_buf = grads[0]
        ctx.steps = None
        it = iter(g_params)
        return (g_mbs, None) + tuple(next(it) if p.requires_grad else None
                                     for p in leaves)


def _shift_raw(x, group, n, back=False):
    """Every stage's ``x`` to the next (``back``: to the one before); the
    first (last) stage receives zeros."""
    from .collectives import _shift
    if n == 1:
        return torch.zeros_like(x)
    return _shift(x, -1 if back else 1, group, wrap=False)


def pipeline_apply(stage_fn, stacked_params, x, mesh, num_microbatches=None,
                   axis="pp"):
    """Run ``x`` through S pipeline stages sharded over ``axis``.

    stage_fn(params, act) -> act : one stage, shape-preserving.
    stacked_params: pytree with leading stage dim S == mesh.shape[axis].
    x: (B, ...) global batch; B must divide into ``num_microbatches``
    (default S) equal microbatches.

    Returns the (B, ...) output after all S stages, on every rank."""
    S = mesh.shape[axis]
    M = int(num_microbatches or S)
    B = x.shape[0]
    if B % M:
        raise MXNetError("batch %d not divisible into %d microbatches"
                         % (B, M))
    mbs = x.reshape((M, B // M) + tuple(x.shape[1:]))
    # this stage's slice of every stacked leaf
    params = tree_map(lambda a: take_block(a, 0, mesh, axis)[0],
                      stacked_params)
    sched = (stage_fn, params, mesh, axis, S, M, mesh.coords[axis])
    mine = _Pipeline.apply(mbs, sched, *_leaves(params))
    # the result lives on the last stage only; the SUM replicates it
    out = sum_over(mine, mesh, axis)
    return out.reshape((B,) + tuple(out.shape[2:]))
