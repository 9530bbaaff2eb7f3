"""Creation operators (counterpart of ``mxnet_tpu/ops/init_ops.py``;
reference: src/operator/tensor/init_op.h).

An op without tensor inputs makes its output on ``ctx``: a Context (default the
current context), or the ``torch.device`` that the executor passes for a graph
node (``meta`` during shape inference).  ``shape_array`` and ``size_array`` are
int32, as the JAX package's int64 request gives with its 32-bit types.
"""
from __future__ import annotations

import torch

from ..base import dtype_torch
from ..context import resolve
from .registry import normalize_tuple, register


def device_of(ctx):
    """``ctx`` (a Context, a ``torch.device`` or None) as a
    ``torch.device``; None means the current context."""
    if isinstance(ctx, torch.device) and ctx.type == "meta":
        return ctx
    return resolve(ctx)


def _shape(shape):
    return normalize_tuple(shape) if shape != () else ()


@register("_zeros", aliases=("zeros_like_shape",))
def _zeros(shape=(), dtype="float32", ctx=None, **attrs):
    return torch.zeros(_shape(shape), dtype=dtype_torch(dtype),
                       device=device_of(ctx))


@register("_ones")
def _ones(shape=(), dtype="float32", ctx=None, **attrs):
    return torch.ones(_shape(shape), dtype=dtype_torch(dtype),
                      device=device_of(ctx))


@register("_full")
def _full(shape=(), value=0.0, dtype="float32", ctx=None, **attrs):
    return torch.full(normalize_tuple(shape), value,
                      dtype=dtype_torch(dtype), device=device_of(ctx))


@register("_arange")
def _arange(start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
            dtype="float32", ctx=None, **attrs):
    """``[start, stop)`` by ``step`` (``[0, start)`` without ``stop``),
    each value repeated ``repeat`` times, on ``ctx`` (default the current
    context)."""
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=dtype_torch(dtype),
                       device=device_of(ctx))
    if repeat > 1:
        out = out.repeat_interleave(int(repeat))
    return out


@register("_eye")
def _eye(N=0, M=0, k=0, dtype="float32", ctx=None, **attrs):
    """N x M (M 0: N x N) with ones on diagonal ``k``."""
    dev = device_of(ctx)
    n, m = int(N), int(M) if M else int(N)
    i = torch.arange(n, device=dev)[:, None]
    j = torch.arange(m, device=dev)[None, :]
    return (j - i == int(k)).to(dtype_torch(dtype))


@register("zeros_like")
def _zeros_like(x, **attrs):
    return torch.zeros_like(x)


@register("ones_like")
def _ones_like(x, **attrs):
    return torch.ones_like(x)


@register("shape_array")
def _shape_array(x, **attrs):
    """x's shape as a 1-D int32 array, made on x's device (a fill per
    dim: no copy from the host)."""
    return torch.stack([torch.full((), d, dtype=torch.int32, device=x.device)
                        for d in x.shape]) if x.dim() else torch.zeros(
        0, dtype=torch.int32, device=x.device)


@register("size_array")
def _size_array(x, **attrs):
    return torch.full((1,), x.numel(), dtype=torch.int32, device=x.device)


@register("_rnn_state_zeros")
def _rnn_state_zeros(ref, shape=None, ref_batch_axis=0, **attrs):
    """A zero initial RNN state whose dims equal to 0 in ``shape`` take
    the batch dim of ``ref`` (axis ``ref_batch_axis``), so a symbolic
    ``begin_state`` is shape-inferable from the data (the JAX package's
    op, ``mxnet_tpu/ops/init_ops.py:59``)."""
    b = ref.shape[int(ref_batch_axis)]
    out_shape = tuple(b if int(d) == 0 else int(d)
                      for d in normalize_tuple(shape))
    return torch.zeros(out_shape, dtype=ref.dtype, device=ref.device)

