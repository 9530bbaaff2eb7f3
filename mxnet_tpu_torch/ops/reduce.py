"""Reductions (counterpart of ``mxnet_tpu/ops/reduce.py``; reference:
src/operator/tensor/broadcast_reduce_op.h).  This package carries sum
and mean with ``axis``, ``keepdims`` and ``exclude``."""
from __future__ import annotations

import torch

from .registry import register


def _norm_axis(axis, ndim, exclude=False):
    if axis is None or axis == ():
        return None     # a full reduction, whatever exclude says
    if isinstance(axis, int):
        axis = (axis,)
    ax = tuple(a % ndim for a in axis)
    if exclude:
        ax = tuple(a for a in range(ndim) if a not in ax)
    return ax


def _reduce(name, f, aliases=()):
    @register(name, aliases=aliases)
    def _op(x, axis=None, keepdims=False, exclude=False, **attrs):
        ax = _norm_axis(axis, x.dim(), exclude)
        if ax is None:
            out = f(x)
            return out.reshape((1,) * x.dim()) if keepdims else out
        return f(x, dim=ax, keepdim=bool(keepdims))
    _op.__name__ = name
    return _op


_reduce("sum", torch.sum, aliases=("sum_axis",))
_reduce("mean", torch.mean)
