"""Reductions and ordering (counterpart of ``mxnet_tpu/ops/reduce.py``;
reference: src/operator/tensor/broadcast_reduce_op.h, ordering_op-inl.h).

A reduction over every axis gives what the JAX package gives: a 0-dim
array, or ``(1,) * ndim`` with ``keepdims``.  Integer sums and products
keep the input's dtype (torch would widen them to int64); ``mean`` of an
integer array is float32.  Ops that return indices (``argmax``,
``argmin``, ``argmax_channel``, ``topk``, ``argsort``) return them as
float32, as the reference does.  ``topk`` and ``argsort`` order equal
values as the JAX package does, by a stable sort: ``topk`` puts the
lowest index first in either direction (``lax.top_k``), and a
descending ``argsort`` is the ascending one reversed, so there the
highest index comes first.  ``torch.topk`` promises no order for ties
and differs between the CPU and the card, so it is not used.
"""
from __future__ import annotations

import torch

from .registry import Param as P, normalize_tuple, register


def _norm_axis(axis, ndim, exclude=False):
    if axis is None or axis == ():
        return None     # a full reduction, whatever exclude says
    if isinstance(axis, int):
        axis = (axis,)
    ax = tuple(a % ndim for a in axis)
    if exclude:
        ax = tuple(a for a in range(ndim) if a not in ax)
    return ax


def _keep_int(f):
    """``f`` with an integer input's dtype kept in the result."""
    def g(x, *args, **kw):
        out = f(x, *args, **kw)
        return out if x.is_floating_point() else out.to(x.dtype)
    return g


def _prod(x, dim=None, keepdim=False):
    if dim is None:
        return torch.prod(x)
    out = x
    for d in sorted(dim, reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdim)
    return out


def _nanprod(x, dim=None, keepdim=False):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim,
                 keepdim)


def _mean(x, dim=None, keepdim=False):
    if not x.is_floating_point():
        x = x.float()
    return torch.mean(x) if dim is None else torch.mean(x, dim=dim,
                                                        keepdim=keepdim)


def _reduce(name, f, aliases=()):
    @register(name, aliases=aliases)
    def _op(x, axis=None, keepdims=False, exclude=False, **attrs):
        ax = _norm_axis(axis, x.dim(), exclude)
        if ax is None:
            out = f(x)
            return out.reshape((1,) * x.dim()) if keepdims else out
        if not ax:
            return x
        return f(x, dim=ax, keepdim=bool(keepdims))
    _op.__name__ = name
    return _op


_reduce("sum", _keep_int(torch.sum), aliases=("sum_axis",))
_reduce("mean", _mean)
_reduce("prod", _keep_int(_prod))
_reduce("nansum", _keep_int(torch.nansum))
_reduce("nanprod", _keep_int(_nanprod))
_reduce("max", torch.amax, aliases=("max_axis",))
_reduce("min", torch.amin, aliases=("min_axis",))


@register("_square_sum", aliases=("square_sum",))
def _square_sum(x, axis=None, keepdims=False, exclude=False, **attrs):
    """The sum of squares over ``axis`` (reference: tensor/
    square_sum-inl.h)."""
    ax = _norm_axis(axis, x.dim(), exclude)
    s = torch.square(x)
    if ax is None:
        out = _keep_int(torch.sum)(s)
        return out.reshape((1,) * x.dim()) if keepdims else out
    if not ax:
        return s
    return _keep_int(torch.sum)(s, dim=ax, keepdim=bool(keepdims))


@register("norm")
def _norm(x, ord=2, axis=None, keepdims=False, **attrs):
    """The L1 norm (``ord=1``) or the L2 norm over ``axis``."""
    ax = _norm_axis(axis, x.dim())
    s = torch.abs(x) if ord == 1 else torch.square(x)
    if ax is None:
        out = torch.sum(s)
        if keepdims:
            out = out.reshape((1,) * x.dim())
    else:
        out = torch.sum(s, dim=ax, keepdim=bool(keepdims))
    return out if ord == 1 else torch.sqrt(out)


def _arg(f, x, axis, keepdims):
    if axis is None:
        out = f(x.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * x.dim())
    else:
        out = f(x, dim=axis, keepdim=bool(keepdims))
    return out.to(torch.float32)


@register("argmax")
def _argmax(x, axis=None, keepdims=False, **attrs):
    return _arg(torch.argmax, x, axis, keepdims)


@register("argmin")
def _argmin(x, axis=None, keepdims=False, **attrs):
    return _arg(torch.argmin, x, axis, keepdims)


@register("argmax_channel")
def _argmax_channel(x, **attrs):
    """Reference: broadcast_reduce_op_index.cc argmax_channel."""
    return torch.argmax(x, dim=1).to(torch.float32)


def _topk_nout(attrs):
    return 2 if attrs.get("ret_typ", "indices") == "both" else 1


@register("topk", num_outputs=_topk_nout, params=[
    P("axis", int, default=-1),
    P("k", int, default=1, low=1),
    P("ret_typ", ("indices", "value", "mask", "both"), default="indices"),
    P("is_ascend", bool, default=False)])
def _topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32", **attrs):
    """Reference: ordering_op-inl.h TopK; ``axis=None`` ranks the
    flattened array.  A stable sort over the moved axis, its first ``k``
    entries: among equal values the lowest index comes first."""
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    axis = axis % x.dim()
    xm = torch.movedim(x, axis, -1)
    vals, idx = torch.sort(xm, dim=-1, descending=not is_ascend, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if ret_typ == "mask":
        mask = torch.zeros_like(xm).scatter_(
            -1, idx, torch.ones((), dtype=x.dtype, device=x.device).expand(
                idx.shape))
        return torch.movedim(mask, -1, axis)
    vals = torch.movedim(vals, -1, axis)
    idx = torch.movedim(idx, -1, axis).to(torch.float32)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx
    return idx


@register("sort")
def _sort(x, axis=-1, is_ascend=True, **attrs):
    if axis is None:
        x, axis = x.reshape(-1), 0
    out = torch.sort(x, dim=axis).values
    return out if is_ascend else torch.flip(out, dims=(axis,))


@register("argsort")
def _argsort(x, axis=-1, is_ascend=True, dtype="float32", **attrs):
    if axis is None:
        x, axis = x.reshape(-1), 0
    out = torch.argsort(x, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, dims=(axis,))
    return out.to(torch.float32)


@register("broadcast_to")
def _broadcast_to(x, shape=None, **attrs):
    """A 0 in ``shape`` keeps the input's dim (the reference's rule)."""
    shape = normalize_tuple(shape)
    tgt = tuple(s if s != 0 else x.shape[i] for i, s in enumerate(shape))
    return x.expand(tgt).contiguous()


@register("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(x, axis=(), size=(), **attrs):
    tgt = list(x.shape)
    for a, s in zip(normalize_tuple(axis), normalize_tuple(size)):
        tgt[a] = s
    return x.expand(tuple(tgt)).contiguous()


@register("broadcast_like")
def _broadcast_like(x, like, **attrs):
    return x.expand(like.shape).contiguous()
