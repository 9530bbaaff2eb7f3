"""Shape and indexing operators (counterpart of ``mxnet_tpu/ops/matrix.py``;
this package carries Flatten, Reshape with MXNet's codes, expand_dims,
slice_like, Embedding and pick)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import Param as P, normalize_tuple, register


@register("Flatten", aliases=("flatten",))
def _flatten(x, **attrs):
    return x.reshape(x.shape[0], -1)


def _infer_reshape(src_shape, target):
    """MXNet reshape spec with 0/-1/-2/-3/-4 codes
    (reference: matrix_op-inl.h ReshapeParam/InferReshapeShape)."""
    out, src_idx = [], 0
    i = 0
    target = list(target)
    while i < len(target):
        t = target[i]
        if t == 0:
            out.append(src_shape[src_idx])
            src_idx += 1
        elif t == -1:
            out.append(-1)
            src_idx += 1
        elif t == -2:
            out.extend(src_shape[src_idx:])
            src_idx = len(src_shape)
        elif t == -3:
            out.append(src_shape[src_idx] * src_shape[src_idx + 1])
            src_idx += 2
        elif t == -4:
            d1, d2 = target[i + 1], target[i + 2]
            cur = src_shape[src_idx]
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            src_idx += 1
            i += 2
        else:
            out.append(t)
            src_idx += 1
        i += 1
    return tuple(out)


@register("Reshape", aliases=("reshape",), params=[
    P("shape", tuple, default=None),
    P("reverse", bool, default=False)])
def _reshape(x, shape=None, reverse=False, **attrs):
    """Reference: src/operator/tensor/matrix_op-inl.h Reshape."""
    if shape is None:
        raise MXNetError("Reshape: a target shape is required")
    shape = normalize_tuple(shape)
    if reverse:
        tgt = _infer_reshape(tuple(x.shape)[::-1], list(shape)[::-1])[::-1]
    else:
        tgt = _infer_reshape(tuple(x.shape), shape)
    return x.reshape(tgt)


@register("expand_dims", params=[P("axis", int, required=True)])
def _expand_dims(x, axis=0, **attrs):
    return x.unsqueeze(axis)


@register("slice_like")
def _slice_like(x, like, axes=(), **attrs):
    """``x`` cut to ``like``'s extent along ``axes`` (all axes when
    empty), from index 0."""
    axes = normalize_tuple(axes) if axes else tuple(range(x.dim()))
    idx = [slice(None)] * x.dim()
    for a in axes:
        idx[a % x.dim()] = slice(0, like.shape[a % x.dim()])
    return x[tuple(idx)]


@register("Embedding", params=[
    P("input_dim", int, required=True, low=1),
    P("output_dim", int, required=True, low=1),
    P("sparse_grad", bool, default=False)])
def _embedding(data, weight, input_dim=None, output_dim=None,
               dtype="float32", sparse_grad=False, **attrs):
    """Reference: src/operator/tensor/indexing_op.h EmbeddingOp.  Ids
    arrive as float32, as in the reference, and are cast to integers;
    an out-of-range id raises."""
    return F.embedding(data.to(torch.int64), weight)


@register("pick", params=[
    P("axis", int, default=-1),
    P("keepdims", bool, default=False),
    P("mode", ("clip", "wrap"), default="clip")])
def _pick(data, index, axis=-1, keepdims=False, mode="clip", **attrs):
    """Reference: broadcast_reduce_op_index.cc pick, as the JAX package
    computes it: one element of ``data`` along ``axis`` per position of
    ``index`` (ids may arrive as float32); out-of-range ids clip or wrap,
    and ``axis=None`` picks from the flattened input."""
    idx = index.to(torch.int64)
    if axis is None:
        flat = data.reshape(-1)
        n = flat.shape[0]
        idx = idx % n if mode == "wrap" else idx.clamp(0, n - 1)
        out = flat[idx]
        return out.unsqueeze(-1) if keepdims else out
    dim = data.shape[axis]
    idx = idx % dim if mode == "wrap" else idx.clamp(0, dim - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)
