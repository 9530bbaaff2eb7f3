"""Long-tail operators (counterpart of ``mxnet_tpu/ops/misc.py``;
reference: src/operator/crop.cc, tensor/matrix_op.cc,
contrib/quadratic_op.cc, identity_attach_KL_sparse_reg.cc,
image/image_random.cc).

The storage ops work on dense values, as in the JAX package:
``_sparse_retain`` zeroes the rows not named, ``cast_storage`` is the
identity (the NDArray-level ``nd.cast_storage`` makes the sparse array)
and ``_contrib_SparseEmbedding`` is the Embedding lookup, whose
row-sparse gradient gluon's ``Embedding(sparse_grad=True)`` and the
lazy updates of ``optimizer.py`` handle.  ``_contrib_PSROIPooling``
averages each bin from a float64 summed-area table of the map, so it
needs no mask of the whole map.  ``Correlation`` is not ported yet
(ROADMAP.md queue 1 item 8).
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import Param as P, _coerce, normalize_tuple, register


@register("reshape_like")
def _reshape_like(lhs, rhs, **attrs):
    return lhs.reshape(rhs.shape)


@register("_identity_with_attr_like_rhs")
def _identity_like_rhs(lhs, rhs, **attrs):
    return lhs


def _region(x, begin, end, step):
    """Broadcasting index tensors of ``x[b:e:s, ...]`` over the first
    ``len(begin)`` axes, built on x's device (numpy's slice rules, a
    negative step included)."""
    from .matrix import _slice_dim
    steps = step if step else [1] * len(begin)
    idx = []
    nd = len(begin)
    for d, (b, e, s) in enumerate(zip(begin, end, steps)):
        r = _slice_dim(torch.arange(x.shape[d], device=x.device), 0, b, e,
                       s or None)
        idx.append(r.reshape((-1,) + (1,) * (nd - 1 - d)))
    return tuple(idx)


@register("_slice_assign")
def _slice_assign(lhs, rhs, begin=(), end=(), step=(), **attrs):
    """``lhs`` with ``rhs`` written into ``lhs[begin:end:step]``
    (reference: matrix_op.cc _slice_assign); a new array."""
    return lhs.index_put(_region(lhs, begin, end, step), rhs.to(lhs.dtype))


@register("_slice_assign_scalar")
def _slice_assign_scalar(data, begin=(), end=(), step=(), scalar=0.0,
                         **attrs):
    return data.index_put(_region(data, begin, end, step), torch.full(
        (), scalar, dtype=data.dtype, device=data.device))


@register("_contrib_quadratic", aliases=("quadratic",))
def _quadratic(data, a=0.0, b=0.0, c=0.0, **attrs):
    return a * data * data + b * data + c


@register("Crop", num_outputs=1)
def _crop(data, *like, offset=(0, 0), h_w=(0, 0), center_crop=False,
          **attrs):
    """Spatial crop of NCHW ``data`` (reference: crop.cc) to ``h_w``, or
    to the H and W of a second input when one is given."""
    offset = normalize_tuple(offset, 2)
    if like:
        th, tw = like[0].shape[2], like[0].shape[3]
    else:
        th, tw = normalize_tuple(h_w, 2)
    H, W = data.shape[2], data.shape[3]
    if center_crop:
        y0, x0 = (H - th) // 2, (W - tw) // 2
    else:
        y0, x0 = offset
    if y0 + th > H or x0 + tw > W or y0 < 0 or x0 < 0:
        raise ValueError("crop window offset %r + size (%d, %d) exceeds "
                         "input (%d, %d)" % ((y0, x0), th, tw, H, W))
    return data[:, :, y0:y0 + th, x0:x0 + tw]


class _KLSparseRegFn(torch.autograd.Function):
    """The identity forward; the backward adds the KL sparseness
    penalty's gradient, ``penalty * (-t / rho + (1 - t) / (1 - rho))``
    over the batch, to the head gradient."""

    @staticmethod
    def forward(ctx, x, rho, target, penalty):
        ctx.save_for_backward(rho.clamp(1e-6, 1.0 - 1e-6))
        ctx.attrs = (target, penalty, x.shape[0])
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (rho,) = ctx.saved_tensors
        t, penalty, n = ctx.attrs
        kl_grad = penalty * (-t / rho + (1.0 - t) / (1.0 - rho))
        return g + kl_grad[None] / n, None, None, None


@register("IdentityAttachKLSparseReg", num_outputs=2,
          mutate_aux=("moving_rho",))
def _identity_kl_sparse_reg(data, moving_rho=None, sparseness_target=0.1,
                            penalty=0.001, momentum=0.9, **attrs):
    """Reference: identity_attach_KL_sparse_reg.cc: the identity forward
    with the mean activation tracked as a momentum average (``moving_rho``,
    zeros when absent), and the KL penalty's gradient added in the
    backward.  As in the JAX package, ``moving_rho`` is a keyword, not an
    input slot, so the updated rho is written back into the last input of
    an imperative call."""
    if moving_rho is None:
        moving_rho = torch.zeros(data.shape[1:], dtype=data.dtype,
                                 device=data.device)
    batch_rho = torch.mean(data, dim=0)
    new_rho = (momentum * moving_rho + (1.0 - momentum) * batch_rho).detach()
    if not (torch.is_grad_enabled() and data.requires_grad):
        return data, new_rho
    return (_KLSparseRegFn.apply(data, new_rho, float(sparseness_target),
                                 float(penalty)), new_rho)


# -- storage ops (reference: src/operator/tensor/sparse_retain-inl.h,
# cast_storage-inl.h, indexing_op.cc SparseEmbedding) ------------------------
@register("_sparse_retain", aliases=("sparse_retain",))
def _sparse_retain_op(data, indices, **attrs):
    """``data`` with every row not named in ``indices`` zeroed (the row
    mask by ``index_fill_``, which reads nothing back to the host)."""
    mask = torch.zeros(data.shape[0], dtype=torch.bool,
                       device=data.device).index_fill_(
        0, indices.to(torch.int64), True)
    return torch.where(mask.reshape((-1,) + (1,) * (data.dim() - 1)), data,
                       torch.zeros((), dtype=data.dtype, device=data.device))


@register("cast_storage", params=[
    P("stype", ("default", "row_sparse", "csr"), default="default")])
def _cast_storage_op(data, stype="default", **attrs):
    return data


@register("_contrib_SparseEmbedding")
def _sparse_embedding(data, weight, input_dim=0, output_dim=0, **attrs):
    return torch.nn.functional.embedding(data.to(torch.int64), weight)


# -- image ops (reference: src/operator/image/image_random.cc) -------------
@register("_image_to_tensor", aliases=("to_tensor",))
def _image_to_tensor(data, **attrs):
    """HWC in [0, 255] to CHW float32 in [0, 1] (reference:
    image_random-inl.h ToTensor); NHWC becomes NCHW."""
    x = data.to(torch.float32) / 255.0
    if x.dim() == 3:
        return x.permute(2, 0, 1)
    return x.permute(0, 3, 1, 2)


@register("_image_normalize", aliases=("image_normalize",))
def _image_normalize(data, mean=(0.0,), std=(1.0,), **attrs):
    """``(x - mean) / std`` by channel of a CHW or NCHW tensor (reference:
    image_random-inl.h Normalize), one channel at a time with the float32
    constants as scalars, so that no host array is copied to the card."""
    axis = data.dim() - 3
    n = data.shape[axis]
    mean, std = (np.broadcast_to(np.atleast_1d(np.asarray(
        _coerce(v), np.float32)), (n,)) for v in (mean, std))
    return torch.stack([(x - float(m)) / float(s) for x, m, s in
                        zip(data.unbind(axis), mean, std)], dim=axis)


@register("_contrib_PSROIPooling")
def _psroi_pooling(data, rois, spatial_scale=1.0, output_dim=1,
                   pooled_size=7, group_size=0, **attrs):
    """Position-sensitive ROI pooling (reference: psroi_pooling.cc): bin
    (od, ph, pw) of a ROI averages every map cell inside it of channel
    (od * gs + gh) * gs + gw.  The bin bounds are the JAX package's
    (floor/ceil of the scaled, rounded corners); each bin's sum is four
    reads of a float64 summed-area table of the map, so memory is O(map +
    R * output_dim * P^2), and the mean is rounded to the map's dtype once.
    Differentiable in data."""
    P_ = int(pooled_size)
    GS = int(group_size) or P_
    OD = int(output_dim)
    B, C, H, W = data.shape
    scale = float(spatial_scale)
    dev, dt = data.device, data.dtype
    grid = torch.arange(P_, device=dev)
    grp = (grid * GS // P_).clamp(max=GS - 1)
    chan = (torch.arange(OD, device=dev)[:, None, None] * GS
            + grp[:, None]) * GS + grp                      # (OD, P, P)
    with torch.no_grad():
        r = rois.detach()
        bidx = r[:, 0].to(torch.int64)
        x1 = torch.round(r[:, 1]) * scale
        y1 = torch.round(r[:, 2]) * scale
        x2 = (torch.round(r[:, 3]) + 1.0) * scale
        y2 = (torch.round(r[:, 4]) + 1.0) * scale
        bh = (y2 - y1).clamp_min(0.1)
        bw = (x2 - x1).clamp_min(0.1)
        # by a device scalar: CUDA divides by a host scalar through its
        # reciprocal, which can move a floor/ceil bin bound by a cell
        bh, bw = bh / bh.new_full((), P_), bw / bw.new_full((), P_)
        ph = grid.to(dt)

        def bounds(lo, step, n):
            start = torch.floor(lo[:, None] + ph * step[:, None])
            end = torch.ceil(lo[:, None] + (ph + 1) * step[:, None])
            return (start.clamp(0, n).to(torch.int64),
                    end.clamp(0, n).to(torch.int64))

        hs, he = bounds(y1, bh, H)                            # (R, P)
        ws, we = bounds(x1, bw, W)
        den = ((he - hs)[:, :, None] * (we - ws)[:, None, :]).clamp_min(1)
    table = torch.nn.functional.pad(
        data.double().cumsum(2).cumsum(3), (1, 0, 1, 0))   # (B, C, H+1, W+1)
    b = bidx[:, None, None, None]
    c = chan[None]
    at = lambda ys, xs: table[b, c, ys[:, None, :, None],  # noqa: E731
                              xs[:, None, None, :]]
    num = at(he, we) - at(hs, we) - at(he, ws) + at(hs, ws)  # (R, OD, P, P)
    return (num / den[:, None]).to(dt)
