"""Neural-network operators of a ResNet (NCHW) and a transformer.

Counterpart of ``mxnet_tpu/ops/nn.py`` for the ops a ResNet forward and
backward and a transformer forward and backward run: Convolution
(``F.conv2d``, OIHW weights as in MXNet), FullyConnected (``F.linear``),
Activation, Pooling, BatchNorm (eval and training mode), LayerNorm
(through the K6a and K6b CUDA kernels over the last axis when
``MXNET_PALLAS_NORM`` is on), ``log_softmax`` and Dropout, plus
``fused_bn_relu_eval``, the inference BatchNorm -> ReLU epilogue that the
executor's peephole routes through the K3 CUDA kernel.  Backward passes
are PyTorch's autograd of these expressions, and K6b for the kernel
LayerNorm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError
from . import cuda_kernels as ck
from .registry import Param as P, normalize_tuple, register


# -- FullyConnected ---------------------------------------------------------
@register("FullyConnected", params=[
    P("num_hidden", int, required=True, low=1,
      doc="number of output units"),
    P("no_bias", bool, default=False),
    P("flatten", bool, default=True,
      doc="collapse all trailing input dims before the matmul")])
def _fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                     flatten=True, **attrs):
    """Reference: src/operator/nn/fully_connected-inl.h."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


# -- Activation -------------------------------------------------------------
@register("Activation", params=[P("act_type", ("relu",), required=True)])
def _activation(data, act_type="relu", **attrs):
    """Reference: src/operator/nn/activation-inl.h; this slice carries
    relu."""
    return torch.relu(data)


# -- Convolution ------------------------------------------------------------
@register("Convolution", aliases=("Convolution_v1",), params=[
    P("kernel", tuple, required=True, low=1, doc="conv window (h, w)"),
    P("num_filter", int, required=True, low=1, high=100000),
    P("stride", tuple, default=None, low=1),
    P("dilate", tuple, default=None, low=1),
    P("pad", tuple, default=None, low=0),
    P("num_group", int, default=1, low=1),
    P("no_bias", bool, default=False),
    P("layout", ("NCHW", None), default=None)])
def _convolution(data, weight, bias=None, kernel=None, stride=None,
                 dilate=None, pad=None, num_filter=None, num_group=1,
                 no_bias=False, layout=None, cudnn_tune=None, cudnn_off=False,
                 workspace=None, **attrs):
    """Reference: src/operator/nn/convolution-inl.h.  2-D NCHW with OIHW
    weights; num_group maps to ``groups``."""
    kernel = normalize_tuple(kernel)
    if len(kernel) != 2 or data.dim() != 4:
        raise MXNetError("Convolution: this package runs 2-D NCHW "
                         "convolutions; got kernel %s on a %d-D input"
                         % (kernel, data.dim()))
    stride = normalize_tuple(stride, 2) if stride else (1, 1)
    dilate = normalize_tuple(dilate, 2) if dilate else (1, 1)
    pad = normalize_tuple(pad, 2) if pad else (0, 0)
    return F.conv2d(data, weight, None if no_bias else bias, stride=stride,
                    padding=pad, dilation=dilate, groups=num_group)


# -- Pooling ----------------------------------------------------------------
@register("Pooling", aliases=("Pooling_v1",), params=[
    P("kernel", tuple, default=None, low=1),
    P("pool_type", ("max", "avg"), default="max"),
    P("stride", tuple, default=None, low=1),
    P("pad", tuple, default=None, low=0),
    P("global_pool", bool, default=False),
    P("pooling_convention", ("valid",), default="valid"),
    P("count_include_pad", bool, default=True)])
def _pooling(data, kernel=None, pool_type="max", stride=None, pad=None,
             global_pool=False, pooling_convention="valid", cudnn_off=False,
             count_include_pad=True, **attrs):
    """Reference: src/operator/nn/pooling-inl.h, as the JAX package
    computes it with the ``valid`` convention: the input is padded
    explicitly (-inf for max, 0 for avg), and ``avg`` divides by the
    window size (``count_include_pad``) or by the count of real elements
    under the window.  ``global_pool`` ignores ``kernel``."""
    if data.dim() != 4:
        raise MXNetError("Pooling: this package runs 2-D NCHW pooling; got "
                         "a %d-D input" % data.dim())
    if global_pool:
        kernel, stride, pad = tuple(data.shape[2:]), (1, 1), (0, 0)
    else:
        kernel = normalize_tuple(kernel, 2)
        stride = normalize_tuple(stride, 2) if stride else (1, 1)
        pad = normalize_tuple(pad, 2) if pad else (0, 0)
    widths = (pad[1], pad[1], pad[0], pad[0])   # F.pad order: W then H
    if pool_type == "max":
        xp = F.pad(data, widths, value=float("-inf")) if any(widths) \
            else data
        return F.max_pool2d(xp, kernel, stride)
    xp = F.pad(data, widths) if any(widths) else data
    summed = F.avg_pool2d(xp, kernel, stride, divisor_override=1)
    if count_include_pad:
        return summed / (kernel[0] * kernel[1])
    ones = F.pad(torch.ones_like(data[:1, :1]), widths)
    counts = F.avg_pool2d(ones, kernel, stride, divisor_override=1)
    return summed / counts


# -- BatchNorm --------------------------------------------------------------
@register("BatchNorm", aliases=("BatchNorm_v1",), needs_is_train=True,
          params=[
              P("eps", float, default=1e-3, low=0.0),
              P("momentum", float, default=0.9, low=0.0, high=1.0),
              P("fix_gamma", bool, default=True),
              P("use_global_stats", bool, default=False),
              P("axis", int, default=1),
              P("output_mean_var", bool, default=False)],
          num_outputs=3, mutate_aux=("moving_mean", "moving_var"))
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False,
                __is_train__=False, **attrs):
    """Reference: src/operator/nn/batch_norm-inl.h, with the JAX package's
    exact expression: ``(x - mean) * (rsqrt(var + eps) * g) + beta``.
    Outputs (out, moving_mean, moving_var) like the JAX op.

    In training (``__is_train__`` without ``use_global_stats``) mean and
    var are the batch's, over every axis but ``axis``, in fp32 (the
    *biased* variance, as ``jnp.var``), and the moving stats come back
    updated, ``momentum * moving + (1 - momentum) * stat``, for the
    executor to write back (``mutate_aux``); autograd differentiates
    through the batch stats, and the new moving stats are detached from
    the graph.  ``F.batch_norm`` would not do: its momentum is MXNet's
    ``1 - momentum`` and it keeps the unbiased variance.  Otherwise the
    moving stats normalise and come back unchanged."""
    ax = axis % data.dim()
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if __is_train__ and not use_global_stats:
        red = tuple(i for i in range(data.dim()) if i != ax)
        var, mean = torch.var_mean(data.float(), dim=red, correction=0)
        new_mean = momentum * moving_mean \
            + (1 - momentum) * mean.detach().to(moving_mean.dtype)
        new_var = momentum * moving_var \
            + (1 - momentum) * var.detach().to(moving_var.dtype)
    else:
        mean, var = moving_mean, moving_var
        new_mean, new_var = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    out = (data - mean.reshape(shape)) * (inv * g).reshape(shape) \
        + beta.reshape(shape)
    return out.to(data.dtype), new_mean, new_var


# -- softmax family ---------------------------------------------------------
@register("log_softmax", params=[P("axis", int, default=-1)])
def _log_softmax(data, axis=-1, temperature=None, **attrs):
    """Reference: src/operator/nn/softmax-inl.h log_softmax."""
    if temperature:
        data = data / temperature
    return torch.log_softmax(data, dim=axis)


# -- LayerNorm --------------------------------------------------------------
class _KernelLayerNorm(torch.autograd.Function):
    """LayerNorm over the last axis through the kernels: the forward is
    K6a, the backward's dx K6b from what ``_fused_layernorm_fwd_rule``
    keeps (x, gamma, mu, rstd), dgamma and dbeta plain reductions."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        o, mu, rstd = ck.layernorm_fwd(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mu, rstd)
        return o

    @staticmethod
    def backward(ctx, do):
        x, gamma, mu, rstd = ctx.saved_tensors
        do = do.contiguous()
        dx = ck.layernorm_bwd(x, do, gamma, mu, rstd) \
            if ctx.needs_input_grad[0] else None
        c = x.shape[-1]
        xhat = (x.float() - mu.unsqueeze(-1)) * rstd.unsqueeze(-1)
        do32 = do.float()
        dgamma = (do32 * xhat).reshape(-1, c).sum(dim=0).to(gamma.dtype)
        dbeta = do32.reshape(-1, c).sum(dim=0).to(gamma.dtype)
        return dx, dgamma, dbeta, None


@register("LayerNorm", params=[
    P("axis", int, default=-1),
    P("eps", float, default=1e-5, low=0.0),
    P("output_mean_var", bool, default=False)])
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False,
                **attrs):
    """Reference: src/operator/nn/layer_norm-inl.h.

    Over the last axis, with ``MXNET_PALLAS_NORM`` on (``auto``: for
    CUDA tensors), the norm is one K6a pass at any width
    (``cuda_kernels.layernorm_fwd``: mean, variance of the centred
    values, normalise and affine, stats in fp32) and its backward one K6b
    pass; other axes and the knob at 0 keep the plain reduction chain,
    differentiated by autograd, as in the JAX package."""
    nd = data.dim()
    if (axis % nd == nd - 1 and nd >= 2
            and ck.family_enabled("MXNET_PALLAS_NORM", data.device)):
        return _KernelLayerNorm.apply(data.contiguous(), gamma.float(),
                                      beta.float(), float(eps))
    mean = data.mean(dim=axis, keepdim=True)
    var = data.var(dim=axis, keepdim=True, correction=0)
    out = (data - mean) * torch.rsqrt(var + eps)
    shape = [1] * nd
    shape[axis % nd] = data.shape[axis % nd]
    return out * gamma.reshape(shape) + beta.reshape(shape)


# -- Dropout ----------------------------------------------------------------
@register("Dropout", needs_is_train=True, params=[
    P("p", float, default=0.5, low=0.0, high=1.0,
      doc="fraction of units dropped in train mode"),
    P("mode", ("training", "always"), default="training"),
    P("axes", tuple, default=(), low=0)])
def _dropout(data, p=0.5, mode="training", axes=(), __is_train__=False,
             **attrs):
    """Reference: src/operator/nn/dropout-inl.h (inverted dropout), as
    the JAX package computes it: in training mode (or ``mode="always"``)
    each unit is kept with probability ``1 - p`` and scaled by ``1 / (1 -
    p)``, the mask shared along ``axes``; the identity in predict mode or
    at p = 0.  The mask comes from the device's ``torch.Generator``
    (``random.py``), so it differs from the JAX package's threefry
    stream."""
    if (not __is_train__ and mode != "always") or p == 0 \
            or data.device.type == "meta":
        return data
    shape = list(data.shape)
    for a in normalize_tuple(axes) if axes else ():
        shape[a] = 1
    keep = 1.0 - p
    mask = torch.rand(shape, device=data.device,
                      generator=_random.generator(data.device)) < keep
    return torch.where(mask, data / keep, 0.0).to(data.dtype)


def fused_bn_relu_eval(data, gamma, beta, moving_mean, moving_var,
                       eps=1e-3, fix_gamma=True, relu=True):
    """Inference BatchNorm(+ReLU) as one K3 pass over NCHW data: the
    moving stats fold into per-channel ``scale = g * rsqrt(var + eps)``
    and ``bias = beta - mean * scale`` (plain torch, C elements), then
    ``cuda_kernels.scale_bias_relu`` applies them in place of layout —
    no transposes.  The executor's eval-graph peephole
    (symbol.py ``build_graph_fn``, ``MXNET_PALLAS_BN_RELU``) calls it."""
    from .cuda_kernels import scale_bias_relu
    g = torch.ones_like(gamma) if fix_gamma else gamma
    scale = (g * torch.rsqrt(moving_var + eps)).float()
    bias = (beta - moving_mean * scale).float()
    return scale_bias_relu(data.contiguous(), scale, bias, relu=relu)
