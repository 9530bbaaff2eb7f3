"""Neural-network operators (counterpart of ``mxnet_tpu/ops/nn.py``).

Convolution (``F.conv2d``, OIHW weights as in MXNet) and Deconvolution
(``F.conv_transpose*d``, whose weight layout (in, out/group, k...) is
MXNet's), FullyConnected (``F.linear``), Activation, LeakyReLU,
Pooling (max/avg/sum over 1-3 spatial dims, the ``valid``, ``same`` and
``full`` conventions), BatchNorm (eval and training mode), LayerNorm
(through the K6a and K6b CUDA kernels over the last axis when
``MXNET_PALLAS_NORM`` is on), InstanceNorm, LRN, UpSampling, the softmax
family and Dropout, plus ``fused_bn_relu_eval``, the inference
BatchNorm -> ReLU epilogue that the executor's peephole routes through
the K3 CUDA kernel.  Backward passes are PyTorch's autograd of these
expressions, and K6b for the kernel LayerNorm.
"""
from __future__ import annotations

import math
import threading

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
@register("Activation", params=[
    P("act_type", ("relu", "sigmoid", "tanh", "softrelu", "softsign"),
      required=True)])
def _activation(data, act_type="relu", **attrs):
    """Reference: src/operator/nn/activation-inl.h."""
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return torch.logaddexp(data, torch.zeros((), dtype=data.dtype,
                                                 device=data.device))
    return data / (1 + torch.abs(data))


def _rng(device, rng):
    return rng if rng is not None else _random.generator(device)


@register("LeakyReLU", needs_is_train=True, needs_rng=True, params=[
    P("act_type", ("leaky", "elu", "selu", "prelu", "rrelu", "gelu"),
      default="leaky"),
    P("slope", float, default=0.25, low=0.0),
    P("lower_bound", float, default=0.125, low=0.0),
    P("upper_bound", float, default=0.334, low=0.0)])
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334,
                __is_train__=False, __rng__=None, **attrs):
    """Reference: src/operator/leaky_relu-inl.h.  ``rrelu`` in training
    draws each slope from U(lower, upper) with the device's generator;
    otherwise it takes their mean.  ``gelu`` is declared but, as in the
    JAX package, not computed."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if data.dim() > 1 else gamma
        return torch.where(data > 0, data, g * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(data > 0, data,
                                   alpha * torch.expm1(data))
    if act_type == "rrelu":
        if __is_train__ and data.device.type != "meta":
            u = torch.rand(data.shape, dtype=data.dtype, device=data.device,
                           generator=_rng(data.device, __rng__))
            s = lower_bound + u * (upper_bound - lower_bound)
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(data > 0, data, s * data)
    raise MXNetError("unknown LeakyReLU act_type %s" % act_type)


# -- Convolution ------------------------------------------------------------
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", aliases=("Convolution_v1",), params=[
    P("kernel", tuple, required=True, low=1, doc="conv window (h, w)"),
    P("num_filter", int, required=True, low=1, high=100000),
    P("stride", tuple, default=None, low=1),
    P("dilate", tuple, default=None, low=1),
    P("pad", tuple, default=None, low=0),
    P("num_group", int, default=1, low=1),
    P("no_bias", bool, default=False),
    P("layout", ("NCHW", "NHWC", "NCW", "NCDHW", None), default=None)])
def _convolution(data, weight, bias=None, kernel=None, stride=None,
                 dilate=None, pad=None, num_filter=None, num_group=1,
                 no_bias=False, layout=None, cudnn_tune=None, cudnn_off=False,
                 workspace=None, **attrs):
    """Reference: src/operator/nn/convolution-inl.h, over 1-3 spatial
    dims as the JAX package computes it: channels first (NCW, NCHW,
    NCDHW) with (O, I/group, k...) weights, or NHWC with (O, H, W, I)
    weights, run channels first between two permutes; num_group maps to
    ``groups`` (depthwise is num_group == channels)."""
    kernel = normalize_tuple(kernel)
    nd = len(kernel)
    if nd not in _CONV or data.dim() != nd + 2:
        raise MXNetError("Convolution: kernel %s on a %d-D input; this "
                         "package convolves 1-3 spatial dims"
                         % (kernel, data.dim()))
    stride = normalize_tuple(stride, nd) if stride else (1,) * nd
    dilate = normalize_tuple(dilate, nd) if dilate else (1,) * nd
    pad = normalize_tuple(pad, nd) if pad else (0,) * nd
    last = layout == "NHWC"
    if last:
        data = data.permute(0, 3, 1, 2)
        weight = weight.permute(0, 3, 1, 2)
    out = _CONV[nd](data, weight, None if no_bias else bias, stride=stride,
                    padding=pad, dilation=dilate, groups=num_group)
    return out.permute(0, 2, 3, 1) if last else out


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution", params=[
    P("kernel", tuple, required=True, low=1),
    P("num_filter", int, required=True, low=1),
    P("stride", tuple, default=None, low=1),
    P("dilate", tuple, default=None, low=1),
    P("pad", tuple, default=None, low=0),
    P("adj", tuple, default=None, low=0),
    P("num_group", int, default=1, low=1),
    P("no_bias", bool, default=True)])
def _deconvolution(data, weight, bias=None, kernel=None, stride=None,
                   dilate=None, pad=None, adj=None, target_shape=None,
                   num_filter=None, num_group=1, no_bias=True, layout=None,
                   workspace=None, cudnn_tune=None, cudnn_off=False,
                   **attrs):
    """Reference: src/operator/nn/deconvolution-inl.h, the transposed
    convolution, channels first.  The weight is (in, out/group, k...),
    the layout ``F.conv_transpose*d`` takes; ``adj`` is the output
    padding; ``no_bias`` defaults to True.  ``target_shape`` is accepted
    and, as in the JAX package, not used."""
    kernel = normalize_tuple(kernel)
    nd = len(kernel)
    if data.dim() != nd + 2 or layout not in (None, "NCW", "NCHW", "NCDHW"):
        raise MXNetError("Deconvolution: this package runs channels-first "
                         "transposed convolutions; got kernel %s on a %d-D "
                         "input, layout %s" % (kernel, data.dim(), layout))
    stride = normalize_tuple(stride, nd) if stride else (1,) * nd
    dilate = normalize_tuple(dilate, nd) if dilate else (1,) * nd
    pad = normalize_tuple(pad, nd) if pad else (0,) * nd
    adj = normalize_tuple(adj, nd) if adj else (0,) * nd
    return _CONV_T[nd](data, weight, None if no_bias else bias,
                       stride=stride, padding=pad, output_padding=adj,
                       groups=num_group, dilation=dilate)


# -- Pooling ----------------------------------------------------------------
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _sum_pool(x, kernel, stride):
    """Window sums (``avg_pool`` with divisor 1; 1-D through 2-D)."""
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1,) + tuple(kernel),
                            (1,) + tuple(stride),
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


@register("Pooling", aliases=("Pooling_v1",), params=[
    P("kernel", tuple, default=None, low=1),
    P("pool_type", ("max", "avg", "sum", "lp"), default="max"),
    P("stride", tuple, default=None, low=1),
    P("pad", tuple, default=None, low=0),
    P("global_pool", bool, default=False),
    P("pooling_convention", ("valid", "full", "same"), default="valid"),
    P("count_include_pad", bool, default=True)])
def _pooling(data, kernel=None, pool_type="max", stride=None, pad=None,
             global_pool=False, pooling_convention="valid", cudnn_off=False,
             count_include_pad=True, **attrs):
    """Reference: src/operator/nn/pooling-inl.h, as the JAX package
    computes it over 1-3 spatial dims: the input is padded explicitly
    (-inf for max, 0 for avg and sum), ``full`` adds right padding until
    ceil((x + 2p - k) / s) + 1 windows fit (``same`` is ``valid``), and
    ``avg`` divides by the window size (``count_include_pad``) or by the
    count of real elements under the window.  ``global_pool`` ignores
    ``kernel``.  ``lp`` is declared but, as in the JAX package, not
    computed."""
    nd = data.dim() - 2
    if nd not in _MAX_POOL:
        raise MXNetError("Pooling: this package pools 1-3 spatial dims; "
                         "got a %d-D input" % data.dim())
    if global_pool:
        kernel, stride, pad = tuple(data.shape[2:]), (1,) * nd, (0,) * nd
    else:
        kernel = normalize_tuple(kernel, nd)
        stride = normalize_tuple(stride, nd) if stride else (1,) * nd
        pad = normalize_tuple(pad, nd) if pad else (0,) * nd
    lohi = [[p, p] for p in pad]
    if pooling_convention == "full" and not global_pool:
        for i in range(nd):
            x, p, k, s = data.shape[2 + i], pad[i], kernel[i], stride[i]
            out_full = -(-(x + 2 * p - k) // s) + 1
            lohi[i][1] += max((out_full - 1) * s + k - (x + 2 * p), 0)
    widths = [w for lo_hi in reversed(lohi) for w in lo_hi]
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError("unknown pool_type %s" % pool_type)
    if pool_type == "max":
        xp = F.pad(data, widths, value=float("-inf")) if any(widths) \
            else data
        return _MAX_POOL[nd](xp, kernel, stride)
    xp = F.pad(data, widths) if any(widths) else data
    summed = _sum_pool(xp, kernel, stride)
    if pool_type == "sum":
        return summed
    if count_include_pad:
        n = 1
        for k in kernel:
            n *= k
        return summed / n
    ones = F.pad(torch.ones_like(data[:1, :1]), widths)
    return summed / _sum_pool(ones, kernel, stride)


@register("_contrib_AdaptiveAvgPooling2D")
def _adaptive_avg_pool(data, output_size=None, **attrs):
    """Window means when the output size divides the input's, else the
    JAX package's ``jax.image.resize(..., "linear")`` (antialiased
    bilinear)."""
    out = normalize_tuple(output_size, 2) if output_size else (1, 1)
    n, c, h, w = data.shape
    if h % out[0] == 0 and w % out[1] == 0:
        x = data.reshape(n, c, out[0], h // out[0], out[1], w // out[1])
        return x.mean(dim=(3, 5))
    return _resize_linear(data, out)


def _resize_linear(data, size):
    return F.interpolate(data, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)


@register("_contrib_BilinearResize2D")
def _bilinear_resize(data, height=None, width=None, scale_height=None,
                     scale_width=None, **attrs):
    h, w = data.shape[2], data.shape[3]
    th = height if height else int(h * scale_height)
    tw = width if width else int(w * scale_width)
    return _resize_linear(data, (th, tw))


@register("UpSampling", params=[
    P("scale", int, required=True, low=1),
    P("sample_type", ("nearest", "bilinear"), default="nearest"),
    P("num_filter", int, default=0, low=0),
    P("multi_input_mode", ("concat", "sum"), default="concat")])
def _upsampling(*args, scale=1, sample_type="nearest", num_filter=0,
                num_args=1, multi_input_mode="concat", workspace=None,
                **attrs):
    """Reference: src/operator/upsampling-inl.h, as the JAX package
    computes it: ``nearest`` repeats every input ``scale`` times along H
    and W and concatenates them; ``bilinear`` is a grouped
    Deconvolution of the data with the weight input."""
    data = args[0]
    if sample_type == "nearest":
        outs = [a.repeat_interleave(scale, dim=2).repeat_interleave(
            scale, dim=3) for a in args]
        return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return _deconvolution(data, args[1], None,
                          kernel=(2 * scale - scale % 2,) * 2,
                          stride=(scale, scale),
                          pad=((scale - scale % 2 + 1) // 2,) * 2,
                          num_filter=num_filter, num_group=data.shape[1],
                          no_bias=True)


# -- BatchNorm --------------------------------------------------------------
# .reduce, while set (parallel.collectives.global_batch_stats): (a
# differentiable SUM over the data-parallel ranks, their count), so that
# training-mode BatchNorm takes the whole global batch's moments
_BATCH_STATS = threading.local()


def _batch_moments(x, red, shape):
    """(biased variance, mean) of ``x`` over the dims ``red``: this
    tensor's, or under ``global_batch_stats`` the global batch's, by two
    passes as ``jnp.mean``/``jnp.var`` (sum, then squared deviations)."""
    sync = getattr(_BATCH_STATS, "reduce", None)
    if sync is None:
        return torch.var_mean(x, dim=red, correction=0)
    reduce, ranks = sync
    count = ranks * math.prod(x.shape[i] for i in red)
    mean = reduce(x.sum(dim=red)) / count
    xc = x - mean.reshape(shape)
    var = reduce((xc * xc).sum(dim=red)) / count
    return var, mean


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
        var, mean = _batch_moments(data.float(), red, shape)
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


@register("softmax", params=[
    P("axis", int, default=-1),
    P("temperature", float, default=1.0)])
def _softmax(data, axis=-1, temperature=None, **attrs):
    """Reference: src/operator/nn/softmax-inl.h."""
    if temperature:
        data = data / temperature
    return torch.softmax(data, dim=axis)


@register("SoftmaxActivation", params=[
    P("mode", ("instance", "channel"), default="instance")])
def _softmax_activation(data, mode="instance", **attrs):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


@register("softmax_cross_entropy")
def _softmax_cross_entropy(data, label, **attrs):
    """The summed cross-entropy of the rows' softmax against ``label``."""
    logp = torch.log_softmax(data, dim=-1)
    return -torch.sum(torch.gather(
        logp, -1, label.to(torch.int64).unsqueeze(-1)))


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
    differentiated by autograd, as in the JAX package.  A bf16 gamma and
    beta (a ``cast`` block) reach the kernels upcast to fp32, which is
    exact, as the Pallas kernel promotes ``x(fp32) * g``; their gradients
    come back through the cast in bf16, rounded once from the fp32
    sums."""
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


@register("InstanceNorm", params=[P("eps", float, default=1e-3, low=0.0)])
def _instance_norm(data, gamma, beta, eps=1e-3, **attrs):
    """Reference: src/operator/instance_norm-inl.h."""
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    var = data.var(dim=red, keepdim=True, correction=0)
    out = (data - mean) * torch.rsqrt(var + eps)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return out * gamma.reshape(shape) + beta.reshape(shape)


@register("LRN", params=[
    P("nsize", int, required=True, low=1),
    P("alpha", float, default=1e-4, low=0.0),
    P("beta", float, default=0.75, low=0.0),
    P("knorm", float, default=2.0)])
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **attrs):
    """Reference: src/operator/nn/lrn-inl.h (across channels), the window
    summed in the JAX package's order."""
    sq = torch.square(data)
    half = nsize // 2
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    c = data.shape[1]
    window = torch.stack([padded[:, i:i + c] for i in range(nsize)],
                         0).sum(0)
    return data / torch.pow(knorm + alpha / nsize * window, beta)


# -- Dropout ----------------------------------------------------------------
@register("Dropout", needs_is_train=True, needs_rng=True, params=[
    P("p", float, default=0.5, low=0.0, high=1.0,
      doc="fraction of units dropped in train mode"),
    P("mode", ("training", "always"), default="training"),
    P("axes", tuple, default=(), low=0)])
def _dropout(data, p=0.5, mode="training", axes=(), __is_train__=False,
             __rng__=None, **attrs):
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
                      generator=_rng(data.device, __rng__)) < keep
    return torch.where(mask, data / keep, 0.0).to(data.dtype)



# -- RNN (fused multi-layer recurrent net) ----------------------------------
_RNN_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(mode, num_layers, input_size, state_size, directions):
    """Length of the packed parameter vector (reference: rnn-inl.h
    GetRnnParamSize)."""
    G, H, D = _RNN_GATES[mode], state_size, directions
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else H * D
        size += D * (G * H * in_sz + G * H * H)
    return size + num_layers * D * 2 * G * H


def rnn_unpack_params(params, mode, num_layers, input_size, state_size,
                      directions):
    """Views of the packed vector as torch's per-layer, per-direction
    ``[w_ih, w_hh, b_ih, b_hh]`` list.  MXNet packs all weights first,
    layer-major with the direction inside (W_i2h then W_h2h), then all
    biases in the same order (``mxnet_tpu/ops/nn.py:557-577``); the
    views keep the gradient flowing into the one packed tensor."""
    G, H, D = _RNN_GATES[mode], state_size, directions
    ws, off = [], 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else H * D
        for _d in range(D):
            wi = params[off:off + G * H * in_sz].view(G * H, in_sz)
            off += G * H * in_sz
            wh = params[off:off + G * H * H].view(G * H, H)
            off += G * H * H
            ws.append((wi, wh))
    out = []
    for wi, wh in ws:
        bi = params[off:off + G * H]
        off += G * H
        bh = params[off:off + G * H]
        off += G * H
        out.extend([wi, wh, bi, bh])
    return out


def _rnn_nout(attrs):
    if attrs.get("state_outputs", False):
        return 3 if attrs.get("mode") == "lstm" else 2
    return 1


def _rnn_layers(mode, x, hx, weights, num_layers, bidirectional):
    """torch's fused recurrent op over ``num_layers`` layers (cuDNN on
    the card, torch's native kernels on the host); returns ``(y, h_n,
    c_n or None)``."""
    import warnings
    fn = {"lstm": torch._VF.lstm, "gru": torch._VF.gru,
          "rnn_tanh": torch._VF.rnn_tanh,
          "rnn_relu": torch._VF.rnn_relu}[mode]
    with warnings.catch_warnings():
        # views of the packed vector are not cuDNN's flat buffer, so it
        # compacts them at each call
        warnings.filterwarnings("ignore", message=".*contiguous chunk.*")
        # cuDNN keeps what its backward needs only in training mode
        out = fn(x, hx if mode == "lstm" else hx[0], weights, True,
                 num_layers, 0.0, torch.is_grad_enabled(), bidirectional,
                 False)
    if mode == "lstm":
        return out[0], out[1], out[2]
    return out[0], out[1], None


@register("RNN", needs_is_train=True, needs_rng=True, num_outputs=_rnn_nout,
          params=[
    P("state_size", int, required=True, low=1),
    P("num_layers", int, required=True, low=1),
    P("mode", ("rnn_relu", "rnn_tanh", "lstm", "gru"), required=True),
    P("bidirectional", bool, default=False),
    P("p", float, default=0.0, low=0.0, high=1.0,
      doc="dropout between stacked layers"),
    P("state_outputs", bool, default=False)])
def _rnn(data, params, state, state_cell=None, mode="lstm", state_size=None,
         num_layers=1, bidirectional=False, p=0.0, state_outputs=False,
         __is_train__=False, __rng__=None, **attrs):
    """Fused multi-layer (bi)RNN (reference: src/operator/rnn-inl.h), as
    ``mxnet_tpu/ops/nn.py:552-651`` computes it: ``data`` is (T, N, I),
    time-major; the gates are LSTM's i, f, g, o and GRU's r, z, n with
    ``r * (W_hn h + b_hn)``, torch's own forms, so the packed weights
    go to torch's RNN (cuDNN on the card) as views.  Dropout ``p`` acts
    between layers in training, its mask drawn from the device's
    generator."""
    T, N, I = data.shape
    H = state_size
    D = 2 if bidirectional else 1
    if mode == "lstm" and state_cell is None:
        state_cell = torch.zeros_like(state)
    if data.device.type == "meta":
        x = torch.empty((T, N, D * H), dtype=data.dtype, device="meta")
        hs = torch.empty((num_layers * D, N, H), dtype=data.dtype,
                         device="meta")
        cs = hs
    else:
        weights = rnn_unpack_params(params, mode, num_layers, I, H, D)
        per = 4 * D
        drop = p > 0 and __is_train__ and num_layers > 1
        if not drop:
            hx = (state, state_cell) if mode == "lstm" else (state,)
            x, hs, cs = _rnn_layers(mode, data, hx, weights, num_layers,
                                    bidirectional)
        else:
            x, h_list, c_list = data, [], []
            for layer in range(num_layers):
                sl = slice(layer * D, (layer + 1) * D)
                hx = (state[sl], state_cell[sl]) if mode == "lstm" \
                    else (state[sl],)
                x, h, c = _rnn_layers(mode, x, hx,
                                      weights[layer * per:(layer + 1) * per],
                                      1, bidirectional)
                h_list.append(h)
                c_list.append(c)
                if layer < num_layers - 1:
                    keep = 1.0 - p
                    mask = torch.rand(x.shape, device=x.device,
                                      generator=_rng(x.device, __rng__)) \
                        < keep
                    x = torch.where(mask, x / keep, 0.0).to(x.dtype)
            hs = torch.cat(h_list, 0)
            cs = torch.cat(c_list, 0) if mode == "lstm" else None
    if state_outputs:
        return (x, hs, cs) if mode == "lstm" else (x, hs)
    return x


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
