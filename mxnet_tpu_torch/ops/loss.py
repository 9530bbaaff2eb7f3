"""Output operators (counterpart of ``mxnet_tpu/ops/loss.py``).

MXNet loss-layer semantics: the forward output of ``SoftmaxOutput`` is a
prediction (the softmax of the data) and its label input is ignored
there; the backward ignores the incoming head gradient and returns the
loss gradient itself, ``grad_scale * (softmax - one_hot(label))``
(reference: src/operator/softmax_output-inl.h).  The JAX package writes
that as a ``jax.custom_vjp``; here it is a ``torch.autograd.Function``,
so the executor seeds the head with ones and autograd reproduces
``Executor.backward()``.  The forward's last-axis softmax runs the K2
CUDA kernel (``softmax_lastaxis``) in training as in inference.
"""
from __future__ import annotations

import torch

from .registry import Param as P, register


def _softmax_fwd(data, multi_output):
    """Forward probabilities.  The last-axis case runs the K2 CUDA kernel
    when ``MXNET_PALLAS_SOFTMAX`` is on for data's device; ``multi_output``
    (softmax over axis 1) and the knob-off path stay plain torch."""
    from .cuda_kernels import family_enabled, softmax_lastaxis
    if (not multi_output and data.dim() >= 2
            and family_enabled("MXNET_PALLAS_SOFTMAX", data.device)):
        return softmax_lastaxis(data)
    return torch.softmax(data, dim=1 if multi_output else -1)


def softmax_output_grad(out, label, grad_scale, ignore_label, use_ignore,
                        normalization, multi_output):
    """The SoftmaxOutput gradient with respect to its data, from the
    forward probabilities ``out`` — expression by expression as
    ``mxnet_tpu/ops/loss.py:53-80``: ``out - one_hot(label)``, masked
    where ``use_ignore`` and the label is ``ignore_label``, scaled by
    ``grad_scale`` divided by the batch (``"batch"``), the count of
    unmasked labels (``"valid"`` with ``use_ignore``) or the label count
    (``"valid"`` without), or not divided (``"null"``)."""
    lbl = label.to(torch.int32)
    out_l = torch.movedim(out, 1, -1) if multi_output else out
    classes = out_l.shape[-1]
    onehot = (lbl.unsqueeze(-1) == torch.arange(
        classes, device=out.device, dtype=torch.int32)).to(out.dtype)
    grad = out_l - onehot
    valid = None
    if use_ignore:
        mask = (lbl != int(ignore_label)).to(out.dtype)
        grad = grad * mask.unsqueeze(-1)
        valid = mask
    scale = grad_scale
    if normalization == "batch":
        scale = scale / label.shape[0]
        grad = grad * scale
    elif normalization == "valid" and valid is not None:
        grad = grad * (scale / torch.clamp(valid.sum(), min=1.0))
    elif normalization == "valid":
        grad = grad * (scale / float(label.numel()))
    else:
        grad = grad * scale
    if multi_output:
        grad = torch.movedim(grad, -1, 1)
    return grad.to(out.dtype)


class _SoftmaxOutputFn(torch.autograd.Function):
    """Forward: the softmax (K2 where it applies).  Backward: the loss
    gradient of :func:`softmax_output_grad`; the head gradient is
    ignored, and the label's gradient is zero."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                normalization, multi_output):
        out = _softmax_fwd(data, multi_output)
        ctx.save_for_backward(out, label)
        ctx.attrs = (grad_scale, ignore_label, use_ignore, normalization,
                     multi_output)
        return out

    @staticmethod
    def backward(ctx, _head_grad):
        out, label = ctx.saved_tensors
        grad = softmax_output_grad(out, label, *ctx.attrs)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return grad, dlabel, None, None, None, None, None


@register("SoftmaxOutput", aliases=("Softmax",), params=[
    P("grad_scale", float, default=1.0),
    P("ignore_label", float, default=-1.0),
    P("multi_output", bool, default=False),
    P("use_ignore", bool, default=False),
    P("preserve_shape", bool, default=False),
    P("normalization", ("null", "batch", "valid"), default="null"),
    P("out_grad", bool, default=False),
    P("smooth_alpha", float, default=0.0, low=0.0, high=1.0)])
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0, **attrs):
    # softmax in fp32 whatever the data dtype, as in the JAX package
    data = data.float()
    if not (torch.is_grad_enabled() and data.requires_grad):
        return _softmax_fwd(data, bool(multi_output))
    return _SoftmaxOutputFn.apply(data, label, float(grad_scale),
                                  float(ignore_label), bool(use_ignore),
                                  normalization, bool(multi_output))


# -- regression outputs (reference: src/operator/regression_output-inl.h) --
def _make_regression(name, fwd, grad_fn):
    """A regression output: forward ``fwd(data)``; backward, whatever the
    head gradient, ``grad_fn(out, label) * grad_scale / (out.numel() /
    batch)``, and a zero gradient for the label (the JAX package's
    ``custom_vjp``)."""

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, data, label, grad_scale):
            out = fwd(data)
            ctx.save_for_backward(out, label)
            ctx.grad_scale = grad_scale
            return out

        @staticmethod
        def backward(ctx, _head_grad):
            out, label = ctx.saved_tensors
            num_out = out.numel() / out.shape[0]
            grad = grad_fn(out, label) * (ctx.grad_scale / num_out)
            dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
                else None
            return grad.to(out.dtype), dlabel, None

    @register(name)
    def _op(data, label, grad_scale=1.0, **attrs):
        label = label.reshape(data.shape)
        if not (torch.is_grad_enabled() and data.requires_grad):
            return fwd(data)
        return _Fn.apply(data, label, float(grad_scale))
    _op.__name__ = name
    return _op


_make_regression("LinearRegressionOutput", lambda d: d, lambda o, l: o - l)
_make_regression("MAERegressionOutput", lambda d: d,
                 lambda o, l: torch.sign(o - l))
_make_regression("LogisticRegressionOutput", torch.sigmoid,
                 lambda o, l: o - l)


class _MakeLossFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, grad_scale, norm_batch):
        ctx.scale = grad_scale / (data.shape[0] if norm_batch else 1)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.scale), None, None


@register("MakeLoss", aliases=("make_loss",), params=[
    P("grad_scale", float, default=1.0),
    P("valid_thresh", float, default=0.0),
    P("normalization", ("null", "batch", "valid"), default="null")])
def _make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null",
               **attrs):
    """Reference: src/operator/make_loss-inl.h: the identity forward; the
    backward is ``grad_scale`` (divided by the batch for ``"batch"``)
    everywhere, whatever the head gradient."""
    if not (torch.is_grad_enabled() and data.requires_grad):
        return data
    return _MakeLossFn.apply(data, float(grad_scale),
                             normalization == "batch")


class _SVMFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.attrs = (margin, reg, use_linear)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, _head_grad):
        data, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.attrs
        lbl = label.to(torch.int32)
        onehot = (lbl[:, None] == torch.arange(
            data.shape[1], device=data.device)).to(data.dtype)
        sign = 2 * onehot - 1      # +1 at the true class, -1 elsewhere
        viol = (margin - sign * data) > 0
        if use_linear:
            grad = torch.where(viol, -sign * reg, 0.0)
        else:
            grad = torch.where(viol, -2 * (margin - sign * data) * sign * reg,
                               0.0)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return grad.to(data.dtype), dlabel, None, None, None


@register("SVMOutput")
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False, **attrs):
    """Reference: src/operator/svm_output-inl.h: the identity forward;
    the backward is the hinge (``use_linear``) or squared-hinge gradient
    against ``label``, whatever the head gradient."""
    if not (torch.is_grad_enabled() and data.requires_grad):
        return data
    return _SVMFn.apply(data, label, float(margin),
                        float(regularization_coefficient), bool(use_linear))
