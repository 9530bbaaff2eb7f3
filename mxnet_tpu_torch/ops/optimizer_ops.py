"""Per-array optimizer updates.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py:20-71`` (reference:
src/operator/optimizer_op-inl.h sgd_update, sgd_mom_update,
adam_update), expression by expression: each function takes tensors
and scalars (Python floats or 0-dim fp32 tensors; either way the
arithmetic runs in fp32) and returns new tensors, writing nothing in
place.  They are the per-array path of ``Optimizer.update`` and of the
executor's fused step with ``MXNET_PALLAS_FUSED_OPT=0``, and the oracle
that the one-sweep kernels (``cuda_kernels.sgd_sweep`` and friends) are
held to.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update"]


def _prep_grad(grad, rescale_grad, clip_gradient, wd=0.0, weight=None):
    """Rescale, clip (a negative or None ``clip_gradient`` means no
    clipping; a NaN passes through the clip) and add the weight decay."""
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    if weight is not None and wd is not None:
        g = g + wd * weight
    return g


def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    return weight - lr * g


def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Returns ``(new_weight, new_mom)``."""
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Returns ``(new_weight, new_mean, new_var)``; ``lr`` is the
    effective rate (the caller folds in the bias correction)."""
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * (g * g)
    new_w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_w, new_mean, new_var
