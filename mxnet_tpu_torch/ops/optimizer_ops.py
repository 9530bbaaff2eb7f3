"""Per-array optimizer updates.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (reference:
src/operator/optimizer_op-inl.h), expression by expression.  The three
functions ``sgd_update``, ``sgd_mom_update`` and ``adam_update`` take
tensors and scalars (Python floats or 0-dim fp32 tensors; either way the
arithmetic runs in fp32) and return new tensors, writing nothing in
place.  They are the per-array path of ``Optimizer.update`` and of the
executor's fused step with ``MXNET_PALLAS_FUSED_OPT=0``, and the oracle
that the one-sweep kernels (``cuda_kernels.sgd_sweep`` and friends) are
held to.

The registered ops (``mx.nd.sgd_update`` ... ``signum_update``, the
eleven dense updates of the JAX package) return the new weight and write
their states back through ``mutate_aux``: the caller's momentum, mean,
variance or master-weight arrays hold the new values after the call.
The ``mp_`` forms take a float16 or bfloat16 weight with a float32
master copy (``weight32``), update the master in fp32 and return it
rounded to the weight's dtype.

The lazy row updates ``sgd_rowsparse``, ``sgd_mom_rowsparse`` and
``adam_rowsparse`` (reference: SGDUpdateRspRspImpl,
SGDMomUpdateRspRspImpl and AdamUpdateRspRspImpl) take a row-sparse
gradient as its stored rows ``vals`` and their indices ``idx``: each
gathers those rows of the weight and states, updates them, and copies
them back into new tensors (``index_copy``), so a row the gradient does
not name keeps its weight, momentum, mean and variance bit for bit.
``_sparse_adagrad_update`` is the registered AdaGrad update of the
reference's row-sparse op, on dense values as in the JAX package.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "adam_update", "sgd_rowsparse",
           "sgd_mom_rowsparse", "adam_rowsparse"]


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


# -- the registered ops -----------------------------------------------------
@register("sgd_update")
def _sgd_update_op(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True, **attrs):
    return sgd_update(weight, grad, lr, wd, rescale_grad, clip_gradient)


@register("sgd_mom_update", num_outputs=2, mutate_aux=("mom",))
def _sgd_mom_update_op(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True, **attrs):
    return sgd_mom_update(weight, grad, mom, lr, momentum, wd, rescale_grad,
                          clip_gradient)


@register("mp_sgd_update", num_outputs=2, mutate_aux=("weight32",))
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, **attrs):
    g = _prep_grad(grad.float(), rescale_grad, clip_gradient, wd, weight32)
    new_w32 = weight32 - lr * g
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", num_outputs=3, mutate_aux=("mom", "weight32"))
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       **attrs):
    g = _prep_grad(grad.float(), rescale_grad, clip_gradient, wd, weight32)
    new_mom = momentum * mom - lr * g
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("adam_update", num_outputs=3, mutate_aux=("mean", "var"))
def _adam_update_op(weight, grad, mean, var, lr=0.001, beta1=0.9,
                    beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, lazy_update=True, **attrs):
    return adam_update(weight, grad, mean, var, lr, beta1, beta2, epsilon,
                       wd, rescale_grad, clip_gradient)


@register("_sparse_adagrad_update", num_outputs=2, mutate_aux=("history",))
def _sparse_adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7,
                           wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                           **attrs):
    """Reference: src/operator/contrib/optimizer_op.cc AdagradUpdate
    (row_sparse); on the dense values every row is stored, so the dense
    arithmetic is the row update."""
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_hist = history + torch.square(g)
    return weight - lr * g / (torch.sqrt(new_hist) + epsilon), new_hist


# -- the lazy row updates -----------------------------------------------------
def _rs_prep(vals, w_rows, rescale, clip, wd):
    g = vals * rescale
    if clip >= 0:
        g = torch.clamp(g, -clip, clip)
    return g + wd * w_rows


def sgd_rowsparse(weight, vals, idx, lr, wd, rescale, clip):
    """Returns the new weight."""
    w_rows = weight.index_select(0, idx)
    g = _rs_prep(vals, w_rows, rescale, clip, wd)
    return weight.index_copy(0, idx, w_rows - lr * g)


def sgd_mom_rowsparse(weight, mom, vals, idx, lr, momentum, wd, rescale,
                      clip):
    """Returns ``(new_weight, new_mom)``."""
    w_rows = weight.index_select(0, idx)
    g = _rs_prep(vals, w_rows, rescale, clip, wd)
    new_mom_rows = momentum * mom.index_select(0, idx) - lr * g
    return (weight.index_copy(0, idx, w_rows + new_mom_rows),
            mom.index_copy(0, idx, new_mom_rows))


def adam_rowsparse(weight, mean, var, vals, idx, lr, beta1, beta2, epsilon,
                   wd, rescale, clip):
    """Returns ``(new_weight, new_mean, new_var)``; ``lr`` is the
    effective rate."""
    w_rows = weight.index_select(0, idx)
    g = _rs_prep(vals, w_rows, rescale, clip, wd)
    m_rows = beta1 * mean.index_select(0, idx) + (1.0 - beta1) * g
    v_rows = beta2 * var.index_select(0, idx) + (1.0 - beta2) * g * g
    w_new = w_rows - lr * m_rows / (torch.sqrt(v_rows) + epsilon)
    return (weight.index_copy(0, idx, w_new), mean.index_copy(0, idx, m_rows),
            var.index_copy(0, idx, v_rows))


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        return torch.clamp(w, -clip_weights, clip_weights)
    return w


@register("rmsprop_update", num_outputs=2, mutate_aux=("n",))
def _rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0, **attrs):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    new_w = weight - lr * g / torch.sqrt(new_n + epsilon)
    return _clip_weights(new_w, clip_weights), new_n


@register("rmspropalex_update", num_outputs=4,
          mutate_aux=("n", "g", "delta"))
def _rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0, **attrs):
    gr = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = gamma1 * n + (1 - gamma1) * torch.square(gr)
    new_g = gamma1 * g + (1 - gamma1) * gr
    new_delta = gamma2 * delta - lr * gr / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    new_w = weight + new_delta
    return _clip_weights(new_w, clip_weights), new_n, new_g, new_delta


@register("ftrl_update", num_outputs=3, mutate_aux=("z", "n"))
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0, **attrs):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) > lamda1,
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd), 0.0).to(weight.dtype)
    return new_w, new_z, new_n


@register("signsgd_update")
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, **attrs):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register("signum_update", num_outputs=2, mutate_aux=("mom",))
def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0, **attrs):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1 - momentum) * g
    new_w = (1 - lr * wd_lh) * weight + lr * torch.sign(new_mom)
    return new_w, new_mom


@register("ftml_update", num_outputs=4, mutate_aux=("d", "v", "z"))
def _ftml_update(weight, grad, d, v, z, lr=0.01, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                 clip_grad=-1.0, **attrs):
    """FTML (reference: optimizer_op.cc FTMLUpdate); the gradient is
    clipped before the weight decay, as in every update here."""
    g = _prep_grad(grad, rescale_grad, clip_grad, wd, weight)
    v_new = beta2 * v + (1.0 - beta2) * g * g
    d_new = (1.0 - beta1 ** t) / lr * (
        torch.sqrt(v_new / (1.0 - beta2 ** t)) + epsilon)
    sigma = d_new - beta1 * d
    z_new = beta1 * z + (1.0 - beta1) * g - sigma * weight
    w_new = -z_new / d_new
    return w_new, d_new, v_new, z_new
