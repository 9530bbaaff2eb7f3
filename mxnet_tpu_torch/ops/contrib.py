"""Contrib operators (counterpart of ``mxnet_tpu/ops/contrib.py``).

This package carries ``_contrib_flash_attention``, ``_contrib_fused_bn_relu``
(the K3 kernel site), the FFT pair and ``count_sketch``.  The detection,
ROI and deformable ops of that module are not ported yet (ROADMAP.md
queue 7).
"""
from __future__ import annotations

import torch

from .registry import register


@register("_contrib_flash_attention")
def _flash_attention_op(q, k, v, causal=False, scale=None, **attrs):
    """Softmax attention over (B, T, H, D) tensors; K/V may carry fewer
    heads (GQA).  Runs ``parallel.attention.local_attention``: the K7a
    flash kernel where it is eligible, else the einsum logits with the
    K5a/K2 softmax or plain torch; differentiable through each route's
    backward (K7b and K7c, K5b, or torch's autograd).  Under an active
    mesh with ``sp > 1`` (``parallel.mesh_scope``) it is
    ``parallel.ring_attention`` over that axis instead, as in the JAX
    package: the same model becomes sequence-parallel."""
    from ..parallel.attention import local_attention, ring_attention
    from ..parallel.mesh import current_mesh
    if scale is not None:
        scale = float(scale)
    mesh = current_mesh()
    if mesh is not None and mesh.shape.get("sp", 1) > 1:
        return ring_attention(q, k, v, mesh=mesh, causal=bool(causal),
                              scale=scale)
    return local_attention(q, k, v, causal=bool(causal), scale=scale)


@register("_contrib_fused_bn_relu")
def _fused_bn_relu(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
                   act=True, **attrs):
    """Inference BatchNorm folded into per-channel scale and bias, and
    ReLU (``act``), over NCHW data: ``relu(x * scale + bias)`` with
    ``scale = gamma * rsqrt(var + eps)`` and ``bias = beta - mean *
    scale`` (gamma is used as given).  With ``MXNET_PALLAS_BN_RELU`` on
    for data's device (``auto``: CUDA tensors) this is one K3 launch
    (``nn.fused_bn_relu_eval`` -> ``cuda_kernels.scale_bias_relu``, the
    plain version for CPU tensors); with the knob at 0 the plain
    version."""
    from . import cuda_kernels as ck
    from .nn import fused_bn_relu_eval
    if ck.family_enabled("MXNET_PALLAS_BN_RELU", data.device):
        return fused_bn_relu_eval(data, gamma, beta, moving_mean, moving_var,
                                  eps=eps, fix_gamma=False, relu=bool(act))
    scale = (gamma * torch.rsqrt(moving_var + eps)).float()
    bias = (beta - moving_mean * scale).float()
    return ck.scale_bias_relu_ref(data, scale, bias, relu=bool(act))


@register("_contrib_fft")
def _fft(data, compute_size=128, **attrs):
    """FFT over the last axis: real (..., D) -> interleaved (re, im)
    (..., 2D) (reference: contrib/fft-inl.h); ``compute_size`` is the
    reference's batching and is ignored."""
    out = torch.fft.fft(data.float(), dim=-1)
    return torch.stack([out.real, out.imag], dim=-1).reshape(
        tuple(data.shape[:-1]) + (2 * data.shape[-1],)).to(data.dtype)


@register("_contrib_ifft")
def _ifft(data, compute_size=128, **attrs):
    """The inverse: interleaved (..., 2D) -> real (..., D), unnormalised
    (scaled by D, as the reference's cuFFT plan leaves it)."""
    d = data.shape[-1] // 2
    x = data.reshape(tuple(data.shape[:-1]) + (d, 2)).float()
    out = torch.fft.ifft(torch.complex(x[..., 0], x[..., 1]), dim=-1).real
    return (out * d).to(data.dtype)


@register("_contrib_count_sketch")
def _count_sketch(data, h, s, out_dim=0, **attrs):
    """Count-sketch projection (reference: contrib/count_sketch-inl.h):
    ``out[..., h[i]] += s[i] * data[..., i]``."""
    hi = h.reshape(-1).to(torch.int64)
    si = s.reshape(-1).to(data.dtype)
    out = torch.zeros(tuple(data.shape[:-1]) + (int(out_dim),),
                      dtype=data.dtype, device=data.device)
    return out.index_add(-1, hi, data * si)
