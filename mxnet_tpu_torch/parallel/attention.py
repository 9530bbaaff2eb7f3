"""Softmax attention on one device.

Counterpart of ``mxnet_tpu/parallel/attention.py`` for its single-device
part: ``local_attention`` with its three routes, ``_flash_eligible`` and
``_expand_kv_heads`` (grouped-query attention).  Ring and Ulysses
attention over a sequence-sharded mesh are multi-GPU work (ROADMAP.md
queue 1) and not ported; so is the ``kv_len`` padding mask they need.

The routes, with the reference's branch conditions:

- flash: K7a (``cuda_kernels.flash_attention_fwd``) over ``(B*H, T,
  D)`` when ``impl="flash"``, or under ``impl="auto"`` when
  ``_flash_eligible`` holds (CUDA tensors, aligned offsets, both lengths
  multiples of 8 — the JAX package's condition with its TPU backend
  read as the GPU); its backward is ``delta = sum(do * o)`` in plain
  torch, then K7b (dq) and K7c (dk, dv), from the q, k, v, o and lse the
  forward kept (``_flash_fwd`` / ``_flash_bwd_rule``);
- fused softmax: the einsum logits, then K5a (``bias_softmax``: the
  mask as a 0 / ``NEG_INF`` bias) or, unmasked, K2 (``softmax_lastaxis``),
  when ``MXNET_PALLAS_SOFTMAX`` is on and every query row keeps a visible
  key (not causal, or ``q_offset >= kv_offset``); its backward is K5b
  from the probabilities alone (``_fused_softmax_nobias`` /
  ``_fused_softmax_bias``);
- einsum: the logits masked to -inf and ``torch.softmax``, so a row
  with no visible key comes out NaN rather than quietly uniform; torch's
  autograd differentiates it.
"""
from __future__ import annotations

import math

import torch

from ..ops import cuda_kernels as ck

__all__ = ["local_attention"]


class _FlashAttention(torch.autograd.Function):
    """K7a forward; backward ``delta = sum(do * o)`` per query row, then
    K7b (dq) and K7c (dk, dv) from the residuals q, k, v, o, lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = ck.flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        args = (q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        dq = ck.flash_attention_bwd_dq(*args)
        dk, dv = ck.flash_attention_bwd_dkv(*args)
        return dq, dk, dv, None, None


class _FusedSoftmax(torch.autograd.Function):
    """K5a (with a bias) or K2 forward over the last axis; backward K5b
    from the probabilities, and the bias's gradient, where one is
    needed, the sum of dx over the leading dims it is shared across."""

    @staticmethod
    def forward(ctx, x, bias):
        x = x.contiguous()
        p = ck.softmax_lastaxis(x) if bias is None else ck.bias_softmax(x,
                                                                        bias)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, do):
        p, = ctx.saved_tensors
        dx = ck.softmax_bwd(p, do.contiguous())
        dbias = None
        if ctx.needs_input_grad[1]:
            dbias = dx.reshape((-1,) + tuple(dx.shape[-2:])).sum(dim=0) \
                .to(torch.float32)
        return dx, dbias


def _flash_eligible(q, k, causal, q_offset, kv_offset):
    """Flash route under ``impl="auto"``: CUDA tensors, aligned offsets
    (the kernel's causal mask assumes a shared origin), lengths that are
    multiples of 8 — the JAX package's condition, with its TPU backend
    read as the GPU."""
    if q.device.type != "cuda":
        return False
    if causal and (q_offset != 0 or kv_offset != 0):
        return False
    return q.shape[1] % 8 == 0 and k.shape[1] % 8 == 0


def _expand_kv_heads(q, k, v):
    """GQA/MQA: repeat K/V heads up to the query head count when
    num_kv_heads divides num_q_heads."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq == hkv:
        return k, v
    if hq % hkv:
        raise ValueError("GQA needs q heads (%d) divisible by kv heads (%d)"
                         % (hq, hkv))
    rep = hq // hkv
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def local_attention(q, k, v, causal=False, q_offset=0, kv_offset=0,
                    scale=None, impl="auto"):
    """Softmax attention on local blocks.

    q: (B, Tq, H, D), k/v: (B, Tk, Hkv, D) with H % Hkv == 0.  The
    offsets give the global positions of the first query and key for
    causal masking.  ``impl``: "auto" takes the flash kernel where
    ``_flash_eligible`` holds; "flash" and "einsum" force a route.
    Returns (B, Tq, H, D)."""
    d = q.shape[-1]
    k, v = _expand_kv_heads(q, k, v)
    if impl == "flash" or (impl == "auto" and _flash_eligible(
            q, k, causal, q_offset, kv_offset)):
        b, tq, h, _ = q.shape
        tk = k.shape[1]

        def fold(a, t):
            return a.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()

        o = _FlashAttention.apply(fold(q, tq), fold(k, tk), fold(v, tk),
                                  causal, scale)
        return o.reshape(b, h, tq, d).permute(0, 2, 1, 3)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = None
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = kv_offset + torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
    if (not causal or q_offset >= kv_offset) \
            and ck.family_enabled("MXNET_PALLAS_SOFTMAX", logits.device):
        b, h, tq, tk = logits.shape
        bias = None if mask is None else \
            torch.where(mask, 0.0, ck.NEG_INF).to(torch.float32)
        probs = _FusedSoftmax.apply(logits.reshape(b * h, tq, tk), bias)
        return torch.einsum("bhqk,bkhd->bqhd", probs.reshape(b, h, tq, tk),
                            v)
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)
