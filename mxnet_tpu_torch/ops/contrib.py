"""Contrib operators (counterpart of ``mxnet_tpu/ops/contrib.py``; this
package carries ``_contrib_flash_attention``)."""
from __future__ import annotations

from .registry import register


@register("_contrib_flash_attention")
def _flash_attention_op(q, k, v, causal=False, scale=None, **attrs):
    """Softmax attention over (B, T, H, D) tensors; K/V may carry fewer
    heads (GQA).  Runs ``parallel.attention.local_attention`` on one
    device: the K7a flash kernel where it is eligible, else the einsum
    logits with the K5a/K2 softmax or plain torch; differentiable through
    each route's backward (K7b and K7c, K5b, or torch's autograd).  The JAX package
    shards T over an ``sp`` mesh axis when one is active; this package
    has no mesh yet (ROADMAP.md queue 1, multi-GPU)."""
    from ..parallel.attention import local_attention
    if scale is not None:
        scale = float(scale)
    return local_attention(q, k, v, causal=bool(causal), scale=scale)
