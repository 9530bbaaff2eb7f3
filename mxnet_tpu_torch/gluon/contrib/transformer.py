"""Transformer blocks: a pre-LN causal decoder LM.

Counterpart of ``mxnet_tpu/gluon/contrib/transformer.py`` (no reference
analogue: MXNet 1.2 predates attention).  ``TransformerLM`` embeds
tokens and learned positions, runs N pre-LN blocks ``x + MHA(LN(x))``,
``x + FFN(LN(x))`` (a ReLU FFN, no bias on the q/k/v/out projections)
and an untied head with a bias.  Its ops reach three CUDA kernels:
LayerNorm (K6a), and attention through ``F.contrib.flash_attention``,
which takes the flash kernel (K7a) where ``local_attention`` finds it
eligible and the masked softmax (K5a) otherwise.

``causal_attention`` is the plain-torch einsum form of the causal
attention, the reference forward the kernels are held against.

Generative serving (``mxnet_tpu_torch.serving.generate``) consumes this
file through two seams, as in the JAX package:

- :func:`cached_attention_step` / :func:`causal_attention` — the plain
  attention math of the KV-cache decode and of the prefill: one query
  token a slot attends against a preallocated fixed-shape cache with a
  validity mask, so every decode step has the same shapes whatever the
  sequence position;
- :meth:`TransformerLM.generative_spec` — the block's weights as raw
  tensors on its device plus the architecture config, the feed
  ``serving/generate/model.py`` runs its prefill and decode from.
"""
from __future__ import annotations

import torch

from ..block import HybridBlock
from ..nn import Dense, Dropout, Embedding, HybridSequential, LayerNorm
from ..parameter import DeferredInitializationError

__all__ = ["MultiHeadAttention", "TransformerEncoderCell", "TransformerLM",
           "causal_attention", "cached_attention_step"]


def causal_attention(q, k, v):
    """Causal attention over full sequences in plain torch: einsum
    scores, the lower-triangular mask at -1e30, softmax, einsum.

    ``q``: ``[B, T, H, D]``; ``k``/``v``: ``[B, T, Hkv, D]`` with
    ``H % Hkv == 0`` (GQA repeats KV head groups).  Returns
    ``[B, T, H, D]``."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, t, hkv, g, d) * (d ** -0.5)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k)
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, -1e30)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(b, t, h, d)


def cached_attention_step(q, k_cache, v_cache, n_valid):
    """One DECODE step against a preallocated KV-cache, in plain torch.

    ``q``: ``[S, H, D]`` (one query token per decode slot);
    ``k_cache``/``v_cache``: ``[S, Hkv, M, D]`` (``M`` = cache capacity);
    ``n_valid``: ``[S]`` ints (a tensor or a host array) — how many cache
    positions hold real history per slot (the ring's fill level).
    Positions ``>= n_valid`` are masked at -1e30, so the same shapes serve
    every slot at every sequence position; causality is structural (the
    cache only ever holds past tokens plus the current one).  Returns
    ``[S, H, D]``."""
    s, h, d = q.shape
    hkv, m = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    qg = q.reshape(s, hkv, g, d) * (d ** -0.5)
    scores = torch.einsum("shgd,shmd->shgm", qg, k_cache)
    n_valid = torch.as_tensor(n_valid, device=q.device)
    valid = torch.arange(m, device=q.device)[None, None, None, :] \
        < n_valid[:, None, None, None]
    scores = scores.masked_fill(~valid, -1e30)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("shgm,shmd->shgd", p, v_cache)
    return out.reshape(s, h, d)


class MultiHeadAttention(HybridBlock):
    """Self-attention with optional GQA (num_kv_heads < num_heads).

    Input (B, T, C); output (B, T, C).
    """

    def __init__(self, units, num_heads, num_kv_heads=None, causal=False,
                 dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError("units (%d) must divide num_heads (%d)"
                             % (units, num_heads))
        self._units = units
        self._h = num_heads
        self._hkv = num_kv_heads or num_heads
        if self._h % self._hkv:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        self._d = units // num_heads
        self._causal = causal
        with self.name_scope():
            self.q_proj = Dense(self._h * self._d, use_bias=False,
                                flatten=False, prefix="q_")
            self.k_proj = Dense(self._hkv * self._d, use_bias=False,
                                flatten=False, prefix="k_")
            self.v_proj = Dense(self._hkv * self._d, use_bias=False,
                                flatten=False, prefix="v_")
            self.out_proj = Dense(units, use_bias=False, flatten=False,
                                  prefix="out_")
            self.drop = Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        q = self.q_proj(x).reshape((0, 0, self._h, self._d))
        k = self.k_proj(x).reshape((0, 0, self._hkv, self._d))
        v = self.v_proj(x).reshape((0, 0, self._hkv, self._d))
        o = F.contrib.flash_attention(q, k, v, causal=self._causal)
        o = self.out_proj(o.reshape((0, 0, -1)))
        return self.drop(o) if self.drop is not None else o


class TransformerEncoderCell(HybridBlock):
    """Pre-LN block: x + MHA(LN(x)); x + FFN(LN(x))."""

    def __init__(self, units, hidden_size, num_heads, num_kv_heads=None,
                 causal=False, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ln1 = LayerNorm()
            self.attn = MultiHeadAttention(units, num_heads,
                                           num_kv_heads=num_kv_heads,
                                           causal=causal, dropout=dropout)
            self.ln2 = LayerNorm()
            self.ffn = HybridSequential(prefix="ffn_")
            with self.ffn.name_scope():
                self.ffn.add(Dense(hidden_size, activation="relu",
                                   flatten=False))
                self.ffn.add(Dense(units, flatten=False))
            self.drop = Dropout(dropout) if dropout else None

    def hybrid_forward(self, F, x):
        x = x + self.attn(self.ln1(x))
        h = self.ffn(self.ln2(x))
        if self.drop is not None:
            h = self.drop(h)
        return x + h


class TransformerLM(HybridBlock):
    """Decoder-only causal LM: embed -> N pre-LN blocks -> untied head.

    Learned positional embeddings sized to ``max_len``; inputs are
    (B, T) token ids (float32, as the reference feeds them), outputs
    (B, T, vocab) logits.
    """

    def __init__(self, vocab_size, units=128, hidden_size=512, num_layers=2,
                 num_heads=4, num_kv_heads=None, max_len=512, dropout=0.0,
                 **kwargs):
        super().__init__(**kwargs)
        self._max_len = max_len
        self._vocab_size = vocab_size
        self._units = units
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._num_heads = num_heads
        self._num_kv_heads = num_kv_heads or num_heads
        with self.name_scope():
            self.embed = Embedding(vocab_size, units)
            self.pos_embed = Embedding(max_len, units)
            self.blocks = HybridSequential(prefix="blocks_")
            with self.blocks.name_scope():
                for _ in range(num_layers):
                    self.blocks.add(TransformerEncoderCell(
                        units, hidden_size, num_heads,
                        num_kv_heads=num_kv_heads, causal=True,
                        dropout=dropout))
            self.ln_f = LayerNorm()
            self.head = Dense(vocab_size, flatten=False, prefix="head_")

    def hybrid_forward(self, F, tokens):
        # the positions' window follows the embedded tokens through
        # slice_like, so any T <= max_len takes the first T positions
        x = self.embed(tokens)
        pos = F.arange(0, self._max_len, ctx=tokens.context)
        pos_e = self.pos_embed(pos).expand_dims(0)
        pos_e = F.slice_like(pos_e, x, axes=(1,))
        x = x + pos_e
        x = self.blocks(x)
        return self.head(self.ln_f(x))

    def generative_spec(self):
        """The decode-path export for ``mxnet_tpu_torch.serving.generate``:
        ``{"config": {...}, "params": {...}}`` with every weight the
        block's raw tensor on its device (the gluon wrapper stripped, no
        copy), in the JAX package's nested layout; Dense keeps ``(units,
        in_units)`` (``y = x @ W.T + b``).

        Deferred parameters are materialised by one dummy forward on the
        block's device, so an initialized-only block exports cleanly."""
        from ... import ndarray as _nd

        def _raw(param):
            try:
                return param.data()._data
            except DeferredInitializationError:
                ctx = self.embed.weight.data().context
                with torch.no_grad():
                    self(_nd.zeros((1, 2), ctx=ctx))
                return param.data()._data

        layers = []
        for cell in self.blocks._children.values():
            ffn = list(cell.ffn._children.values())
            layers.append({
                "ln1_g": _raw(cell.ln1.gamma),
                "ln1_b": _raw(cell.ln1.beta),
                "wq": _raw(cell.attn.q_proj.weight),
                "wk": _raw(cell.attn.k_proj.weight),
                "wv": _raw(cell.attn.v_proj.weight),
                "wo": _raw(cell.attn.out_proj.weight),
                "ln2_g": _raw(cell.ln2.gamma),
                "ln2_b": _raw(cell.ln2.beta),
                "w1": _raw(ffn[0].weight), "b1": _raw(ffn[0].bias),
                "w2": _raw(ffn[1].weight), "b2": _raw(ffn[1].bias),
            })
        params = {
            "embed": _raw(self.embed.weight),
            "pos_embed": _raw(self.pos_embed.weight),
            "layers": layers,
            "ln_f_g": _raw(self.ln_f.gamma),
            "ln_f_b": _raw(self.ln_f.beta),
            "head_w": _raw(self.head.weight),
            "head_b": _raw(self.head.bias),
        }
        config = {
            "vocab_size": self._vocab_size,
            "units": self._units,
            "hidden_size": self._hidden_size,
            "num_layers": self._num_layers,
            "num_heads": self._num_heads,
            "num_kv_heads": self._num_kv_heads,
            "max_len": self._max_len,
        }
        return {"config": config, "params": params}
