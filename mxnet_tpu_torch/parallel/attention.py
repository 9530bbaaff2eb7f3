"""Softmax attention: on one device, and over a sequence-sharded mesh.

Counterpart of ``mxnet_tpu/parallel/attention.py``: ``local_attention``
with its three routes and the ``kv_len`` padding mask,
``_flash_eligible``, ``_expand_kv_heads`` (grouped-query attention),
``_pad_to_shards``, and the two sequence-parallel forms over the ``sp``
axis of a mesh (each rank one process, the port's form of a JAX mesh
device):

- ``ring_attention`` (Liu et al. 2310.01889): each rank keeps its 1/sp of
  the queries and K/V blocks rotate around the ring by point-to-point
  calls (``collectives.shift``: ``batch_isend_irecv`` to the next rank of
  the ``sp`` group, whose backward rotates the other way, the transpose
  of a ``ppermute``), each block folded into a running log-sum-exp by the
  JAX package's einsum math;
- ``ulysses_attention`` (Jacobs et al. 2309.14509): an all-to-all
  (``collectives.all_to_all``, backward the inverse exchange) trades the
  sequence shard for a head shard, ``local_attention`` runs over the full
  sequence with H/sp heads (so on the card K7a/K7b/K7c, or K5a/K5b at a
  length not a multiple of 8), and a second all-to-all trades back.

Both take and return GLOBAL (B, T, H, D) arrays, as the JAX functions
do: on entry each rank takes its block of the time axis (padded up to a
multiple of sp, the padded keys masked by ``kv_len``), on exit the ranks'
blocks are gathered.  Those edges are the JAX package's ``device_put``
scatter and its ``_restore_device`` gather, each differentiated as its
exact transpose (``collectives.take_block``, ``gather_blocks``).

The single-device routes, with the reference's branch conditions:

- flash: K7a (``cuda_kernels.flash_attention_fwd``) over ``(B*H, T,
  D)`` when ``impl="flash"``, or under ``impl="auto"`` when
  ``_flash_eligible`` holds (CUDA tensors, aligned offsets, both lengths
  multiples of 8 — the JAX package's condition with its TPU backend
  read as the GPU), and no key is padded (``kv_len``); its backward is
  ``delta = sum(do * o)`` in plain torch, then K7b (dq) and K7c (dk,
  dv), from the q, k, v, o and lse the forward kept (``_flash_fwd`` /
  ``_flash_bwd_rule``);
- fused softmax: the einsum logits, then K5a (``bias_softmax``: the
  mask as a 0 / ``NEG_INF`` bias) or, unmasked, K2 (``softmax_lastaxis``),
  when ``MXNET_PALLAS_SOFTMAX`` is on, no key is padded and every query
  row keeps a visible key (not causal, or ``q_offset >= kv_offset``);
  its backward is K5b from the probabilities alone
  (``_fused_softmax_nobias`` / ``_fused_softmax_bias``);
- einsum: the logits masked to -inf and ``torch.softmax``, so a row
  with no visible key comes out NaN rather than quietly uniform, but for
  the rows of padded queries under ``kv_len``, which are defined to come
  out zero; torch's autograd differentiates it.
"""
from __future__ import annotations

import math

import torch

from ..ops import cuda_kernels as ck
from .collectives import all_to_all, gather_blocks, shift, take_block

__all__ = ["ring_attention", "ulysses_attention", "local_attention"]


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
                    scale=None, impl="auto", kv_len=None):
    """Softmax attention on local blocks.

    q: (B, Tq, H, D), k/v: (B, Tk, Hkv, D) with H % Hkv == 0.  The
    offsets give the global positions of the first query and key for
    causal masking.  ``kv_len`` masks out keys whose global position is
    >= kv_len (the padding of a sequence padded up to a shard multiple).
    ``impl``: "auto" takes the flash kernel where ``_flash_eligible``
    holds; "flash" and "einsum" force a route.  Returns (B, Tq, H, D)."""
    d = q.shape[-1]
    k, v = _expand_kv_heads(q, k, v)
    if kv_len is not None and kv_len >= kv_offset + k.shape[1]:
        kv_len = None   # no padded key in this block
    if kv_len is None and (impl == "flash" or (impl == "auto" and
                                               _flash_eligible(
                                                   q, k, causal, q_offset,
                                                   kv_offset))):
        b, tq, h, _ = q.shape
        tk = k.shape[1]

        def fold(a, t):
            return a.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()

        o = _FlashAttention.apply(fold(q, tq), fold(k, tk), fold(v, tk),
                                  causal, scale)
        return o.reshape(b, h, tq, d).permute(0, 2, 1, 3)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    kpos = kv_offset + torch.arange(k.shape[1], device=q.device)
    mask = None
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
    if kv_len is not None:
        valid = (kpos < kv_len)[None, :]
        mask = valid if mask is None else mask & valid
    if kv_len is None and (not causal or q_offset >= kv_offset) \
            and ck.family_enabled("MXNET_PALLAS_SOFTMAX", logits.device):
        b, h, tq, tk = logits.shape
        bias = None if mask is None else \
            torch.where(mask, 0.0, ck.NEG_INF).to(torch.float32)
        probs = _FusedSoftmax.apply(logits.reshape(b * h, tq, tk), bias)
        return torch.einsum("bhqk,bkhd->bqhd", probs.reshape(b, h, tq, tk),
                            v)
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    if kv_len is not None:
        # padded queries see no valid key: their rows come out zero
        probs = torch.where(torch.isnan(probs), 0.0, probs)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _pad_to_shards(q, k, v, sp):
    """Pad the time axis up to a multiple of ``sp``: ``(q, k, v, kv_len)``
    with ``kv_len`` the real key count where padding was added (the
    shard bodies mask keys past it), else None."""
    t = q.shape[1]
    pad = (-t) % sp
    if pad == 0:
        return q, k, v, None

    def padded(a):
        return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))

    return padded(q), padded(k), padded(v), t


def _ring_attention_local(q, k, v, mesh, axis_name, causal, scale,
                          kv_len=None):
    """One rank's ring: its query block against every K/V block as they
    rotate past, with a running max and denominator (the JAX package's
    per-device body, its einsum math)."""
    k, v = _expand_kv_heads(q, k, v)
    axis_size = mesh.shape[axis_name]
    idx = mesh.coords[axis_name]
    b, t_local, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q_offset = idx * t_local
    neg_inf = float("-inf")
    qpos = q_offset + torch.arange(t_local, device=q.device)

    def block(carry, kk, vv, src):
        o, m, l = carry
        kv_offset = src * t_local
        logits = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
        kpos = kv_offset + torch.arange(t_local, device=q.device)
        mask = None
        if causal:
            mask = qpos[:, None] >= kpos[None, :]
        if kv_len is not None:
            valid = (kpos < kv_len)[None, :]
            mask = valid if mask is None else mask & valid
        if mask is not None:
            logits = torch.where(mask[None, None], logits, neg_inf)
        block_max = logits.amax(dim=-1)
        new_m = torch.maximum(m, block_max)
        # guard the rows with no valid key yet against NaN in exp
        new_m_safe = torch.where(torch.isneginf(new_m), 0.0, new_m)
        p = torch.exp(logits - new_m_safe[..., None])
        p = torch.where(torch.isneginf(logits), 0.0, p)
        correction = torch.exp(torch.where(torch.isneginf(m), neg_inf, m)
                               - new_m_safe)
        correction = torch.where(torch.isneginf(m), 0.0, correction)
        l_new = l * correction + p.sum(dim=-1)
        o_new = o * correction[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, vv)
        return o_new, new_m, l_new

    carry = (q.new_zeros((b, h, t_local, d)),
             q.new_full((b, h, t_local), neg_inf),
             q.new_zeros((b, h, t_local)))
    kk, vv, src = k, v, idx
    for step in range(axis_size):
        carry = block(carry, kk, vv, src)
        if step != axis_size - 1:
            # the next rank's block arrives as this one leaves
            kk = shift(kk, mesh, axis_name, 1)
            vv = shift(vv, mesh, axis_name, 1)
            src = (src - 1) % axis_size
    o, m, l = carry
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l[..., None]).permute(0, 2, 1, 3)   # (b, t_local, h, d)


def _sp_mesh(mesh, axis_name):
    from .mesh import current_mesh
    mesh = mesh or current_mesh()
    if mesh is None or mesh.shape.get(axis_name, 1) == 1:
        return None
    return mesh


def ring_attention(q, k, v, mesh=None, axis_name="sp", causal=False,
                   scale=None):
    """Ring attention over a sequence-sharded mesh axis.

    Global (B, T, H, D) inputs and output, on every rank of the mesh
    (``mesh``, else the current one); without a mesh, or with the axis of
    width one, it is ``local_attention``.  T need not divide the axis:
    it is padded and the padded keys masked."""
    mesh = _sp_mesh(mesh, axis_name)
    if mesh is None:
        return local_attention(q, k, v, causal=causal, scale=scale)
    sp = mesh.shape[axis_name]
    t_real = q.shape[1]
    q, k, v, kv_len = _pad_to_shards(q, k, v, sp)
    q, k, v = (take_block(a, 1, mesh, axis_name) for a in (q, k, v))
    out = _ring_attention_local(q, k, v, mesh, axis_name, causal, scale,
                                kv_len)
    out = gather_blocks(out, 1, mesh, axis_name)
    return out[:, :t_real] if kv_len is not None else out


def ulysses_attention(q, k, v, mesh=None, axis_name="sp", causal=False,
                      scale=None):
    """DeepSpeed-Ulysses sequence parallelism over a mesh axis; needs
    num_heads % sp == 0.  Global inputs and output, as
    :func:`ring_attention`."""
    mesh = _sp_mesh(mesh, axis_name)
    if mesh is None:
        return local_attention(q, k, v, causal=causal, scale=scale)
    sp = mesh.shape[axis_name]
    if q.shape[2] % sp:
        raise ValueError(
            "ulysses needs heads (%d) divisible by sp (%d); use "
            "ring_attention" % (q.shape[2], sp))
    t_real = q.shape[1]
    q, k, v, kv_len = _pad_to_shards(q, k, v, sp)
    q, k, v = (take_block(a, 1, mesh, axis_name) for a in (q, k, v))
    k, v = _expand_kv_heads(q, k, v)
    # (b, t/sp, h, d) -> gather the sequence, scatter the heads
    q, k, v = (all_to_all(a, 2, 1, mesh, axis_name) for a in (q, k, v))
    out = local_attention(q, k, v, causal=causal, scale=scale,
                          kv_len=kv_len)
    # back: scatter the sequence, gather the heads
    out = all_to_all(out, 1, 2, mesh, axis_name)
    out = gather_blocks(out, 1, mesh, axis_name)
    return out[:, :t_real] if kv_len is not None else out
