"""Hand-written CUDA kernels for the hot paths, with their plain versions.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``.  Each kernel lives in
``csrc/<name>.cu`` behind a plain C function (built by ``_build.py``),
and has here:

- a wrapper that checks device, dtype, contiguity and shape, allocates
  the output with ``torch.empty`` (or, for the optimizer sweeps, writes
  its operands in place), launches on the current stream and raises if
  the launch failed.  A tensor on the CPU goes to the plain
  version instead; there is no fallback from a CUDA tensor;
- the plain PyTorch version, which repeats the kernel's arithmetic: the
  CPU path, and the kernel's reference on the card;
- a launch count (:func:`kernel_calls`), advanced only where the wrapper
  launches the kernel, and, while telemetry is on, the registry's
  ``mxnet_pallas_kernel_calls_total{kernel=...}`` under the JAX
  package's label for the Pallas kernel it replaces (``_TELEMETRY_LABEL``;
  the two backward kernels of flash attention share
  ``flash_attention_bwd``).  The JAX package counts once per traced
  program; the port counts each launch.

Ported so far (the K numbers of the kernel table in PERF.md):

- K3 ``scale_bias_relu`` <- ``_scale_bias_relu_kernel``: the inference
  BatchNorm + ReLU epilogue, read straight from NCHW.
- K2 ``softmax_lastaxis`` <- ``_softmax_fwd_kernel``: the SoftmaxOutput
  forward.
- K1a ``sgd_sweep`` <- ``_sgd_kernel``, K1b ``sgd_mom_sweep`` <-
  ``_sgd_mom_kernel``, K4 ``adam_sweep`` <- ``_adam_kernel``: the
  executor's fused optimizer step, one launch per flat fp32 bucket,
  updating the weights and slots in place (all three in
  ``csrc/optimizer_sweep.cu``);
- K6a ``layernorm_fwd`` <- ``_layernorm_fwd_kernel``: the LayerNorm op
  over the last axis, saving mu and rstd per row;
- K6b ``layernorm_bwd`` <- ``_layernorm_bwd_kernel``: its dx, from the
  mu and rstd K6a saved;
- K7a ``flash_attention_fwd`` <- ``_flash_fwd_kernel``: online-softmax
  attention over (batch*heads, T, D), with the row logsumexp;
- K7b ``flash_attention_bwd_dq`` <- ``_flash_bwd_dq_kernel`` and K7c
  ``flash_attention_bwd_dkv`` <- ``_flash_bwd_dkv_kernel``: its dq, and
  its dk and dv (all three in ``csrc/flash_attention.cu``);
- K5a ``bias_softmax`` <- ``_softmax_bias_fwd_kernel``: ``softmax(x +
  bias)`` with an (R, C) bias shared over x's leading dim, the masked
  attention of ``local_attention``, and K5b ``softmax_bwd`` <-
  ``_softmax_bwd_kernel``: the backward of K2 and K5a (both in
  ``csrc/softmax.cu`` beside K2).

``family_enabled`` resolves the JAX package's tri-state ``MXNET_PALLAS_*``
knobs: ``auto`` turns a family on for tensors on the GPU, ``1`` forces it
(CPU tensors then take the plain version), ``0`` turns it off.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from .. import config as _config
from .. import telemetry
from ..base import MXNetError

__all__ = ["scale_bias_relu", "scale_bias_relu_ref", "softmax_lastaxis",
           "softmax_lastaxis_ref", "sgd_sweep", "sgd_sweep_ref",
           "sgd_mom_sweep", "sgd_mom_sweep_ref", "adam_sweep",
           "adam_sweep_ref", "layernorm_fwd", "layernorm_fwd_ref",
           "layernorm_bwd", "layernorm_bwd_ref", "flash_attention_fwd",
           "flash_attention_fwd_ref", "flash_attention_bwd_dq",
           "flash_attention_bwd_dq_ref", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dkv_ref", "bias_softmax", "bias_softmax_ref",
           "softmax_bwd", "softmax_bwd_ref", "NEG_INF", "kernel_calls",
           "reset_kernel_calls", "family_enabled"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_COUNT_LOCK = threading.Lock()
_CALLS = {"scale_bias_relu": 0, "softmax_lastaxis": 0,  # guarded-by: _COUNT_LOCK
          "sgd_sweep": 0, "sgd_mom_sweep": 0, "adam_sweep": 0,
          "layernorm_fwd": 0, "layernorm_bwd": 0, "flash_attention_fwd": 0,
          "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
          "bias_softmax": 0, "softmax_bwd": 0}

# the masked-logit value of the attention kernels (pallas_kernels.NEG_INF):
# finite, so a masked column's exp underflows to exactly 0
NEG_INF = -1e30


def kernel_calls():
    """Kernel launches so far, by kernel name."""
    with _COUNT_LOCK:
        return dict(_CALLS)


def reset_kernel_calls():
    with _COUNT_LOCK:
        for k in _CALLS:
            _CALLS[k] = 0


# each wrapper's label in mxnet_pallas_kernel_calls_total: the JAX
# package's name of the Pallas kernel it replaces (ops/pallas_kernels.py)
_TELEMETRY_LABEL = {
    "scale_bias_relu": "fused_scale_bias_relu",
    "softmax_lastaxis": "fused_softmax_fwd",
    "bias_softmax": "fused_softmax_fwd",
    "softmax_bwd": "fused_softmax_bwd",
    "sgd_sweep": "fused_sgd",
    "sgd_mom_sweep": "fused_sgd_momentum",
    "adam_sweep": "fused_adam",
    "layernorm_fwd": "fused_layernorm_fwd",
    "layernorm_bwd": "fused_layernorm_bwd",
    "flash_attention_fwd": "flash_attention_fwd",
    "flash_attention_bwd_dq": "flash_attention_bwd",
    "flash_attention_bwd_dkv": "flash_attention_bwd",
}


def _count(name):
    with _COUNT_LOCK:
        _CALLS[name] += 1
    if telemetry.enabled():
        telemetry.counter(
            "mxnet_pallas_kernel_calls_total",
            "launches of the hand-written CUDA kernels, by the JAX "
            "package's name of the Pallas kernel each replaces (one per "
            "launch: the graph is eager; flash attention's backward is "
            "two kernels)").labels(kernel=_TELEMETRY_LABEL[name]).inc()


def family_enabled(knob, device):
    """Resolve a tri-state kernel-family knob for tensors on ``device``."""
    v = str(_config.tuned(knob) or "").lower()
    if v in ("", "auto"):
        return torch.device(device).type == "cuda"
    return v not in ("0", "false")


_FNS = {}    # C function name -> ctypes function with argtypes set


def _bind(lib_name, fn_name, argtypes):
    """The C entry point ``fn_name`` of ``libmxtt_<lib_name>.so``, built
    and loaded at its first call."""
    fn = _FNS.get(fn_name)
    if fn is None:
        from . import _build
        fn = getattr(_build.library(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[fn_name] = fn
    return fn


def _check_cuda(name, x):
    if x.dtype not in _DTYPE_CODE:
        raise MXNetError("%s: the CUDA kernel takes float32 or bfloat16, "
                         "got %s" % (name, x.dtype))
    if not x.is_contiguous():
        raise MXNetError("%s: the CUDA kernel takes a contiguous tensor"
                         % name)


def _launch(name, fn, device, *args):
    """Call ``fn(*args, stream)`` on ``device``'s current stream, raise if
    the launch was refused, and count it."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise MXNetError("%s: CUDA kernel launch failed with cudaError_t %d"
                         % (name, rc))
    _count(name)


# ---------------------------------------------------------------------------
# K3: inference BatchNorm + ReLU epilogue
# ---------------------------------------------------------------------------
def scale_bias_relu_ref(x, scale, bias, relu=True):
    """Plain version of K3: ``relu(x * scale[c] + bias[c])`` over dim 1
    of an (N, C, ...) tensor, computed in fp32 and rounded once to x's
    dtype."""
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    y = x.float() * scale.view(shape) + bias.view(shape)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def scale_bias_relu(x, scale, bias, relu=True):
    """K3: ``y = relu(x * scale[c] + bias[c])`` for an (N, C, *spatial)
    tensor x in float32 or bfloat16 (channel = dim 1, read in place:
    NCHW needs no transpose) with float32 (C,) scale and bias."""
    if x.dim() < 2:
        raise MXNetError("scale_bias_relu: x needs a channel dim (N, C, "
                         "...), got shape %s" % (tuple(x.shape),))
    c = x.shape[1]
    for nm, v in (("scale", scale), ("bias", bias)):
        if v.shape != (c,) or v.dtype != torch.float32 \
                or v.device != x.device:
            raise MXNetError(
                "scale_bias_relu: %s must be float32 of shape (%d,) on %s, "
                "got %s %s on %s" % (nm, c, x.device, v.dtype,
                                     tuple(v.shape), v.device))
    if x.device.type != "cuda":
        return scale_bias_relu_ref(x, scale, bias, relu)
    _check_cuda("scale_bias_relu", x)
    scale, bias = scale.contiguous(), bias.contiguous()
    y = torch.empty_like(x)
    n = x.numel()
    hw = n // (x.shape[0] * c) if n else 1
    xp, yp = x.data_ptr(), y.data_ptr()
    vec = int(hw % (16 // x.element_size()) == 0 and xp % 16 == 0
              and yp % 16 == 0)
    fn = _bind("scale_bias_relu", "mxtt_scale_bias_relu",
               [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
               + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    _launch("scale_bias_relu", fn, x.device, xp, scale.data_ptr(),
            bias.data_ptr(), yp, n, hw, c, _DTYPE_CODE[x.dtype], vec,
            int(bool(relu)))
    return y


# ---------------------------------------------------------------------------
# K2: last-axis softmax
# ---------------------------------------------------------------------------
def softmax_lastaxis_ref(x):
    """Plain version of K2: softmax over the last axis with fp32 max, exp
    and sum, output in x's dtype."""
    s = x.float()
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def softmax_lastaxis(x):
    """K2: softmax over the last axis of a float32 or bfloat16 tensor of
    any shape (rows = the product of the leading dims), output in x's
    dtype.  Rows of up to 1024 columns are read once into registers (one
    row a block of up to 8 warps below 1024 rows, one warp a row from
    there on); wider rows are read once into the registers of one CTA a
    row, or of a cluster of 2-8 CTAs where the rows are too few to fill
    the card or a row does not fit in one CTA; rows past what eight CTAs
    hold (262,144 columns) take a streaming form that reads x twice."""
    if x.dim() < 1:
        raise MXNetError("softmax_lastaxis: x needs at least one dim")
    if x.device.type != "cuda":
        return softmax_lastaxis_ref(x)
    _check_cuda("softmax_lastaxis", x)
    y = torch.empty_like(x)
    cols = x.shape[-1]
    rows = x.numel() // cols if cols else 0
    fn = _bind("softmax", "mxtt_softmax_lastaxis",
               [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2
               + [ctypes.c_int, ctypes.c_void_p])
    _launch("softmax_lastaxis", fn, x.device, x.data_ptr(), y.data_ptr(),
            rows, cols, _DTYPE_CODE[x.dtype])
    return y


# ---------------------------------------------------------------------------
# K1a / K1b / K4: one-sweep optimizer updates over a flat fp32 bucket
# ---------------------------------------------------------------------------
# name -> (kind in the C entry point, optimizer slots, hyperparameter
# count without the clip, indices of wd, rescale and clip).  The vectors
# keep the JAX package's order (pallas_kernels.py fused_sgd_momentum /
# fused_adam), the clip bound last when it is on:
#   sgd_sweep      [lr, wd, rescale, (clip)]
#   sgd_mom_sweep  [lr, mu, wd, rescale, (clip)]
#   adam_sweep     [lr_eff, b1, b2, 1-b1, 1-b2, eps, wd, rescale, (clip)]
_SWEEPS = {
    "sgd_sweep": (0, 0, 3, (1, 2, 3)),
    "sgd_mom_sweep": (1, 1, 4, (2, 3, 4)),
    "adam_sweep": (2, 2, 8, (6, 7, 8)),
}


def sweep_hyper_len(name, use_clip):
    """Length of ``name``'s hyperparameter vector."""
    return _SWEEPS[name][2] + int(bool(use_clip))


def _sweep_grad_ref(w, g, h, idx, use_clip):
    """The shared prologue, as ``optimizer_ops._prep_grad``: rescale,
    clip, add the weight decay; the scalars are 0-dim fp32 tensors."""
    i_wd, i_rescale, i_clip = idx
    g = g * h[i_rescale]
    if use_clip:
        g = torch.clamp(g, -h[i_clip], h[i_clip])
    return g + h[i_wd] * w


def sgd_sweep_ref(w, g, hyper, use_clip=False):
    """Plain version of K1a, in place: ``w -= lr * g'``."""
    gp = _sweep_grad_ref(w, g, hyper, _SWEEPS["sgd_sweep"][3], use_clip)
    w.copy_(w - hyper[0] * gp)


def sgd_mom_sweep_ref(w, g, m, hyper, use_clip=False):
    """Plain version of K1b, in place: ``m = mu * m - lr * g'; w += m``."""
    gp = _sweep_grad_ref(w, g, hyper, _SWEEPS["sgd_mom_sweep"][3], use_clip)
    nm = hyper[1] * m - hyper[0] * gp
    w.copy_(w + nm)
    m.copy_(nm)


def adam_sweep_ref(w, g, m, v, hyper, use_clip=False):
    """Plain version of K4, in place: ``m = b1 m + (1-b1) g'``,
    ``v = b2 v + (1-b2) g'^2``, ``w -= (lr_eff m) / (sqrt(v) + eps)``."""
    gp = _sweep_grad_ref(w, g, hyper, _SWEEPS["adam_sweep"][3], use_clip)
    nm = hyper[1] * m + hyper[3] * gp
    nv = hyper[2] * v + hyper[4] * (gp * gp)
    w.copy_(w - hyper[0] * nm / (torch.sqrt(nv) + hyper[5]))
    m.copy_(nm)
    v.copy_(nv)


_SWEEP_REFS = {"sgd_sweep": sgd_sweep_ref, "sgd_mom_sweep": sgd_mom_sweep_ref,
               "adam_sweep": adam_sweep_ref}


def _sweep(name, w, g, slots, hyper, use_clip):
    """Check the operands of sweep ``name`` and run it in place: the plain
    version for CPU tensors, the kernel for CUDA tensors."""
    kind, n_slots, n_hyper, _ = _SWEEPS[name]
    bufs = (w, g) + tuple(slots)
    if len(slots) != n_slots:
        raise MXNetError("%s takes %d optimizer slots, got %d"
                         % (name, n_slots, len(slots)))
    for t in bufs:
        if t.dtype != torch.float32 or t.device != w.device \
                or t.numel() != w.numel():
            raise MXNetError(
                "%s: w, g and the slots must be float32 tensors of %d "
                "elements on %s; got %s of %d elements on %s"
                % (name, w.numel(), w.device, t.dtype, t.numel(), t.device))
    need = n_hyper + int(bool(use_clip))
    if hyper.dtype != torch.float32 or hyper.device != w.device \
            or hyper.dim() != 1 or hyper.numel() != need:
        raise MXNetError("%s: hyper must be a float32 vector of %d on %s, "
                         "got %s %s on %s" % (name, need, w.device,
                                              hyper.dtype, tuple(hyper.shape),
                                              hyper.device))
    if w.device.type != "cuda":
        _SWEEP_REFS[name](*bufs, hyper, use_clip)
        return
    for t in bufs + (hyper,):
        if not t.is_contiguous():
            raise MXNetError("%s: the CUDA kernel takes contiguous tensors"
                             % name)
    ptrs = [t.data_ptr() for t in bufs]
    vec = int(all(p % 16 == 0 for p in ptrs))
    ptrs += [None] * (4 - len(ptrs))
    fn = _bind("optimizer_sweep", "mxtt_optimizer_sweep",
               [ctypes.c_int] + [ctypes.c_void_p] * 5
               + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p])
    _launch(name, fn, w.device, kind, *ptrs, hyper.data_ptr(), w.numel(),
            int(bool(use_clip)), vec)


def sgd_sweep(w, g, hyper, use_clip=False):
    """K1a: SGD over a flat fp32 bucket, ``w`` updated in place.
    ``hyper`` = ``[lr, wd, rescale, (clip)]`` as a float32 vector on w's
    device."""
    _sweep("sgd_sweep", w, g, (), hyper, use_clip)


def sgd_mom_sweep(w, g, m, hyper, use_clip=False):
    """K1b: SGD with momentum over a flat fp32 bucket, ``w`` and the
    momentum ``m`` updated in place.  ``hyper`` = ``[lr, mu, wd,
    rescale, (clip)]``."""
    _sweep("sgd_mom_sweep", w, g, (m,), hyper, use_clip)


def adam_sweep(w, g, m, v, hyper, use_clip=False):
    """K4: Adam over a flat fp32 bucket, ``w``, ``m`` and ``v`` updated in
    place.  ``hyper`` = ``[lr_eff, b1, b2, 1-b1, 1-b2, eps, wd, rescale,
    (clip)]``, with ``1-b`` computed on the host in double."""
    _sweep("adam_sweep", w, g, (m, v), hyper, use_clip)


# ---------------------------------------------------------------------------
# K6a: LayerNorm forward over the last axis
# ---------------------------------------------------------------------------
def layernorm_fwd_ref(x, gamma, beta, eps):
    """Plain version of K6a over the last axis, in fp32: ``mu``, ``var``
    of the centred values, ``rstd = rsqrt(var + eps)``, ``o = (xc * rstd)
    * gamma + beta`` in x's dtype; ``mu`` and ``rstd`` as fp32 of shape
    ``x.shape[:-1]``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    o = ((xc * rstd) * gamma + beta).to(x.dtype)
    return o, mu.squeeze(-1), rstd.squeeze(-1)


def layernorm_fwd(x, gamma, beta, eps=1e-5):
    """K6a: LayerNorm over the last axis of a float32 or bfloat16 tensor
    with float32 (C,) ``gamma`` and ``beta``.  Returns ``(o, mu, rstd)``:
    ``o`` in x's dtype and shape, ``mu`` and ``rstd`` fp32 of shape
    ``x.shape[:-1]`` (what the backward reads)."""
    if x.dim() < 1:
        raise MXNetError("layernorm_fwd: x needs at least one dim")
    c = x.shape[-1]
    for nm, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (c,) or t.dtype != torch.float32 \
                or t.device != x.device:
            raise MXNetError(
                "layernorm_fwd: %s must be float32 of shape (%d,) on %s, got "
                "%s %s on %s" % (nm, c, x.device, t.dtype, tuple(t.shape),
                                 t.device))
    if x.device.type != "cuda":
        return layernorm_fwd_ref(x, gamma, beta, eps)
    _check_cuda("layernorm_fwd", x)
    rows = x.numel() // c if c else 0
    if c < 1 or (c > 1024 and rows >= 2 ** 31):
        raise MXNetError("layernorm_fwd: the CUDA kernel takes C >= 1 and, "
                         "for C > 1024, fewer than 2**31 rows; got %s"
                         % (tuple(x.shape),))
    gamma, beta = gamma.contiguous(), beta.contiguous()
    o = torch.empty_like(x)
    mu = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    fn = _bind("layernorm", "mxtt_layernorm_fwd",
               [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int,
                                        ctypes.c_float, ctypes.c_int,
                                        ctypes.c_void_p])
    _launch("layernorm_fwd", fn, x.device, x.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), o.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            rows, c, float(eps), _DTYPE_CODE[x.dtype])
    return o, mu, rstd


# ---------------------------------------------------------------------------
# K6b: LayerNorm backward (dx)
# ---------------------------------------------------------------------------
def layernorm_bwd_ref(x, do, gamma, mu, rstd):
    """Plain version of K6b over the last axis, in fp32: ``xhat = (x -
    mu) * rstd``, ``dxh = do * gamma``, ``dx = rstd * (dxh - mean(dxh) -
    xhat * mean(dxh * xhat))`` in x's dtype."""
    rs = rstd.unsqueeze(-1)
    xhat = (x.float() - mu.unsqueeze(-1)) * rs
    dxh = do.float() * gamma
    c1 = dxh.mean(dim=-1, keepdim=True)
    c2 = (dxh * xhat).mean(dim=-1, keepdim=True)
    return (rs * (dxh - c1 - xhat * c2)).to(x.dtype)


def layernorm_bwd(x, do, gamma, mu, rstd):
    """K6b: the dx of K6a's LayerNorm over the last axis, from x and do
    (float32 or bfloat16, one shape and dtype), float32 (C,) ``gamma``
    and the fp32 ``mu`` and ``rstd`` of shape ``x.shape[:-1]`` that
    :func:`layernorm_fwd` returned.  Returns dx in x's dtype and shape;
    dgamma and dbeta are the caller's plain reductions."""
    if x.dim() < 1 or do.shape != x.shape or do.dtype != x.dtype \
            or do.device != x.device:
        raise MXNetError("layernorm_bwd: do must match x in shape, dtype "
                         "and device, got %s %s and %s %s"
                         % (tuple(x.shape), x.dtype, tuple(do.shape),
                            do.dtype))
    c = x.shape[-1]
    if gamma.shape != (c,) or gamma.dtype != torch.float32 \
            or gamma.device != x.device:
        raise MXNetError("layernorm_bwd: gamma must be float32 of shape "
                         "(%d,) on %s, got %s %s" % (c, x.device, gamma.dtype,
                                                     tuple(gamma.shape)))
    for nm, t in (("mu", mu), ("rstd", rstd)):
        if t.shape != x.shape[:-1] or t.dtype != torch.float32 \
                or t.device != x.device:
            raise MXNetError("layernorm_bwd: %s must be float32 of shape %s "
                             "on %s (one per row), got %s %s"
                             % (nm, tuple(x.shape[:-1]), x.device, t.dtype,
                                tuple(t.shape)))
    if x.device.type != "cuda":
        return layernorm_bwd_ref(x, do, gamma, mu, rstd)
    rows = x.numel() // c if c else 0
    if c < 1 or (c > 1024 and rows >= 2 ** 31):
        raise MXNetError("layernorm_bwd: the CUDA kernel takes C >= 1 and, "
                         "for C > 1024, fewer than 2**31 rows; got %s"
                         % (tuple(x.shape),))
    for nm, t in (("x", x), ("do", do), ("mu", mu), ("rstd", rstd)):
        _check_cuda("layernorm_bwd (%s)" % nm, t)
    gamma = gamma.contiguous()
    dx = torch.empty_like(x)
    fn = _bind("layernorm", "mxtt_layernorm_bwd",
               [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p])
    _launch("layernorm_bwd", fn, x.device, x.data_ptr(), do.data_ptr(),
            gamma.data_ptr(), mu.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            rows, c, _DTYPE_CODE[x.dtype])
    return dx


# ---------------------------------------------------------------------------
# K7a, K7b, K7c: flash attention, forward and backward
# ---------------------------------------------------------------------------
_FLASH_MAX_T = 65535 * 32   # 32-row tiles on the grid's second axis
_FLASH_MAX_D = 65535 * 64   # 64-column chunks of D on the grid's third


def _flash_check(name, q, k, v, rows=()):
    """Shapes, dtypes and devices of a flash call: q ``(BH, Tq, D)``, k and
    v ``(BH, Tk, D)``, and ``rows``, ``(label, tensor, want)`` triples
    that must equal ``want`` (``"q"`` for q's shape and dtype, ``"lse"``
    for fp32 ``(BH, Tq)``)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 \
            or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2]:
        raise MXNetError("%s: q must be (BH, Tq, D) and k, v (BH, Tk, D), "
                         "got %s, %s, %s" % (name, tuple(q.shape),
                                             tuple(k.shape), tuple(v.shape)))
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise MXNetError("%s: q, k and v must share dtype and device, "
                             "got %s/%s and %s/%s" % (name, q.dtype, q.device,
                                                      t.dtype, t.device))
    for label, t, want in rows:
        shape, dtype = (q.shape, q.dtype) if want == "q" \
            else (q.shape[:2], torch.float32)
        if t.shape != shape or t.dtype != dtype or t.device != q.device:
            raise MXNetError("%s: %s must be %s of shape %s on %s, got %s %s "
                             "on %s" % (name, label, dtype, tuple(shape),
                                        q.device, t.dtype, tuple(t.shape),
                                        t.device))


def _flash_cuda_check(name, q, k, tensors):
    """What the CUDA kernels take: 1 <= D <= 65535 * 64, 1 <= T <= 65535
    * 32, BH < 2**31, contiguous tensors."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    if not 1 <= d <= _FLASH_MAX_D:
        raise MXNetError("%s: the CUDA kernel takes head dims 1 to %d, got "
                         "%d" % (name, _FLASH_MAX_D, d))
    if min(bh, tq, tk) < 1 or max(tq, tk) > _FLASH_MAX_T or bh >= 2 ** 31:
        raise MXNetError("%s: the CUDA kernel takes 1 <= Tq, Tk <= %d and 1 "
                         "<= BH < 2**31, got %s and Tk %d"
                         % (name, _FLASH_MAX_T, tuple(q.shape), tk))
    for nm, t in tensors:
        _check_cuda("%s (%s)" % (name, nm), t)


def flash_attention_fwd_ref(q, k, v, causal=False, scale=None):
    """Plain version of K7a: one-shot masked softmax attention in fp32
    over (BH, T, D) tensors, with the kernel's mask (``qpos >= kpos`` from
    a shared origin, masked logits at the finite ``NEG_INF``) and its
    clamp of the row sum; p is rounded to v's dtype before ``p v`` and
    summed unrounded, as the TPU kernel does.  Returns ``(o, lse)``: o in
    q's dtype, lse fp32 (BH, Tq)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (torch.matmul(_rounded(p, v.dtype), v.float()) / lsum).to(q.dtype)
    return o, (m + torch.log(lsum)).squeeze(-1)


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """K7a: attention over float32 or bfloat16 ``(BH, T, D)`` tensors,
    batch and heads folded into the leading dim (q ``(BH, Tq, D)``, k and
    v ``(BH, Tk, D)``), any ``D`` (the kernel's instance is D rounded up
    to 32, the padding zero; above 256 the output is computed in chunks of
    64 columns), ``scale`` default ``1/sqrt(D)``.  A causal mask keeps ``qpos >= kpos`` with both
    counted from 0.  Returns ``(o, lse)``: o ``(BH, Tq, D)`` in q's
    dtype, lse the fp32 ``(BH, Tq)`` row logsumexp (what the backward
    reads)."""
    _flash_check("flash_attention_fwd", q, k, v)
    if q.device.type != "cuda":
        return flash_attention_fwd_ref(q, k, v, causal, scale)
    _flash_cuda_check("flash_attention_fwd", q, k,
                      (("q", q), ("k", k), ("v", v)))
    bh, tq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    fn = _bind("flash_attention", "mxtt_flash_attention_fwd",
               [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_int] * 3
               + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p])
    _launch("flash_attention_fwd", fn, q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, tq, k.shape[1],
            d, float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype])
    return o, lse


def _flash_bwd_p_ds(q, k, v, do, lse, delta, causal, scale):
    """The backward's recomputed probabilities and score gradients, fp32
    ``(BH, Tq, Tk)``, as the TPU kernels form them: ``s = (q k^T) *
    scale`` masked to ``NEG_INF``, ``p = exp(s - lse)``, ``dp = do v^T``,
    ``ds = (p * (dp - delta)) * scale``."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(~(qpos[:, None] >= kpos[None, :]), NEG_INF)
    p = torch.exp(s - lse.unsqueeze(-1))
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    return p, (p * (dp - delta.unsqueeze(-1))) * scale


def _rounded(t, dtype):
    """``t`` rounded to ``dtype`` and back to fp32: the TPU kernels'
    ``.astype`` of p and ds before a product, a no-op in fp32."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal=False,
                               scale=None):
    """Plain version of K7b: ``dq = ds k`` in fp32, with ds rounded to k's
    dtype first; dq in q's dtype."""
    _, ds = _flash_bwd_p_ds(q, k, v, do, lse, delta, causal, scale)
    return torch.matmul(_rounded(ds, k.dtype), k.float()).to(q.dtype)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal=False,
                                scale=None):
    """Plain version of K7c: ``dk = ds^T q`` and ``dv = p^T do`` in fp32,
    with p and ds rounded to the inputs' dtype first; both in k's
    dtype."""
    p, ds = _flash_bwd_p_ds(q, k, v, do, lse, delta, causal, scale)
    dk = torch.matmul(_rounded(ds, q.dtype).transpose(1, 2), q.float())
    dv = torch.matmul(_rounded(p, q.dtype).transpose(1, 2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_on_card(name, q, k, v, do, lse, delta):
    """Check a backward call's operands; whether they lie on the card
    (else the caller takes the plain version)."""
    _flash_check(name, q, k, v, (("do", do, "q"), ("lse", lse, "lse"),
                                 ("delta", delta, "lse")))
    if q.device.type != "cuda":
        return False
    _flash_cuda_check(name, q, k, (("q", q), ("k", k), ("v", v), ("do", do),
                                   ("lse", lse), ("delta", delta)))
    return True


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False,
                           scale=None):
    """K7b: the dq of K7a's attention, from q, k, v, the output's
    gradient ``do`` (q's shape and dtype), K7a's fp32 ``lse`` and ``delta
    = sum(do * o)`` per query row (fp32 ``(BH, Tq)``).  Returns dq in q's
    dtype."""
    if not _flash_bwd_on_card("flash_attention_bwd_dq", q, k, v, do, lse,
                              delta):
        return flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal,
                                          scale)
    bh, tq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dq = torch.empty_like(q)
    fn = _bind("flash_attention", "mxtt_flash_attention_bwd_dq",
               [ctypes.c_void_p] * 7 + [ctypes.c_int64] + [ctypes.c_int] * 3
               + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p])
    _launch("flash_attention_bwd_dq", fn, q.device, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), bh, tq, k.shape[1], d,
            float(scale), int(bool(causal)), _DTYPE_CODE[q.dtype])
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            scale=None):
    """K7c: the dk and dv of K7a's attention, from the operands of
    :func:`flash_attention_bwd_dq`.  Returns ``(dk, dv)`` in k's
    dtype."""
    if not _flash_bwd_on_card("flash_attention_bwd_dkv", q, k, v, do, lse,
                              delta):
        return flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal,
                                           scale)
    bh, tq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _bind("flash_attention", "mxtt_flash_attention_bwd_dkv",
               [ctypes.c_void_p] * 8 + [ctypes.c_int64] + [ctypes.c_int] * 3
               + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p])
    _launch("flash_attention_bwd_dkv", fn, q.device, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, tq,
            k.shape[1], d, float(scale), int(bool(causal)),
            _DTYPE_CODE[q.dtype])
    return dk, dv


# ---------------------------------------------------------------------------
# K5a: softmax(x + bias) over the last axis, bias shared over x's batch
# ---------------------------------------------------------------------------
def bias_softmax_ref(x, bias):
    """Plain version of K5a: ``s = x.float() + bias``, then K2's plain
    arithmetic on s, output in x's dtype."""
    return softmax_lastaxis_ref(x.float() + bias).to(x.dtype)


def bias_softmax(x, bias):
    """K5a: ``softmax(x + bias)`` over the last axis of a float32 or
    bfloat16 tensor ``x`` of shape ``(..., R, C)``, with a float32 ``(R,
    C)`` bias shared over x's leading dims (the attention-mask form: 0
    where a key is visible, ``NEG_INF`` where it is masked); max and sum
    in fp32, output in x's dtype.  Rows of up to 1024 columns are read
    once into registers with their bias row, in K2's two layouts; wider
    rows take the strided three-pass loop."""
    if bias.dim() != 2 or x.dim() < 2 or x.shape[-2] != bias.shape[0] \
            or x.shape[-1] != bias.shape[1]:
        raise MXNetError("bias_softmax: bias rows (%s) must equal x's "
                         "second-to-last dim and its columns x's last (%s)"
                         % (tuple(bias.shape), tuple(x.shape)))
    if bias.dtype != torch.float32 or bias.device != x.device:
        raise MXNetError("bias_softmax: bias must be float32 on %s, got %s "
                         "on %s" % (x.device, bias.dtype, bias.device))
    if x.device.type != "cuda":
        return bias_softmax_ref(x, bias)
    _check_cuda("bias_softmax", x)
    bias = bias.contiguous()
    y = torch.empty_like(x)
    r, c = bias.shape
    fn = _bind("softmax", "mxtt_bias_softmax",
               [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
               + [ctypes.c_int, ctypes.c_void_p])
    _launch("bias_softmax", fn, x.device, x.data_ptr(), bias.data_ptr(),
            y.data_ptr(), x.numel() // c if c else 0, r, c,
            _DTYPE_CODE[x.dtype])
    return y


# ---------------------------------------------------------------------------
# K5b: the backward of the last-axis softmax (K2, K5a)
# ---------------------------------------------------------------------------
def softmax_bwd_ref(p, do):
    """Plain version of K5b: ``dx = p * (do - sum(p * do))`` over the last
    axis, in fp32, output in p's dtype."""
    pf, gf = p.float(), do.float()
    return (pf * (gf - (pf * gf).sum(dim=-1, keepdim=True))).to(p.dtype)


def softmax_bwd(p, do):
    """K5b: the input gradient of a last-axis softmax from its output
    ``p`` and the output's gradient ``do`` (float32 or bfloat16, one
    shape and dtype, any shape; rows = the product of the leading dims).
    The row dot runs in fp32; dx comes back in p's dtype.  Rows of up to
    1024 columns are read once into registers (one warp a row); wider
    rows take a strided two-pass loop."""
    if p.dim() < 1 or do.shape != p.shape or do.dtype != p.dtype \
            or do.device != p.device:
        raise MXNetError("softmax_bwd: p and do must share shape, dtype and "
                         "device, got %s %s and %s %s"
                         % (tuple(p.shape), p.dtype, tuple(do.shape),
                            do.dtype))
    if p.device.type != "cuda":
        return softmax_bwd_ref(p, do)
    _check_cuda("softmax_bwd (p)", p)
    _check_cuda("softmax_bwd (do)", do)
    dx = torch.empty_like(p)
    cols = p.shape[-1]
    fn = _bind("softmax", "mxtt_softmax_bwd",
               [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
               + [ctypes.c_int, ctypes.c_void_p])
    _launch("softmax_bwd", fn, p.device, p.data_ptr(), do.data_ptr(),
            dx.data_ptr(), p.numel() // cols if cols else 0, cols,
            _DTYPE_CODE[p.dtype])
    return dx
