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
  launches the kernel.

Ported so far (the K numbers of the kernel table in PERF.md):

- K3 ``scale_bias_relu`` <- ``_scale_bias_relu_kernel``: the inference
  BatchNorm + ReLU epilogue, read straight from NCHW.
- K2 ``softmax_lastaxis`` <- ``_softmax_fwd_kernel``: the SoftmaxOutput
  forward.
- K1a ``sgd_sweep`` <- ``_sgd_kernel``, K1b ``sgd_mom_sweep`` <-
  ``_sgd_mom_kernel``, K4 ``adam_sweep`` <- ``_adam_kernel``: the
  executor's fused optimizer step, one launch per flat fp32 bucket,
  updating the weights and slots in place (all three in
  ``csrc/optimizer_sweep.cu``).

``family_enabled`` resolves the JAX package's tri-state ``MXNET_PALLAS_*``
knobs: ``auto`` turns a family on for tensors on the GPU, ``1`` forces it
(CPU tensors then take the plain version), ``0`` turns it off.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .. import config as _config
from ..base import MXNetError

__all__ = ["scale_bias_relu", "scale_bias_relu_ref", "softmax_lastaxis",
           "softmax_lastaxis_ref", "sgd_sweep", "sgd_sweep_ref",
           "sgd_mom_sweep", "sgd_mom_sweep_ref", "adam_sweep",
           "adam_sweep_ref", "kernel_calls", "reset_kernel_calls",
           "family_enabled"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_COUNT_LOCK = threading.Lock()
_CALLS = {"scale_bias_relu": 0, "softmax_lastaxis": 0,  # guarded-by: _COUNT_LOCK
          "sgd_sweep": 0, "sgd_mom_sweep": 0, "adam_sweep": 0}


def kernel_calls():
    """Kernel launches so far, by kernel name."""
    with _COUNT_LOCK:
        return dict(_CALLS)


def reset_kernel_calls():
    with _COUNT_LOCK:
        for k in _CALLS:
            _CALLS[k] = 0


def _count(name):
    with _COUNT_LOCK:
        _CALLS[name] += 1


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
    dtype."""
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
