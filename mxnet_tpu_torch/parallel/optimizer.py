"""Optimizers of ``ParallelTrainer``: ``init(params) -> state`` and
``apply(params, grads, state, lr) -> (params, state)``.

Counterpart of ``mxnet_tpu/parallel/optimizer.py``.  The JAX package's
transforms are pure; here ``apply`` updates the parameter and slot
tensors IN PLACE (the trainer owns them and nothing else reads them
mid-step) and returns them, so a caller may use either.

With ``flat=True`` the leaves are flat fp32 bucket buffers (under ZeRO,
this rank's contiguous 1/n shard of each bucket) and, where
``MXNET_PALLAS_FUSED_OPT`` is on for their device, each one is updated by
ONE launch of the port's sweep kernel: K1a ``sgd_sweep``, K1b
``sgd_mom_sweep`` or K4 ``adam_sweep`` (``ops/csrc/optimizer_sweep.cu``;
the counterpart of the ``shard_map``-wrapped sweep at
``mxnet_tpu/ops/pallas_kernels.py:606-640``).  Otherwise — the knob at 0,
the per-parameter path, or a CPU tensor under the knob — the update is the
kernels' plain mirrors (``sgd_sweep_ref`` and friends), whose arithmetic
is the JAX package's ``tree_map`` expressions term for term: the oracle
on the card and the path on the CPU.  There is no fallback from a CUDA
tensor to the mirror when a kernel fails to build or launch.

Adam's bias correction is computed as the JAX package does it, in
float32: ``coef = sqrt(1 - b2**t) / (1 - b1**t)`` and ``lr_eff = lr *
coef``, so ``w -= (lr_eff * m) / (sqrt(v) + eps)``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..ops import cuda_kernels as ck

__all__ = ["PureSGD", "PureAdam", "make_optimizer", "sharded_zeros_like"]


def _fused_sweep_on(flat, device=None):
    """Whether flat buckets on ``device`` take the sweep kernels (without
    a device: on this machine's card, if it has one)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return bool(flat) and ck.family_enabled("MXNET_PALLAS_FUSED_OPT",
                                            device)


def sharded_zeros_like(params, shardings):
    """Zero slots for ``params`` (a ``{name: tensor}`` dict), each of its
    entry's shard shape in ``shardings`` (``None`` entries and a ``None``
    dict take the parameter's own shape), on the parameter's device."""
    out = {}
    for k, p in params.items():
        s = None if shardings is None else shardings.get(k)
        shape = tuple(p.shape) if s is None else s.shard_shape(p.shape)
        out[k] = torch.zeros(shape, dtype=p.dtype, device=p.device)
    return out


def _hyper(values, device):
    """The float32 hyperparameter vector of one update on ``device``; on
    the card staged through pinned memory and copied without making the
    host wait."""
    host = torch.from_numpy(np.asarray(values, np.float32))
    if torch.device(device).type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def _clip(clip):
    return None if clip is None else float(clip)


class PureSGD:
    """SGD (+momentum, +wd), updated in place."""

    def __init__(self, learning_rate=0.01, momentum=0.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=None):
        self.lr = learning_rate
        self.momentum = momentum
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient

    def init(self, params, shardings=None):
        """Slot state for ``params``; with ``shardings`` each slot is
        allocated at its shard's shape."""
        if self.momentum == 0.0:
            return {}
        return {"mom": sharded_zeros_like(params, shardings)}

    def slot_spec(self):
        """The slot layout (``plan_spec``'s optimizer entry)."""
        return {"slots": [] if self.momentum == 0.0 else ["mom"],
                "scalar_slots": [],
                "fused_sweep": _fused_sweep_on(True)}

    def apply(self, params, grads, state, lr=None, flat=False, mesh=None):
        """Update every ``params[k]`` (and its slot) from ``grads[k]`` in
        place; ``flat`` marks the leaves as flat fp32 buckets, which the
        sweep kernels may take.  ``mesh`` is accepted for the JAX
        package's signature: a shard is already this rank's."""
        del mesh
        if not params:
            return params, state
        lr = self.lr if lr is None else lr
        clip = _clip(self.clip_gradient)
        mom = self.momentum != 0.0
        device = next(iter(params.values())).device
        sweep = _fused_sweep_on(flat, device)
        if mom:
            h = [lr, self.momentum, self.wd, self.rescale_grad]
        else:
            h = [lr, self.wd, self.rescale_grad]
        hyper = _hyper(h + ([clip] if clip is not None else []), device)
        for k, w in params.items():
            if mom:
                fn = ck.sgd_mom_sweep if sweep else ck.sgd_mom_sweep_ref
                fn(w, grads[k], state["mom"][k], hyper,
                   use_clip=clip is not None)
            else:
                fn = ck.sgd_sweep if sweep else ck.sgd_sweep_ref
                fn(w, grads[k], hyper, use_clip=clip is not None)
        return params, state


class PureAdam:
    """Adam, updated in place."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=None):
        self.lr = learning_rate
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient

    def init(self, params, shardings=None):
        """See :meth:`PureSGD.init`; ``t`` is an int32 scalar on the
        host (it steers the host-side bias correction)."""
        return {"mean": sharded_zeros_like(params, shardings),
                "var": sharded_zeros_like(params, shardings),
                "t": torch.zeros((), dtype=torch.int32)}

    def slot_spec(self):
        """See :meth:`PureSGD.slot_spec`."""
        return {"slots": ["mean", "var"], "scalar_slots": [["t", 4]],
                "fused_sweep": _fused_sweep_on(True)}

    def lr_eff(self, t, lr=None):
        """``lr * sqrt(1 - b2**t) / (1 - b1**t)`` in float32, as the JAX
        package evaluates it."""
        lr = self.lr if lr is None else lr
        tf = torch.tensor(float(t), dtype=torch.float32)
        b1 = torch.tensor(self.beta1, dtype=torch.float32)
        b2 = torch.tensor(self.beta2, dtype=torch.float32)
        coef = torch.sqrt(1 - b2 ** tf) / (1 - b1 ** tf)
        return float(torch.tensor(lr, dtype=torch.float32) * coef)

    def apply(self, params, grads, state, lr=None, flat=False, mesh=None):
        """See :meth:`PureSGD.apply`; ``state["t"]`` advances by one."""
        del mesh
        t = state["t"] + 1
        new_state = dict(state, t=t)
        if not params:
            return params, new_state
        clip = _clip(self.clip_gradient)
        device = next(iter(params.values())).device
        sweep = _fused_sweep_on(flat, device)
        b1, b2 = self.beta1, self.beta2
        h = [self.lr_eff(int(t), lr), b1, b2, 1.0 - b1, 1.0 - b2,
             self.epsilon, self.wd, self.rescale_grad]
        hyper = _hyper(h + ([clip] if clip is not None else []), device)
        fn = ck.adam_sweep if sweep else ck.adam_sweep_ref
        for k, w in params.items():
            fn(w, grads[k], state["mean"][k], state["var"][k], hyper,
               use_clip=clip is not None)
        return params, new_state


def make_optimizer(name, **kwargs):
    name = name.lower()
    if name == "sgd":
        return PureSGD(**kwargs)
    if name == "adam":
        return PureAdam(**kwargs)
    raise MXNetError("unknown pure optimizer %r (sgd/adam supported in the "
                     "compiled step; others via the eager Trainer)" % name)
