"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer.py`` (reference:
python/mxnet/optimizer.py): the ``Optimizer`` base with its registry,
lr/wd multipliers (biases and betas get no weight decay), ``idx2name``
and per-index update counts; the sixteen optimizers of the JAX package,
registered under its names (``SGD``, ``ccSGD``, ``Signum``, ``FTML``,
``LBSGD``, ``DCASGD``, ``NAG``, ``SGLD``, ``Test``, ``Adam``,
``AdaGrad``, ``RMSProp``, ``AdaDelta``, ``Ftrl``, ``Adamax``,
``Nadam``); ``Updater``, the per-array wrapper a kvstore or ``Module``
applies, whose ``get_states``/``set_states`` pickle its states as the JAX
package's do (the ``.states`` files of ``Module`` and ``gluon.Trainer``;
with ``multi_precision`` an fp16 weight's state is ``(state, fp32
master)``, the JAX package's layout); and the helpers of the executor's
fused step, ``fused_update_kernel``, ``fused_lr_wd`` and the slot <->
state conversions, which take SGD and Adam only (the others update one
array at a time, as in the JAX package).  Where the JAX class calls a
registered update op, the update goes through ``ops/optimizer_ops.py``;
where it writes the arithmetic out, the same expressions run here on
tensors in the same order.  Either way the weight's and the states'
tensors are replaced (``_data``), nothing is written in place.
"""
from __future__ import annotations

import math
import pickle

import torch

from .base import MXNetError
from .context import resolve
from .ndarray import NDArray
from .ops import optimizer_ops as oo

__all__ = ["Optimizer", "SGD", "Signum", "FTML", "LBSGD", "DCASGD", "NAG",
           "SGLD", "Adam", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl",
           "Adamax", "Nadam", "Test", "ccSGD", "Updater", "get_updater",
           "create", "register", "fused_update_kernel", "fused_lr_wd",
           "state_slots", "slots_state"]


class Optimizer:
    """Base optimizer (reference: optimizer.py:35)."""

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.wd = wd
        self.multi_precision = multi_precision
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise MXNetError("param_idx2name should be a dict of param "
                             "indexes to names.")
        self.idx2name = param_idx2name.copy()
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ()
        self.param_dict = param_dict if param_dict else {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision``, an fp16 weight keeps an fp32 master
        copy: the state is ``(state of the master, master)`` (reference:
        optimizer.py:434); any other weight gets ``create_state``."""
        if self.multi_precision and weight._data.dtype == torch.float16:
            master = weight.astype("float32")
            return (self.create_state(index, master), master)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):  # pragma: no cover
        raise NotImplementedError()

    def update_multi_precision(self, index, weight, grad, state):
        """Update an fp16 weight through its fp32 master (the gradient
        cast to fp32, the weight the master rounded back), any other
        weight with ``update``."""
        if self.multi_precision and weight._data.dtype == torch.float16:
            inner, master = state
            self.update(index, master, grad.astype("float32"), inner)
            weight._data = master._data.to(weight._data.dtype)
        else:
            self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already "
                              "been defined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            # biases/norms get no weight decay by convention
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _param_mult(self, index, table, attr):
        """Per-parameter multiplier, one rule for lr and wd: a gluon
        Parameter wins, then the index table, then the name table (via
        idx2name); default 1."""
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        base = self.lr if self.lr_scheduler is None \
            else self.lr_scheduler(self.num_update)
        return base * self._param_mult(index, self.lr_mult, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._param_mult(index, self.wd_mult, "wd_mult")

    def __getstate__(self):
        ret = self.__dict__.copy()
        del ret["sym_info"]
        return ret

    def __setstate__(self, state):
        self.__dict__ = state
        self.sym_info = ()


register = Optimizer.register


def _zeros_like(weight):
    return NDArray(torch.zeros_like(weight._data))


def _zeros_f32(weight):
    """fp32 zeros of the weight's shape on its device (the JAX package's
    ``zeros(shape, ctx)`` without a dtype)."""
    return NDArray(torch.zeros(weight._data.shape, dtype=torch.float32,
                               device=weight._data.device))


def _clip_kw(optimizer, kw):
    if optimizer.clip_gradient is not None:
        kw["clip_gradient"] = optimizer.clip_gradient
    return kw


def _rescaled(optimizer, grad):
    """``grad * rescale_grad``, clipped to ``clip_gradient`` if set."""
    g = grad._data * optimizer.rescale_grad
    if optimizer.clip_gradient is not None:
        g = torch.clamp(g, -optimizer.clip_gradient, optimizer.clip_gradient)
    return g


@register
class SGD(Optimizer):
    """SGD with momentum (reference: optimizer.py:434; kernels
    optimizer_op-inl.h sgd_update / sgd_mom_update)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad)
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        if state is not None:
            weight._data, state._data = oo.sgd_mom_update(
                weight._data, grad._data, state._data,
                momentum=self.momentum, **kw)
        else:
            weight._data = oo.sgd_update(weight._data, grad._data, **kw)


@register
class Adam(Optimizer):
    """Adam (reference: optimizer.py Adam; adam_update kernel)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon)
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        mean, var = state
        weight._data, mean._data, var._data = oo.adam_update(
            weight._data, grad._data, mean._data, var._data, **kw)


@register
class ccSGD(SGD):
    """Deprecated alias of SGD (reference: optimizer.py ccSGD); not the
    fused step's SGD, which goes by type name."""


@register
class Signum(Optimizer):
    """Sign-based SGD (reference: optimizer.py Signum; signum_update and
    signsgd_update)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = _clip_kw(self, dict(lr=self._get_lr(index),
                                 wd=self._get_wd(index),
                                 rescale_grad=self.rescale_grad))
        if state is not None:
            weight._data, state._data = oo._signum_update(
                weight._data, grad._data, state._data,
                momentum=self.momentum, wd_lh=self.wd_lh, **kw)
        else:
            weight._data = oo._signsgd_update(weight._data, grad._data, **kw)


@register
class FTML(Optimizer):
    """FTML (reference: optimizer.py FTML), written out as the JAX class
    does: the weight decay is added before the clip."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),   # d, v
                _zeros_like(weight))                        # z

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        d, v, z = state
        w = weight._data
        g = grad._data * self.rescale_grad + wd * w
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        v._data = self.beta2 * v._data + (1.0 - self.beta2) * g * g
        d_t = (1.0 - pow(self.beta1, t)) / lr * (
            torch.sqrt(v._data / (1.0 - pow(self.beta2, t))) + self.epsilon)
        sigma_t = d_t - self.beta1 * d._data
        z._data = self.beta1 * z._data + (1.0 - self.beta1) * g \
            - sigma_t * w
        d._data = d_t
        weight._data = -1.0 * z._data / d_t


@register
class LBSGD(Optimizer):
    """Large-batch SGD with a warmup of the rate over the first epochs,
    or LARS's layer-wise trust ratio (reference: optimizer.py LBSGD)."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.lbmult = 1.0
        self.cumgrads = {}
        self.adaptive = False
        self.admult = 1

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    # the fraction of the warmup done -> the fraction of the extra
    # (batch_scale - 1) rate applied
    _WARMUP_RAMPS = {
        "linear": lambda f: f,
        "power2": lambda f: f * f,
        "sqrt": math.sqrt,
    }

    def _get_lbmult(self, nup):
        """The rate multiplier after ``nup`` updates: from 1 to
        ``batch_scale`` over the warmup epochs along the chosen ramp."""
        warmup_updates = self.warmup_epochs * self.updates_per_epoch
        if nup >= warmup_updates:
            return float(self.batch_scale)
        if warmup_updates <= 1:
            return 1.0
        ramp = self._WARMUP_RAMPS.get(self.warmup_strategy)
        if ramp is None:
            return 1.0
        done = float(nup) / warmup_updates
        return 1.0 + (float(self.batch_scale) - 1.0) * ramp(done)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if self.warmup_strategy == "lars":
            # the trust ratio scales a host-side rate, so the two norms
            # are read here, as in the JAX package
            w_norm = float(torch.linalg.vector_norm(weight._data))
            g_norm = float(torch.linalg.vector_norm(grad._data))
            if w_norm > 0 and g_norm > 0:
                lbmult = w_norm / (g_norm + wd * w_norm + 1e-9)
            else:
                lbmult = 1.0
            lr = lr * lbmult
        else:
            lr = lr * self._get_lbmult(self.num_update + self.init_updates)
        kw = _clip_kw(self, dict(lr=lr, wd=wd,
                                 rescale_grad=self.rescale_grad))
        if state is not None:
            weight._data, state._data = oo.sgd_mom_update(
                weight._data, grad._data, state._data,
                momentum=self.momentum, **kw)
        else:
            weight._data = oo.sgd_update(weight._data, grad._data, **kw)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference: optimizer.py
    DCASGD); the state is ``(momentum or None, previous weight)``."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else _zeros_like(weight)
        return (mom, NDArray(weight._data.clone()))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = _rescaled(self, grad)
        mom, previous_weight = state
        w = weight._data
        d = g + wd * w + self.lamda * g * g * (w - previous_weight._data)
        if mom is not None:
            mom._data = self.momentum * mom._data - lr * d
            step = mom._data
        else:
            step = -lr * d
        previous_weight._data = w
        weight._data = w + step


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference: optimizer.py NAG)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        g = _rescaled(self, grad) + wd * w
        if state is not None:
            state._data = self.momentum * state._data + g
            weight._data = w - lr * (g + self.momentum * state._data)
        else:
            weight._data = w - lr * g


def _sgld_noise(weight, lr):
    """SGLD's noise: N(0, sqrt(lr)) of the weight's shape and dtype from
    the generator of its device (``random.generator``)."""
    from .random import generator
    w = weight._data
    return torch.normal(0.0, math.sqrt(lr), size=tuple(w.shape),
                        dtype=w.dtype, device=w.device,
                        generator=generator(w.device))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference: optimizer.py
    SGLD): half a gradient step plus N(0, sqrt(lr)) noise.  The noise
    comes from the port's generators, so its values differ from the JAX
    package's; the step without it is the same."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = _rescaled(self, grad)
        noise = _sgld_noise(weight, lr)
        w = weight._data
        weight._data = w - lr / 2 * (g + wd * w) + noise


@register
class Test(Optimizer):
    """Reference: optimizer.py Test (for testing only)."""

    def create_state(self, index, weight):
        return _zeros_f32(weight)

    def update(self, index, weight, grad, state):
        weight._data = weight._data + grad._data * self.rescale_grad
        state._data = weight._data.clone()


@register
class AdaGrad(Optimizer):
    """AdaGrad (reference: optimizer.py AdaGrad)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_f32(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = _rescaled(self, grad)
        state._data = state._data + g * g
        div = g / torch.sqrt(state._data + self.float_stable_eps)
        w = weight._data
        weight._data = w - lr * (div + wd * w)


@register
class RMSProp(Optimizer):
    """RMSProp, plain (Tieleman) or centred (Graves) (reference:
    optimizer.py RMSProp; rmsprop_update and rmspropalex_update)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_f32(weight), _zeros_f32(weight),   # n, g
                    _zeros_f32(weight))                       # delta
        return (_zeros_f32(weight),)                          # n

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = _clip_kw(self, dict(lr=self._get_lr(index),
                                 wd=self._get_wd(index),
                                 rescale_grad=self.rescale_grad,
                                 gamma1=self.gamma1, epsilon=self.epsilon))
        if self.clip_weights is not None:
            kw["clip_weights"] = self.clip_weights
        if not self.centered:
            (n,) = state
            weight._data, n._data = oo._rmsprop_update(
                weight._data, grad._data, n._data, **kw)
        else:
            n, g, delta = state
            weight._data, n._data, g._data, delta._data = \
                oo._rmspropalex_update(weight._data, grad._data, n._data,
                                       g._data, delta._data,
                                       gamma2=self.gamma2, **kw)


@register
class AdaDelta(Optimizer):
    """AdaDelta (reference: optimizer.py AdaDelta); takes no rate."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_f32(weight),    # accumulated g
                _zeros_f32(weight))    # accumulated delta

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        g = _rescaled(self, grad)
        acc_g, acc_delta = state
        acc_g._data = self.rho * acc_g._data + (1.0 - self.rho) * g * g
        current_delta = (torch.sqrt(acc_delta._data + self.epsilon)
                         / torch.sqrt(acc_g._data + self.epsilon)) * g
        acc_delta._data = self.rho * acc_delta._data \
            + (1.0 - self.rho) * current_delta * current_delta
        w = weight._data
        weight._data = w - current_delta - wd * w


@register
class Ftrl(Optimizer):
    """FTRL-proximal (reference: optimizer.py Ftrl; ftrl_update).  As in
    the JAX class, ``learning_rate`` is set after the base class, so a
    scheduler keeps the base class's default rate."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self.lamda1 = lamda1
        self.beta = beta
        self.lr = learning_rate

    def create_state(self, index, weight):
        return (_zeros_f32(weight),    # z
                _zeros_f32(weight))    # n

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = _clip_kw(self, dict(lr=self._get_lr(index),
                                 wd=self._get_wd(index),
                                 rescale_grad=self.rescale_grad,
                                 lamda1=self.lamda1, beta=self.beta))
        z, n = state
        weight._data, z._data, n._data = oo._ftrl_update(
            weight._data, grad._data, z._data, n._data, **kw)


@register
class Adamax(Optimizer):
    """AdaMax, Adam under the infinity norm (reference: optimizer.py
    Adamax)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr /= (1.0 - self.beta1 ** t)
        w = weight._data
        g = grad._data * self.rescale_grad + wd * w
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        m_t, u_t = state
        m_t._data = self.beta1 * m_t._data + (1.0 - self.beta1) * g
        u_t._data = torch.maximum(self.beta2 * u_t._data, torch.abs(g))
        weight._data = w - lr * m_t._data / u_t._data


@register
class Nadam(Optimizer):
    """Nesterov Adam (reference: optimizer.py Nadam); the momentum
    schedule's product is one per optimizer, as in the JAX class."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        w = weight._data
        g = grad._data * self.rescale_grad + wd * w
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m_t, v_t = state
        m_t._data = self.beta1 * m_t._data + (1.0 - self.beta1) * g
        v_t._data = self.beta2 * v_t._data + (1.0 - self.beta2) * g * g
        grad_prime = g / (1.0 - self.m_schedule)
        m_t_prime = m_t._data / (1.0 - m_schedule_next)
        v_t_prime = v_t._data / (1.0 - self.beta2 ** t)
        m_t_bar = (1.0 - momentum_t) * grad_prime \
            + momentum_t_1 * m_t_prime
        weight._data = w - lr * m_t_bar / (torch.sqrt(v_t_prime)
                                           + self.epsilon)


class Updater:
    """Wraps an optimizer for kvstore use and owns its states
    (reference: optimizer.py:1453).  States loaded by ``set_states`` come
    back on the CPU and move to their weight's device at its next
    update."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            self.states[index] = self.sync_state_context(
                self.states[index], weight.context)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def sync_state_context(self, state, context):
        """``state`` with every NDArray in it on ``context``'s device
        (reference: optimizer.py sync_state_context)."""
        return _state_to(state, resolve(context))

    def set_states(self, states):
        """Take the states (and, if pickled with them, the optimizer) from
        ``get_states``' bytes (reference: optimizer.py set_states)."""
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states
        self.states_synced = dict.fromkeys(self.states, False)

    def get_states(self, dump_optimizer=False):
        """The pickled ``{index: state}``, with the optimizer if asked."""
        return pickle.dumps((self.states, self.optimizer) if dump_optimizer
                            else self.states)


def _state_to(state, device):
    """A state with every NDArray in it on ``device`` (reference:
    optimizer.py sync_state_context)."""
    if isinstance(state, NDArray):
        return NDArray(state._data.to(device))
    if isinstance(state, (tuple, list)):
        return type(state)(_state_to(s, device) for s in state)
    return state


def state_slots(state):
    """An ``Updater`` state (None, an NDArray, or a tuple of them) -> the
    tuple of its tensors: the fused step's slot layout."""
    if state is None:
        return ()
    if isinstance(state, NDArray):
        return (state._data,)
    return tuple(s._data for s in state)


def slots_state(slots):
    """The inverse of :func:`state_slots` for SGD and Adam: no slot is
    None, one is an NDArray (the momentum), two a tuple (Adam's mean and
    variance)."""
    if not slots:
        return None
    if len(slots) == 1:
        return NDArray(slots[0])
    return tuple(NDArray(s) for s in slots)


def get_updater(optimizer):
    return Updater(optimizer)


def create(name, **kwargs):
    """Reference: mx.optimizer.create."""
    return Optimizer.create_optimizer(name, **kwargs)


def fused_update_kernel(optimizer):
    """The per-array update of a stock optimizer on raw tensors, or None.

    Returns ``(init_state, one)``: ``init_state(w)`` gives the tuple of
    slot tensors, ``one(w, g, state, lr, wd) -> (new_w, new_state)``
    runs the exact arithmetic of ``optimizer.update``
    (``ops/optimizer_ops.py``), with ``lr`` and ``wd`` passed in (0-dim
    fp32 tensors from the executor's device table, so a schedule step
    changes a value, not the code).  The scheduler and update counts stay
    in Python, in :func:`fused_lr_wd`."""
    kind = type(optimizer).__name__
    if kind not in ("SGD", "Adam") or optimizer.multi_precision:
        return None
    rescale = float(optimizer.rescale_grad)
    clip = optimizer.clip_gradient if optimizer.clip_gradient is not None \
        else -1.0
    if kind == "SGD":
        momentum = float(optimizer.momentum)

        def init_state(w):
            return () if momentum == 0.0 else (torch.zeros_like(w),)

        def one(w, g, state, lr, wd):
            if not state:
                return oo.sgd_update(w, g, lr=lr, wd=wd, rescale_grad=rescale,
                                     clip_gradient=clip), ()
            nw, nm = oo.sgd_mom_update(w, g, state[0], lr=lr,
                                       momentum=momentum, wd=wd,
                                       rescale_grad=rescale,
                                       clip_gradient=clip)
            return nw, (nm,)
        return init_state, one

    beta1, beta2 = float(optimizer.beta1), float(optimizer.beta2)
    eps = float(optimizer.epsilon)

    def init_state(w):
        return (torch.zeros_like(w), torch.zeros_like(w))

    def one(w, g, state, lr, wd):
        nw, nm, nv = oo.adam_update(w, g, state[0], state[1], lr=lr,
                                    beta1=beta1, beta2=beta2, epsilon=eps,
                                    wd=wd, rescale_grad=rescale,
                                    clip_gradient=clip)
        return nw, (nm, nv)
    return init_state, one


def fused_lr_wd(optimizer, index):
    """Advance ``index``'s update count and return its effective
    ``(lr, wd)`` as Python floats, Adam's bias correction folded into the
    lr."""
    optimizer._update_count(index)
    lr = optimizer._get_lr(index)
    wd = optimizer._get_wd(index)
    if type(optimizer).__name__ == "Adam":
        t = optimizer._index_update_count[index]
        lr *= math.sqrt(1.0 - optimizer.beta2 ** t) / \
            (1.0 - optimizer.beta1 ** t)
    return lr, wd
