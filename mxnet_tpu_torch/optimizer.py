"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer.py`` (reference:
python/mxnet/optimizer.py): the ``Optimizer`` base with its registry,
lr/wd multipliers (biases and betas get no weight decay), ``idx2name``
and per-index update counts; ``SGD`` (with momentum) and ``Adam``;
``Updater``, the per-array wrapper a kvstore or ``Module`` applies, whose
``get_states``/``set_states`` pickle its states as the JAX package's do
(the ``.states`` files of ``Module`` and ``gluon.Trainer``; with
``multi_precision`` an fp16 weight's state is ``(state, fp32 master)``,
the JAX package's layout); and the
helpers of the executor's fused step, ``fused_update_kernel``,
``fused_lr_wd`` and the slot <-> state conversions.  Updates go through
``ops/optimizer_ops.py`` and replace the weight's and the slots' tensors
(``_data``), writing nothing in place.
"""
from __future__ import annotations

import math
import pickle

import torch

from .base import MXNetError
from .ndarray import NDArray
from .ops import optimizer_ops as oo

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
           "register", "fused_update_kernel", "fused_lr_wd", "state_slots",
           "slots_state"]


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
            self.states[index] = _state_to(self.states[index],
                                           weight._data.device)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

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
