"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (reference:
python/mxnet/initializer.py): ``Initializer`` with MXNet's name rules
(``*weight`` by the initializer, ``*bias``/``*beta``/moving means 0,
``*gamma``/moving vars 1, an ``__init__`` attr overriding), ``Zero``,
``One``, ``Uniform``, ``Normal`` and ``Xavier``.  The
random ones fill the array in place on its own device, drawing from
that device's generator (``random.generator``), so a model on the GPU
is initialised there without a host round trip.
"""
from __future__ import annotations

import json

import numpy as np

from . import random as _random

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Uniform",
           "Normal", "Xavier", "register", "create"]

_INITIALIZER_REGISTRY = {}


def register(klass):
    _INITIALIZER_REGISTRY[klass.__name__.lower()] = klass
    return klass


def _uniform(arr, low, high):
    t = arr._data
    t.uniform_(float(low), float(high), generator=_random.generator(t.device))


def _normal(arr, loc, scale):
    t = arr._data
    t.normal_(float(loc), float(scale), generator=_random.generator(t.device))


class InitDesc(str):
    """Name + attrs descriptor for a parameter (reference:
    initializer.py:39)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer (reference: initializer.py:52)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be a string or InitDesc")
        if isinstance(desc, InitDesc) and desc.global_init is None:
            desc.global_init = self
        init = desc.attrs.get("__init__", "") \
            if isinstance(desc, InitDesc) else ""
        if init:
            create(init)._init_weight(desc, arr)
        elif desc.endswith("weight"):
            self._init_weight(desc, arr)
        elif desc.endswith("bias"):
            self._init_bias(desc, arr)
        elif desc.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif desc.endswith("beta"):
            self._init_beta(desc, arr)
        elif desc.endswith("min"):
            self._init_zero(desc, arr)
        elif desc.endswith("max"):
            self._init_one(desc, arr)
        elif desc.endswith(("moving_mean", "running_mean", "moving_avg",
                            "moving_inv_var")):
            self._init_zero(desc, arr)
        elif desc.endswith(("moving_var", "running_var")):
            self._init_one(desc, arr)
        else:
            self._init_default(desc, arr)

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    _init_bias = _init_zero
    _init_beta = _init_zero
    _init_gamma = _init_one

    def _init_weight(self, name, arr):  # pragma: no cover - abstract
        raise NotImplementedError("Must override it")

    def _init_default(self, name, _):
        raise ValueError(
            "Unknown initialization pattern for %s. Default initialization "
            "is now limited to \"weight\", \"bias\", \"gamma\" (1.0), and "
            "\"beta\" (0.0). Please use mx.sym.Variable(init=mx.init.*) to "
            "set initialization pattern" % name)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0

    _init_default = _init_weight


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0

    _init_default = _init_weight


@register
class Uniform(Initializer):
    """U(-scale, scale) (reference: initializer.py Uniform)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        _uniform(arr, -self.scale, self.scale)


@register
class Normal(Initializer):
    """N(0, sigma) (reference: initializer.py Normal)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        _normal(arr, 0.0, self.sigma)


@register
class Xavier(Initializer):
    """Xavier/Glorot init (reference: initializer.py Xavier): scale
    ``sqrt(magnitude / fan)`` with fan the average, the input or the
    output fan of the weight (trailing dims count as receptive field)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = 1.0
        if len(shape) < 2:
            raise ValueError(
                "Xavier initializer cannot be applied to vector %s. It "
                "requires at least 2D." % name)
        if len(shape) > 2:
            hw_scale = np.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        fans = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                "out": fan_out}
        if self.factor_type not in fans:
            raise ValueError("Incorrect factor type")
        scale = np.sqrt(self.magnitude / fans[self.factor_type])
        if self.rnd_type == "uniform":
            _uniform(arr, -scale, scale)
        elif self.rnd_type == "gaussian":
            _normal(arr, 0.0, scale)
        else:
            raise ValueError("Unknown random type")


def create(init, **kwargs):
    """An initializer from a name or from its ``dumps()`` JSON."""
    if isinstance(init, Initializer):
        return init
    if init.startswith("["):
        klass_name, kw = json.loads(init)
        return _INITIALIZER_REGISTRY[klass_name.lower()](**kw)
    return _INITIALIZER_REGISTRY[init.lower()](**kwargs)
