"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py`` (reference:
python/mxnet/initializer.py): ``Initializer`` with MXNet's name rules
(``*weight`` by the initializer, ``*bias``/``*beta``/moving means 0,
``*gamma``/moving vars 1, an ``__init__`` attr overriding), ``Zero``,
``One``, ``Constant``, ``Uniform``, ``Normal``, ``Orthogonal``,
``Xavier``, ``MSRAPrelu``, ``Bilinear``, ``LSTMBias``, ``FusedRNN``
(the packed parameter blob of ops/nn.py's fused RNN, in the JAX
package's layout), ``Load`` and ``Mixed``.  The random ones fill the
array in place on its own device, drawing from that device's generator
(``random.generator``), so a model on the GPU is initialised there
without a host round trip; their numbers differ from the JAX package's,
their distributions do not.
"""
from __future__ import annotations

import json
import logging
import re

import numpy as np
import torch

from . import random as _random

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "FusedRNN", "Load", "Mixed", "register", "create"]

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
        self._verbose = False
        self._print_func = None

    def set_verbosity(self, verbose=False, print_func=None):
        """Log each initialised array with ``print_func(arr)`` (default:
        its mean absolute value)."""
        self._verbose = verbose
        if print_func is None:
            def asum_stat(x):
                return str((np.abs(x.asnumpy()).mean(),))
            print_func = asum_stat
        self._print_func = print_func
        return self

    def _verbose_print(self, desc, init, arr):
        if self._verbose and self._print_func:
            logging.info("Initialized %s as %s: %s", desc, init,
                         self._print_func(arr))

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
            self._verbose_print(desc, init, arr)
        elif desc.endswith("weight"):
            self._init_weight(desc, arr)
            self._verbose_print(desc, "weight", arr)
        elif desc.endswith("bias"):
            self._init_bias(desc, arr)
            self._verbose_print(desc, "bias", arr)
        elif desc.endswith("gamma"):
            self._init_gamma(desc, arr)
            self._verbose_print(desc, "gamma", arr)
        elif desc.endswith("beta"):
            self._init_beta(desc, arr)
            self._verbose_print(desc, "beta", arr)
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

    def _init_bilinear(self, _, arr):
        """The bilinear upsampling kernel of a 4-D weight (reference:
        initializer.py _init_bilinear), computed in float64."""
        shape = arr.shape
        i = np.arange(int(np.prod(shape)))
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c)))
        arr[:] = weight.astype(np.float32).reshape(shape)

    def _init_loc_bias(self, _, arr):
        if arr.shape[0] != 6:
            raise ValueError("a localisation bias has 6 values, got %s"
                             % (arr.shape,))
        arr[:] = np.array([1.0, 0, 0, 0, 1.0, 0], dtype=np.float32)

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
class Constant(Initializer):
    """Every value ``value`` (reference: initializer.py Constant)."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value

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
class Orthogonal(Initializer):
    """A scaled orthogonal matrix over the weight's first axis and the
    rest flattened (reference: initializer.py Orthogonal): the singular
    vectors of a uniform(-1, 1) or normal draw, drawn in float64 from the
    array's device's generator."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        t = arr._data
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        tmp = torch.empty((nout, nin), dtype=torch.float64, device=t.device)
        gen = _random.generator(t.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=gen)
        else:
            tmp.normal_(0.0, 1.0, generator=gen)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr[:] = (self.scale * q).reshape(arr.shape).to(t.dtype)


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


@register
class MSRAPrelu(Xavier):
    """MSRA (He) initialisation for PReLU nets (reference:
    initializer.py MSRAPrelu): Gaussian Xavier of magnitude
    2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """Bilinear upsampling kernels (reference: initializer.py Bilinear)."""

    def _init_weight(self, _, arr):
        self._init_bilinear(_, arr)


@register
class LSTMBias(Initializer):
    """Zeros with the forget gate's slice (gate order i, f, c, o) at
    ``forget_bias`` (reference: initializer.py LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_bias(self, desc, arr):
        num_hidden = int(arr.shape[0] / 4)
        a = np.zeros(arr.shape, dtype=np.float32)
        a[num_hidden:2 * num_hidden] = self.forget_bias
        arr[:] = a

    _init_weight = _init_bias


@register
class FusedRNN(Initializer):
    """The packed parameter blob of a fused RNN (reference:
    initializer.py FusedRNN), in the JAX package's layout
    (``mxnet_tpu/initializer.py`` FusedRNN, ops/nn.py
    ``_unpack_rnn_params``): for each layer and direction W_i2h then
    W_h2h, every weight first, then each layer-direction's b_i2h and
    b_h2h; gates i, f, g, o.  Each weight matrix is filled by the wrapped
    initializer as the 2-D array it is, on the CPU; biases are zero but
    an LSTM's forget gate, ``forget_bias`` in both biases."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = create(klass, **kwargs)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from .context import cpu
        from .ndarray import zeros as nd_zeros

        gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4,
                 "gru": 3}[self._mode]
        H = self._num_hidden
        L = self._num_layers
        D = 2 if self._bidirectional else 1
        num_bias = L * D * 2 * gates * H
        blob = np.zeros(arr.shape, np.float32)
        # the first layer's input size, solved from the blob's length
        upper_w = (L - 1) * D * (gates * H * H * D + gates * H * H)
        l0_w = blob.size - num_bias - upper_w
        in0 = (l0_w // D - gates * H * H) // (gates * H)
        offset = 0
        for layer in range(L):
            in_sz = in0 if layer == 0 else H * D
            for _ in range(D):
                for rows, cols in ((gates * H, in_sz), (gates * H, H)):
                    n = rows * cols
                    mat = nd_zeros((rows, cols), ctx=cpu())
                    if self._init is not None:
                        self._init._init_weight(desc, mat)
                    blob[offset: offset + n] = mat.asnumpy().reshape(-1)
                    offset += n
        if self._mode == "lstm":
            base = blob.size - num_bias
            for ld in range(L * D):
                off = base + ld * 2 * gates * H
                blob[off + H: off + 2 * H] = self._forget_bias
                blob[off + gates * H + H: off + gates * H + 2 * H] = \
                    self._forget_bias
        arr[:] = blob


class Load:
    """Values from a dict of arrays (``arg:``/``aux:`` prefixes dropped),
    ``default_init`` for the rest (reference: initializer.py Load)."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {
            (k[4:] if k.startswith("arg:") or k.startswith("aux:") else k): v
            for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            if tuple(self.param[name].shape) != tuple(arr.shape):
                raise AssertionError(
                    "Parameter %s cannot be initialized from loading. Shape "
                    "mismatch, target %s vs loaded %s"
                    % (name, str(arr.shape), str(self.param[name].shape)))
            arr[:] = self.param[name]
            if self.verbose:
                logging.info("Initialized %s by loading", name)
        else:
            if self.default_init is None:
                raise AssertionError(
                    "Cannot Initialize parameter %s. Not found in loaded "
                    "param and no default Initializer is provided." % name)
            self.default_init(name, arr)
            if self.verbose:
                logging.info("Initialized %s by default", name)


class Mixed:
    """The first initializer whose regex matches the name (reference:
    initializer.py Mixed)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("%d patterns for %d initializers"
                             % (len(patterns), len(initializers)))
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError(
            "Parameter name %s did not match any pattern. Consider adding a "
            "\".*\" pattern at the and with default Initializer." % name)


def create(init, **kwargs):
    """An initializer from a name or from its ``dumps()`` JSON."""
    if isinstance(init, Initializer):
        return init
    if init.startswith("["):
        klass_name, kw = json.loads(init)
        return _INITIALIZER_REGISTRY[klass_name.lower()](**kw)
    return _INITIALIZER_REGISTRY[init.lower()](**kwargs)
