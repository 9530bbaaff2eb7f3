"""Gluon basic layers (reference: python/mxnet/gluon/nn/basic_layers.py;
counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``): Sequential,
HybridSequential, Dense, Dropout, BatchNorm, Embedding, Flatten,
InstanceNorm, LayerNorm, Lambda and HybridLambda.

BatchNorm runs the ``BatchNorm`` op with MXNet's momentum; in training
mode the op hands back the updated moving statistics, and
``imperative.invoke`` writes them into the ``running_mean`` and
``running_var`` parameters' arrays, as the JAX package's op does."""
from __future__ import annotations

import warnings

import numpy as np

from ... import initializer
from ... import ndarray
from ..block import Block, HybridBlock
from .activations import Activation

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "Embedding", "Flatten", "InstanceNorm", "LayerNorm", "Lambda",
           "HybridLambda"]


def _init(init):
    """Resolve the string initializer names ``zeros``/``ones``."""
    if init is None or not isinstance(init, str):
        return init
    return initializer.create({"zeros": "zero", "ones": "one"}.get(init, init))


def _getitem(seq, key):
    """A child, or for a slice a new container of the same type and
    prefix holding those children."""
    layers = list(seq._children.values())[key]
    if isinstance(layers, list):
        net = type(seq)(prefix=seq._prefix)
        with net.name_scope():
            net.add(*layers)
        return net
    return layers


class Sequential(Block):
    """Stack of Blocks (reference: basic_layers.py:32)."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __getitem__(self, key):
        return _getitem(self, key)

    def __len__(self):
        return len(self._children)

    def hybridize(self, active=True, **kwargs):
        if self._children and all(isinstance(c, HybridBlock)
                                  for c in self._children.values()):
            warnings.warn(
                "All children of this Sequential layer '%s' are "
                "HybridBlocks. Consider using HybridSequential for the best "
                "performance." % self.prefix, stacklevel=2)
        super().hybridize(active, **kwargs)


class HybridSequential(HybridBlock):
    """Stack of HybridBlocks (reference: basic_layers.py:99)."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def hybrid_forward(self, F, x):
        return self.forward(x)

    def __getitem__(self, key):
        return _getitem(self, key)

    def __len__(self):
        return len(self._children)


class Dense(HybridBlock):
    """Fully-connected layer (reference: basic_layers.py:162): the weight
    is ``(units, in_units)``, ``y = x @ W.T + b``; with ``flatten=False``
    it applies to the last axis."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._flatten = flatten
        with self.name_scope():
            self._units = units
            self._in_units = in_units
            self.weight = self.params.get(
                "weight", shape=(units, in_units),
                init=weight_initializer, dtype=dtype,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), init=_init(bias_initializer),
                    dtype=dtype, allow_deferred_init=True)
            else:
                self.bias = None
            if activation is not None:
                self.act = Activation(activation, prefix=activation + "_")
            else:
                self.act = None

    def _shape_hook(self, inputs):
        x = inputs[0]
        in_units = int(np.prod(x.shape[1:])) if self._flatten \
            else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight, bias=None):
        act = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units, flatten=self._flatten,
                               name="fwd")
        if self.act is not None:
            act = self.act(act)
        return act


class Dropout(HybridBlock):
    """Dropout (reference: basic_layers.py:238); the identity in predict
    mode."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes, name="fwd")


class BatchNorm(HybridBlock):
    """Batch normalization over ``axis`` (reference:
    basic_layers.py:291).  Without ``scale`` gamma stays 1 (the op's
    ``fix_gamma``) and takes no gradient; without ``center`` beta takes
    none; the running statistics never do."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self._axis = axis
        if in_channels != 0:
            self.in_channels = in_channels
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=_init(gamma_initializer),
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=_init(beta_initializer),
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=_init(running_mean_initializer),
                allow_deferred_init=True, differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=_init(running_variance_initializer),
                allow_deferred_init=True, differentiable=False)

    def _shape_hook(self, inputs):
        c = inputs[0].shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)

    def cast(self, dtype):
        """A float16 BatchNorm keeps its parameters in float32."""
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        if name == "float16":
            dtype = "float32"
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           name="fwd", **self._kwargs)

    def __repr__(self):
        return "BatchNorm(%s, in_channels=%s)" % (
            ", ".join("%s=%r" % kv for kv in self._kwargs.items()),
            self.gamma.shape[0])


class Embedding(HybridBlock):
    """Embedding lookup (reference: basic_layers.py:397); ids may arrive
    as float32.  With ``sparse_grad`` the weight's gradient is row-sparse
    (``grad_stype="row_sparse"``), so the Trainer's lazy update moves only
    the rows a batch looked up."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                allow_deferred_init=True,
                grad_stype="row_sparse" if sparse_grad else "default")

    def _shape_hook(self, inputs):
        pass

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, name="fwd", **self._kwargs)


class Flatten(HybridBlock):
    """Flattens every axis but the first (reference:
    basic_layers.py:446)."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return "Flatten"


class InstanceNorm(HybridBlock):
    """Instance normalization over ``axis`` (reference:
    basic_layers.py:467): the op normalises axis 1, so another axis is
    swapped there and back."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"eps": epsilon, "axis": axis, "center": center,
                        "scale": scale}
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=_init(gamma_initializer),
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=_init(beta_initializer),
                allow_deferred_init=True)

    def _shape_hook(self, inputs):
        c = inputs[0].shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, name="fwd",
                                  eps=self._epsilon)
        x = x.swapaxes(1, self._axis)
        return F.InstanceNorm(x, gamma, beta, name="fwd",
                              eps=self._epsilon).swapaxes(1, self._axis)


class LayerNorm(HybridBlock):
    """Layer normalization (reference: basic_layers.py:553)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=_init(gamma_initializer),
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=_init(beta_initializer),
                allow_deferred_init=True)

    def _shape_hook(self, inputs):
        c = inputs[0].shape[self._axis]
        self.gamma.shape = (c,)
        self.beta.shape = (c,)

    def hybrid_forward(self, F, data, gamma, beta):
        return F.LayerNorm(data, gamma=gamma, beta=beta, axis=self._axis,
                           eps=self._epsilon)


def _resolve_function(function):
    """``(callable, name)`` for a function or the name of one in the
    ``nd`` namespace."""
    if isinstance(function, str):
        if not hasattr(ndarray, function):
            raise ValueError("Function name %s is not found in ndarray."
                             % function)
        return getattr(ndarray, function), function
    if callable(function):
        return function, function.__name__
    raise ValueError("Unrecognized function in lambda: %s of type %s"
                     % (function, type(function)))


class Lambda(Block):
    """A function as a Block (reference: basic_layers.py:633): a callable,
    or the name of an ``nd`` function."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_impl, self._func_name = _resolve_function(function)

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return "Lambda(%s)" % self._func_name


class HybridLambda(HybridBlock):
    """A function of ``(F, x, *args)`` as a HybridBlock (reference:
    basic_layers.py:676), or the name of an ``nd`` function."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            _resolve_function(function)
            self._func = lambda F, *args: getattr(F, function)(*args)
            self._func_name = function
        else:
            impl, self._func_name = _resolve_function(function)
            self._func = impl

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return "HybridLambda(%s)" % self._func_name
