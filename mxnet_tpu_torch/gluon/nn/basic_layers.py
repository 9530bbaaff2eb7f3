"""Gluon basic layers (reference: python/mxnet/gluon/nn/basic_layers.py;
this package carries Sequential, HybridSequential, Dense, Dropout,
Embedding and LayerNorm)."""
from __future__ import annotations

import numpy as np

from ... import initializer
from ..block import Block, HybridBlock
from .activations import Activation

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "LayerNorm"]


def _init(init):
    """Resolve the string initializer names ``zeros``/``ones``."""
    if init is None or not isinstance(init, str):
        return init
    return initializer.create({"zeros": "zero", "ones": "one"}.get(init, init))


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
        return list(self._children.values())[key]

    def __len__(self):
        return len(self._children)


class HybridSequential(HybridBlock):
    """Stack of HybridBlocks (reference: basic_layers.py:99)."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __getitem__(self, key):
        return list(self._children.values())[key]

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


class Embedding(HybridBlock):
    """Embedding lookup (reference: basic_layers.py:397); ids may arrive
    as float32."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype}
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim),
                init=weight_initializer, dtype=dtype,
                allow_deferred_init=True)

    def _shape_hook(self, inputs):
        pass

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, name="fwd", **self._kwargs)


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
