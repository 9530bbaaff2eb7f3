"""``mx.sym.random`` (counterpart of ``mxnet_tpu/symbol/random.py``): the
scalar-parameter samplers as graph nodes; at bind they draw on the
executor's device."""
from __future__ import annotations


def _call(op, attrs):
    from . import _make_symbol_call
    return _make_symbol_call(op, [], attrs)


def uniform(low=0, high=1, shape=None, dtype="float32", **kwargs):
    return _call("_random_uniform", {"low": low, "high": high,
                                     "shape": shape, "dtype": dtype})


def normal(loc=0, scale=1, shape=None, dtype="float32", **kwargs):
    return _call("_random_normal", {"loc": loc, "scale": scale,
                                    "shape": shape, "dtype": dtype})
