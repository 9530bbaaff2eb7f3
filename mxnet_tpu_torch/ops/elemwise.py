"""Element-wise operators (counterpart of ``mxnet_tpu/ops/elemwise.py``;
this package carries the arithmetic that ``Symbol.__add__`` and NDArray's
operators emit: the binary ops, which broadcast as in the JAX package,
their scalar forms, and the unary ops the gluon losses call)."""
from __future__ import annotations

import torch

from .registry import register


def _binary(name, f, aliases=()):
    @register(name, aliases=aliases)
    def _op(lhs, rhs, **attrs):
        return f(lhs, rhs)
    _op.__name__ = name
    return _op


_binary("elemwise_add", torch.add, aliases=(
    "_add", "_plus", "_Plus", "broadcast_add", "broadcast_plus"))
_binary("elemwise_sub", torch.sub, aliases=(
    "_sub", "_minus", "_Minus", "broadcast_sub", "broadcast_minus"))
_binary("elemwise_mul", torch.mul, aliases=("_mul", "_Mul", "broadcast_mul"))
_binary("elemwise_div", torch.div, aliases=("_div", "_Div", "broadcast_div"))
_binary("_power", torch.pow, aliases=("_Power", "broadcast_power", "pow"))


def _scalar_op(name, f, aliases=()):
    """``f(x, scalar)`` with the scalar in x's kind (an integer array
    takes it truncated, as the JAX package casts it to x's dtype), so the
    result keeps x's dtype."""
    @register(name, aliases=aliases)
    def _op(x, scalar=0.0, **attrs):
        s = float(scalar) if x.is_floating_point() else int(scalar)
        return f(x, s)
    _op.__name__ = name
    return _op


_scalar_op("_plus_scalar", torch.add, aliases=("_PlusScalar",))
_scalar_op("_minus_scalar", torch.sub, aliases=("_MinusScalar",))
_scalar_op("_rminus_scalar", lambda x, s: s - x, aliases=("_RMinusScalar",))
_scalar_op("_mul_scalar", torch.mul, aliases=("_MulScalar",))
_scalar_op("_div_scalar", torch.div, aliases=("_DivScalar",))
_scalar_op("_rdiv_scalar", lambda x, s: s / x, aliases=("_RDivScalar",))
_scalar_op("_power_scalar", torch.pow, aliases=("_PowerScalar",))
_scalar_op("_rpower_scalar", lambda x, s: torch.pow(s, x),
           aliases=("_RPowerScalar",))


def _unary(name, f):
    @register(name)
    def _op(x, **attrs):
        return f(x)
    _op.__name__ = name
    return _op


_unary("negative", torch.neg)
_unary("abs", torch.abs)
_unary("square", torch.square)
_unary("exp", torch.exp)
_unary("log", torch.log)
