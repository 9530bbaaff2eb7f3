"""Element-wise operators (counterpart of ``mxnet_tpu/ops/elemwise.py``;
reference: src/operator/mshadow_op.h and the elemwise registration files
under src/operator/tensor/).

Each op is one torch expression on the caller's device, the JAX
package's expression for expression, under the reference's op names
(the ``_plus_scalar``-style scalar forms and the ``broadcast_*`` names
included, so saved symbols load).  Binary ops broadcast as numpy does.
Parity points:

- a scalar takes x's dtype first (an integer array truncates it, a
  half-precision one rounds it), as ``jnp.asarray(scalar, x.dtype)``;
- comparisons and logic ops return x's dtype as 0/1, never ``bool``;
- ``_mod`` is ``jnp.mod``, the sign of the divisor: ``torch.remainder``,
  not ``torch.fmod``;
- ``round`` is half-to-even (``jnp.round``), as is ``rint``;
- ``gamma`` is ``exp(lgamma(x))``, without a sign for negative x;
- ``relu`` and the maximum/minimum ops split the gradient evenly at a
  tie, as ``jnp.maximum`` does (``torch.maximum``, not ``torch.relu``).
"""
from __future__ import annotations

import math

import torch

from ..base import dtype_torch
from .registry import Param as P, register

_HALF = (torch.float16, torch.bfloat16)
# the 64-bit types a cast narrows, as the JAX package runs with 32-bit
# types (its ``astype(float64)`` gives float32)
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _scalar(x, s):
    """``s`` in x's kind: a Python int for an integer array (truncated),
    a Python float for fp32/fp64, a 0-dim tensor of x's dtype for a
    half-precision x (so the scalar rounds as the JAX package rounds
    it)."""
    if not x.is_floating_point():
        return int(s)
    if x.dtype in _HALF:
        return torch.full((), float(s), dtype=x.dtype, device=x.device)
    return float(s)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


# -- unary ------------------------------------------------------------------
def _unary(name, f, aliases=()):
    @register(name, aliases=aliases)
    def _op(x, **attrs):
        return f(x)
    _op.__name__ = name
    return _op


_unary("abs", torch.abs, aliases=("_abs",))
_unary("sign", torch.sign)
_unary("rint", torch.round)
_unary("round", torch.round)
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("trunc", torch.trunc)
_unary("fix", torch.trunc)
_unary("square", torch.square)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("cbrt", _cbrt)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("log10", torch.log10)
_unary("log2", torch.log2)
_unary("log1p", torch.log1p)
_unary("expm1", torch.expm1)
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tan", torch.tan)
_unary("arcsin", torch.asin)
_unary("arccos", torch.acos)
_unary("arctan", torch.atan)
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("tanh", torch.tanh)
_unary("arcsinh", torch.asinh)
_unary("arccosh", torch.acosh)
_unary("arctanh", torch.atanh)
_unary("degrees", lambda x: x * (180.0 / math.pi))
_unary("radians", lambda x: x * (math.pi / 180.0))
_unary("sigmoid", torch.sigmoid)
_unary("softsign", lambda x: x / (1 + torch.abs(x)))
_unary("reciprocal", lambda x: 1.0 / x)
_unary("negative", torch.neg)
_unary("logical_not", lambda x: (x == 0).to(x.dtype))
_unary("gamma", lambda x: torch.exp(torch.lgamma(x)))
_unary("gammaln", torch.lgamma)
_unary("erf", torch.erf)
_unary("erfinv", torch.erfinv)
_unary("relu", lambda x: torch.maximum(x, _zero(x)))
_unary("softrelu", lambda x: torch.logaddexp(x, _zero(x)))
class _ZeroGrad(torch.autograd.Function):
    """The identity whose gradient is zero: the output stays in the
    recorded graph (a backward from it runs and gives zeros), as
    ``lax.stop_gradient`` under the JAX package's tape."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def _stop_gradient(x):
    if torch.is_grad_enabled() and x.requires_grad:
        return _ZeroGrad.apply(x)
    return x


_unary("_copy", torch.clone, aliases=("identity",))
_unary("make_loss_grad_blocked", _stop_gradient)


@register("BlockGrad", aliases=("stop_gradient",))
def _block_grad(x, **attrs):
    """Reference: src/operator/tensor/elemwise_unary_op_basic.cc
    BlockGrad: the identity with a zero gradient."""
    return _stop_gradient(x)


@register("Cast", aliases=("cast",), params=[
    P("dtype", ("float32", "float64", "float16", "bfloat16", "uint8",
                "int8", "int32", "int64", "bool"), required=True)])
def _cast(x, dtype="float32", **attrs):
    """x in ``dtype``; float64 and int64 narrow to float32 and int32, as
    in the JAX package."""
    dt = torch.bool if dtype == "bool" else dtype_torch(dtype)
    return x.to(_NARROW.get(dt, dt))


@register("clip", params=[
    P("a_min", float, default=None),
    P("a_max", float, default=None)])
def _clip(x, a_min=None, a_max=None, **attrs):
    if a_min is None and a_max is None:
        return x
    return torch.clamp(x, a_min, a_max)


# -- binary (elemwise and broadcast forms share one function) ---------------
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
_binary("_mod", torch.remainder, aliases=("broadcast_mod",))
_binary("_power", torch.pow, aliases=("_Power", "broadcast_power", "pow"))
_binary("_maximum", torch.maximum, aliases=("broadcast_maximum",))
_binary("_minimum", torch.minimum, aliases=("broadcast_minimum",))
_binary("_hypot", torch.hypot, aliases=("broadcast_hypot",))
# the gradient-accumulation add (reference: elemwise_binary_op_basic.cc
# _grad_add), a name of its own so saved JSON holding it loads
_binary("_grad_add", torch.add)
# the _scatter_* forms apply to the stored rows of a row_sparse input in
# the reference; on dense arrays they are the plain ops
_binary("_scatter_elemwise_div", torch.div)


def _cmp(name, f, aliases=()):
    @register(name, aliases=aliases)
    def _op(lhs, rhs, **attrs):
        return f(lhs, rhs).to(lhs.dtype)
    _op.__name__ = name
    return _op


_cmp("_equal", torch.eq, aliases=("broadcast_equal",))
_cmp("_not_equal", torch.ne, aliases=("broadcast_not_equal",))
_cmp("_greater", torch.gt, aliases=("broadcast_greater",))
_cmp("_greater_equal", torch.ge, aliases=("broadcast_greater_equal",))
_cmp("_lesser", torch.lt, aliases=("broadcast_lesser",))
_cmp("_lesser_equal", torch.le, aliases=("broadcast_lesser_equal",))
_cmp("_logical_and", torch.logical_and, aliases=("broadcast_logical_and",))
_cmp("_logical_or", torch.logical_or, aliases=("broadcast_logical_or",))
_cmp("_logical_xor", torch.logical_xor, aliases=("broadcast_logical_xor",))


# -- scalar forms (reference: elemwise_binary_scalar_op_*.cc) ---------------
def _scalar_op(name, f, aliases=()):
    """``f(x, scalar)`` with the scalar in x's dtype, so the result keeps
    x's dtype."""
    @register(name, aliases=aliases)
    def _op(x, scalar=0.0, **attrs):
        return f(x, _scalar(x, scalar))
    _op.__name__ = name
    return _op


def _as_tensor(x, s):
    return s if isinstance(s, torch.Tensor) else torch.full(
        (), s, dtype=x.dtype, device=x.device)


_scalar_op("_plus_scalar", torch.add, aliases=("_PlusScalar",))
_scalar_op("_minus_scalar", torch.sub, aliases=("_MinusScalar",))
_scalar_op("_rminus_scalar", lambda x, s: s - x, aliases=("_RMinusScalar",))
_scalar_op("_mul_scalar", torch.mul, aliases=("_MulScalar",))
_scalar_op("_div_scalar", torch.div, aliases=("_DivScalar",))
_scalar_op("_rdiv_scalar", lambda x, s: s / x, aliases=("_RDivScalar",))
_scalar_op("_mod_scalar", torch.remainder)
_scalar_op("_rmod_scalar", lambda x, s: torch.remainder(_as_tensor(x, s), x))
_scalar_op("_power_scalar", torch.pow, aliases=("_PowerScalar",))
_scalar_op("_rpower_scalar", lambda x, s: torch.pow(s, x),
           aliases=("_RPowerScalar",))
_scalar_op("_maximum_scalar", lambda x, s: torch.maximum(x, _as_tensor(x, s)),
           aliases=("_MaximumScalar",))
_scalar_op("_minimum_scalar", lambda x, s: torch.minimum(x, _as_tensor(x, s)),
           aliases=("_MinimumScalar",))
_scalar_op("_equal_scalar", lambda x, s: (x == s).to(x.dtype))
_scalar_op("_not_equal_scalar", lambda x, s: (x != s).to(x.dtype))
_scalar_op("_greater_scalar", lambda x, s: (x > s).to(x.dtype))
_scalar_op("_greater_equal_scalar", lambda x, s: (x >= s).to(x.dtype))
_scalar_op("_lesser_scalar", lambda x, s: (x < s).to(x.dtype))
_scalar_op("_lesser_equal_scalar", lambda x, s: (x <= s).to(x.dtype))
_scalar_op("_logical_and_scalar", lambda x, s: torch.logical_and(
    x, _as_tensor(x, s)).to(x.dtype))
_scalar_op("_logical_or_scalar", lambda x, s: torch.logical_or(
    x, _as_tensor(x, s)).to(x.dtype))
_scalar_op("_logical_xor_scalar", lambda x, s: torch.logical_xor(
    x, _as_tensor(x, s)).to(x.dtype))
_scalar_op("_hypot_scalar", lambda x, s: torch.hypot(x, _as_tensor(x, s)),
           aliases=("_HypotScalar",))
_scalar_op("_scatter_plus_scalar", torch.add)
_scalar_op("_scatter_minus_scalar", torch.sub)


@register("hard_sigmoid")
def _hard_sigmoid(x, alpha=0.2, beta=0.5, **attrs):
    """Reference: elemwise_unary_op_basic.cc hard_sigmoid."""
    return torch.clamp(float(alpha) * x + float(beta), 0.0, 1.0)


@register("smooth_l1")
def _smooth_l1(x, scalar=1.0, **attrs):
    """Reference: elemwise_binary_scalar_op_extended.cc smooth_l1."""
    s2 = scalar * scalar
    absx = torch.abs(x)
    return torch.where(absx < 1.0 / s2, 0.5 * s2 * x * x, absx - 0.5 / s2)


@register("add_n", aliases=("ElementWiseSum", "_sum", "elemwise_sum"))
def _add_n(*args, num_args=None, **attrs):
    """Reference: src/ndarray/ndarray_function ElementwiseSum, summed
    left to right."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out
