"""Random sampling operators (counterpart of ``mxnet_tpu/ops/random_ops.py``;
reference: src/operator/random/sample_op.h, multisample_op.h,
sample_multinomial_op.h, shuffle_op.cc).

Every op draws with ``__rng__``, the ``torch.Generator`` of the device
it runs on (``random.generator``: seeded by ``mx.random.seed``, one per
device), on that device: a draw for the card is made on the card, never
on the host and copied.  An op without tensor inputs runs on ``ctx``
(default the current context).  The parameterisations are the JAX package's:
``gamma(alpha, beta)`` has beta a scale, ``exponential(lam)`` lam a rate,
``negative_binomial(k, p)`` is Poisson(Gamma(k) (1 - p) / p) and
``generalized_negative_binomial(mu, alpha)`` the same with ``k = 1 / alpha``
and ``p = k / (k + mu)``.  The JAX package draws from
threefry and this package from torch's Philox: the same seed gives other
numbers, from the same distributions.  The ``_sample_*`` ops take one
set of parameters per element of their parameter arrays; their output
is the parameters' shape followed by ``shape``.
"""
from __future__ import annotations

import torch

from ..base import dtype_torch
from .init_ops import device_of
from .registry import Param as P, normalize_tuple, register


def _shape(shape):
    if shape is None or shape == ():
        return ()
    return normalize_tuple(shape)


def _gen(device, rng):
    from .. import random as _random
    return rng if rng is not None else _random.generator(device)


def _draw(kind, shape, dtype, device, rng, **kw):
    """``shape`` draws of ``kind`` ('uniform', 'normal', 'exponential')
    on ``device`` from its generator; an empty tensor on ``meta``."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    g = _gen(device, rng)
    if kind == "uniform":
        return torch.rand(shape, dtype=dtype, device=device, generator=g)
    if kind == "normal":
        return torch.randn(shape, dtype=dtype, device=device, generator=g)
    return torch.empty(shape, dtype=dtype, device=device).exponential_(
        1.0, generator=g)


def _std_gamma(alpha, rng):
    """Gamma(alpha, 1) for a tensor of shapes ``alpha``, on its device."""
    if alpha.device.type == "meta":
        return torch.empty_like(alpha)
    return torch._standard_gamma(alpha, generator=_gen(alpha.device, rng))


def _poisson(lam, rng):
    if lam.device.type == "meta":
        return torch.empty_like(lam)
    return torch.poisson(lam, generator=_gen(lam.device, rng))


@register("_random_uniform", aliases=("uniform", "random_uniform"),
          needs_rng=True, params=[
              P("low", float, default=0.0), P("high", float, default=1.0)])
def _uniform(low=0.0, high=1.0, shape=(), dtype="float32", ctx=None,
             __rng__=None, **attrs):
    u = _draw("uniform", _shape(shape), dtype_torch(dtype), device_of(ctx),
              __rng__)
    return low + u * (high - low)


@register("_random_normal", aliases=("normal", "random_normal"),
          needs_rng=True, params=[
              P("loc", float, default=0.0),
              P("scale", float, default=1.0, low=0.0)])
def _normal(loc=0.0, scale=1.0, shape=(), dtype="float32", ctx=None,
            __rng__=None, **attrs):
    return loc + scale * _draw("normal", _shape(shape), dtype_torch(dtype),
                               device_of(ctx), __rng__)


@register("_random_uniform_like", aliases=("random_uniform_like",),
          needs_rng=True, params=[
              P("low", float, default=0.0), P("high", float, default=1.0)])
def _uniform_like(data, low=0.0, high=1.0, __rng__=None, **attrs):
    u = _draw("uniform", data.shape, data.dtype, data.device, __rng__)
    return low + u * (high - low)


@register("_random_normal_like", aliases=("random_normal_like",),
          needs_rng=True, params=[
              P("loc", float, default=0.0),
              P("scale", float, default=1.0, low=0.0)])
def _normal_like(data, loc=0.0, scale=1.0, __rng__=None, **attrs):
    return loc + scale * _draw("normal", data.shape, data.dtype, data.device,
                               __rng__)


def _full(shape, value, device):
    return torch.full(shape, float(value), dtype=torch.float32, device=device)


@register("_random_gamma", aliases=("random_gamma",), needs_rng=True)
def _gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32", ctx=None,
           __rng__=None, **attrs):
    a = _full(_shape(shape), alpha, device_of(ctx))
    return (beta * _std_gamma(a, __rng__)).to(dtype_torch(dtype))


@register("_random_exponential",
          aliases=("random_exponential", "exponential"), needs_rng=True)
def _exponential(lam=1.0, shape=(), dtype="float32", ctx=None, __rng__=None,
                 **attrs):
    return _draw("exponential", _shape(shape), dtype_torch(dtype),
                 device_of(ctx), __rng__) / lam


@register("_random_poisson", aliases=("random_poisson", "poisson"),
          needs_rng=True)
def _poisson_op(lam=1.0, shape=(), dtype="float32", ctx=None, __rng__=None,
                **attrs):
    rate = _full(_shape(shape), lam, device_of(ctx))
    return _poisson(rate, __rng__).to(dtype_torch(dtype))


def _nb(k, p, rng):
    """Poisson(Gamma(k) (1 - p) / p): the negative binomial."""
    return _poisson(_std_gamma(k, rng) * (1 - p) / p, rng)


@register("_random_negative_binomial",
          aliases=("random_negative_binomial", "negative_binomial"),
          needs_rng=True)
def _neg_binomial(k=1, p=1.0, shape=(), dtype="float32", ctx=None,
                  __rng__=None, **attrs):
    kk = _full(_shape(shape), k, device_of(ctx))
    return _nb(kk, p, __rng__).to(dtype_torch(dtype))


@register("_random_generalized_negative_binomial",
          aliases=("random_generalized_negative_binomial",
                   "generalized_negative_binomial"), needs_rng=True)
def _gen_neg_binomial(mu=1.0, alpha=1.0, shape=(), dtype="float32", ctx=None,
                      __rng__=None, **attrs):
    r = 1.0 / alpha
    kk = _full(_shape(shape), r, device_of(ctx))
    return _nb(kk, r / (r + mu), __rng__).to(dtype_torch(dtype))


@register("_random_randint", aliases=("random_randint",), needs_rng=True)
def _randint(low=0, high=1, shape=(), dtype="int32", ctx=None, __rng__=None,
             **attrs):
    dev, dt = device_of(ctx), dtype_torch(dtype)
    if dev.type == "meta":
        return torch.empty(_shape(shape), dtype=dt, device=dev)
    return torch.randint(int(low), int(high), _shape(shape), dtype=dt,
                         device=dev, generator=_gen(dev, __rng__))


# -- per-element parameters (reference: multisample_op.h) -------------------
def _expand(param, s):
    """``param`` broadcast to ``param.shape + s``."""
    return param.reshape(param.shape + (1,) * len(s)).expand(
        tuple(param.shape) + s)


@register("_sample_uniform", aliases=("sample_uniform",), needs_rng=True)
def _sample_uniform(low, high, shape=(), dtype="float32", __rng__=None,
                    **attrs):
    s = _shape(shape)
    u = _draw("uniform", tuple(low.shape) + s, dtype_torch(dtype),
              low.device, __rng__)
    lo = low.reshape(low.shape + (1,) * len(s))
    hi = high.reshape(high.shape + (1,) * len(s))
    return lo + u * (hi - lo)


@register("_sample_normal", aliases=("sample_normal",), needs_rng=True)
def _sample_normal(mu, sigma, shape=(), dtype="float32", __rng__=None,
                   **attrs):
    s = _shape(shape)
    z = _draw("normal", tuple(mu.shape) + s, dtype_torch(dtype), mu.device,
              __rng__)
    return mu.reshape(mu.shape + (1,) * len(s)) \
        + z * sigma.reshape(sigma.shape + (1,) * len(s))


@register("_sample_gamma", aliases=("sample_gamma",), needs_rng=True)
def _sample_gamma(alpha, beta, shape=(), dtype="float32", __rng__=None,
                  **attrs):
    s = _shape(shape)
    g = _std_gamma(_expand(alpha.float(), s).contiguous(), __rng__).to(
        dtype_torch(dtype))
    return g * beta.reshape(beta.shape + (1,) * len(s))


@register("_sample_exponential", aliases=("sample_exponential",),
          needs_rng=True)
def _sample_exponential(lam, shape=(), dtype="float32", __rng__=None,
                        **attrs):
    s = _shape(shape)
    e = _draw("exponential", tuple(lam.shape) + s, dtype_torch(dtype),
              lam.device, __rng__)
    return e / lam.reshape(lam.shape + (1,) * len(s))


@register("_sample_poisson", aliases=("sample_poisson",), needs_rng=True)
def _sample_poisson(lam, shape=(), dtype="float32", __rng__=None, **attrs):
    s = _shape(shape)
    return _poisson(_expand(lam.float(), s).contiguous(), __rng__).to(
        dtype_torch(dtype))


@register("_sample_negative_binomial",
          aliases=("sample_negative_binomial",), needs_rng=True)
def _sample_negative_binomial(k, p, shape=(), dtype="float32", __rng__=None,
                              **attrs):
    s = _shape(shape)
    return _nb(_expand(k.float(), s).contiguous(), _expand(p.float(), s),
               __rng__).to(dtype_torch(dtype))


@register("_sample_generalized_negative_binomial",
          aliases=("sample_generalized_negative_binomial",), needs_rng=True)
def _sample_gen_negative_binomial(mu, alpha, shape=(), dtype="float32",
                                  __rng__=None, **attrs):
    s = _shape(shape)
    r = 1.0 / _expand(alpha.float(), s)
    p = r / (r + _expand(mu.float(), s))
    return _nb(r.contiguous(), p, __rng__).to(dtype_torch(dtype))


@register("_sample_multinomial", aliases=("sample_multinomial",),
          needs_rng=True,
          num_outputs=lambda attrs: 2 if attrs.get("get_prob") else 1)
def _multinomial(data, shape=(), get_prob=False, dtype="int32", __rng__=None,
                 **attrs):
    """Reference: sample_multinomial_op.h: ``data`` (..., K) holds
    probabilities; ``get_prob`` also returns each draw's log-probability
    (float32) under the normalised distribution."""
    s = _shape(shape)
    n = 1
    for d in s:
        n *= d
    n = max(n, 1)
    k = data.shape[-1]
    flat = torch.clamp(data, min=1e-37).reshape(-1, k).float()
    out_shape = tuple(data.shape[:-1]) + s
    if data.device.type == "meta":
        samples = torch.empty((flat.shape[0], n), dtype=torch.int64,
                              device=data.device)
    else:
        samples = torch.multinomial(flat, n, replacement=True,
                                    generator=_gen(data.device, __rng__))
    out = samples.reshape(out_shape).to(dtype_torch(dtype))
    if get_prob:
        logp = torch.log_softmax(torch.log(flat), dim=-1)
        lp = torch.gather(logp, 1, samples)
        return out, lp.reshape(out_shape).to(torch.float32)
    return out


@register("_shuffle", aliases=("shuffle",), needs_rng=True)
def _shuffle(data, __rng__=None, **attrs):
    """``data`` with its first axis permuted at random."""
    if data.device.type == "meta":
        return torch.empty_like(data)
    perm = torch.randperm(data.shape[0], device=data.device,
                          generator=_gen(data.device, __rng__))
    return data[perm]
