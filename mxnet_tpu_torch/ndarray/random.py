"""``mx.nd.random`` (counterpart of ``mxnet_tpu/ndarray/random.py``).

Scalar parameters call the ``_random_*`` op on ``ctx`` (default
the current context); NDArray parameters call the ``_sample_*`` op, one
distribution per element, on their device (a scalar beside them becomes
a 0-dim array there).  Draws come from that device's generator.
"""
from __future__ import annotations

from ..imperative import invoke

_SCALAR_NAMES = {
    "_random_uniform": ("low", "high"),
    "_random_normal": ("loc", "scale"),
    "_random_gamma": ("alpha", "beta"),
    "_random_exponential": ("lam",),
    "_random_poisson": ("lam",),
    "_random_negative_binomial": ("k", "p"),
    "_random_generalized_negative_binomial": ("mu", "alpha"),
    "_random_randint": ("low", "high"),
}


def _sample(op_scalar, op_tensor, params, shape, dtype, ctx, out, kwargs):
    from .ndarray import NDArray, array as nd_array
    arrays = [p for p in params if isinstance(p, NDArray)]
    if arrays:
        dev = arrays[0].context
        params = [p if isinstance(p, NDArray) else nd_array(float(p),
                                                            ctx=dev)
                  for p in params]
        return invoke(op_tensor, list(params),
                      dict(shape=shape, dtype=dtype, **kwargs), out=out)
    attrs = dict(shape=shape if shape is not None else (), dtype=dtype,
                 ctx=ctx, **kwargs)
    attrs.update(zip(_SCALAR_NAMES[op_scalar], params))
    return invoke(op_scalar, [], attrs, out=out)


def uniform(low=0, high=1, shape=None, dtype="float32", ctx=None, out=None,
            **kwargs):
    return _sample("_random_uniform", "_sample_uniform", (low, high),
                   shape, dtype, ctx, out, kwargs)


def normal(loc=0, scale=1, shape=None, dtype="float32", ctx=None, out=None,
           **kwargs):
    return _sample("_random_normal", "_sample_normal", (loc, scale),
                   shape, dtype, ctx, out, kwargs)


randn = normal


def gamma(alpha=1, beta=1, shape=None, dtype="float32", ctx=None, out=None,
          **kwargs):
    return _sample("_random_gamma", "_sample_gamma", (alpha, beta),
                   shape, dtype, ctx, out, kwargs)


def exponential(scale=1, shape=None, dtype="float32", ctx=None, out=None,
                **kwargs):
    """Exponential draws of mean ``scale`` (the op takes the rate)."""
    return _sample("_random_exponential", "_sample_exponential",
                   (1.0 / scale,), shape, dtype, ctx, out, kwargs)


def poisson(lam=1, shape=None, dtype="float32", ctx=None, out=None,
            **kwargs):
    return _sample("_random_poisson", "_sample_poisson", (lam,),
                   shape, dtype, ctx, out, kwargs)


def negative_binomial(k=1, p=1, shape=None, dtype="float32", ctx=None,
                      out=None, **kwargs):
    return _sample("_random_negative_binomial", "_sample_negative_binomial",
                   (k, p), shape, dtype, ctx, out, kwargs)


def generalized_negative_binomial(mu=1, alpha=1, shape=None,
                                  dtype="float32", ctx=None, out=None,
                                  **kwargs):
    return _sample("_random_generalized_negative_binomial",
                   "_sample_generalized_negative_binomial",
                   (mu, alpha), shape, dtype, ctx, out, kwargs)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None,
            **kwargs):
    return _sample("_random_randint", "_random_randint", (low, high),
                   shape, dtype, ctx, out, kwargs)


def multinomial(data, shape=None, get_prob=False, out=None, dtype="int32",
                **kwargs):
    return invoke("_sample_multinomial", [data],
                  {"shape": shape if shape is not None else (),
                   "get_prob": get_prob, "dtype": dtype}, out=out)


def shuffle(data, out=None, **kwargs):
    return invoke("_shuffle", [data], {}, out=out)
