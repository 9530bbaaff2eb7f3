"""Base utilities: the framework error type and dtype helpers.

Counterpart of ``mxnet_tpu/base.py``: the ``MXNetError`` contract, the
dtype normalisation that op params and ``NDArray`` constructors share,
expressed in ``torch.dtype`` terms, and MXNet's dtype ids, which the
``nd.save`` container writes.
"""
from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["MXNetError", "getenv", "string_types", "numeric_types",
           "dtype_np", "dtype_torch", "dtype_name", "dtype_id",
           "dtype_from_id", "classproperty"]

string_types = (str,)
numeric_types = (float, int, np.generic)


class MXNetError(RuntimeError):
    """Framework-wide error type (reference: python/mxnet/base.py:74)."""


_NAME_TO_TORCH = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_TORCH_TO_NAME = {v: k for k, v in _NAME_TO_TORCH.items()}

# MXNet's dtype ids, kept so saved .params files keep their meaning
# (reference: python/mxnet/ndarray/ndarray.py _DTYPE_NP_TO_MX; bfloat16 is
# later MXNet's 12, as in the JAX package)
_TORCH_TO_ID = {
    torch.float32: 0, torch.float64: 1, torch.float16: 2, torch.uint8: 3,
    torch.int32: 4, torch.int8: 5, torch.int64: 6, torch.bfloat16: 12,
}
_ID_TO_TORCH = {v: k for k, v in _TORCH_TO_ID.items()}


def dtype_torch(dtype):
    """Normalise a user dtype (str, numpy dtype or type, torch.dtype) to a
    ``torch.dtype``; None means float32."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_TO_NAME:
            raise MXNetError("unsupported dtype %s" % dtype)
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _NAME_TO_TORCH:
        raise MXNetError("unsupported dtype %s" % (dtype,))
    return _NAME_TO_TORCH[name]


def dtype_np(dtype):
    """Normalise a user dtype (str, numpy dtype or type, torch.dtype) to a
    ``numpy.dtype``; None means float32.  ``"bfloat16"`` is
    ``ml_dtypes``' bfloat16 where that package is installed."""
    if dtype is None:
        return np.dtype(np.float32)
    if isinstance(dtype, torch.dtype):
        dtype = dtype_name(dtype)
    if isinstance(dtype, str) and dtype == "bfloat16":
        try:
            import ml_dtypes
        except ImportError:
            raise MXNetError("numpy has no bfloat16 without ml_dtypes")
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(dtype)


def dtype_name(dtype):
    """``torch.dtype`` -> the MXNet dtype string (``"float32"``...)."""
    return _TORCH_TO_NAME[dtype_torch(dtype)]


def dtype_id(dtype):
    """A dtype -> its MXNet id (the ``nd.save`` container's dtype field);
    MXNetError for a dtype the container has no id for (bool)."""
    dt = dtype_torch(dtype)
    if dt not in _TORCH_TO_ID:
        raise MXNetError("dtype %s has no MXNet dtype id" % dtype_name(dt))
    return _TORCH_TO_ID[dt]


def dtype_from_id(tid):
    """An MXNet dtype id -> ``torch.dtype``; MXNetError for an unknown id."""
    if tid not in _ID_TO_TORCH:
        raise MXNetError("unknown dtype id %d in an NDArray file" % tid)
    return _ID_TO_TORCH[tid]


class classproperty:  # noqa: N801
    """A read-only property of the class (``owner.name`` runs ``f(owner)``)."""

    def __init__(self, f):
        self.f = f

    def __get__(self, obj, owner):
        return self.f(owner)


_TRUE = ("1", "true", "True", "yes", "on")


def getenv(name, default=None, typ=None):
    """dmlc::GetEnv equivalent; MXNET_* names kept for compatibility."""
    val = os.environ.get(name)
    if val is None:
        return default
    if typ is bool or isinstance(default, bool):
        return val in _TRUE
    if typ is int or isinstance(default, int):
        return int(val)
    if typ is float or isinstance(default, float):
        return float(val)
    return val
