"""``mx.nd.utils`` (counterpart of ``mxnet_tpu/ndarray/utils.py``): the
dense constructors; a sparse ``stype`` is not ported yet (ROADMAP.md
queue 7)."""
from __future__ import annotations

from ..base import MXNetError
from .ndarray import array as _dense_array, zeros as _dense_zeros


def zeros(shape, ctx=None, dtype=None, stype=None, **kwargs):
    if stype not in (None, "default"):
        raise MXNetError("sparse storage types are not ported yet")
    return _dense_zeros(shape, ctx=ctx, dtype=dtype)


def array(source_array, ctx=None, dtype=None):
    return _dense_array(source_array, ctx=ctx, dtype=dtype)
