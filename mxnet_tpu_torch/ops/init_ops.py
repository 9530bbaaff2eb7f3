"""Creation operators (counterpart of ``mxnet_tpu/ops/init_ops.py``;
reference: src/operator/tensor/init_op.h).  This package carries
``_arange``."""
from __future__ import annotations

import torch

from ..base import dtype_torch
from ..context import resolve
from .registry import register


@register("_arange")
def _arange(start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
            dtype="float32", ctx=None, **attrs):
    """``[start, stop)`` by ``step`` (``[0, start)`` without ``stop``),
    each value repeated ``repeat`` times, on ``ctx`` (default gpu(0))."""
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=dtype_torch(dtype),
                       device=resolve(ctx))
    if repeat > 1:
        out = out.repeat_interleave(int(repeat))
    return out
