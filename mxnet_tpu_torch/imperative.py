"""Imperative op invocation: eager execution of registered ops on NDArrays.

Counterpart of ``mxnet_tpu/imperative.py`` (reference:
src/imperative/imperative.cc Imperative::Invoke:86).  PyTorch runs
eagerly and queues device work asynchronously on the current stream, so
what remains here is attr coercion and validation, the op's
``attr_defaults``, the train-mode flag for ops that declare
``needs_is_train``, the generator of the device the op runs on (its
first input's, or its ``ctx``) for ops that declare ``needs_rng``,
recording, the write-back of ``mutate_aux`` outputs, and ``out=``.
Inside ``engine.naive()`` an op on the card waits for its stream before
returning, as under the reference's NaiveEngine.

Recording is PyTorch's autograd: an op runs with torch's grad mode on
exactly while ``autograd.record()`` is on, so its output joins the graph
when an input is a marked variable or a recorded output.  A ``mutate_aux``
output (a moving statistic) is written back detached, outside the graph;
``out=`` rebinds the target to the result, which keeps its graph.
"""
from __future__ import annotations

import torch

from . import autograd, engine
from .base import MXNetError
from .ops.registry import OpDef, coerce_attrs, get_op

__all__ = ["invoke"]


def invoke(op, nd_inputs, attrs=None, out=None):
    """Run ``op`` (an OpDef or a registered name) on NDArrays with
    ``attrs``; returns an NDArray, or a list for an op with several
    outputs.  With ``out`` (an NDArray or a list) the results are written
    into it and it is returned."""
    from .ndarray.ndarray import NDArray

    if not isinstance(op, OpDef):
        op = get_op(op)
    kw = dict(op.attr_defaults)
    kw.update(op.validate_attrs(coerce_attrs(attrs or {})))
    if op.needs_is_train:
        kw["__is_train__"] = autograd.is_training()
    for x in nd_inputs:
        if not isinstance(x, NDArray):
            raise MXNetError("%s: inputs must be NDArrays, got %s"
                             % (op.name, type(x).__name__))
    if op.needs_rng:
        from .ops.init_ops import device_of
        from .random import generator
        kw["__rng__"] = generator(nd_inputs[0]._data.device if nd_inputs
                                  else device_of(kw.get("ctx")))
    with autograd.grad_mode():
        outputs = op.fn(*[x._data for x in nd_inputs], **kw)
    outs = list(outputs) if isinstance(outputs, tuple) else [outputs]
    if engine.naive_scope_active():
        for o in outs:
            if o.is_cuda:
                torch.cuda.current_stream(o.device).synchronize()
    n_aux = len(op.mutate_aux)
    if n_aux:
        # the updated states go back into their input slots (an aux that
        # is a keyword of the op, not an input slot, has none)
        slots = op.sig.required
        for name, new in zip(op.mutate_aux, outs[-n_aux:]):
            if name in slots and slots.index(name) < len(nd_inputs):
                nd_inputs[slots.index(name)]._data = new.detach()
        outs = outs[:-n_aux]
    if out is not None:
        targets = out if isinstance(out, (list, tuple)) else [out]
        if len(targets) != len(outs):
            raise MXNetError("%s: out= takes %d arrays, got %d"
                             % (op.name, len(outs), len(targets)))
        with autograd.grad_mode():
            for tgt, src in zip(targets, outs):
                tgt._data = src.to(tgt._data.dtype)
        return out
    nd_outs = [NDArray(o) for o in outs]
    return nd_outs[0] if len(nd_outs) == 1 else nd_outs
