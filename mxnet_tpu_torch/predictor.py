"""Standalone inference predictor.

Counterpart of ``mxnet_tpu/predictor.py`` (the ``c_predict_api``
contract: load a ``prefix-symbol.json`` and ``prefix-NNNN.params``
checkpoint, bind for inference, set inputs, forward, get outputs).  The
constructor takes the JAX package's arguments, files or their contents,
with ``dev_type="gpu"`` as the default device; ``from_parts`` binds from
an in-memory symbol and parameter NDArrays, which is what the serving
executor cache does.
"""
from __future__ import annotations

import numpy as np

from . import ndarray as nd
from .base import MXNetError
from .context import Context
from .ndarray import NDArray

__all__ = ["Predictor", "create"]


class Predictor:
    """An inference-bound symbol with its parameters aliased in
    (reference: c_predict_api.h:77).

    >>> p = Predictor("model-symbol.json", "model-0001.params",
    ...               {"data": (1, 3, 224, 224)})      # on gpu(0)
    >>> p.forward(data=x).get_output(0).asnumpy()
    """

    def __init__(self, symbol_file, param_file, input_shapes,
                 dev_type="gpu", dev_id=0, output_names=None):
        ctx = Context(dev_type, dev_id)
        sym = _load_symbol(symbol_file, output_names)
        arg_params, aux_params = _load_params(param_file, ctx)
        self._bind_aliased(sym, arg_params, aux_params, input_shapes, ctx)

    def _bind_aliased(self, symbol, arg_params, aux_params, input_shapes,
                      ctx):
        """Inference-bind ``symbol`` on ``ctx`` (default the current
        context) and alias the parameter tensors in (``_data`` assignment: a
        reference, never a copy, so every bucket's predictor shares one
        set of weights).  A parameter on another device or of another
        shape is an error, not a silent copy."""
        self._sym = symbol
        self._exe = symbol.simple_bind(ctx=ctx, grad_req="null",
                                       **input_shapes)
        dev = self._exe.device
        for params, slots in ((arg_params, self._exe.arg_dict),
                              (aux_params, self._exe.aux_dict)):
            for k, v in (params or {}).items():
                if k not in slots:
                    continue
                if v._data.device != dev or v.shape != slots[k].shape:
                    raise MXNetError(
                        "parameter %r is %s on %s; the predictor is bound "
                        "with %s on %s" % (k, v.shape, v._data.device,
                                           slots[k].shape, dev))
                slots[k]._data = v._data
        self._input_names = list(input_shapes)
        self._inputs = {}
        self._outputs = None

    @classmethod
    def from_parts(cls, symbol, arg_params, aux_params, input_shapes,
                   ctx=None):
        """Bind from an already-loaded symbol and parameter dicts (the
        serving executor cache binds one predictor per shape bucket)."""
        p = cls.__new__(cls)
        p._bind_aliased(symbol, arg_params, aux_params, input_shapes, ctx)
        return p

    def set_input(self, name, data):
        if name not in self._input_names:
            raise MXNetError("unknown input %r; inputs are %s"
                             % (name, self._input_names))
        self._inputs[name] = data if isinstance(data, NDArray) \
            else np.asarray(data, np.float32)

    def set_input_bytes(self, name, buf):
        """A raw float32 buffer as input ``name``, in its bound shape (the
        native c_predict_api data path, MXPredSetInput)."""
        if name not in self._input_names:
            raise MXNetError("unknown input %r; inputs are %s"
                             % (name, self._input_names))
        shape = self._exe.arg_dict[name].shape
        self.set_input(name, np.frombuffer(buf, np.float32).reshape(shape))

    def get_output_bytes(self, index=0):
        """Output ``index`` as raw float32 bytes (MXPredGetOutput)."""
        return self.get_output(index).asnumpy().astype(
            np.float32, copy=False).tobytes()

    def forward(self, **inputs):
        for k, v in inputs.items():
            self.set_input(k, v)
        missing = [n for n in self._input_names if n not in self._inputs]
        if missing:
            raise MXNetError("inputs not set: %s" % missing)
        self._outputs = self._exe.forward(is_train=False, **self._inputs)
        return self

    def get_output(self, index=0):
        if self._outputs is None:
            raise MXNetError("call forward() before get_output()")
        return self._outputs[index]

    @property
    def num_outputs(self):
        return len(self._sym.list_outputs())

    def get_output_shape(self, index=0):
        """The shape of output ``index`` (reference: c_predict_api.h:120,
        MXPredGetOutputShape): the last forward's, or before any forward
        the symbol's inference from the bound input shapes, without
        running the graph."""
        if self._outputs is not None:
            return tuple(self._outputs[index].shape)
        known = {n: self._exe.arg_dict[n].shape for n in self._input_names}
        _, out_shapes, _ = self._sym.infer_shape(**known)
        return tuple(out_shapes[index])

    def reshape(self, input_shapes):
        """A new predictor bound for ``input_shapes`` that shares this
        one's parameter tensors (reference: MXPredReshape)."""
        new = Predictor.__new__(Predictor)
        params = {k: v for k, v in self._exe.arg_dict.items()
                  if k not in input_shapes}
        new._bind_aliased(self._sym, params, dict(self._exe.aux_dict),
                          input_shapes, self._exe.device)
        return new

    def free(self):
        """Release the executor and its buffers (reference: MXPredFree)."""
        self._exe = None
        self._outputs = None
        self._inputs = {}


def _load_symbol(symbol_file, output_names=None):
    """A Symbol from a path or from the JSON text itself (c_predict_api
    receives buffers, not paths); ``output_names`` picks internal heads
    (MXPredCreatePartialOut)."""
    from .symbol import Group, load, load_json
    if isinstance(symbol_file, str) and symbol_file.lstrip()[:1] == "{":
        sym = load_json(symbol_file)
    else:
        sym = load(symbol_file)
    if output_names:
        outs = sym.get_internals()
        names = outs.list_outputs()
        picked = []
        for want in output_names:
            if want not in names:
                raise MXNetError("output %r not in graph (%s...)"
                                 % (want, ", ".join(names[:8])))
            picked.append(outs[names.index(want)])
        sym = picked[0] if len(picked) == 1 else Group(picked)
    return sym


def _load_params(param_file, ctx=None):
    """``(arg_params, aux_params)`` on ``ctx`` from a checkpoint's
    ``.params`` path or its bytes (c_predict_api's param_bytes), split by
    ``save_checkpoint``'s ``arg:``/``aux:`` names; a name with neither
    is an argument."""
    loaded = (nd.load_buffer(param_file, ctx=ctx)
              if isinstance(param_file, (bytes, bytearray, memoryview))
              else nd.load(param_file, ctx=ctx))
    if not isinstance(loaded, dict):
        raise MXNetError(
            "param container must map names to arrays (save it from a "
            "dict, e.g. {'arg:fc_weight': ...}); got a nameless list")
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k] = v
    return arg_params, aux_params


def create(symbol_file, param_file, input_shapes, **kwargs):
    """A :class:`Predictor` with MXPredCreate's call shape."""
    return Predictor(symbol_file, param_file, input_shapes, **kwargs)
