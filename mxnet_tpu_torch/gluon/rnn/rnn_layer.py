"""Gluon recurrent layers backed by the fused RNN op.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py`` (reference:
``python/mxnet/gluon/rnn/rnn_layer.py``: the _RNNLayer base, RNN, LSTM
and GRU, all calling the fused ``RNN`` operator, src/operator/rnn-inl.h
and cudnn_rnn-inl.h).  The parameters keep the JAX package's names and
order (``l0_i2h_weight``, ...); each forward packs them, weights first
then biases, into the op's flat vector, and the op hands them to
torch's fused RNN as views (cuDNN on the card).  Without states a
forward starts from zeros on the inputs' context; ``begin_state`` makes
them on the current context.
"""
from __future__ import annotations

import numpy as np

from ... import ndarray
from ...base import MXNetError
from ...ndarray import NDArray
from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """Base for RNN/LSTM/GRU layers (reference: rnn_layer.py:33)."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._mode = mode
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]
        self._dir = 2 if bidirectional else 1
        self._hidden_size, self._num_layers = hidden_size, num_layers
        self._layout, self._dropout = layout, dropout
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._h2h_bias_initializer = h2h_bias_initializer

        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][:self._dir]:
                self._register_param("{}{}_i2h_weight".format(j, i),
                                     shape=(ng * nh, ni),
                                     init=i2h_weight_initializer)
                self._register_param("{}{}_h2h_weight".format(j, i),
                                     shape=(ng * nh, nh),
                                     init=h2h_weight_initializer)
                self._register_param("{}{}_i2h_bias".format(j, i),
                                     shape=(ng * nh,),
                                     init=i2h_bias_initializer)
                self._register_param("{}{}_h2h_bias".format(j, i),
                                     shape=(ng * nh,),
                                     init=h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        from ..nn.basic_layers import _init
        p = self.params.get(name, shape=shape, init=_init(init),
                            allow_deferred_init=True)
        setattr(self, name, p)
        return p

    def __repr__(self):
        s = "{name}({mapping}, {_layout}"
        if self._num_layers != 1:
            s += ", num_layers={_num_layers}"
        if self._dropout != 0:
            s += ", dropout={_dropout}"
        if self._dir == 2:
            s += ", bidirectional"
        s += ")"
        shape = self.l0_i2h_weight.shape
        mapping = "{0} -> {1}".format(shape[1] if shape[1] else None,
                                      shape[0] // self._gates)
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def _shape_hook(self, inputs):
        x = inputs[0]
        ni = x.shape[2] if self._layout == "TNC" else x.shape[2]
        ng, nh = self._gates, self._hidden_size
        cur = ni
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                getattr(self, "{}{}_i2h_weight".format(j, i)).shape = \
                    (ng * nh, cur)
            cur = nh * self._dir

    def state_info(self, batch_size=0):  # pragma: no cover - abstract
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=ndarray.zeros, **kwargs):
        """Initial states (reference: rnn_layer.py begin_state)."""
        return [func(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def forward(self, inputs, states=None):
        """Reference: rnn_layer.py forward — flatten params into the fused
        op's packed vector, run, unpack states."""
        batch_size = inputs.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context)
        if isinstance(states, NDArray):
            states = [states]
        for state, info in zip(states, self.state_info(batch_size)):
            if state.shape != info["shape"]:
                raise ValueError(
                    "Invalid recurrent state shape. Expecting %s, got %s." % (
                        str(info["shape"]), str(state.shape)))
        if self._input_size == 0:
            self._shape_hook((inputs,))
            for p in self._reg_params.values():
                p._finish_deferred_init()
        out = self._forward_kernel(inputs, states)
        return out[0] if skip_states else out

    def _forward_kernel(self, inputs, states):
        if self._layout == "NTC":
            inputs = inputs.swapaxes(0, 1)
        params = []
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                for t in ("i2h_weight", "h2h_weight"):
                    params.append(getattr(
                        self, "{}{}_{}".format(j, i, t)).data().reshape(-1))
        for i in range(self._num_layers):
            for j in ["l", "r"][:self._dir]:
                for t in ("i2h_bias", "h2h_bias"):
                    params.append(getattr(
                        self, "{}{}_{}".format(j, i, t)).data().reshape(-1))
        params = ndarray.concat(*params, dim=0) if len(params) > 1 else params[0]

        args = [inputs, params] + list(states)
        rnn_outs = ndarray.RNN(
            *args, state_size=self._hidden_size, num_layers=self._num_layers,
            bidirectional=self._dir == 2, p=self._dropout,
            state_outputs=True, mode=self._mode)
        if not isinstance(rnn_outs, list):
            rnn_outs = [rnn_outs]
        outputs, states = rnn_outs[0], list(rnn_outs[1:])
        if self._layout == "NTC":
            outputs = outputs.swapaxes(0, 1)
        return outputs, states

    def hybrid_forward(self, F, inputs, *states, **params):
        raise NotImplementedError  # forward overridden


def _argnames(func):
    import inspect
    try:
        return list(inspect.signature(func).parameters)
    except (TypeError, ValueError):
        return []


class RNN(_RNNLayer):
    """Elman RNN, relu or tanh (reference: rnn_layer.py:225)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference: rnn_layer.py:317)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU (reference: rnn_layer.py:414)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
