"""Symbolic RNN cells for the Module and bucketing API.

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py`` (reference:
``python/mxnet/rnn/rnn_cell.py``): RNNParams, BaseRNNCell, RNNCell,
LSTMCell, GRUCell, FusedRNNCell (:536), SequentialRNNCell,
BidirectionalCell, DropoutCell, ModifierCell, ZoneoutCell and
ResidualCell.  They build Symbol graphs; ``FusedRNNCell`` is one ``RNN``
op over a packed parameter vector (torch's RNN, cuDNN on the card), and
``unfuse()`` gives the equivalent stack of unrolled cells.  As in the
JAX package, ``pack_weights``/``unpack_weights`` hand the parameters
back unchanged, so checkpoints keep each cell's own names.
"""
from __future__ import annotations

from .. import symbol
from ..base import MXNetError

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ZoneoutCell", "ResidualCell"]


class RNNParams:
    """Container for cell parameter symbols (reference: rnn_cell.py:36)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.var(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """Abstract symbolic cell (reference: rnn_cell.py:66)."""

    def __init__(self, prefix="", params=None):
        self._own_params = params is None
        self._params = RNNParams(prefix) if params is None else params
        self._prefix = prefix
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):  # pragma: no cover - abstract
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):  # pragma: no cover - abstract
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    def begin_state(self, func=symbol.zeros, **kwargs):
        """Initial state symbols (reference: rnn_cell.py begin_state)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called "\
            "directly. Call the modifier cell instead."
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if info is None:
                state = func(name="%sbegin_state_%d" % (
                    self._prefix, self._init_counter), **kwargs)
            else:
                kw = dict(kwargs)
                kw.update(info)
                state = _begin_state_var(
                    "%sbegin_state_%d" % (self._prefix, self._init_counter),
                    kw)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Split fused param blobs (reference: rnn_cell.py unpack_weights)."""
        return dict(args)

    def pack_weights(self, args):
        return dict(args)

    def _auto_begin_state(self, ref_input, ref_batch_axis=0):
        """Shape-inferable zero states derived from an input symbol's batch
        (_rnn_state_zeros op; see its docstring)."""
        states = []
        for info in self.state_info:
            self._init_counter += 1
            states.append(symbol._make_symbol_call(
                "_rnn_state_zeros", [ref_input],
                {"shape": info["shape"], "ref_batch_axis": ref_batch_axis},
                name="%sbegin_state_%d" % (self._prefix, self._init_counter)))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Unroll into a symbolic graph (reference: rnn_cell.py unroll)."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self._auto_begin_state(inputs[0])
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


def _begin_state_var(name, kwargs):
    kwargs.pop("__layout__", None)
    shape = kwargs.pop("shape", None)
    return symbol.var(name, shape=shape, **{k: v for k, v in kwargs.items()
                                            if k in ("dtype", "init")})


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """Reference: rnn_cell.py _normalize_sequence."""
    assert inputs is not None
    axis = layout.find("T")
    if isinstance(inputs, symbol.Symbol):
        if merge is False:
            assert len(inputs.list_outputs()) == 1
            inputs = list(symbol.SliceChannel(
                inputs, axis=axis, num_outputs=length, squeeze_axis=1))
    else:
        assert length is None or len(inputs) == length
        if merge is True:
            inputs = [symbol.expand_dims(i, axis=axis) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=axis)
    return inputs, axis


class RNNCell(BaseRNNCell):
    """Elman cell (reference: rnn_cell.py:108)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (reference: rnn_cell.py:190)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        from .. import initializer
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get(
            "i2h_bias", init=initializer.LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(states[0], self._hW, self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%sh2h" % name)
        gates = i2h + h2h
        slice_gates = symbol.SliceChannel(gates, num_outputs=4, axis=-1,
                                          name="%sslice" % name)
        in_gate = symbol.sigmoid(slice_gates[0])
        forget_gate = symbol.sigmoid(slice_gates[1])
        in_transform = symbol.tanh(slice_gates[2])
        out_gate = symbol.sigmoid(slice_gates[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (reference: rnn_cell.py:285)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        seq_idx = self._counter
        name = "%st%d_" % (self._prefix, seq_idx)
        prev_state_h = states[0]
        i2h = symbol.FullyConnected(inputs, self._iW, self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(prev_state_h, self._hW, self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%sh2h" % name)
        i2h_slice = symbol.SliceChannel(i2h, num_outputs=3, axis=-1)
        h2h_slice = symbol.SliceChannel(h2h, num_outputs=3, axis=-1)
        reset_gate = symbol.sigmoid(i2h_slice[0] + h2h_slice[0])
        update_gate = symbol.sigmoid(i2h_slice[1] + h2h_slice[1])
        next_h_tmp = symbol.tanh(i2h_slice[2] + reset_gate * h2h_slice[2])
        next_h = (1.0 - update_gate) * next_h_tmp + \
            update_gate * prev_state_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN through the ``RNN`` op over one packed
    parameter vector (reference: rnn_cell.py:536)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = 2 if bidirectional else 1
        self._parameter = self.params.get("parameters")

    @property
    def state_info(self):
        b = self._directions * self._num_layers
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": (b, 0, self._num_hidden), "__layout__": "LNC"}
                for _ in range(n)]

    def __call__(self, inputs, states):
        raise MXNetError("FusedRNNCell cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:  # NTC -> TNC for the fused op
            inputs = symbol.SwapAxis(inputs, dim1=0, dim2=1)
        if begin_state is None:
            # TNC: batch is dim 1 of the merged input
            begin_state = self._auto_begin_state(inputs, ref_batch_axis=1)
        states = begin_state
        rnn_args = [inputs, self._parameter] + list(states)
        rnn = symbol.RNN(*rnn_args, state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional, p=self._dropout,
                         state_outputs=self._get_next_state, mode=self._mode,
                         name=self._prefix + "rnn")
        outputs = rnn if not self._get_next_state else rnn[0]
        final_states = [] if not self._get_next_state else list(rnn[1:])
        if axis == 1:
            outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = list(symbol.SliceChannel(
                outputs, axis=axis, num_outputs=length, squeeze_axis=1))
        return outputs, final_states

    def unfuse(self):
        """Equivalent stack of unfused cells (reference: rnn_cell.py
        unfuse)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden, "relu", p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden, "tanh", p),
            "lstm": lambda p: LSTMCell(self._num_hidden, p),
            "gru": lambda p: GRUCell(self._num_hidden, p)}[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_" % (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stacked cells (reference: rnn_cell.py:698)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []
        self._override_cell_params = params is not None

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        states = begin_state
        p = 0
        final_states = []
        for i, cell in enumerate(self._cells):
            if states is None:
                s = None
            else:
                n = len(cell.state_info)
                s = states[p:p + n]
                p += n
            inputs, s = cell.unroll(
                length, inputs=inputs, begin_state=s, layout=layout,
                merge_outputs=None if i < len(self._cells) - 1
                else merge_outputs)
            final_states.extend(s)
        return inputs, final_states


class DropoutCell(BaseRNNCell):
    """Dropout between layers (reference: rnn_cell.py:772)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """Reference: rnn_cell.py:816."""

    def __init__(self, base_cell):
        base_cell._modified = True
        super().__init__()
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Reference: rnn_cell.py:863."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout. Please unfuse first."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        p_outputs, p_states = self.zoneout_outputs, self.zoneout_states
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: symbol.Dropout(  # noqa: E731
            symbol.ones_like(like), p=p)
        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(next_output)
        output = symbol.where(mask(p_outputs, next_output), next_output,
                              prev_output) if p_outputs != 0.0 \
            else next_output
        states = [symbol.where(mask(p_states, new_s), new_s, old_s)
                  for new_s, old_s in zip(next_states, states)] \
            if p_states != 0.0 else next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Reference: rnn_cell.py:921."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.elemwise_add(output, inputs)
        return output, states


class BidirectionalCell(BaseRNNCell):
    """Reference: rnn_cell.py:958."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._output_prefix = output_prefix
        self._cells = [l_cell, r_cell]

    def __call__(self, inputs, states):
        raise MXNetError(
            "Bidirectional cannot be stepped. Please use unroll")

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self._auto_begin_state(inputs[0])
        states = begin_state
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[n_l:], layout=layout, merge_outputs=False)
        outputs = [symbol.Concat(l_o, r_o, dim=1,
                                 name="%st%d" % (self._output_prefix, i))
                   for i, (l_o, r_o) in enumerate(
                       zip(l_outputs, reversed(r_outputs)))]
        if merge_outputs:
            outputs = [symbol.expand_dims(o, axis=axis) for o in outputs]
            outputs = symbol.Concat(*outputs, dim=axis)
        states = l_states + r_states
        return outputs, states
