"""Gluon recurrent cells.

Counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py`` (reference:
``python/mxnet/gluon/rnn/rnn_cell.py``): the RecurrentCell /
HybridRecurrentCell base (``begin_state``, ``unroll`` over either
layout, ``merge_outputs`` and ``valid_length``), RNNCell, LSTMCell,
GRUCell, SequentialRNNCell, DropoutCell, ModifierCell, ZoneoutCell,
ResidualCell and BidirectionalCell, each step a few ``nd`` ops run
eagerly.  ``begin_state`` makes its arrays on the current context
(``ndarray.zeros`` with no ``ctx``), ``unroll`` without a begin state on
the inputs' context.
"""
from __future__ import annotations

from ... import ndarray
from ...base import MXNetError
from ...ndarray import NDArray
from ..block import Block, HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ModifierCell",
           "ZoneoutCell", "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """Normalize sequence input to list-of-steps or merged tensor
    (reference: rnn_cell.py _format_sequence)."""
    assert inputs is not None
    axis = layout.find("T")
    batch_axis = layout.find("N")
    if isinstance(inputs, NDArray):
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            assert length is None or length == inputs.shape[axis]
            inputs = [x.squeeze(axis=axis) for x in
                      ndarray.SliceChannel(inputs,
                                           num_outputs=inputs.shape[axis],
                                           axis=axis, squeeze_axis=False)]
    else:
        assert length is None or len(inputs) == length
        batch_size = inputs[0].shape[batch_axis]
        if merge is True:
            inputs = [x.expand_dims(axis=axis) for x in inputs]
            inputs = ndarray.concat(*inputs, dim=axis)
    return inputs, axis, batch_size


class RecurrentCell(Block):
    """Abstract base for RNN cells (reference: rnn_cell.py:108)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset step counters (reference: rnn_cell.py:125)."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children.values():
            cell.reset()

    def state_info(self, batch_size=0):  # pragma: no cover - abstract
        raise NotImplementedError()

    def begin_state(self, batch_size=0, func=ndarray.zeros, **kwargs):
        """Reference: rnn_cell.py begin_state."""
        assert not self._modified, \
            "After applying modifier cells (e.g. ZoneoutCell) the base cell " \
            "cannot be called directly. Call the modifier cell instead."
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                shape = info["shape"]
            else:
                shape = None
            states.append(func(shape, **kwargs))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell over time (reference: rnn_cell.py unroll)."""
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        begin_state = begin_state if begin_state is not None else \
            self.begin_state(batch_size, ctx=_context_of(inputs))
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if valid_length is not None:
            merged = _merge_outputs(outputs, axis)
            masked = ndarray.SequenceMask(
                merged.swapaxes(0, axis) if axis != 0 else merged,
                sequence_length=valid_length, use_sequence_length=True)
            if axis != 0:
                masked = masked.swapaxes(0, axis)
            if merge_outputs is False:
                return ([o.squeeze(axis=axis) for o in ndarray.SliceChannel(
                    masked, num_outputs=length, axis=axis)], states)
            return masked, states
        if merge_outputs:
            outputs = _merge_outputs(outputs, axis)
        return outputs, states

    def _alias(self):
        return "rnn"

    def forward(self, inputs, states):  # pragma: no cover - abstract
        raise NotImplementedError()


def _context_of(inputs):
    """The context of a sequence's (first) step."""
    return (inputs[0] if isinstance(inputs, (list, tuple))
            else inputs).context


def _merge_outputs(outputs, axis):
    """Stack per-step outputs along the time axis."""
    return ndarray.concat(*[o.expand_dims(axis) for o in outputs], dim=axis)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """Cells whose step is hybridizable (reference: rnn_cell.py:363)."""

    def __init__(self, prefix=None, params=None):
        RecurrentCell.__init__(self, prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        params = {}
        from ..parameter import DeferredInitializationError
        try:
            for k, v in self._reg_params.items():
                params[k] = v.data()
        except DeferredInitializationError:
            self._infer_param_shapes(inputs)
            for k, v in self._reg_params.items():
                params[k] = v.data()
        return self.hybrid_forward(ndarray, inputs, states, **params)

    def _infer_param_shapes(self, x):
        self._shape_hook((x,))
        for v in self._reg_params.values():
            v._finish_deferred_init()


class RNNCell(HybridRecurrentCell):
    """Elman cell (reference: rnn_cell.py:390)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        from ..nn.basic_layers import _init
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(hidden_size, input_size),
            init=_init(i2h_weight_initializer), allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(hidden_size, hidden_size),
            init=_init(h2h_weight_initializer), allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(hidden_size,),
            init=_init(i2h_bias_initializer), allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(hidden_size,),
            init=_init(h2h_bias_initializer), allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "rnn"

    def _shape_hook(self, inputs):
        self.i2h_weight.shape = (self._hidden_size, inputs[0].shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size,
                               name=prefix + "h2h")
        output = F.Activation(i2h + h2h, act_type=self._activation,
                              name=prefix + "out")
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """LSTM cell (reference: rnn_cell.py:477)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        from ..nn.basic_layers import _init
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=_init(i2h_weight_initializer), allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, hidden_size),
            init=_init(h2h_weight_initializer), allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=_init(i2h_bias_initializer), allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=_init(h2h_bias_initializer), allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def _shape_hook(self, inputs):
        self.i2h_weight.shape = (4 * self._hidden_size, inputs[0].shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=4 * self._hidden_size,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=4 * self._hidden_size,
                               name=prefix + "h2h")
        gates = i2h + h2h
        slices = F.SliceChannel(gates, num_outputs=4, axis=-1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.tanh(slices[2])
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """GRU cell (reference: rnn_cell.py:581)."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        from ..nn.basic_layers import _init
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(3 * hidden_size, input_size),
            init=_init(i2h_weight_initializer), allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(3 * hidden_size, hidden_size),
            init=_init(h2h_weight_initializer), allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(3 * hidden_size,),
            init=_init(i2h_bias_initializer), allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(3 * hidden_size,),
            init=_init(h2h_bias_initializer), allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size), "__layout__": "NC"}]

    def _alias(self):
        return "gru"

    def _shape_hook(self, inputs):
        self.i2h_weight.shape = (3 * self._hidden_size, inputs[0].shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        prefix = "t%d_" % self._counter
        prev_state_h = states[0]
        i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                               num_hidden=3 * self._hidden_size,
                               name=prefix + "i2h")
        h2h = F.FullyConnected(prev_state_h, h2h_weight, h2h_bias,
                               num_hidden=3 * self._hidden_size,
                               name=prefix + "h2h")
        i2h_slices = F.SliceChannel(i2h, num_outputs=3, axis=-1)
        h2h_slices = F.SliceChannel(h2h, num_outputs=3, axis=-1)
        reset_gate = F.sigmoid(i2h_slices[0] + h2h_slices[0])
        update_gate = F.sigmoid(i2h_slices[1] + h2h_slices[1])
        next_h_tmp = F.tanh(i2h_slices[2] + reset_gate * h2h_slices[2])
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_state_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack of cells applied per step (reference: rnn_cell.py:674)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        states = begin_state if begin_state is not None else \
            self.begin_state(batch_size, ctx=_context_of(inputs))
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = _merge_outputs(outputs, axis)
        return outputs, states


class ModifierCell(HybridRecurrentCell):
    """Base for cells wrapping another cell (reference: rnn_cell.py:762)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified. One cell cannot be modified twice" \
            % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=ndarray.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(batch_size=batch_size, func=func,
                                           **kwargs)
        self.base_cell._modified = True
        return begin

    def forward(self, inputs, states):
        self._counter += 1
        return self.hybrid_forward(ndarray, inputs, states)


class DropoutCell(HybridRecurrentCell):
    """Dropout on inputs per step (reference: rnn_cell.py:712)."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert isinstance(rate, (int, float))
        self.rate = rate

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def forward(self, inputs, states):
        self._counter += 1
        return self.hybrid_forward(ndarray, inputs, states)

    def hybrid_forward(self, F, inputs, states):
        if self.rate > 0:
            inputs = F.Dropout(inputs, p=self.rate,
                               name="t%d_fwd" % self._counter)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference: rnn_cell.py:810)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout since it doesn't " \
            "support step. Please add ZoneoutCell to the cells underneath " \
            "instead."
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        super().__init__(base_cell)
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell = self.base_cell
        p_outputs, p_states = self._zoneout_outputs, self._zoneout_states
        next_output, next_states = cell(inputs, states)
        mask = (lambda p, like: F.Dropout(F.ones_like(like), p=p))
        prev_output = self._prev_output
        if prev_output is None:
            prev_output = ndarray.zeros_like(next_output)
        output = (F.where(mask(p_outputs, next_output), next_output,
                          prev_output)
                  if p_outputs != 0.0 else next_output)
        new_states = ([F.where(mask(p_states, new_s), new_s, old_s)
                       for new_s, old_s in zip(next_states, states)]
                      if p_states != 0.0 else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Adds residual connection (reference: rnn_cell.py:884)."""

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def _alias(self):
        return "residual"

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=False, valid_length=valid_length)
        self.base_cell._modified = True
        ins, axis, _ = _format_sequence(length, inputs, layout, False)
        outputs = [o + i for o, i in zip(outputs, ins)]
        if merge_outputs:
            outputs = ndarray.concat(*[o.expand_dims(axis) for o in outputs],
                                     dim=axis)
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """Forward+backward cells over a sequence (reference: rnn_cell.py:928)."""

    def __init__(self, l_cell, r_cell, prefix="bi_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children.values(),
                                  batch_size=batch_size, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        begin_state = begin_state if begin_state is not None else \
            self.begin_state(batch_size, ctx=_context_of(inputs))
        states = begin_state
        l_cell, r_cell = self._children.values()
        n_l = len(l_cell.state_info(batch_size))
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[n_l:], layout=layout, merge_outputs=False,
            valid_length=valid_length)
        outputs = [ndarray.concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, reversed(r_outputs))]
        if merge_outputs:
            outputs = _merge_outputs(outputs, axis)
        states = l_states + r_states
        return outputs, states
