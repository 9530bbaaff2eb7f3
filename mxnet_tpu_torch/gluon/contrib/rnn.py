"""Experimental recurrent cells.

Counterpart of ``mxnet_tpu/gluon/contrib/rnn.py`` (reference:
``python/mxnet/gluon/contrib/rnn/``): VariationalDropoutCell (one
dropout mask reused at every time step, Gal & Ghahramani) and
Conv2DLSTMCell (Shi et al.'s ConvLSTM).  The mask is drawn at the first
step after ``reset()`` (``unroll`` resets) and kept, so a sequence has
one mask; the conv cell's gates are one ``Convolution`` per path feeding
the dense LSTMCell's gate math.
"""
from __future__ import annotations

from ..rnn.rnn_cell import HybridRecurrentCell, ModifierCell
from ..nn.basic_layers import _init

__all__ = ["VariationalDropoutCell", "Conv2DLSTMCell"]


class VariationalDropoutCell(ModifierCell):
    """Apply the SAME dropout mask at every time step (reference:
    contrib/rnn/rnn_cell.py VariationalDropoutCell)."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def reset(self):
        super().reset()
        self._input_mask = None
        self._state_mask = None
        self._output_mask = None

    def _mask(self, F, cached_name, like, p):
        mask = getattr(self, cached_name)
        if mask is None:
            # Dropout of ones yields the scaled Bernoulli mask; caching
            # it keeps the mask constant across the unrolled steps
            mask = F.Dropout(F.ones_like(like), p=p)
            setattr(self, cached_name, mask)
        return mask

    def hybrid_forward(self, F, inputs, states):
        if self.drop_inputs:
            inputs = inputs * self._mask(F, "_input_mask", inputs,
                                         self.drop_inputs)
        if self.drop_states:
            states = [s * self._mask(F, "_state_mask", s, self.drop_states)
                      if i == 0 else s
                      for i, s in enumerate(states)]
        output, states = self.base_cell(inputs, states)
        if self.drop_outputs:
            output = output * self._mask(F, "_output_mask", output,
                                         self.drop_outputs)
        return output, states

    def __repr__(self):
        return "VariationalDropoutCell(%s)" % self.base_cell


class Conv2DLSTMCell(HybridRecurrentCell):
    """Convolutional LSTM over NCHW feature maps (reference:
    contrib/rnn/conv_rnn_cell.py Conv2DLSTMCell; Shi et al. 2015).

    input_shape: (C, H, W) of the inputs; hidden state has
    ``hidden_channels`` channels at the same spatial size (SAME
    padding is applied for odd kernels).
    """

    def __init__(self, input_shape, hidden_channels, i2h_kernel=(3, 3),
                 h2h_kernel=(3, 3), i2h_weight_initializer=None,
                 h2h_weight_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_shape = tuple(input_shape)
        self._hc = int(hidden_channels)
        self._i2h_kernel = tuple(i2h_kernel)
        self._h2h_kernel = tuple(h2h_kernel)
        if any(k % 2 == 0 for k in self._i2h_kernel + self._h2h_kernel):
            raise ValueError("conv LSTM kernels must be odd for SAME "
                             "padding, got %r/%r"
                             % (self._i2h_kernel, self._h2h_kernel))
        in_c = self._input_shape[0]
        self.i2h_weight = self.params.get(
            "i2h_weight",
            shape=(4 * self._hc, in_c) + self._i2h_kernel,
            init=_init(i2h_weight_initializer), allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight",
            shape=(4 * self._hc, self._hc) + self._h2h_kernel,
            init=_init(h2h_weight_initializer), allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * self._hc,), init=_init("zeros"),
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hc) + self._input_shape[1:]
        return [{"shape": shape, "__layout__": "NCHW"},
                {"shape": shape, "__layout__": "NCHW"}]

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias):
        prefix = "t%d_" % self._counter
        pad_i = tuple(k // 2 for k in self._i2h_kernel)
        pad_h = tuple(k // 2 for k in self._h2h_kernel)
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=pad_i,
                            num_filter=4 * self._hc,
                            name=prefix + "i2h")
        h2h = F.Convolution(states[0], h2h_weight,
                            kernel=self._h2h_kernel, pad=pad_h,
                            num_filter=4 * self._hc, no_bias=True,
                            name=prefix + "h2h")
        gates = i2h + h2h
        slices = F.SliceChannel(gates, num_outputs=4, axis=1)
        in_gate = F.sigmoid(slices[0])
        forget_gate = F.sigmoid(slices[1])
        in_transform = F.tanh(slices[2])
        out_gate = F.sigmoid(slices[3])
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.tanh(next_c)
        return next_h, [next_h, next_c]
