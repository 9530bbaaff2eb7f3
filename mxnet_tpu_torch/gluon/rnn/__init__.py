"""Gluon RNN package (reference: python/mxnet/gluon/rnn/__init__.py;
counterpart of ``mxnet_tpu/gluon/rnn``)."""
from .rnn_layer import RNN, LSTM, GRU  # noqa: F401
from .rnn_cell import (  # noqa: F401
    RecurrentCell, HybridRecurrentCell, RNNCell, LSTMCell, GRUCell,
    SequentialRNNCell, DropoutCell, ModifierCell, ZoneoutCell, ResidualCell,
    BidirectionalCell,
)
