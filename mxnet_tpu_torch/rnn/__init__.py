"""Symbolic RNN package (reference: python/mxnet/rnn/__init__.py)."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
