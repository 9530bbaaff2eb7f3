"""Gluon neural-network layers (reference: python/mxnet/gluon/nn/)."""
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401
