"""Gluon, the imperative and hybrid API (reference: python/mxnet/gluon/;
counterpart of ``mxnet_tpu/gluon``): Parameter and Constant, Block,
HybridBlock and SymbolBlock, the ``nn`` layers, the recurrent layers and
cells of ``rnn``, ``contrib.rnn`` and ``contrib.transformer``, the
``Trainer``, the losses, ``utils``, ``data`` and ``model_zoo``."""
from .parameter import (  # noqa: F401
    Constant, DeferredInitializationError, Parameter, ParameterDict)
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import rnn  # noqa: F401
from . import data  # noqa: F401
from . import model_zoo  # noqa: F401
from . import loss  # noqa: F401
from . import utils  # noqa: F401
from .utils import split_and_load, split_data, clip_global_norm  # noqa: F401
from . import contrib  # noqa: F401
