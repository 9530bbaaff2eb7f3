"""Gluon, the imperative and hybrid API (reference:
python/mxnet/gluon/; counterpart of ``mxnet_tpu/gluon``).  This package
carries Parameter, Block, HybridBlock, the ``nn`` layers a transformer
runs, ``contrib.transformer``, the ``Trainer`` and the losses a language
model and simple heads train with."""
from .parameter import (  # noqa: F401
    DeferredInitializationError, Parameter, ParameterDict)
from .block import Block, HybridBlock  # noqa: F401
from . import nn  # noqa: F401
from . import contrib  # noqa: F401
from . import loss  # noqa: F401
from .trainer import Trainer  # noqa: F401
