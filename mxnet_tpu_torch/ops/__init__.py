"""Operator library: importing it registers every op (counterpart of
``mxnet_tpu/ops/__init__.py``); the range overlay goes on last."""
from . import registry  # noqa: F401
from .registry import coerce_attrs, get_op, has_op, list_ops  # noqa: F401
from . import nn  # noqa: F401
from . import matrix  # noqa: F401
from . import elemwise  # noqa: F401
from . import reduce  # noqa: F401
from . import init_ops  # noqa: F401
from . import loss  # noqa: F401
from . import random_ops  # noqa: F401
from . import contrib  # noqa: F401
from . import misc  # noqa: F401
from . import cuda_kernels  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import constraints  # noqa: E402

constraints.install()
