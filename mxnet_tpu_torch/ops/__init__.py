"""Operator library: importing it registers every op (counterpart of
``mxnet_tpu/ops/__init__.py``)."""
from . import registry  # noqa: F401
from . import nn  # noqa: F401
from . import matrix  # noqa: F401
from . import elemwise  # noqa: F401
from . import reduce  # noqa: F401
from . import init_ops  # noqa: F401
from . import loss  # noqa: F401
from . import contrib  # noqa: F401
from . import cuda_kernels  # noqa: F401
from . import optimizer_ops  # noqa: F401
