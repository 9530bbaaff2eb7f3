"""Parallel helpers (counterpart of ``mxnet_tpu/parallel``; this package
carries the flat-bucket plan of ``collectives`` and single-device
``attention``)."""
from . import collectives  # noqa: F401
from . import attention  # noqa: F401
