"""Parallel training helpers (counterpart of ``mxnet_tpu/parallel``;
this package carries the flat-bucket plan of ``collectives``)."""
from . import collectives  # noqa: F401
