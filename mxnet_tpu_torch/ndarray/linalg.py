"""``mx.nd.linalg`` (counterpart of ``mxnet_tpu/ndarray/linalg.py``):
every registered ``_linalg_*`` op without the prefix."""
from __future__ import annotations

from .register import populate

populate(__name__, prefix="_linalg_")
