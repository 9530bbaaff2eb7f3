"""``mx.sym.linalg``: every registered ``_linalg_*`` op without the
prefix (counterpart of ``mxnet_tpu/symbol/linalg.py``)."""
from __future__ import annotations

from . import _populate

_populate(__name__, prefix="_linalg_")
