"""``mx.sym.contrib``: every registered ``_contrib_*`` op without the
prefix (counterpart of ``mxnet_tpu/symbol/contrib.py``)."""
from __future__ import annotations

from . import _populate

_populate(__name__, prefix="_contrib_")
