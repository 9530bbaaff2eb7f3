"""``mx.nd.contrib``: every registered ``_contrib_*`` op without the
prefix (counterpart of ``mxnet_tpu/ndarray/contrib.py``)."""
from __future__ import annotations

from .register import populate

populate(__name__, prefix="_contrib_")
