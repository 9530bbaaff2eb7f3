"""NDArray package (reference: python/mxnet/ndarray/__init__.py)."""
from .ndarray import NDArray, array, empty, ones, zeros  # noqa: F401
from . import ndarray  # noqa: F401
