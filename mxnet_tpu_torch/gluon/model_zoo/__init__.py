"""Model zoo (reference: python/mxnet/gluon/model_zoo/__init__.py)."""
from . import model_store  # noqa: F401
from . import vision  # noqa: F401
from .vision import get_model  # noqa: F401
