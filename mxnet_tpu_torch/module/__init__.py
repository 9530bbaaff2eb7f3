"""Module API (reference: python/mxnet/module/)."""
from .base_module import BaseModule  # noqa: F401
from .module import Module  # noqa: F401
