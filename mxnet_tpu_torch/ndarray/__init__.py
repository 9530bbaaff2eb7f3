"""NDArray package (reference: python/mxnet/ndarray/__init__.py): the
``NDArray`` type, its constructors, and one ``mx.nd.<op>`` function per
registered op (``mx.nd.contrib.<op>`` for the ``_contrib_`` ones)."""
from .ndarray import (  # noqa: F401
    NDArray, arange, array, empty, load, load_buffer, ones, save, zeros,
)
from . import ndarray  # noqa: F401
from .. import ops as _ops  # noqa: F401  (registers every op)
from . import register as _register

_register.populate(__name__)

from . import contrib  # noqa: E402,F401  (needs the registry)
