"""NDArray package (reference: python/mxnet/ndarray/__init__.py): the
``NDArray`` type, its constructors, one ``mx.nd.<op>`` function per
registered op (``mx.nd.contrib.<op>`` for the ``_contrib_`` ones), the
``random``, ``linalg`` and ``utils`` namespaces, and the module-level
arithmetic functions, which take an NDArray or a scalar on either
side."""
from .ndarray import (  # noqa: F401
    NDArray, arange, array, concat, concatenate, empty, full, imdecode, load,
    load_buffer, moveaxis, onehot_encode, ones, save, waitall, zeros,
)
from . import ndarray  # noqa: F401
from .. import ops as _ops  # noqa: F401  (registers every op)
from . import register as _register

_register.populate(__name__)
_register.attach_methods(NDArray)

from . import contrib  # noqa: E402,F401  (needs the registry)
from . import linalg  # noqa: E402,F401
from . import random  # noqa: E402,F401
from . import utils  # noqa: E402,F401


def _module_binop(array_op, scalar_op, rscalar_op=None):
    """``f(lhs, rhs)``: the array op for two NDArrays, the scalar op for
    an NDArray and a scalar (its mirror ``rscalar_op`` when the scalar
    is on the left of an op that does not commute)."""
    def helper(lhs, rhs):
        if isinstance(lhs, NDArray):
            out = lhs._binop(rhs, array_op, scalar_op)
        elif isinstance(rhs, NDArray):
            out = rhs._binop(lhs, array_op, rscalar_op or scalar_op,
                             reverse=True)
        else:
            raise TypeError("at least one operand must be an NDArray")
        if out is NotImplemented:
            raise TypeError("unsupported operand types for %s" % array_op)
        return out
    helper.__name__ = array_op.lstrip("_")
    return helper


add = _module_binop("elemwise_add", "_plus_scalar")
subtract = _module_binop("elemwise_sub", "_minus_scalar", "_rminus_scalar")
multiply = _module_binop("elemwise_mul", "_mul_scalar")
divide = _module_binop("elemwise_div", "_div_scalar", "_rdiv_scalar")
true_divide = divide
modulo = _module_binop("_mod", "_mod_scalar", "_rmod_scalar")
power = _module_binop("_power", "_power_scalar", "_rpower_scalar")
maximum = _module_binop("_maximum", "_maximum_scalar")
minimum = _module_binop("_minimum", "_minimum_scalar")
equal = _module_binop("_equal", "_equal_scalar")
not_equal = _module_binop("_not_equal", "_not_equal_scalar")
# a scalar on the left mirrors: greater(2, x) is lesser_scalar(x, 2)
greater = _module_binop("_greater", "_greater_scalar", "_lesser_scalar")
greater_equal = _module_binop("_greater_equal", "_greater_equal_scalar",
                              "_lesser_equal_scalar")
lesser = _module_binop("_lesser", "_lesser_scalar", "_greater_scalar")
lesser_equal = _module_binop("_lesser_equal", "_lesser_equal_scalar",
                             "_greater_equal_scalar")
logical_and = _module_binop("_logical_and", "_logical_and_scalar")
logical_or = _module_binop("_logical_or", "_logical_or_scalar")
logical_xor = _module_binop("_logical_xor", "_logical_xor_scalar")
