"""Generate the ``mx.nd.*`` function namespace from the op registry.

Counterpart of ``mxnet_tpu/ndarray/register.py`` (reference:
python/mxnet/ndarray/register.py, which generates Python functions from
the C op list at import time).  Here the registry is Python, so each
function is a closure over its OpDef that calls ``imperative.invoke``.
"""
from __future__ import annotations

import sys

from ..imperative import invoke
from ..ops.registry import _OP_REGISTRY

__all__ = ["populate", "make_op_func", "attach_methods", "METHOD_OPS"]


def _inputs_and_attrs(opdef, args, kwargs):
    """Split a call into the op's array inputs, in its declared slot
    order, and its attrs.  Positional NDArrays (None skipped) fill the
    slots first; a keyword whose name is an input slot of the op, or
    whose value is an NDArray, is an input too."""
    from .ndarray import NDArray
    inputs = [a for a in args if isinstance(a, NDArray)]
    slots = opdef.sig.array_order() or []
    named, attrs = {}, {}
    for k, v in kwargs.items():
        if isinstance(v, NDArray) or k in slots:
            named[k] = v
        else:
            attrs[k] = v
    inputs += [named.pop(k) for k in slots[len(inputs):] if k in named]
    inputs += list(named.values())
    return inputs, attrs


def make_op_func(name, opdef):
    """The ``mx.nd.<name>`` function of ``opdef``."""
    def op_func(*args, out=None, name=None, **kwargs):
        inputs, attrs = _inputs_and_attrs(opdef, args, kwargs)
        return invoke(opdef, inputs, attrs, out=out)

    op_func.__name__ = name
    op_func.__doc__ = opdef.gen_doc()
    return op_func


def populate(module_name, prefix=""):
    """Install one function per registered op whose name starts with
    ``prefix`` into ``module_name``, under the name without the prefix;
    names that are not identifiers, and names the module already has,
    are left alone."""
    mod = sys.modules[module_name]
    for name, opdef in _OP_REGISTRY.items():
        if not name.startswith(prefix):
            continue
        short = name[len(prefix):]
        if short.isidentifier() and not hasattr(mod, short):
            setattr(mod, short, make_op_func(short, opdef))


# single-tensor ops the reference also exposes as NDArray methods
# (x.sin(), x.zeros_like()...), the JAX package's list; Symbol takes the
# same ones
METHOD_OPS = (
    "sin cos tan sinh cosh arcsin arccos arctan arcsinh arccosh arctanh "
    "degrees radians exp expm1 log log10 log2 log1p sqrt rsqrt cbrt rcbrt "
    "square reciprocal abs sign ceil floor rint round fix trunc relu "
    "sigmoid softmax log_softmax erf gamma gammaln sum nansum prod nanprod "
    "mean max min norm argmax argmin argmax_channel topk sort argsort "
    "clip flatten tile repeat pad swapaxes flip depth_to_space "
    "space_to_depth slice_axis slice_like one_hot take pick "
    "expand_dims squeeze split zeros_like ones_like sum_axis max_axis "
    "min_axis broadcast_axes broadcast_axis").split()


def attach_methods(nd_class):
    """Each op of ``METHOD_OPS`` as a method of ``nd_class`` that the
    class does not define itself: ``x.op(*args, **kwargs)`` calls the op
    with x first; positional values that are not arrays take the op's
    attrs in declaration order (``x.clip(0, 1)``, ``x.tile((2, 2))``), as
    they bind to the op function's parameters in the JAX package."""
    from .ndarray import NDArray
    for opname in METHOD_OPS:
        opdef = _OP_REGISTRY.get(opname)
        if opdef is None or hasattr(nd_class, opname):
            continue

        def method(self, *args, _op=opdef, **kwargs):
            extras = [a for a in args if not isinstance(a, NDArray)]
            inputs, attrs = _inputs_and_attrs(_op, (self,) + args, kwargs)
            for k, v in zip(list(_op.sig.attrs), extras):
                attrs.setdefault(k, v)
            return invoke(_op, inputs, attrs)

        method.__name__ = opname
        method.__doc__ = opdef.gen_doc()
        setattr(nd_class, opname, method)
