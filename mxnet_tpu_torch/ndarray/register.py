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

__all__ = ["populate", "make_op_func"]


def _inputs_and_attrs(opdef, args, kwargs):
    """Split a call into the op's array inputs, in its declared slot
    order, and its attrs.  Positional NDArrays (None skipped) fill the
    slots first; a keyword whose name is an input slot of the op, or
    whose value is an NDArray, is an input too."""
    from .ndarray import NDArray
    inputs = [a for a in args if isinstance(a, NDArray)]
    slots = opdef.sig.required + opdef.sig.optional
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
