"""Symbol package: the ``sym.<Op>`` namespace generated from the op
registry (counterpart of ``mxnet_tpu/symbol/__init__.py``), the fluent
op methods of ``Symbol``, ``sym.maximum``/``minimum``/``hypot`` (a
Symbol or a scalar on either side), ``sym.zeros``/``ones``/``arange``,
and the ``random``, ``linalg`` and ``contrib`` namespaces."""
from __future__ import annotations

import sys

from .symbol import (  # noqa: F401
    Group, Symbol, Variable, _SymNode, _op_input_names, load, load_json,
    var,
)
from .. import ops  # noqa: F401  (registers every op)
from ..attribute import AttrScope
from ..name import NameManager
from ..ops.registry import _OP_REGISTRY, coerce_attrs, get_op


def _make_symbol_call(op_name, input_syms, attrs, name=None):
    """Create an op node, auto-creating variables for unbound inputs
    (``<name>_weight``, ``<name>_bias``, ``<name>_moving_mean``...); the
    current ``AttrScope``'s attrs go on the node."""
    op = get_op(op_name)
    hint = op.name.lower().replace("_v1", "")
    if hint.startswith("_"):
        hint = hint[1:]
    name = NameManager.current().get(name, hint)
    attrs = {k: v for k, v in attrs.items() if v is not None}
    # typed-parameter enforcement where the graph is built
    op.validate_attrs(coerce_attrs(attrs))
    node_attrs = dict(AttrScope.current().get({}))
    node_attrs.update(attrs)
    if isinstance(input_syms, tuple):
        pos_syms, kw_syms = input_syms
    elif isinstance(input_syms, dict):
        pos_syms, kw_syms = [], input_syms
    else:
        pos_syms, kw_syms = list(input_syms), {}
    param_names = _op_input_names(op, attrs)
    inputs = []
    if param_names and param_names[0] == "*data":
        # a variadic op binds its tensors in call order (an op with named
        # inputs before its variadic tail, Crop, binds by the loop below,
        # as in the JAX package, which names a missing tail op_*data)
        for s in pos_syms or list(kw_syms.values()):
            inputs.append(s._heads[0])
    else:
        si = 0
        for pi, pname in enumerate(param_names):
            sym = kw_syms.get(pname)
            # the reference calls every op's first input `data`
            if sym is None and pi == 0 and "data" not in param_names:
                sym = kw_syms.get("data")
            if sym is None and si < len(pos_syms):
                sym = pos_syms[si]
                si += 1
            if sym is None:
                sym = var("%s_%s" % (name, pname))
            inputs.append(sym._heads[0])
    node = _SymNode(op, name, inputs, node_attrs)
    n_out = op.n_outputs(coerce_attrs(node_attrs)) - len(op.mutate_aux)
    return Symbol([(node, i) for i in range(n_out if n_out > 1 else 1)])


def _make_sym_func(op_name, opdef):
    def sym_func(*args, name=None, attr=None, **kwargs):
        sym_kwargs, attrs = {}, {}
        for k, v in kwargs.items():
            (sym_kwargs if isinstance(v, Symbol) else attrs)[k] = v
        pos = [a for a in args if isinstance(a, Symbol)]
        return _make_symbol_call(op_name, (pos, sym_kwargs), attrs,
                                 name=name)

    sym_func.__name__ = op_name
    sym_func.__doc__ = opdef.gen_doc()
    return sym_func


def _populate(module_name=__name__, prefix=""):
    """One ``sym`` function per registered op whose name starts with
    ``prefix``, under the name without it."""
    mod = sys.modules[module_name]
    for opn, opdef in _OP_REGISTRY.items():
        if not opn.startswith(prefix):
            continue
        short = opn[len(prefix):]
        if short.isidentifier() and not hasattr(mod, short):
            setattr(mod, short, _make_sym_func(opn, opdef))


_populate()


def _attach_symbol_methods():
    """The single-tensor ops as ``Symbol`` methods (``s.sin()``,
    ``s.flatten()``...), the JAX package's list; explicit methods are
    kept."""
    from ..ndarray.register import METHOD_OPS
    extra = ("exp log sqrt square abs sign sigmoid tanh relu "
             "reshape_like broadcast_to slice slice_axis").split()
    for opn in list(METHOD_OPS) + extra:
        opdef = _OP_REGISTRY.get(opn)
        if opdef is None or hasattr(Symbol, opn):
            continue
        fn = _make_sym_func(opn, opdef)

        def method(self, *args, _f=fn, **kwargs):
            return _f(self, *args, **kwargs)

        method.__name__ = opn
        method.__doc__ = opdef.gen_doc()
        setattr(Symbol, opn, method)


_attach_symbol_methods()

from . import contrib  # noqa: E402,F401
from . import linalg  # noqa: E402,F401
from . import random  # noqa: E402,F401


def zeros(shape, dtype="float32", **kwargs):
    return _make_symbol_call("_zeros", [], {"shape": shape, "dtype": dtype})


def ones(shape, dtype="float32", **kwargs):
    return _make_symbol_call("_ones", [], {"shape": shape, "dtype": dtype})


def arange(start, stop=None, step=1.0, repeat=1, dtype="float32", **kwargs):
    return _make_symbol_call("_arange", [], {
        "start": start, "stop": stop, "step": step, "repeat": repeat,
        "dtype": dtype})


def _module_binop(array_op, scalar_op, rscalar_op=None):
    def helper(lhs, rhs):
        if isinstance(lhs, Symbol):
            return lhs._binop(rhs, array_op, scalar_op)
        if isinstance(rhs, Symbol):
            return rhs._binop(lhs, array_op, rscalar_op or scalar_op,
                              reverse=True)
        raise TypeError("at least one operand must be a Symbol")
    helper.__name__ = array_op.lstrip("_")
    return helper


maximum = _module_binop("_maximum", "_maximum_scalar")
minimum = _module_binop("_minimum", "_minimum_scalar")
hypot = _module_binop("_hypot", "_hypot_scalar")
