"""Symbol package: the ``sym.<Op>`` namespace generated from the op
registry (counterpart of ``mxnet_tpu/symbol/__init__.py``)."""
from __future__ import annotations

import sys

from .symbol import (  # noqa: F401
    Group, Symbol, Variable, _SymNode, _op_input_names, load, load_json,
    var,
)
from .. import ops  # noqa: F401  (registers every op)
from ..name import NameManager
from ..ops.registry import _OP_REGISTRY, coerce_attrs, get_op


def _make_symbol_call(op_name, input_syms, attrs, name=None):
    """Create an op node, auto-creating variables for unbound inputs
    (``<name>_weight``, ``<name>_bias``, ``<name>_moving_mean``...)."""
    op = get_op(op_name)
    hint = op.name.lower().replace("_v1", "")
    if hint.startswith("_"):
        hint = hint[1:]
    name = NameManager.current().get(name, hint)
    attrs = {k: v for k, v in attrs.items() if v is not None}
    # typed-parameter enforcement where the graph is built
    op.validate_attrs(coerce_attrs(attrs))
    if isinstance(input_syms, tuple):
        pos_syms, kw_syms = input_syms
    else:
        pos_syms, kw_syms = list(input_syms), {}
    param_names = _op_input_names(op, attrs)
    inputs, si = [], 0
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
    node = _SymNode(op, name, inputs, dict(attrs))
    n_out = max(1, op.n_outputs(coerce_attrs(attrs)) - len(op.mutate_aux))
    return Symbol([(node, i) for i in range(n_out)])


def _make_sym_func(op_name, opdef):
    def sym_func(*args, name=None, **kwargs):
        sym_kwargs, attrs = {}, {}
        for k, v in kwargs.items():
            (sym_kwargs if isinstance(v, Symbol) else attrs)[k] = v
        pos = [a for a in args if isinstance(a, Symbol)]
        return _make_symbol_call(op_name, (pos, sym_kwargs), attrs,
                                 name=name)

    sym_func.__name__ = op_name
    sym_func.__doc__ = opdef.gen_doc()
    return sym_func


def _populate(module_name=__name__):
    mod = sys.modules[module_name]
    for opn, opdef in _OP_REGISTRY.items():
        if opn.isidentifier() and not hasattr(mod, opn):
            setattr(mod, opn, _make_sym_func(opn, opdef))


_populate()
