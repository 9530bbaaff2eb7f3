"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py``: every operator is ONE
function ``fn(*tensors, **attrs) -> tensor | tuple`` over ``torch.Tensor``
arguments, with a typed parameter table (``Param``) that rejects unknown
or malformed attributes where the graph is built.  The same function
serves execution and shape inference (run on ``meta`` tensors).

Context the caller injects through reserved attrs: ``__is_train__`` for
ops that declare ``needs_is_train``, and ``__rng__``, the
``torch.Generator`` of the device the op runs on (``random.generator``;
None on ``meta`` tensors), for ops that declare ``needs_rng``.
``attr_defaults`` supplies attrs an op receives unless the caller sets
them; ``free_attrs`` exempts an op from unknown-attr rejection;
``num_outputs`` may be a function of the attrs (``SliceChannel``,
``topk``).
"""
from __future__ import annotations

import ast
import difflib
import inspect
import numbers

from ..base import MXNetError

__all__ = ["OpDef", "Param", "register", "get_op", "has_op", "list_ops",
           "coerce_attrs", "normalize_tuple"]

_OP_REGISTRY: dict[str, "OpDef"] = {}

# keyword-with-default fn parameters that are tensors, not attrs (the
# JAX package's set, so both packages slot the same inputs)
OPTIONAL_ARRAY_INPUTS = frozenset({
    "bias", "gamma", "state_cell", "sequence_length",
    "data_lengths", "label_lengths", "trans"})

# framework metadata attrs that ride along with any op call
_PASSTHROUGH_ATTRS = frozenset({"name", "ctx_group"})


class Param:
    """Typed op parameter (the ``dmlc::Parameter`` field analogue).

    ptype: int/float/bool/str/tuple, a tuple of allowed strings (an
    enum), or None ("any value": name-checked only).  ``low``/``high``
    bound numeric values, element-wise for tuples; ``elem`` is a tuple's
    element type (None: elements pass unconverted).  ``derived`` marks an
    entry inferred from the op function's signature, which the
    constraint overlay (``constraints.py``) may type and bound."""

    __slots__ = ("name", "ptype", "default", "low", "high", "required",
                 "doc", "elem", "derived")

    def __init__(self, name, ptype, default=None, low=None, high=None,
                 required=False, doc="", elem=int, derived=False):
        self.name = name
        self.ptype = ptype
        self.default = default
        self.low = low
        self.high = high
        self.required = required
        self.doc = doc
        self.elem = elem
        self.derived = derived

    def check(self, opname, value):
        """Validate and normalise one value; raises MXNetError naming the
        op and the parameter."""
        def fail(why):
            raise MXNetError("%s: invalid parameter %s=%r — %s"
                             % (opname, self.name, value, why))

        if value is None:
            if self.required:
                fail("a value is required")
            return value
        if self.ptype is None:
            return value
        if isinstance(self.ptype, tuple):
            if value not in self.ptype:
                fail("expected one of %s" % (self.ptype,))
            return value
        if self.ptype is bool:
            if isinstance(value, (bool, int)) or value in (0, 1):
                return bool(value)
            fail("expected a boolean")
        if self.ptype is int:
            if isinstance(value, bool) or \
                    not isinstance(value, numbers.Integral):
                fail("expected an integer")
            self._range(fail, int(value))
            return int(value)
        if self.ptype is float:
            if isinstance(value, bool) or \
                    not isinstance(value, numbers.Real):
                fail("expected a number")
            self._range(fail, float(value))
            return float(value)
        if self.ptype is str:
            if not isinstance(value, str):
                fail("expected a string")
            return value
        if self.ptype is not tuple:
            return value
        cast = self.elem if self.elem is not None else (lambda v: v)
        what = ("a tuple of %ss" % self.elem.__name__
                if self.elem is not None else "a tuple")
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            value = (cast(value),)
        if not isinstance(value, (tuple, list)):
            fail("expected %s" % what)
        try:
            t = tuple(None if v is None else cast(v) for v in value)
        except (TypeError, ValueError):
            fail("expected %s" % what)
        if self.elem is not None:
            for v in t:
                if v is not None:
                    self._range(fail, v)
        return t

    def _range(self, fail, v):
        if self.low is not None and v < self.low:
            fail("below the allowed minimum %s" % self.low)
        if self.high is not None and v > self.high:
            fail("above the allowed maximum %s" % self.high)


def _infer_param(name, default):
    """A signature-derived Param, typed from its default value."""
    if name == "dtype" or default is None:
        return Param(name, None, default=default, derived=True)
    for typ in (bool, int, float, str):
        if isinstance(default, typ):
            return Param(name, typ, default=default, derived=True)
    if isinstance(default, (tuple, list)):
        elem = float if any(isinstance(v, float) for v in default) else int
        return Param(name, tuple, default=tuple(default), elem=elem,
                     derived=True)
    return Param(name, None, default=default, derived=True)


class SigSplit:
    """An op fn's named parameters, classified once.

    required: positional tensor inputs (no default), declaration order
    optional: optional tensor inputs (OPTIONAL_ARRAY_INPUTS present)
    attrs:    {name: default} for keyword attrs (``__*__`` excluded)
    variadic: the fn takes ``*args`` (Concat, add_n): tensors bind by
              call order
    """

    __slots__ = ("required", "optional", "attrs", "variadic")

    def __init__(self, fn):
        self.required, self.optional, self.attrs = [], [], {}
        self.variadic = False
        for p in inspect.signature(fn).parameters.values():
            if p.kind == inspect.Parameter.VAR_POSITIONAL:
                self.variadic = True
                continue
            if p.kind == inspect.Parameter.VAR_KEYWORD:
                continue
            if p.default is inspect.Parameter.empty:
                if p.kind == inspect.Parameter.KEYWORD_ONLY:
                    self.attrs[p.name] = None
                else:
                    self.required.append(p.name)
            elif p.name in OPTIONAL_ARRAY_INPUTS:
                self.optional.append(p.name)
            elif not p.name.startswith("__"):
                self.attrs[p.name] = p.default

    def array_order(self):
        """Tensor-input names in slot order (None for a variadic op)."""
        return None if self.variadic else self.required + self.optional

    def array_names(self):
        return frozenset(self.required) | frozenset(self.optional)


class OpDef:
    """Metadata and implementation of one operator."""

    def __init__(self, name, fn, *, num_outputs=1, aliases=(),
                 needs_is_train=False, needs_rng=False, mutate_aux=(),
                 attr_defaults=None, params=None, free_attrs=False):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs    # int or callable(attrs) -> int
        self.aliases = tuple(aliases)
        self.needs_is_train = needs_is_train
        self.needs_rng = needs_rng
        # inputs that are auxiliary state, returned updated as trailing
        # outputs (BatchNorm moving_mean/moving_var)
        self.mutate_aux = tuple(mutate_aux)
        self.attr_defaults = dict(attr_defaults or {})
        self.free_attrs = free_attrs
        self.sig = SigSplit(fn)
        self.params = {p.name: p for p in (params or ())}
        if not free_attrs:
            for n, default in self.sig.attrs.items():
                if n not in self.mutate_aux and n not in self.params:
                    self.params[n] = _infer_param(
                        n, self.attr_defaults.get(n, default))
            for n, v in self.attr_defaults.items():
                if n not in self.params and not n.startswith("__"):
                    self.params[n] = _infer_param(n, v)
        self.doc = fn.__doc__ or ""

    def validate_attrs(self, attrs):
        """Enforce the parameter table: unknown names raise, naming the
        nearest valid parameter; required params must be present."""
        for k, v in attrs.items():
            if k.startswith("__") or k in _PASSTHROUGH_ATTRS:
                continue
            spec = self.params.get(k)
            if spec is None:
                if self.free_attrs:
                    continue
                close = difflib.get_close_matches(k, self.params, n=1)
                hint = "; did you mean %r?" % close[0] if close else ""
                raise MXNetError(
                    "%s: unknown parameter %r%s  (valid parameters: %s)"
                    % (self.name, k, hint,
                       ", ".join(sorted(self.params)) or "<none>"))
            attrs[k] = spec.check(self.name, v)
        for spec in self.params.values():
            if spec.required and attrs.get(spec.name) is None:
                raise MXNetError("%s: required parameter %r is missing"
                                 % (self.name, spec.name))
        return attrs

    def n_outputs(self, attrs):
        if callable(self.num_outputs):
            return self.num_outputs(attrs)
        return self.num_outputs

    def gen_doc(self):
        lines = [self.doc.strip() or "%s operator." % self.name, "",
                 "Parameters", "----------"]
        for n in self.sig.required:
            lines.append("%s : Symbol (%s)" % (
                n, "aux state" if n in self.mutate_aux else "input"))
        if self.sig.variadic:
            lines.append("*data : Symbol (variadic input)")
        for n in self.sig.optional:
            lines.append("%s : Symbol (optional input)" % n)
        for p in self.params.values():
            lines.append("%s : %s" % (p.name, "required" if p.required
                                      else "default=%r" % (p.default,)))
        return "\n".join(lines)

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name, *, num_outputs=1, aliases=(), needs_is_train=False,
             needs_rng=False, mutate_aux=(), attr_defaults=None,
             params=None, free_attrs=False):
    """Decorator: register a torch function as an operator."""

    def _wrap(fn):
        op = OpDef(name, fn, num_outputs=num_outputs, aliases=aliases,
                   needs_is_train=needs_is_train, needs_rng=needs_rng,
                   mutate_aux=mutate_aux, attr_defaults=attr_defaults,
                   params=params, free_attrs=free_attrs)
        for n in (name,) + tuple(aliases):
            if n in _OP_REGISTRY:
                raise MXNetError("duplicate op registration: %s" % n)
            _OP_REGISTRY[n] = op
        return fn

    return _wrap


def get_op(name):
    op = _OP_REGISTRY.get(name)
    if op is None:
        raise MXNetError("operator %r is not registered in this package "
                         "(it has not been ported yet)" % name)
    return op


def has_op(name):
    return name in _OP_REGISTRY


def list_ops():
    """Every canonical op name (aliases excluded)."""
    return sorted({op.name for op in _OP_REGISTRY.values()})


# ---------------------------------------------------------------------------
# attr coercion: symbol JSON and user kwargs carry attrs as strings
# ("(2,2)", "True", "2e-05"); normalise them to python values.
# ---------------------------------------------------------------------------
_BOOL = {"true": True, "false": False, "True": True, "False": False}


def _coerce(v):
    if not isinstance(v, str):
        return v
    if v in _BOOL:
        return _BOOL[v]
    if v == "None":
        return None
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def coerce_attrs(attrs):
    return {k: _coerce(v) for k, v in attrs.items()}


def normalize_tuple(x, n=None):
    """'(2,2)' | 2 | (2,2) -> tuple; broadcast a scalar to length n."""
    x = _coerce(x)
    if isinstance(x, (list, tuple)):
        t = tuple(None if i is None else int(i) for i in x)
    else:
        t = (int(x),)
    if n is not None and len(t) == 1:
        t = t * n
    return t
