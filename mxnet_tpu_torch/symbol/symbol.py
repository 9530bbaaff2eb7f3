"""Symbol — composable symbolic graph.

Counterpart of ``mxnet_tpu/symbol/symbol.py``: the graph is a Python DAG
of op nodes.  Binding lowers it to one function over tensors that runs
eagerly (there is no jit); shape inference runs the same op functions
on ``meta`` tensors (the counterpart of ``jax.eval_shape``), helped by
per-op parameter-shape hooks that reproduce MXNet's weight-shape
inference.  ``tojson``/``load_json`` (and ``save``/``load``, their
file forms) write and read the JAX package's nnvm JSON schema, so graphs
move between the two packages as JSON.  ``infer_type`` propagates numpy
dtypes as the JAX package does (numpy promotion, ``dtype`` attrs
override), ``bind``/``eval`` run over the ``Executor``, and a node's
``ctx`` attr (creation and sampling ops) is the executor's device.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .._atomic_io import atomic_write
from ..base import MXNetError, dtype_torch
from ..ops.registry import OpDef, coerce_attrs, get_op

__all__ = ["Symbol", "var", "Variable", "Group", "load_json", "load"]


class _SymNode:
    """One graph node: a variable (op=None) or an op application."""

    __slots__ = ("op", "name", "inputs", "attrs")

    def __init__(self, op, name, inputs, attrs):
        self.op = op          # OpDef or None for variables
        self.name = name
        self.inputs = inputs  # list of (_SymNode, out_index)
        self.attrs = attrs    # dict (strings or python values)

    @property
    def is_variable(self):
        return self.op is None

    def num_outputs(self):
        if self.op is None:
            return 1
        return self.op.n_outputs(coerce_attrs(self.attrs))


def _op_input_names(op: OpDef, attrs):
    """Tensor-input names of an op node, in slot order (a variadic op's
    tail is ``"*data"``), with the JAX package's rules for the optional
    inputs."""
    if op.sig.variadic:
        return list(op.sig.required) + ["*data"]
    names = list(op.sig.required)
    a = coerce_attrs(attrs)
    if "bias" in op.sig.optional and not a.get("no_bias", False):
        names.append("bias")
    if "trans" in op.sig.optional and not a.get("no_trans", False):
        names.append("trans")
    if op.name == "RNN" and a.get("mode") == "lstm":
        names.append("state_cell")
    if op.name == "LeakyReLU" and a.get("act_type") != "prelu" \
            and "gamma" in names:
        names.remove("gamma")
    if op.name in ("SequenceMask", "SequenceLast", "SequenceReverse") \
            and a.get("use_sequence_length"):
        names.append("sequence_length")
    return names


def _visible_attrs(node):
    """An op node's attrs as op-function kwargs: the op's
    ``attr_defaults``, then the node's attrs coerced from strings, minus
    the ``__*__`` scope attrs."""
    kw = dict(node.op.attr_defaults)
    kw.update({k: v for k, v in coerce_attrs(node.attrs).items()
               if not k.startswith("__")})
    return kw


def _np_dtype(dt):
    """A dtype as ``numpy.dtype``, or the name ``"bfloat16"``, which
    numpy lacks."""
    if isinstance(dt, torch.dtype):
        dt = str(dt).replace("torch.", "")
    if isinstance(dt, str) and dt == "bfloat16":
        return "bfloat16"
    return np.dtype(dt)


def _promote(dts):
    """numpy's result type of ``dts``, or torch's where bfloat16 is among
    them."""
    if any(isinstance(d, str) for d in dts):
        out = dtype_torch(dts[0])
        for d in dts[1:]:
            out = torch.promote_types(out, dtype_torch(d))
        return _np_dtype(out)
    return np.result_type(*dts)





class Symbol:
    """A (multi-)output handle onto the symbolic graph."""

    __slots__ = ("_heads",)

    def __init__(self, heads):
        self._heads = list(heads)  # list of (_SymNode, out_idx)

    @property
    def name(self):
        if len(self._heads) == 1:
            return self._heads[0][0].name
        return None

    def attr(self, key):
        """The head node's attr ``key`` (a string), or None."""
        return self._heads[0][0].attrs.get(key)

    def list_attr(self):
        """The head node's string attrs."""
        return {k: v for k, v in self._heads[0][0].attrs.items()
                if isinstance(v, str)}

    def _set_attr(self, **kwargs):
        self._heads[0][0].attrs.update(kwargs)

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "group")

    def __iter__(self):
        for i in range(len(self.list_outputs())):
            yield self[i]

    def __len__(self):
        return len(self.list_outputs())

    def _flat_outputs(self):
        return list(self._heads)

    def __getitem__(self, index):
        """The output at ``index`` (an int, a slice, or an output name)."""
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("no output named %r in %s" % (index, names))
            index = names.index(index)
        if isinstance(index, slice):
            return Symbol(self._heads[index])
        return Symbol([self._heads[index]])

    # -- graph walking ------------------------------------------------------
    def _topo(self):
        seen, order = set(), []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for (src, _) in node.inputs:
                visit(src)
            order.append(node)

        for node, _ in self._heads:
            visit(node)
        return order

    def get_internals(self):
        """A symbol whose outputs are every node's outputs, in graph order
        (reference: symbol.py get_internals)."""
        return Symbol([(node, i) for node in self._topo()
                       for i in range(node.num_outputs())])

    def get_children(self):
        """The head node's inputs as one symbol, or None for a
        variable."""
        node = self._heads[0][0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    def list_inputs(self):
        """Every variable, aux states included, in topo order."""
        return [n.name for n in self._topo() if n.is_variable]

    def list_arguments(self):
        """Variables excluding aux states, topo order."""
        aux = self._aux_nodes()
        return [n.name for n in self._topo()
                if n.is_variable and id(n) not in aux]

    def list_outputs(self):
        outs = []
        for node, idx in self._heads:
            if node.is_variable:
                outs.append(node.name)
            else:
                outs.append("%s_output" % node.name
                            if node.num_outputs() == 1
                            else "%s_output%d" % (node.name, idx))
        return outs

    def attr_dict(self):
        """``{node name: {attr: str value}}`` of every node that has
        attrs (the optimizer reads ``__lr_mult__``/``__wd_mult__`` here,
        the initializer ``__init__``)."""
        out = {}
        for node in self._topo():
            d = {k: str(v) for k, v in node.attrs.items()}
            if d:
                out[node.name] = d
        return out

    def _aux_nodes(self):
        """ids of variable nodes feeding mutate_aux positions."""
        aux = set()
        for node in self._topo():
            if node.is_variable or not node.op.mutate_aux:
                continue
            names = _op_input_names(node.op, node.attrs)
            for pname, (src, _) in zip(names, node.inputs):
                if pname in node.op.mutate_aux and src.is_variable:
                    aux.add(id(src))
        return aux

    def list_auxiliary_states(self):
        aux = self._aux_nodes()
        return [n.name for n in self._topo()
                if n.is_variable and id(n) in aux]

    # -- composition --------------------------------------------------------
    def _binop(self, other, op, scalar_op, reverse=False):
        from . import _make_symbol_call
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _make_symbol_call(op, [a, b], {})
        return _make_symbol_call(scalar_op, [self], {"scalar": float(other)})

    def __add__(self, other):
        return self._binop(other, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        if isinstance(other, Symbol):
            return other.__sub__(self)
        return self._binop(other, None, "_rminus_scalar")

    def __mul__(self, other):
        return self._binop(other, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, other):
        if isinstance(other, Symbol):
            return other.__truediv__(self)
        return self._binop(other, None, "_rdiv_scalar")

    def __pow__(self, other):
        return self._binop(other, "_power", "_power_scalar")

    def __neg__(self):
        return self._binop(-1.0, None, "_mul_scalar")

    def __eq__(self, other):
        if isinstance(other, (Symbol, int, float)):
            return self._binop(other, "_equal", "_equal_scalar")
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, (Symbol, int, float)):
            return self._binop(other, "_not_equal", "_not_equal_scalar")
        return NotImplemented

    def __gt__(self, other):
        return self._binop(other, "_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binop(other, "_greater_equal", "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binop(other, "_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binop(other, "_lesser_equal", "_lesser_equal_scalar")

    __hash__ = object.__hash__

    def __copy__(self):
        return Symbol(list(self._heads))

    def __deepcopy__(self, memo):
        return load_json(self.tojson())

    # -- fluent forms of common ops (the rest are attached in __init__) -----
    def reshape(self, shape, **kw):
        from . import _make_symbol_call
        return _make_symbol_call("Reshape", [self], {"shape": shape, **kw})

    def transpose(self, axes=None):
        from . import _make_symbol_call
        return _make_symbol_call("transpose", [self],
                                 {"axes": axes} if axes else {})

    def sum(self, axis=None, keepdims=False):
        from . import _make_symbol_call
        return _make_symbol_call("sum", [self], {"axis": axis,
                                                 "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        from . import _make_symbol_call
        return _make_symbol_call("mean", [self], {"axis": axis,
                                                  "keepdims": keepdims})

    def astype(self, dtype):
        from . import _make_symbol_call
        return _make_symbol_call("Cast", [self], {"dtype": dtype})

    def slice_axis(self, axis, begin, end):
        from . import _make_symbol_call
        return _make_symbol_call("slice_axis", [self], {
            "axis": axis, "begin": begin, "end": end})

    def __call__(self, *args, **kwargs):
        """Compose: replace variable inputs with the given symbols."""
        s = self.__copy__()
        s._compose(*args, **kwargs)
        return s

    def _compose(self, *args, **kwargs):
        kwargs.pop("name", None)
        mapping = {}
        if args:
            free = [n for n in self._topo() if n.is_variable]
            for node, repl in zip(free, args):
                mapping[id(node)] = repl._heads[0]
        for k, v in kwargs.items():
            for node in self._topo():
                if node.is_variable and node.name == k:
                    mapping[id(node)] = v._heads[0]
        if not mapping:
            return
        memo = {}

        def rebuild(node):
            if id(node) in memo:
                return memo[id(node)]
            if id(node) in mapping:
                res = mapping[id(node)][0]
            elif node.is_variable:
                res = node
            else:
                res = _SymNode(node.op, node.name,
                               [(rebuild(s), i) for (s, i) in node.inputs],
                               dict(node.attrs))
            memo[id(node)] = res
            return res

        self._heads = [(rebuild(n), i) for (n, i) in self._heads]

    # -- inference and binding ----------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """Reference: symbol.py infer_shape.  Returns (arg_shapes,
        out_shapes, aux_shapes) in list order."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """``infer_shape`` that leaves what it cannot infer as None
        instead of raising."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        known = {}
        for name, shp in zip(self.list_arguments(), args):
            if shp is not None:
                known[name] = tuple(shp)
        known.update({k: tuple(v) for k, v in kwargs.items()})
        shapes, aux_shapes = _infer_graph(self, known, partial=partial)
        return ([shapes.get(n) for n in self.list_arguments()],
                [shapes.get(("out", id(n), i)) for (n, i) in self._heads],
                [aux_shapes.get(n) for n in self.list_auxiliary_states()])

    def infer_type(self, *args, **kwargs):
        """Reference: symbol.py infer_type, as the JAX package computes
        it: dtypes propagate from the given inputs (else a variable's
        ``__dtype__``, else the first given dtype, else float32) by
        numpy's promotion, a ``dtype`` attr (Cast, creation ops)
        overriding; aux states are float32.  Returns (arg_types,
        out_types, aux_types) of ``numpy.dtype`` (bfloat16 by name)."""
        known = {}
        for name, dt in zip(self.list_arguments(), args):
            if dt is not None:
                known[name] = _np_dtype(dtype_torch(dt) if not isinstance(
                    dt, str) else dt)
        known.update({k: _np_dtype(v if isinstance(v, str)
                                   else dtype_torch(v))
                      for k, v in kwargs.items()})
        default = next(iter(known.values()), np.dtype(np.float32))
        node_dtype = {}
        for node in self._topo():
            if node.is_variable:
                if node.name in known:
                    node_dtype[id(node)] = known[node.name]
                elif "__dtype__" in node.attrs:
                    node_dtype[id(node)] = _np_dtype(node.attrs["__dtype__"])
                else:
                    node_dtype[id(node)] = default
                continue
            attrs = coerce_attrs(node.attrs)
            if attrs.get("dtype"):
                node_dtype[id(node)] = _np_dtype(attrs["dtype"])
                continue
            in_dts = [node_dtype.get(id(src), default)
                      for (src, _i) in node.inputs]
            try:
                node_dtype[id(node)] = _promote(in_dts) if in_dts \
                    else default
            except TypeError:
                node_dtype[id(node)] = default
        arg_types = []
        for n in self.list_arguments():
            node = next(x for x in self._topo()
                        if x.is_variable and x.name == n)
            if n in known:
                arg_types.append(known[n])
            elif "__dtype__" in node.attrs:
                arg_types.append(_np_dtype(node.attrs["__dtype__"]))
            else:
                arg_types.append(np.dtype(np.float32))
        out_types = [node_dtype.get(id(node), default)
                     for node, _ in self._flat_outputs()]
        aux_types = [np.dtype(np.float32)
                     for _ in self.list_auxiliary_states()]
        return arg_types, out_types, aux_types

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """Bind given arrays (reference: symbol.py:1548): ``args`` (and
        ``args_grad``, ``aux_states``) a list in argument order or a
        dict; aux states not given start at zeros.  The executor uses
        the arrays themselves, not copies."""
        from ..executor import Executor
        return Executor._bind(self, ctx, args, args_grad, grad_req,
                              aux_states)

    def eval(self, ctx=None, **kwargs):
        """Bind ``kwargs`` as the arguments and run one forward; returns
        the outputs.  ``ctx`` defaults to the current context."""
        return self.bind(ctx, kwargs).forward()

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, *,
                    compute_dtype=None, cast_exclude=(), **kwargs):
        """Allocate every argument, aux state and (for a ``grad_req`` of
        write or add: a string, a list in argument order or a dict) the
        gradient buffers from the inferred shapes, and bind (reference:
        symbol.py:1284).  ``ctx`` defaults to the current context;
        ``grad_req`` defaults to ``write``, as in MXNet.

        ``stype_dict`` is taken and, as in the JAX package, every array
        is bound dense; ``group2ctx`` takes only the one device the
        executor runs on.  ``shared_arg_names`` and ``shared_buffer`` are
        accepted and, as in the JAX package, not used.

        ``compute_dtype="bfloat16"`` turns on the executor's
        mixed-precision policy (fp32 masters, bf16 compute); the names in
        ``cast_exclude`` (labels) stay fp32.  With ``shared_exec`` each
        argument and aux state that it holds at the same shape is its
        NDArray, shared."""
        from ..executor import Executor
        from ..context import Context, current_context
        if group2ctx:
            devices = {Context(c) for c in group2ctx.values()}
            devices.add(Context(ctx if ctx is not None
                                else current_context()))
            if len(devices) > 1:
                raise MXNetError(
                    "simple_bind: group2ctx places the graph on %d devices "
                    "(%s); this package binds an executor on one device"
                    % (len(devices), sorted(map(str, devices))))
        return Executor._simple_bind(self, ctx, grad_req, type_dict, kwargs,
                                     compute_dtype, cast_exclude,
                                     shared_exec)

    # -- serialization ------------------------------------------------------
    def tojson(self):
        """The JAX package's nnvm JSON schema, byte for byte."""
        nodes = self._topo()
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": "null" if n.is_variable else n.op.name,
                "name": n.name,
                "attrs": {k: str(v) for k, v in n.attrs.items()},
                "inputs": [[nid[id(s)], i, 0] for (s, i) in n.inputs],
            })
        arg_nodes = [i for i, n in enumerate(nodes) if n.is_variable]
        heads = [[nid[id(n)], i, 0] for (n, i) in self._heads]
        return json.dumps({
            "nodes": jnodes, "arg_nodes": arg_nodes, "heads": heads,
            "attrs": {"mxnet_version": ["int", 10200]},
        }, indent=2)

    def save(self, fname):
        """Write ``tojson()`` to ``fname``, atomically: the
        ``-symbol.json`` half of a checkpoint never exists half
        written."""
        atomic_write(fname, self.tojson(), mode="w")

    def debug_str(self):
        """One line per node: its op (or Variable), name and inputs."""
        return "\n".join(
            "%s %s <- %s" % ("Variable" if n.is_variable else n.op.name,
                             n.name, [s.name for (s, _) in n.inputs])
            for n in self._topo())


# ---------------------------------------------------------------------------
# graph lowering and inference (the executor uses these)
# ---------------------------------------------------------------------------
def _bn_relu_peephole(symbol, nodes, is_train, device):
    """Eval-graph BatchNorm -> Activation(relu) fusion plan, with the JAX
    package's matching rules: the BatchNorm's only consumer is a relu
    Activation, it normalises axis 1 without ``output_mean_var``, no
    output of it is a graph head, and its mean/var outputs are unused.
    Returns ``(skip, fuse)``: BatchNorm node ids to defer, and
    {activation node id: its BatchNorm node}.  Empty in training and
    when ``MXNET_PALLAS_BN_RELU`` is off for ``device``."""
    from ..ops.cuda_kernels import family_enabled
    if is_train or not family_enabled("MXNET_PALLAS_BN_RELU", device):
        return frozenset(), {}
    consumers = {}
    for n in nodes:
        if n.is_variable:
            continue
        for (src, oi) in n.inputs:
            consumers.setdefault((id(src), oi), []).append(n)
    heads = {(id(n), i) for (n, i) in symbol._flat_outputs()}
    skip, fuse = set(), {}
    for node in nodes:
        if node.is_variable or node.op.name != "Activation":
            continue
        if coerce_attrs(node.attrs).get("act_type") != "relu":
            continue
        src, oi = node.inputs[0]
        if oi != 0 or src.is_variable or src.op.name != "BatchNorm":
            continue
        battrs = coerce_attrs(src.attrs)
        if int(battrs.get("axis", 1)) != 1 or battrs.get("output_mean_var"):
            continue
        if any((id(src), i) in heads for i in range(3)):
            continue
        if len(consumers.get((id(src), 0), ())) != 1:
            continue
        # outputs 1/2 (mean/var) must be unused: skipping the BN node
        # leaves their env slots unpopulated
        if consumers.get((id(src), 1)) or consumers.get((id(src), 2)):
            continue
        skip.add(id(src))
        fuse[id(node)] = src
    return frozenset(skip), fuse


def build_graph_fn(symbol, arg_names, aux_names, device, is_train=False):
    """Lower the symbol DAG to one function over tensors on ``device``
    (which decides the ``auto`` kernel knobs).

    In eval mode ``fn(arg_list, aux_list) -> outputs``, with the
    BatchNorm->ReLU peephole.  With ``is_train`` the ops see
    ``__is_train__=True`` (BatchNorm normalises by the batch's stats),
    the peephole is off, and ``fn(arg_list, aux_list) -> (outputs,
    new_aux)``: the aux list with each ``mutate_aux`` input replaced by
    its op's updated value (BatchNorm's new moving stats), for the
    executor to write back.

    ``fn(..., tap=callback)`` also hands every op node's visible outputs,
    as they are computed, to ``callback(name, tensor)`` under the names
    of ``get_internals().list_outputs()`` (the monitor's taps).  A
    BatchNorm the peephole folds into its ReLU is computed for the tap
    alone; nothing the graph computes changes."""
    nodes = symbol._topo()
    aux_index = {name: i for i, name in enumerate(aux_names)}
    arg_index = {name: i for i, name in enumerate(arg_names)}
    bn_skip, bn_fuse = _bn_relu_peephole(symbol, nodes, is_train, device)
    plans = {id(n): _visible_attrs(n) for n in nodes if not n.is_variable}
    # (node id) -> [(aux list index, trailing output index)]
    writeback = {}
    for n in nodes:
        if n.is_variable or not n.op.mutate_aux:
            continue
        names = _op_input_names(n.op, n.attrs)
        n_aux = len(n.op.mutate_aux)
        for k, pname in enumerate(n.op.mutate_aux):
            for nm, (src, _) in zip(names, n.inputs):
                if nm == pname and src.is_variable \
                        and src.name in aux_index:
                    writeback.setdefault(id(n), []).append(
                        (aux_index[src.name], k - n_aux))

    dev = torch.device(device)
    rng = None
    if any(n.op.needs_rng for n in nodes if not n.is_variable):
        from ..random import generator
        rng = generator(dev)

    def emit(tap, node, outs):
        if node.num_outputs() == 1:
            tap("%s_output" % node.name, outs[0].detach())
            return
        for i in range(node.num_outputs()):
            tap("%s_output%d" % (node.name, i), outs[i].detach())

    def fn(args, aux, tap=None):
        env = {}
        new_aux = list(aux)
        for node in nodes:
            if node.is_variable:
                if node.name in aux_index:
                    env[(id(node), 0)] = aux[aux_index[node.name]]
                elif node.name in arg_index:
                    env[(id(node), 0)] = args[arg_index[node.name]]
                else:
                    raise MXNetError("unbound variable %s" % node.name)
                continue
            if id(node) in bn_skip:
                # deferred into the fused Activation below; in eval the
                # moving stats are untouched, so nothing is lost
                if tap is not None:
                    emit(tap, node, node.op.fn(
                        *[env[(id(s), i)] for (s, i) in node.inputs],
                        **plans[id(node)]))
                continue
            if id(node) in bn_fuse:
                bn = bn_fuse[id(node)]
                ins = [env[(id(s), i)] for (s, i) in bn.inputs]
                battrs = plans[id(bn)]
                if ins[0].dim() == 4:
                    from ..ops.nn import fused_bn_relu_eval
                    out = fused_bn_relu_eval(
                        *ins, eps=float(battrs.get("eps", 1e-3)),
                        fix_gamma=bool(battrs.get("fix_gamma", True)))
                else:
                    # non-4D data: run the pair unfused
                    out = torch.relu(bn.op.fn(*ins, **battrs)[0])
                env[(id(node), 0)] = out
                if tap is not None:
                    emit(tap, node, (out,))
                continue
            op = node.op
            kw = dict(plans[id(node)])
            if op.needs_is_train:
                kw["__is_train__"] = is_train
            if op.needs_rng:
                kw["__rng__"] = rng
            if "ctx" in op.sig.attrs:
                kw["ctx"] = dev
            outs = op.fn(*[env[(id(s), i)] for (s, i) in node.inputs], **kw)
            if not isinstance(outs, tuple):
                outs = (outs,)
            for ai, oi in writeback.get(id(node), ()):
                new_aux[ai] = outs[oi]
            for i, o in enumerate(outs[:len(outs) - len(op.mutate_aux)]):
                env[(id(node), i)] = o
            if tap is not None:
                emit(tap, node, outs)
        outputs = [env[(id(n), i)] for (n, i) in symbol._flat_outputs()]
        return (outputs, new_aux) if is_train else outputs

    return fn


def _infer_graph(symbol, known_shapes, partial=False):
    """Topo-walk shape inference: each op runs on ``meta`` tensors, and
    parameter-shape hooks fill in unknown weight shapes.  Returns
    ``(shapes, aux_shapes)``: variable name -> shape, plus
    ``("out", node id, index)`` -> shape for every graph head (None
    where ``partial`` let a node go uninferred)."""
    nodes = symbol._topo()
    shapes = dict(known_shapes)
    env = {}   # (node id, out index) -> meta tensor
    aux_names = set(symbol.list_auxiliary_states())
    aux_shapes = {}

    def meta(shp, attrs):
        dt = dtype_torch(attrs["__dtype__"]) if "__dtype__" in attrs \
            else torch.float32
        return torch.empty(tuple(int(d) for d in shp), dtype=dt,
                           device="meta")

    for node in nodes:
        if node.is_variable:
            shp = shapes.get(node.name)
            if shp is None and "__shape__" in node.attrs:
                shp = tuple(coerce_attrs(node.attrs)["__shape__"])
            if shp is not None:
                env[(id(node), 0)] = meta(shp, node.attrs)
                shapes[node.name] = tuple(shp)
                if node.name in aux_names:
                    aux_shapes[node.name] = tuple(shp)
            continue
        op = node.op
        attrs = _visible_attrs(node)
        names = _op_input_names(op, node.attrs)
        hook = _PARAM_SHAPE_HOOKS.get(op.name)
        if hook is not None:
            ins_known = {nm: tuple(env[(id(src), i)].shape)
                         for nm, (src, i) in zip(names, node.inputs)
                         if (id(src), i) in env}
            try:
                inferred = hook(attrs, ins_known)
            except (KeyError, TypeError):
                inferred = {}
            for nm, (src, i) in zip(names, node.inputs):
                if (id(src), i) not in env and nm in inferred \
                        and src.is_variable:
                    shp = tuple(int(d) for d in inferred[nm])
                    env[(id(src), i)] = meta(shp, src.attrs)
                    shapes[src.name] = shp
                    if src.name in aux_names:
                        aux_shapes[src.name] = shp
        missing = [s.name for (s, i) in node.inputs if (id(s), i) not in env]
        if missing and partial:
            continue
        if missing:
            raise MXNetError("cannot infer shape for inputs %s of node %s "
                             "(%s)" % (missing, node.name, op.name))
        kw = dict(attrs)
        if op.needs_is_train:
            kw["__is_train__"] = False
        if "ctx" in op.sig.attrs:
            kw["ctx"] = torch.device("meta")
        try:
            outs = op.fn(*[env[(id(s), i)] for (s, i) in node.inputs], **kw)
        except MXNetError:
            raise
        except Exception as exc:
            raise MXNetError(
                "shape inference failed at node %r (op %s) with input "
                "shapes %s: %s"
                % (node.name, op.name,
                   [tuple(env[(id(s), i)].shape) for (s, i) in node.inputs],
                   exc)) from exc
        if not isinstance(outs, tuple):
            outs = (outs,)
        for i, o in enumerate(outs[:len(outs) - len(op.mutate_aux)]):
            env[(id(node), i)] = o
    for (n, i) in symbol._flat_outputs():
        t = env.get((id(n), i))
        shapes[("out", id(n), i)] = tuple(t.shape) if t is not None else None
    return shapes, aux_shapes


# per-op parameter-shape inference (the FInferShape weight logic)
def _fc_shapes(attrs, known):
    d = known["data"]
    in_dim = int(np.prod(d[1:])) if attrs.get("flatten", True) else d[-1]
    out = {"weight": (attrs["num_hidden"], in_dim)}
    if not attrs.get("no_bias", False):
        out["bias"] = (attrs["num_hidden"],)
    return out


def _conv_shapes(attrs, known):
    d = known["data"]
    k = attrs["kernel"]
    if isinstance(k, int):
        k = (k,)
    nf = attrs["num_filter"]
    out = {"weight": (nf, d[1] // attrs.get("num_group", 1)) + tuple(k)}
    if not attrs.get("no_bias", False):
        out["bias"] = (nf,)
    return out


def _deconv_shapes(attrs, known):
    d = known["data"]
    k = attrs["kernel"]
    if isinstance(k, int):
        k = (k,)
    nf = attrs["num_filter"]
    out = {"weight": (d[1], nf // attrs.get("num_group", 1)) + tuple(k)}
    if not attrs.get("no_bias", True):
        out["bias"] = (nf,)
    return out


def _ln_shapes(attrs, known):
    c = known["data"][attrs.get("axis", -1)]
    return {"gamma": (c,), "beta": (c,)}


def _in_shapes(attrs, known):
    c = known["data"][1]
    return {"gamma": (c,), "beta": (c,)}


def _embed_shapes(attrs, known):
    return {"weight": (attrs["input_dim"], attrs["output_dim"])}


def _prelu_shapes(attrs, known):
    if attrs.get("act_type") == "prelu":
        d = known["data"]
        return {"gamma": (d[1] if len(d) > 1 else 1,)}
    return {}


def _regression_label_shapes(attrs, known):
    return {"label": tuple(known["data"])}


def _svm_label_shapes(attrs, known):
    return {"label": (known["data"][0],)}


def _bn_shapes(attrs, known):
    c = known["data"][attrs.get("axis", 1)]
    return {"gamma": (c,), "beta": (c,), "moving_mean": (c,),
            "moving_var": (c,)}


def _rnn_shapes(attrs, known):
    from ..ops.nn import rnn_param_size
    d = known["data"]
    L, H = attrs["num_layers"], attrs["state_size"]
    D = 2 if attrs.get("bidirectional", False) else 1
    mode = attrs.get("mode", "lstm")
    out = {"params": (rnn_param_size(mode, L, d[2], H, D),),
           "state": (L * D, d[1], H)}
    if mode == "lstm":
        out["state_cell"] = (L * D, d[1], H)
    return out


def _softmax_output_shapes(attrs, known):
    d = known["data"]
    if attrs.get("multi_output", False):
        return {"label": (d[0],) + tuple(d[2:])}
    return {"label": tuple(d[:-1])}


_PARAM_SHAPE_HOOKS = {
    "SoftmaxOutput": _softmax_output_shapes,
    "LinearRegressionOutput": _regression_label_shapes,
    "LogisticRegressionOutput": _regression_label_shapes,
    "MAERegressionOutput": _regression_label_shapes,
    "SVMOutput": _svm_label_shapes,
    "FullyConnected": _fc_shapes,
    "Convolution": _conv_shapes,
    "Convolution_v1": _conv_shapes,
    "Deconvolution": _deconv_shapes,
    "BatchNorm": _bn_shapes,
    "BatchNorm_v1": _bn_shapes,
    "LayerNorm": _ln_shapes,
    "InstanceNorm": _in_shapes,
    "Embedding": _embed_shapes,
    "LeakyReLU": _prelu_shapes,
    "RNN": _rnn_shapes,
}


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------
def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs):
    """Create a variable symbol (reference: symbol.py var), with the
    current ``AttrScope``'s attrs.  ``stype`` is taken and, as in the JAX
    package, the variable binds dense."""
    from ..attribute import AttrScope
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attrs = dict(AttrScope.current().get(attr or {}))
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        attrs["__dtype__"] = str(dtype_torch(dtype)).replace("torch.", "")
    if lr_mult is not None:
        attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attrs["__wd_mult__"] = str(wd_mult)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    attrs.update({k: str(v) for k, v in kwargs.items()})
    return Symbol([(_SymNode(None, name, [], attrs), 0)])


Variable = var


def Group(symbols):
    heads = []
    for s in symbols:
        heads.extend(s._flat_outputs())
    return Symbol(heads)


def load_json(json_str):
    """Reconstruct a Symbol from nnvm JSON."""
    g = json.loads(json_str)
    nodes = []
    for jn in g["nodes"]:
        attrs = jn.get("attrs", jn.get("param", {})) or {}
        if jn["op"] == "null":
            nodes.append(_SymNode(None, jn["name"], [], dict(attrs)))
        else:
            inputs = [(nodes[i[0]], i[1]) for i in jn["inputs"]]
            nodes.append(_SymNode(get_op(jn["op"]), jn["name"], inputs,
                                  dict(attrs)))
    return Symbol([(nodes[h[0]], h[1]) for h in g["heads"]])


def load(fname):
    """Read a symbol from a JSON file (reference: mx.sym.load)."""
    with open(fname) as f:
        return load_json(f.read())
