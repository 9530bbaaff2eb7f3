"""Symbol — composable symbolic graph.

Counterpart of ``mxnet_tpu/symbol/symbol.py``: the graph is a Python DAG
of op nodes.  Binding lowers it to one function over tensors that runs
eagerly (there is no jit); shape inference runs the same op functions
on ``meta`` tensors (the counterpart of ``jax.eval_shape``), helped by
per-op parameter-shape hooks that reproduce MXNet's weight-shape
inference.  ``tojson``/``load_json`` (and ``save``/``load``, their
file forms) write and read the JAX package's nnvm JSON schema, so graphs
move between the two packages as JSON.
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
    """Tensor-input names of an op node, in slot order."""
    names = list(op.sig.required)
    if "bias" in op.sig.optional and \
            not coerce_attrs(attrs).get("no_bias", False):
        names.append("bias")
    return names


def _visible_attrs(node):
    """An op node's attrs as op-function kwargs: coerced from strings,
    minus the ``__*__`` scope attrs."""
    return {k: v for k, v in coerce_attrs(node.attrs).items()
            if not k.startswith("__")}


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

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "group")

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
    def __add__(self, other):
        if not isinstance(other, Symbol):
            raise MXNetError("Symbol + %s: only Symbol + Symbol "
                             "(elemwise_add) is ported" % type(other).__name__)
        from . import _make_symbol_call
        return _make_symbol_call("elemwise_add", [self, other], {})

    __hash__ = object.__hash__

    def __copy__(self):
        return Symbol(list(self._heads))

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
        known = {}
        for name, shp in zip(self.list_arguments(), args):
            if shp is not None:
                known[name] = tuple(shp)
        known.update({k: tuple(v) for k, v in kwargs.items()})
        shapes, aux_shapes = _infer_graph(self, known)
        return ([shapes.get(n) for n in self.list_arguments()],
                [shapes[("out", id(n), i)] for (n, i) in self._heads],
                [aux_shapes.get(n) for n in self.list_auxiliary_states()])

    def simple_bind(self, ctx=None, grad_req="null", type_dict=None,
                    **kwargs):
        """Allocate every argument, aux state and (for a ``grad_req`` of
        write or add: a string, a list in argument order or a dict) the
        gradient buffers from the inferred shapes, and bind (reference:
        symbol.py:1284).  ``ctx`` defaults to ``gpu(0)``."""
        from ..executor import Executor
        return Executor._simple_bind(self, ctx, grad_req, type_dict, kwargs)

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
    executor to write back."""
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

    def fn(args, aux):
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
                continue
            op = node.op
            kw = dict(plans[id(node)])
            if op.needs_is_train:
                kw["__is_train__"] = is_train
            outs = op.fn(*[env[(id(s), i)] for (s, i) in node.inputs], **kw)
            if not isinstance(outs, tuple):
                outs = (outs,)
            for ai, oi in writeback.get(id(node), ()):
                new_aux[ai] = outs[oi]
            for i, o in enumerate(outs[:len(outs) - len(op.mutate_aux)]):
                env[(id(node), i)] = o
        outputs = [env[(id(n), i)] for (n, i) in symbol._flat_outputs()]
        return (outputs, new_aux) if is_train else outputs

    return fn


def _infer_graph(symbol, known_shapes):
    """Topo-walk shape inference: each op runs on ``meta`` tensors, and
    parameter-shape hooks fill in unknown weight shapes.  Returns
    ``(shapes, aux_shapes)``: variable name -> shape, plus
    ``("out", node id, index)`` -> shape for every graph head."""
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
        if missing:
            raise MXNetError("cannot infer shape for inputs %s of node %s "
                             "(%s)" % (missing, node.name, op.name))
        kw = dict(attrs)
        if op.needs_is_train:
            kw["__is_train__"] = False
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
        shapes[("out", id(n), i)] = tuple(env[(id(n), i)].shape)
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


def _bn_shapes(attrs, known):
    c = known["data"][attrs.get("axis", 1)]
    return {"gamma": (c,), "beta": (c,), "moving_mean": (c,),
            "moving_var": (c,)}


def _softmax_output_shapes(attrs, known):
    d = known["data"]
    if attrs.get("multi_output", False):
        return {"label": (d[0],) + tuple(d[2:])}
    return {"label": tuple(d[:-1])}


_PARAM_SHAPE_HOOKS = {
    "SoftmaxOutput": _softmax_output_shapes,
    "FullyConnected": _fc_shapes,
    "Convolution": _conv_shapes,
    "Convolution_v1": _conv_shapes,
    "BatchNorm": _bn_shapes,
    "BatchNorm_v1": _bn_shapes,
}


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------
def var(name, attr=None, shape=None, dtype=None, **kwargs):
    """Create a variable symbol."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attrs = dict(attr or {})
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        attrs["__dtype__"] = str(dtype_torch(dtype)).replace("torch.", "")
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
