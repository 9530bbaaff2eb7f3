"""Gluon Block and HybridBlock.

Counterpart of ``mxnet_tpu/gluon/block.py`` (reference:
python/mxnet/gluon/block.py Block:123, HybridBlock:428): ``_BlockScope``
gives every block and parameter the reference's names
(``transformerlm0_blocks_transformerencodercell0_layernorm0_gamma``), a
block registers its children and parameters as attributes are set, and
``HybridBlock.forward`` runs ``hybrid_forward(nd, x, **params)``,
finishing deferred parameter shapes through the block's
``_shape_hook`` on the first call.  ``save_parameters``/
``load_parameters`` write and read the ``nd.save`` container with the
root prefix stripped, so the JAX package's files load here and the other
way round.

``hybridize()`` sets the flag and the forward stays the same eager
``hybrid_forward``: PyTorch queues each op on the stream as it is called,
so there is no program to trace; a CUDA graph per input shape is the
counterpart of the JAX package's jit cache, for a later change.
"""
from __future__ import annotations

import re
import threading
import warnings

import torch

from .. import autograd, ndarray
from ..context import current_context
from ..name import NameManager
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope:
    """Name manager for Blocks (reference: block.py:33)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """The prefix and ParameterDict of a new block (reference:
        block.py:41): a root block counts per ``hint`` in the thread's
        NameManager, a child per hint within its parent's scope."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = NameManager.current().get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


class Block:
    """Base building block (reference: block.py:123)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = {}
        self._reg_params = {}

    def __repr__(self):
        children = "\n".join("  (%s): %s" % (k, v)
                             for k, v in self._children.items())
        return "%s(\n%s\n)" % (type(self).__name__, children)

    def __setattr__(self, name, value):
        """Registers parameters and children."""
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)):
                raise TypeError("Changing attribute type for %s from %s to "
                                "%s is not allowed." % (name, type(existing),
                                                        type(value)))
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            if name in self._reg_params:
                raise ValueError(
                    "Overriding Parameter attribute %s is not allowed. To "
                    "share parameters between blocks, set 'params' at Block "
                    "construction instead." % name)
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def _alias(self):
        return type(self).__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        """The scope in which child blocks take this block's prefix."""
        return self._scope

    @property
    def params(self):
        """This block's own ParameterDict."""
        return self._params

    def collect_params(self, select=None):
        """The parameters of this block and its children, in creation
        order; with ``select``, only those whose name a regular
        expression matches (``re.match``; reference: block.py:186)."""
        self._check_container_with_block()
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for cld in self._children.values():
            ret.update(cld.collect_params(select=select))
        return ret

    def _check_container_with_block(self):
        """Warn of Blocks held in a public list, tuple or dict attribute
        and not registered as children: their parameters are not
        collected."""
        children = set(self._children.values())
        for k, v in self.__dict__.items():
            if isinstance(v, (list, tuple, dict)) and not k.startswith("_"):
                for i in (v.values() if isinstance(v, dict) else v):
                    if isinstance(i, Block) and i not in children:
                        warnings.warn(
                            '"%s.%s" is an unregistered container with '
                            "Blocks. Note that Blocks inside the list, "
                            "tuple or dict will not be registered "
                            "automatically. Make sure to register them "
                            "using register_child() or switching to "
                            "nn.Sequential/nn.HybridSequential instead."
                            % (type(self).__name__, k), stacklevel=3)

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def apply(self, fn):
        """Call ``fn`` on every child, depth first, then on this block
        (reference: block.py apply)."""
        for cld in self._children.values():
            cld.apply(fn)
        fn(self)
        return self

    def save_params(self, fname):
        """Save every parameter under its name less this block's prefix
        (reference: gluon/block.py:307)."""
        self.collect_params().save(fname, strip_prefix=self.prefix)

    def load_params(self, fname, ctx=None, allow_missing=False,
                    ignore_extra=False):
        """Load what ``save_params`` wrote (reference: gluon/block.py:317);
        parameters not yet initialized are created on ``ctx`` (default
        the current context)."""
        self.collect_params().load(fname, ctx, allow_missing, ignore_extra,
                                   self.prefix)

    save_parameters = save_params
    load_parameters = load_params

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default the current
        context, ``gpu(0)`` outside a ``with`` block, which raises without
        a GPU) with ``init`` as the default initializer (``Uniform()``
        when None)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        """Recurses to the children and changes nothing else: every block
        runs the same eager ``hybrid_forward(nd, ...)`` either way (no
        graph is traced or cached yet)."""
        for cld in self._children.values():
            cld.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast the children's parameters, then this block's own, to
        ``dtype`` (reference: block.py cast).  A hybridized block has no
        cached graph to clear: its next forward runs in the new dtype."""
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):  # pragma: no cover - abstract
        raise NotImplementedError


class HybridBlock(Block):
    """A block written against ``F`` (reference: block.py:428); here
    ``F`` is always the ``nd`` namespace."""

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s "
                "has type %s. If you are using Sequential, please try "
                "HybridSequential instead." % (block, type(block)))
        super().register_child(block, name)

    def forward(self, x, *args):
        """``hybrid_forward(nd, x, *args, **params)``, finishing deferred
        initialization from the input shapes first when needed
        (reference: block.py:613)."""
        try:
            params = {k: v.data() for k, v in self._reg_params.items()}
        except DeferredInitializationError:
            self._shape_hook((x,) + tuple(args))
            for v in self._reg_params.values():
                v._finish_deferred_init()
            params = {k: v.data() for k, v in self._reg_params.items()}
        return self.hybrid_forward(ndarray, x, *args, **params)

    def infer_shape(self, *args):
        """Give every parameter its shape from the inputs ``args``
        (reference: block.py infer_shape): one forward on them, recorded
        by nothing and in predict mode, whose deferred initializations
        finish as the first forward's would (the same initializers in the
        same order).  The JAX package's ``infer_shape`` does nothing and
        leaves the shapes to the first forward."""
        with autograd.pause(train_mode=False), torch.no_grad():
            self(*args)

    def _shape_hook(self, inputs):
        """Subclasses set their parameters' unknown dims from the input
        shapes."""
        raise DeferredInitializationError(
            "Block %s cannot infer parameter shapes from inputs; specify "
            "in_units/in_channels." % self.name)

    def hybrid_forward(self, F, x, *args, **kwargs):  # pragma: no cover
        raise NotImplementedError

    def export(self, path, epoch=0):
        """Write every parameter as ``arg:<name>`` to
        ``<path>-<epoch:04d>.params``, as the JAX package's export does
        (reference: block.py export); there is no traced graph to write
        beside it, so ``SymbolBlock.imports`` takes the symbol from a
        file of its own."""
        params = {"arg:%s" % name: param.data()
                  for name, param in self.collect_params().items()}
        ndarray.save("%s-%04d.params" % (path, epoch), params)


class SymbolBlock(HybridBlock):
    """A Symbol as a Block (reference: block.py:652): its arguments but
    the inputs, and its aux states (``grad_req="null"``), are this
    block's parameters under their own names.  The first forward, and
    one at a new input shape, finishes their deferred shapes from
    ``infer_shape_partial``, binds the symbol with
    ``simple_bind(grad_req="null")`` on the current context and puts the
    parameters' arrays in the executor's place; the forward runs through
    that executor, as the JAX package's does."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        from .. import symbol as sym_mod
        if isinstance(inputs, sym_mod.Symbol):
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(outputs)
        self._symbol = outputs
        self._input_names = [i.name for i in inputs]
        for name in outputs.list_arguments():
            if name not in self._input_names:
                self.params.get(name, allow_deferred_init=True)
        for name in outputs.list_auxiliary_states():
            self.params.get(name, grad_req="null", allow_deferred_init=True)
        self._exec = None

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of the symbol in ``symbol_file`` with inputs
        ``input_names``, its parameters loaded from ``param_file``
        (``arg:`` and ``aux:`` keys, names beyond the symbol's ignored)
        onto ``ctx`` (reference: block.py SymbolBlock.imports)."""
        from .. import symbol as sym_mod
        sym = sym_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(sym, [sym_mod.var(i) for i in input_names])
        if param_file is not None:
            ret.load_params(param_file, ctx=ctx, allow_missing=False,
                            ignore_extra=True)
        return ret

    def _bind(self, shapes):
        arg_shapes, _, aux_shapes = self._symbol.infer_shape_partial(
            **shapes)
        known = dict(zip(self._symbol.list_arguments(), arg_shapes))
        known.update(zip(self._symbol.list_auxiliary_states(), aux_shapes))
        for name, param in self.params.items():
            if param.shape is None and known.get(name):
                param.shape = tuple(known[name])
            param._finish_deferred_init()
        self._exec = self._symbol.simple_bind(
            ctx=current_context(), grad_req="null", **shapes)
        for name, param in self.params.items():
            for slots in (self._exec.arg_dict, self._exec.aux_dict):
                if name in slots:
                    slots[name] = param.data()

    def forward(self, x, *args):
        shapes = {self._input_names[0]: x.shape}
        shapes.update((n, a.shape) for n, a in
                      zip(self._input_names[1:], args))
        if self._exec is None or any(
                self._exec.arg_dict[n].shape != tuple(s)
                for n, s in shapes.items()):
            self._bind(shapes)
        feed = {self._input_names[0]: x}
        feed.update(zip(self._input_names[1:], args))
        outs = self._exec.forward(is_train=autograd.is_training(), **feed)
        return outs[0] if len(outs) == 1 else list(outs)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError
