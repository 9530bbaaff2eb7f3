"""Gluon Parameter and ParameterDict.

Counterpart of ``mxnet_tpu/gluon/parameter.py`` (reference:
python/mxnet/gluon/parameter.py): a Parameter owns one NDArray on one
device; its shape may hold 0 for a dim the first forward fills in
(deferred initialization, finished by the block's ``_shape_hook``).
``initialize`` resolves its context at once (by default the current
context: ``gpu(0)`` outside a ``with`` block), so without a GPU that
raises there and not at the first forward.

A parameter whose ``grad_req`` is not ``null`` gets a zero grad buffer
when its value is set, and its value is marked as an autograd variable
(``autograd.mark_variables``), also when the deferred initialization
finishes inside a forward under ``record()``; ``Trainer.step`` marks it
again after the optimizer rebinds it.

``ParameterDict.save``/``load`` write and read the ``nd.save`` container
by parameter name, as the JAX package does; a deferred parameter takes
its shape from the file.
"""
from __future__ import annotations

import warnings
from collections import OrderedDict

import numpy as np
import torch

from .. import autograd, initializer
from .. import ndarray
from ..base import MXNetError, dtype_torch
from ..context import cpu, current_context, resolve
from ..initializer import InitDesc
from ..ndarray import NDArray

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict", "tensor_types"]

tensor_types = (NDArray,)


class DeferredInitializationError(MXNetError):
    """Error for unfinished deferred initialization (reference:
    parameter.py:35)."""


def _check_stype(name, what, stype):
    """Only the dense storage type: a sparse one needs sparse arrays,
    which this package does not have yet."""
    if stype != "default":
        raise MXNetError(
            "Parameter '%s': %s %r needs sparse arrays (ndarray/sparse.py), "
            "which this package does not have yet; use 'default'"
            % (name, what, stype))


def _merge_shapes(declared, stored):
    """Unify a newly declared shape with a stored one, 0 meaning an
    unknown dim.  Returns the merged tuple, or None on a conflict."""
    if stored is None:
        return tuple(declared)
    if len(declared) != len(stored):
        return None
    merged = []
    for want, have in zip(declared, stored):
        if 0 not in (want, have) and want != have:
            return None
        merged.append(have if want == 0 else want)
    return tuple(merged)


class Parameter:
    """A parameter of Blocks (reference: parameter.py:42).  ``stype`` and
    ``grad_stype`` take the dense ``default`` only."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        _check_stype(name, "stype", stype)
        _check_stype(name, "grad_stype", grad_stype)
        if isinstance(shape, int):
            shape = (shape,)
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._differentiable = differentiable
        self._allow_deferred_init = allow_deferred_init
        self._data = None
        self._grad = None
        self._grad_req = None
        self._deferred_init = ()
        self._ctx_list = None
        self._var = None
        self.grad_req = grad_req

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                      self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        """``write``, ``add`` or ``null`` (always ``null`` for a parameter
        that is not differentiable); an initialized parameter gets or
        drops its grad buffer at once."""
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be one of 'write', 'add', or "
                             "'null', but got '%s'" % req)
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if self._data is not None:
            self._init_grad()

    def _init_grad(self):
        """A zero grad buffer for the value, marked as its variable's
        (none for ``null``)."""
        self._grad = None if self._grad_req == "null" else NDArray(
            torch.zeros_like(self._data._data,
                             memory_format=torch.contiguous_format))
        autograd.mark_variables([self._data], [self._grad], self._grad_req)

    @property
    def shape(self):
        """The shape, with 0 for a dim not known until the first forward."""
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        merged = _merge_shapes(tuple(new_shape), self._shape)
        if merged is None:
            raise MXNetError("Parameter '%s': expected shape %s is "
                             "incompatible with given shape %s"
                             % (self.name, self._shape, tuple(new_shape)))
        self._shape = merged

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Initialize the value on ``ctx`` (a Context, or a list of which
        the first is used; default the current context) by ``init``, this
        parameter's own initializer, or ``default_init``, in that order
        (reference: parameter.py initialize).  A shape with unknown dims
        defers the work to the first forward."""
        if default_init is None:
            default_init = initializer.Uniform()
        if self._data is not None and not force_reinit:
            warnings.warn("Parameter '%s' is already initialized, ignoring. "
                          "Set force_reinit=True to re-initialize."
                          % self.name, stacklevel=2)
            return
        self._data = self._grad = None
        if ctx is None:
            ctx = current_context()
        self._ctx_list = list(ctx) if isinstance(ctx, (list, tuple)) \
            else [ctx]
        ctx = self._ctx_list[0]
        resolve(ctx)    # a GPU context without a GPU raises here
        if init is None:
            init = default_init if self.init is None else self.init
        self._deferred_init = (init, ctx, default_init)
        if self._shape is None or int(np.prod(self._shape)) <= 0:
            if self._allow_deferred_init:
                return
            raise ValueError("Cannot initialize Parameter '%s' because it "
                             "has invalid shape: %s." % (self.name,
                                                         self._shape))
        self._finish_deferred_init()

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init = self._deferred_init
        if self._shape is None or int(np.prod(self._shape)) <= 0:
            raise MXNetError(
                "Cannot initialize Parameter '%s' because it has invalid "
                "shape: %s. Please specify in_units, in_channels, etc for "
                "`Block`s." % (self.name, self._shape))
        self._deferred_init = ()
        data = NDArray(torch.zeros(self._shape, dtype=dtype_torch(self.dtype),
                                   device=resolve(ctx)))
        with torch.no_grad():
            initializer.create(default_init)(
                InitDesc(self.name, {"__init__": init.dumps()
                                     if hasattr(init, "dumps") else str(init)}),
                data)
        self._set(data)

    def _set(self, data):
        """Take the NDArray ``data`` as the value, with its grad buffer."""
        self._data = data
        self._init_grad()

    def _check_and_get(self):
        if self._data is not None:
            return self._data
        if self._deferred_init:
            raise DeferredInitializationError(
                "Parameter '%s' has not been initialized yet because "
                "initialization was deferred. Actual initialization happens "
                "during the first forward pass. Please pass one batch of "
                "data through the network before accessing Parameters."
                % self.name)
        raise MXNetError(
            "Parameter '%s' has not been initialized. Note that you should "
            "initialize parameters with Block.collect_params() instead of "
            "Block.params because the latter does not include Parameters of "
            "nested child Blocks" % self.name)

    def data(self, ctx=None):
        """The value (reference: parameter.py data)."""
        return self._check_and_get()

    def grad(self, ctx=None):
        """The grad buffer (reference: parameter.py grad); raises for
        ``grad_req="null"``."""
        if self._data is not None and self._grad is None:
            raise MXNetError("Cannot get gradient array for Parameter '%s' "
                             "because grad_req='null'" % self.name)
        self._check_and_get()
        return self._grad

    def list_data(self):
        """The value, as the one-element list of its devices' copies."""
        return [self._check_and_get()]

    def list_grad(self):
        """The grad buffer, as a one-element list."""
        return [self.grad()]

    def list_ctx(self):
        """The contexts given to ``initialize`` or ``reset_ctx`` (the
        value lives on the first)."""
        if self._data is None and not self._deferred_init:
            raise MXNetError("Parameter '%s' has not been initialized"
                             % self.name)
        return list(self._ctx_list or [self._data.context])

    def reset_ctx(self, ctx):
        """Move the value and its grad buffer to ``ctx`` (a Context or a
        list, of which the first is used), marked as the autograd variable
        again; a deferred parameter initializes there."""
        ctx = [ctx] if not isinstance(ctx, (list, tuple)) else list(ctx)
        device = resolve(ctx[0])
        self._ctx_list = ctx
        if self._data is not None:
            with torch.no_grad():
                self._data = NDArray(self._data._data.to(device))
            if self._grad is not None:
                self._grad = NDArray(self._grad._data.to(device))
            autograd.mark_variables([self._data], [self._grad],
                                    self._grad_req)
        elif self._deferred_init:
            init, _, default_init = self._deferred_init
            self._deferred_init = (init, ctx[0], default_init)

    def var(self):
        """This parameter as a variable Symbol (reference: parameter.py
        var), made once."""
        from .. import symbol
        if self._var is None:
            self._var = symbol.var(self.name, shape=self.shape,
                                   dtype=self.dtype, lr_mult=self.lr_mult,
                                   wd_mult=self.wd_mult, init=self.init)
        return self._var

    def zero_grad(self):
        """Set the grad buffer to zeros (reference: parameter.py
        zero_grad)."""
        if self._grad is not None:
            self._grad._data = torch.zeros_like(self._grad._data)

    def set_data(self, data):
        """Assign a new value (an NDArray, tensor or host array) of this
        parameter's shape, on its device, in its dtype; a deferred
        parameter takes its shape from ``data``."""
        t = data._data if isinstance(data, NDArray) else torch.as_tensor(
            np.asarray(data) if not isinstance(data, torch.Tensor) else data)
        if self._data is not None:
            self.shape = tuple(t.shape)
            with torch.no_grad():
                self._data._data.copy_(t)
        elif self._deferred_init:
            device = resolve(self._deferred_init[1])
            self._load_init(NDArray(t.to(device=device,
                                         dtype=dtype_torch(self.dtype))))
        else:
            raise MXNetError("Parameter '%s' has not been initialized"
                             % self.name)

    def cast(self, dtype):
        """Cast the value and its grad buffer to ``dtype`` and mark them
        as the autograd variable again (reference: parameter.py cast); a
        parameter not yet initialized takes the dtype when it is."""
        self.dtype = dtype
        if self._data is None:
            return
        with torch.no_grad():
            self._data = NDArray(self._data._data.to(dtype_torch(dtype)))
        if self._grad is not None:
            self._grad = NDArray(self._grad._data.to(dtype_torch(dtype)))
        autograd.mark_variables([self._data], [self._grad], self._grad_req)

    def _load_init(self, data):
        """Take the NDArray ``data`` (in this parameter's dtype, on the
        device it is to live on) as the value, initialized or not; its
        shape must agree with the known dims."""
        self.shape = data.shape
        self._deferred_init = ()
        self._set(data)


class Constant(Parameter):
    """A parameter that holds ``value`` and takes no gradient
    (``grad_req="null"``; reference: parameter.py Constant).  Its
    initializer copies ``value``; it is an instance of a class registered
    under a name of its own, so that ``initialize`` finds it again by
    that name (the JAX package registers the class but hands over an
    instance of its unregistered base, whose name ``initialize`` does not
    find)."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = ndarray.array(value)
        self.value = value

        class Init(initializer.Initializer):
            def _init_weight(self, _, arr):
                value.copyto(arr)

            _init_default = _init_weight

        init_name = "Constant_{}_{}".format(name, id(self))
        klass = initializer.register(type(init_name, (Init,), {}))
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=klass())


class ParameterDict:
    """Parameters by name, sharing a prefix (reference: parameter.py:560).
    Iteration order is creation order."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __iter__(self):
        return iter(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def items(self):
        return self._params.items()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        p = self._params.get(name)
        if p is None and self._shared is not None:
            p = self._shared._params.get(name)
            if p is not None:
                self._params[name] = p      # adopt the shared parameter
        return p

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, created with ``kwargs`` if it
        does not exist (reference: parameter.py get).  An existing one
        must agree with ``kwargs``; a shape with unknown (0) dims merges
        with the stored one."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if k == "shape" and v is not None:
                param.shape = v
            elif v is not None and existing is not None and v != existing:
                raise MXNetError(
                    "Cannot retrieve Parameter '%s' because desired attribute "
                    "does not match with stored for attribute '%s': desired "
                    "'%s' vs stored '%s'." % (name, k, v, existing))
            elif existing is None:
                setattr(param, k, v)
        return param

    def get_constant(self, name, value=None):
        """The Constant ``prefix + name``, created from ``value`` if it does
        not exist (reference: parameter.py get_constant)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise KeyError("No constant named '%s'. Please specify "
                               "value if you want to create a new constant."
                               % name)
            param = Constant(name, value)
            self._params[name] = param
        elif value is not None and not isinstance(param, Constant):
            raise MXNetError("Parameter '%s' already exists but it is not a "
                             "constant." % name)
        return param

    def update(self, other):
        """Merge another dict (reference: parameter.py update)."""
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(
                    "Cannot update self with other because they have "
                    "different Parameters with the same name '%s'" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter with ``init`` as the default
        initializer, on ``ctx`` (default the current context)."""
        if init is None:
            init = initializer.Uniform()
        for v in self.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        """Zero every parameter's grad buffer."""
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        """``reset_ctx`` every parameter."""
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set attribute ``name`` of every parameter to ``value`` (e.g.
        ``grad_req``, ``lr_mult``)."""
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        """Save every parameter's value under its name less
        ``strip_prefix`` (reference: parameter.py save:725)."""
        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    "Prefix '%s' is to be striped before saving, but "
                    "Parameter's name '%s' does not start with '%s'"
                    % (strip_prefix, param.name, strip_prefix))
            arg_dict[param.name[len(strip_prefix):]] = param.data()
        ndarray.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Set the parameters from a file ``save`` wrote, each name
        prefixed with ``restore_prefix`` (reference: parameter.py
        load:748).  An initialized parameter keeps its device and takes
        the values; a deferred one is finished on the device it was
        initialized for, with the file's shape; any other is created on
        ``ctx`` (default the current context).  A parameter missing from
        the file (unless ``allow_missing``) or a name in the file that is
        not a parameter (unless ``ignore_extra``) raises MXNetError."""
        if restore_prefix:
            for name in self.keys():
                if not name.startswith(restore_prefix):
                    raise MXNetError(
                        "restore_prefix is '%s' but Parameters name '%s' "
                        "does not start with '%s'"
                        % (restore_prefix, name, restore_prefix))
        lprefix = len(restore_prefix)
        loaded = ndarray.load(filename, ctx=cpu())
        arg_dict = {restore_prefix + k.split(":", 1)[-1]: v
                    for k, v in (loaded.items() if isinstance(loaded, dict)
                                 else ())}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise MXNetError("Parameter '%s' is missing in file '%s'"
                                     % (name[lprefix:], filename))
        for name, value in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError(
                        "Parameter '%s' loaded from file '%s' is not present "
                        "in ParameterDict" % (name[lprefix:], filename))
                continue
            param = self[name]
            if param._data is None and not param._deferred_init:
                param._load_init(NDArray(value._data.to(
                    device=resolve(ctx), dtype=dtype_torch(param.dtype))))
            else:
                param.set_data(value)
