"""Checkpoint files and the kvstore helpers of the training loop.

Counterpart of ``mxnet_tpu/model.py`` (reference: python/mxnet/model.py):
``save_checkpoint``/``load_checkpoint`` (``prefix-symbol.json`` and
``prefix-NNNN.params`` with ``arg:``/``aux:`` names, the files the JAX
package writes), ``BatchEndParam``, ``_create_kvstore`` (which store, and
whether the update runs on it), ``_initialize_kvstore``, the two
update paths, and the legacy ``FeedForward`` (reference: model.py
FeedForward), a thin shim over ``Module``: ``fit``, ``predict``,
``score``, ``save``, ``load`` and ``create``.
"""
from __future__ import annotations

import logging
from collections import namedtuple

import numpy as np

from . import io
from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym
from .context import current_context

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "FeedForward"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


# ``local`` updates on the workers past this many values in one
# parameter (reference: model.py _create_kvstore); the store then only
# sums the gradients
LOCAL_UPDATE_ON_KVSTORE_MAX = 1024 * 1024 * 16


def _create_kvstore(kvstore, num_device, arg_params):
    """``(kvstore or None, update_on_kvstore)`` (reference: model.py:55).
    On one device ``local`` needs no store (the module updates with its
    own updater); ``tpu`` and ``device`` keep theirs."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore and kvstore not in (
                "tpu", "nccl", "device"):
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(np.prod(param.shape)
                               for param in arg_params.values())
                if max_size > LOCAL_UPDATE_ON_KVSTORE_MAX:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Reference: model.py:87."""
    names = list(param_names[:len(param_arrays)])
    if names:
        kvstore.init(names, [arg_params[n] for n in names])
    if update_on_kvstore:
        for idx, param_on_devs in enumerate(param_arrays):
            kvstore.pull(param_names[idx], param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Reference: model.py:99.  A fused store takes every push before the
    first pull, so it applies all updates at once."""
    live = [(i, a, g) for i, (a, g) in
            enumerate(zip(param_arrays, grad_arrays)) if g[0] is not None]
    if getattr(kvstore, "fused_update", False):
        for index, _, grad_list in live:
            kvstore.push(param_names[index], grad_list, priority=-index)
        for index, arg_list, _ in live:
            kvstore.pull(param_names[index], arg_list, priority=-index)
        return
    for index, arg_list, grad_list in live:
        kvstore.push(param_names[index], grad_list, priority=-index)
        kvstore.pull(param_names[index], arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Reference: model.py:114."""
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        if kvstore:
            name = param_names[index]
            kvstore.push(name, grad_list, priority=-index)
            kvstore.pull(name, grad_list, priority=-index)
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updater(index * num_device + k, g, w)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params`` (reference:
    model.py:365), each atomically."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch, ctx=None):
    """``(symbol, arg_params, aux_params)`` from the files
    :func:`save_checkpoint` writes (reference: model.py:395), the arrays
    on ``ctx`` (default the current context)."""
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch), ctx=ctx)
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class FeedForward:
    """The legacy training API (reference: model.py FeedForward): a
    shim over ``Module`` that trains on arrays or an iterator, with
    the optimizer's parameters as keyword arguments."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as init_mod
        self.symbol = symbol
        self.ctx = ctx if ctx is not None else [current_context()]
        if not isinstance(self.ctx, (list, tuple)):
            self.ctx = [self.ctx]
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or init_mod.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs
        self._module = None

    def _get_module(self, data_iter):
        """The Module, made at the first call; its labels are the
        iterator's, or for one without labels (``predict`` on arrays)
        the symbol's arguments named ``*label``, so that they are not
        taken for parameters (the JAX package takes them for parameters,
        and its ``predict`` on arrays after ``load`` raises)."""
        from .module import Module
        if self._module is None:
            label_names = [d.name for d in (data_iter.provide_label or [])] \
                or [a for a in self.symbol.list_arguments()
                    if a.endswith("label")]
            self._module = Module(
                self.symbol, context=self.ctx,
                data_names=[d.name for d in data_iter.provide_data],
                label_names=label_names or None)
        return self._module

    def _as_iter(self, X, y):
        if isinstance(X, io.DataIter):
            return X
        return io.NDArrayIter(X, y, batch_size=self.numpy_batch_size)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """Train for ``num_epoch`` epochs on ``X`` (an iterator, or
        arrays with labels ``y``)."""
        train_data = self._as_iter(X, y)
        mod = self._get_module(train_data)
        mod.fit(train_data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=dict(self.kwargs),
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
                monitor=monitor, eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback)
        self.arg_params, self.aux_params = mod.get_params()

    def _bound_module(self, data_iter):
        """The Module bound for ``data_iter``'s shapes: bound anew (its
        parameters kept) when they differ, as when ``score`` with labels
        follows ``predict`` on arrays."""
        mod = self._get_module(data_iter)
        labels = data_iter.provide_label or None
        if mod.binded and mod.params_initialized and (
                [tuple(d.shape) for d in mod.data_shapes]
                != [tuple(d[1]) for d in data_iter.provide_data]
                or [tuple(d.shape) for d in mod.label_shapes or []]
                != [tuple(d[1]) for d in labels or []]):
            self.arg_params, self.aux_params = mod.get_params()
            mod.bind(data_shapes=data_iter.provide_data,
                     label_shapes=labels, for_training=False,
                     force_rebind=True)
        if not mod.binded:
            mod.bind(data_shapes=data_iter.provide_data,
                     label_shapes=labels, for_training=False)
            mod.init_params(self.initializer, arg_params=self.arg_params,
                            aux_params=self.aux_params, allow_missing=False)
        return mod

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The first output over ``X``, as a numpy array."""
        data_iter = self._as_iter(X, None)
        outs = self._bound_module(data_iter).predict(
            data_iter, num_batch=num_batch, reset=reset)
        return outs.asnumpy() if isinstance(outs, nd.NDArray) else outs

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """The value of ``eval_metric`` over ``X`` (reference: model.py
        FeedForward.score)."""
        data_iter = self._as_iter(X, None)
        res = self._bound_module(data_iter).score(
            data_iter, eval_metric, num_batch=num_batch,
            batch_end_callback=batch_end_callback, reset=reset)
        return res[0][1]

    def save(self, prefix, epoch=None):
        """``prefix-symbol.json`` and ``prefix-%04d.params`` at ``epoch``
        (default ``num_epoch``)."""
        if epoch is None:
            epoch = self.num_epoch
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """A FeedForward from the files ``save`` wrote, its arrays on
        ``ctx`` (default the current context)."""
        c = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch,
                                                         ctx=c)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None,
               epoch_size=None, optimizer="sgd", initializer=None,
               eval_data=None, eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Make a FeedForward and ``fit`` it (reference: model.py
        FeedForward.create)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model

