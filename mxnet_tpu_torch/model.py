"""Checkpoint files and the kvstore helpers of the training loop.

Counterpart of ``mxnet_tpu/model.py`` (reference: python/mxnet/model.py):
``save_checkpoint``/``load_checkpoint`` (``prefix-symbol.json`` and
``prefix-NNNN.params`` with ``arg:``/``aux:`` names, the files the JAX
package writes), ``BatchEndParam``, ``_create_kvstore`` (which store, and
whether the update runs on it), ``_initialize_kvstore`` and the two
update paths.  The legacy ``FeedForward`` is not ported.
"""
from __future__ import annotations

import logging
import os
from collections import namedtuple

import numpy as np

from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym
from .base import MXNetError

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


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
                if max_size > 1024 * 1024 * 16:
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


def _refuse_manager(manager):
    """The JAX package routes a save through a ``checkpoint``
    CheckpointManager when given one or when ``MXNET_CKPT_DIR`` is set;
    that package (``checkpoint/``) is not ported, so either raises here
    rather than being ignored.  ``manager=False`` suppresses the routing,
    as there."""
    if manager is False:
        return
    if manager is not None or os.environ.get("MXNET_CKPT_DIR"):
        raise MXNetError(
            "checkpoint managers (manager=, MXNET_CKPT_DIR) need the "
            "checkpoint/ package, which mxnet_tpu_torch does not port yet; "
            "save with a prefix only and unset MXNET_CKPT_DIR")
