"""Kvstore helpers of the training loop.

Counterpart of the parts of ``mxnet_tpu/model.py`` that ``Module`` uses
(reference: python/mxnet/model.py): ``BatchEndParam``,
``_create_kvstore`` (which store, and whether the update runs on it),
``_initialize_kvstore`` and the two update paths.  Checkpoint files wait
for the V2 ``save``/``load`` container.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from . import kvstore as kvs

__all__ = ["BatchEndParam"]

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
