"""Gluon Trainer.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (reference:
python/mxnet/gluon/trainer.py Trainer:27, step:157): an optimizer
applied to a set of Parameters, one array at a time through the
optimizer's ``Updater``, as the JAX package's Trainer does.  On one
device there is nothing to reduce, so ``allreduce_grads`` does nothing
and there is no kvstore.

The update runs under ``torch.no_grad()`` and rebinds each weight's
tensor (``optimizer.py``); the Trainer then marks the new tensor as the
parameter's autograd variable again, so the next ``record()`` tracks
it.  A parameter with ``grad_stype="row_sparse"`` (``Embedding(
sparse_grad=True)``) hands the optimizer its gradient's nonzero rows as
a ``RowSparseNDArray``, so SGD and Adam take their lazy row update.

``save_states``/``load_states`` pickle the updater's states without the
optimizer, as the JAX package does: a resumed Adam starts its update
count, and so its bias correction, again.
"""
from __future__ import annotations

import torch

from .. import autograd
from .. import optimizer as opt
from .._atomic_io import atomic_write
from ..ndarray import sparse
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    """Applies an Optimizer on a set of Parameters (reference:
    trainer.py:27)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters, got %s." % type(params))
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 "Parameters, got list of %s." % type(param))
            self._params.append(param)
        optimizer_params = optimizer_params if optimizer_params else {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        """Reference: trainer.py set_learning_rate."""
        self._optimizer.lr = lr

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimization step with the gradients scaled by ``1 /
        batch_size`` (reference: trainer.py:157)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Reference: trainer.py allreduce_grads; on one device every
        gradient is already whole."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The optimizer step alone, the gradients taken as reduced
        (reference: trainer.py update)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            if param._data is None:
                if not ignore_stale_grad:
                    raise UserWarning(
                        "Gradient of Parameter `%s` on context %s has not "
                        "been updated by backward since last `step`. This "
                        "could mean a bug in your model that made it only "
                        "use a subset of the Parameters (Blocks) for this "
                        "iteration. If you are intentionally only using a "
                        "subset, call step with ignore_stale_grad=True to "
                        "suppress this warning and skip updating of "
                        "Parameters with stale gradient"
                        % (param.name, "device"))
                continue
            weight = param.data()
            grad = param.grad()
            if param._grad_stype == "row_sparse":
                # the tape's gradient is dense; the rows no lookup reached
                # are exact zeros, so its nonzero rows are the touched set
                # (a looked-up row whose gradient sums to zero drops out,
                # as in the JAX package)
                grad = sparse.RowSparseNDArray(grad._data)
            with torch.no_grad():
                self._updater(i, grad, weight)
            autograd.mark_variables([weight], [param.grad()],
                                    param.grad_req)

    def save_states(self, fname):
        """Write the optimizer's states to ``fname`` (reference:
        trainer.py save_states)."""
        atomic_write(fname, self._updater.get_states(dump_optimizer=False))

    def load_states(self, fname):
        """Read states ``save_states`` wrote (reference: trainer.py
        load_states); each moves to its parameter's device at the next
        step."""
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        self._optimizer = self._updater.optimizer
