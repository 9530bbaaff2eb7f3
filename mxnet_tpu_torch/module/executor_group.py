"""DataParallelExecutorGroup for one device.

Counterpart of ``mxnet_tpu/module/executor_group.py`` (reference:
python/mxnet/module/executor_group.py:129) for a single context: it
derives each argument's ``grad_req`` (parameters write, fixed
parameters, states and labels null, data only with
``inputs_need_grad``), binds one executor (with the Module's
mixed-precision policy, ``compute_dtype`` and ``cast_exclude``; with a
``shared_group`` the parameter and aux arrays of the same shape are the
shared group's own NDArrays), feeds batches to it, rebinds it for new
input shapes (``reshape``), and exposes the parameter, gradient, input
gradient and aux arrays.  Splitting a batch over several devices comes
with the multi-GPU slice; ``_split_input_slice`` and ``_load_general``
are the helpers ``executor_manager`` re-exports.
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from ..context import Context
from ..io import DataDesc

__all__ = ["DataParallelExecutorGroup"]


def _split_input_slice(batch_size, work_load_list):
    """A batch split in proportion to the work loads (reference:
    executor_manager.py:31)."""
    total = sum(work_load_list)
    nums = [round(w * batch_size / total) for w in work_load_list]
    if sum(nums) < batch_size:
        nums[-1] += batch_size - sum(nums)
    slices = []
    end = 0
    for num in nums:
        begin = int(min(end, batch_size))
        end = int(min(begin + num, batch_size))
        if begin >= end:
            raise ValueError("Too many slices. Some splits are empty.")
        slices.append(slice(begin, end))
    return slices


def _feed(src, dst):
    """Point the bound input ``dst`` at batch array ``src``, on dst's
    device and in its dtype (no copy when src is already there)."""
    if tuple(src.shape) != tuple(dst.shape):
        raise MXNetError("batch array of shape %s for an input bound as %s"
                         % (tuple(src.shape), tuple(dst.shape)))
    dst._data = src._data.to(device=dst._data.device, dtype=dst._data.dtype)


def _load_general(data, targets):
    """Feed each batch array to its targets: one bound array, or a list
    of ``(slice, array)`` pairs, one a device (reference:
    executor_manager.py:65)."""
    for d_src, d_targets in zip(data, targets):
        if not isinstance(d_targets, (list, tuple)):
            _feed(d_src, d_targets)
            continue
        for slice_idx, d_dst in d_targets:
            _feed(d_src[slice_idx], d_dst)


class DataParallelExecutorGroup:
    """The executor of a Module on one context (reference:
    executor_group.py:129)."""

    def __init__(self, symbol, contexts, workload, data_shapes,
                 label_shapes, param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write", state_names=None, compute_dtype=None,
                 cast_exclude=()):
        if len(contexts) != 1:
            raise MXNetError("this package binds a Module on one device; "
                             "got %d contexts" % len(contexts))
        self.compute_dtype = compute_dtype
        self.cast_exclude = tuple(cast_exclude)
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = [Context(c) for c in contexts]
        self.workload = list(workload) if workload \
            else [1] * len(self.contexts)
        if len(self.workload) != len(self.contexts):
            raise MXNetError("workload needs one entry a context: %s for %d"
                             % (self.workload, len(self.contexts)))
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = fixed_param_names or []
        self.state_names = state_names or []
        self.logger = logger
        data_names = [x[0] for x in data_shapes]
        if isinstance(grad_req, str):
            self.grad_req = {}
            for k in self.arg_names:
                if k in self.param_names:
                    self.grad_req[k] = ("null" if k in self.fixed_param_names
                                        else grad_req)
                elif k in data_names:
                    self.grad_req[k] = grad_req if inputs_need_grad \
                        else "null"
                else:
                    self.grad_req[k] = "null"
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        elif isinstance(grad_req, dict):
            self.grad_req = {k: "null" for k in self.arg_names}
            self.grad_req.update(grad_req)
        else:
            raise ValueError("invalid grad_req")
        if not for_training:
            self.grad_req = {k: "null" for k in self.arg_names}
        self.output_names = symbol.list_outputs()
        self.execs = []
        self.bind_exec(data_shapes, label_shapes, shared_group)

    def bind_exec(self, data_shapes, label_shapes, shared_group=None,
                  reshape=False):
        """Bind the executor for these input shapes (reference: :330);
        ``reshape`` is accepted and, as in the JAX package, changes
        nothing: a rebind shares ``shared_group``'s arrays either way."""
        descs = list(data_shapes) + list(label_shapes or [])
        self.batch_size = descs[0].shape[DataDesc.get_batch_axis(
            getattr(descs[0], "layout", "NCHW"))]
        self.slices = _split_input_slice(self.batch_size, self.workload)
        shapes = {d.name: tuple(d.shape) for d in descs}
        # float64 host data trains in float32, MXNet's default dtype
        type_dict = {d.name: np.float32 if np.dtype(d.dtype) == np.float64
                     else d.dtype for d in descs}
        shared_exec = None if shared_group is None else shared_group.execs[0]
        exe = self.symbol.simple_bind(ctx=self.contexts[0],
                                      grad_req=self.grad_req,
                                      type_dict=type_dict,
                                      compute_dtype=self.compute_dtype,
                                      cast_exclude=self.cast_exclude,
                                      shared_exec=shared_exec, **shapes)
        self.execs = [exe]
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.data_names = [d.name for d in data_shapes]
        self.label_names = [d.name for d in label_shapes or []]
        self.data_arrays = [[(self.slices[0], exe.arg_dict[n])]
                            for n in self.data_names]
        self.label_arrays = [[(self.slices[0], exe.arg_dict[n])]
                             for n in self.label_names] \
            if label_shapes else None
        self.param_arrays = [[exe.arg_dict[n]] for n in self.param_names]
        self.grad_arrays = [[exe.grad_dict.get(n)] for n in self.param_names] \
            if self.for_training else None
        self.input_grad_arrays = [[exe.grad_dict.get(n)]
                                  for n in self.data_names] \
            if self.inputs_need_grad else None
        self.aux_arrays = [[exe.aux_dict[n]] for n in self.aux_names]
        self.state_arrays = [[exe.arg_dict[n]] for n in self.state_names]

    def reshape(self, data_shapes, label_shapes):
        """Rebind for new shapes, sharing the parameters (reference:
        :398)."""
        if data_shapes == self.data_shapes \
                and label_shapes == self.label_shapes:
            return
        self.bind_exec(data_shapes, label_shapes, shared_group=self,
                       reshape=True)

    def set_params(self, arg_params, aux_params, allow_extra=False):
        """Copy parameters into the executor (reference: :441)."""
        self.execs[0].copy_params_from(arg_params, aux_params,
                                       allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """Copy the executor's parameters out (reference: :453)."""
        for name, block in zip(self.param_names, self.param_arrays):
            arg_params[name] = block[0].astype(arg_params[name].dtype) \
                if name in arg_params else block[0].copy()
        for name, block in zip(self.aux_names, self.aux_arrays):
            aux_params[name] = block[0].copy()

    def forward(self, data_batch, is_train=None):
        """Feed the batch and run forward (reference: :422)."""
        _load_general(data_batch.data, self.data_arrays)
        if self.label_arrays is not None and data_batch.label:
            _load_general(data_batch.label, self.label_arrays)
        self.execs[0].forward(is_train=self.for_training if is_train is None
                              else is_train)

    def backward(self, out_grads=None):
        """Reference: :554."""
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run "
                             "backward")
        self.execs[0].backward(out_grads=out_grads)

    def get_outputs(self, merge_multi_context=True):
        outs = self.execs[0].outputs
        return outs if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        """The data inputs' gradients (reference: :530)."""
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True")
        if merge_multi_context:
            return [g[0] for g in self.input_grad_arrays]
        return self.input_grad_arrays

    def get_states(self, merge_multi_context=True):
        if merge_multi_context:
            raise MXNetError("merge_multi_context=True is not supported "
                             "for get_states")
        return [[] for _ in self.execs]

    def set_states(self, states=None, value=None):
        raise NotImplementedError("stateful modules are not supported by "
                                  "the executor group")

    def install_monitor(self, mon):
        """Reference: executor_group.py:311."""
        for exe in self.execs:
            mon.install(exe)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        """Reference: :583."""
        labels_ = dict(zip(self.label_names, labels or []))
        preds = dict(zip(self.output_names, self.execs[0].outputs))
        eval_metric.update_dict(labels_, preds)
