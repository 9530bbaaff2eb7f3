"""DataParallelExecutorGroup — the data-parallel engine of the Module API.

Counterpart of ``mxnet_tpu/module/executor_group.py`` (reference:
python/mxnet/module/executor_group.py:129): it derives each argument's
``grad_req`` (parameters write, fixed parameters, states and labels
null, data only with ``inputs_need_grad``), splits each batch over the
contexts in proportion to ``workload`` (``decide_slices``), binds one
executor a context on that context (with the Module's mixed-precision
policy, ``compute_dtype`` and ``cast_exclude``; with a ``shared_group``
executor i shares the parameter and aux arrays of the shared group's
executor i), scatters each batch's slices to them, runs them, and
exposes the per-context parameter, gradient, input gradient and aux
arrays.  ``get_outputs``/``get_input_grads`` concatenate the contexts'
slices along the batch axis unless ``merge_multi_context=False``;
``update_metric`` updates the metric once a slice.  Each executor's
BatchNorm takes its own rows.  ``_split_input_slice`` and
``_load_general`` are the helpers ``executor_manager`` re-exports.
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
    """One executor per context (reference: executor_group.py:129)."""

    def __init__(self, symbol, contexts, workload, data_shapes,
                 label_shapes, param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write", state_names=None, compute_dtype=None,
                 cast_exclude=()):
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
        self.num_outputs = len(self.output_names)
        self.output_layouts = [0] * self.num_outputs
        self.shared_group = shared_group
        self.execs = []
        self.data_shapes = self.label_shapes = None
        self.data_layouts = self.label_layouts = None
        self.bind_exec(data_shapes, label_shapes, shared_group)

    def decide_slices(self, data_shapes):
        """The batch axis of each of ``data_shapes`` (-1 where its layout
        has none), checking that they agree on the batch size, and the
        per-context ``slices`` of that batch (reference:
        executor_group.py:289)."""
        if not data_shapes:
            raise MXNetError("decide_slices needs at least one input")
        major_axis = [DataDesc.get_batch_axis(getattr(x, "layout", "NCHW"))
                      for x in data_shapes]
        for (name, shape), axis in zip(data_shapes, major_axis):
            if axis == -1:
                continue
            batch_size = shape[axis]
            if self.batch_size is not None:
                if batch_size != self.batch_size:
                    raise MXNetError(
                        "all data must have the same batch size: "
                        "batch_size = %d, but %s has shape %s"
                        % (self.batch_size, name, shape))
            else:
                self.batch_size = batch_size
                self.slices = _split_input_slice(self.batch_size,
                                                 self.workload)
        return major_axis

    def bind_exec(self, data_shapes, label_shapes, shared_group=None,
                  reshape=False):
        """Bind one executor a context for these input shapes (reference:
        :330); ``reshape`` is accepted and, as in the JAX package, changes
        nothing: a rebind shares ``shared_group``'s arrays either way."""
        self.batch_size = None
        self.data_layouts = self.decide_slices(data_shapes)
        if label_shapes:
            self.label_layouts = self.decide_slices(label_shapes)
        # built into a local list: during reshape shared_group is self and
        # the old executors must stay visible for the sharing
        execs = [self._bind_ith_exec(i, data_shapes, label_shapes,
                                     shared_group)
                 for i in range(len(self.contexts))]
        self.execs = execs
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.data_names = [d.name for d in data_shapes]
        self.label_names = [d.name for d in label_shapes or []]
        self._collect_arrays()

    def _sliced_shape(self, shapes, i, major_axis):
        """Context ``i``'s share of each input: its rows of the batch."""
        out = []
        for desc, axis in zip(shapes, major_axis):
            shape = list(desc.shape)
            if axis >= 0:
                shape[axis] = self.slices[i].stop - self.slices[i].start
            out.append((desc.name, tuple(shape), desc.dtype))
        return out

    def _bind_ith_exec(self, i, data_shapes, label_shapes, shared_group):
        """Bind context ``i``'s executor on that context (reference:
        :176), sharing executor i of ``shared_group``."""
        descs = self._sliced_shape(data_shapes, i, self.data_layouts)
        if label_shapes:
            descs += self._sliced_shape(label_shapes, i, self.label_layouts)
        shapes = {name: shape for name, shape, _ in descs}
        # float64 host data trains in float32, MXNet's default dtype
        type_dict = {name: np.float32 if np.dtype(dtype) == np.float64
                     else dtype for name, _, dtype in descs}
        shared_exec = None if shared_group is None \
            else shared_group.execs[i]
        return self.symbol.simple_bind(ctx=self.contexts[i],
                                       grad_req=self.grad_req,
                                       type_dict=type_dict,
                                       compute_dtype=self.compute_dtype,
                                       cast_exclude=self.cast_exclude,
                                       shared_exec=shared_exec, **shapes)

    def _collect_arrays(self):
        """Each argument's arrays, one a context (reference: :310)."""
        execs = self.execs

        def per_exec(names, table):
            return [[getattr(e, table).get(n) for e in execs] for n in names]

        self.data_arrays = [[(self.slices[i], e.arg_dict[n])
                             for i, e in enumerate(execs)]
                            for n in self.data_names]
        self.label_arrays = [[(self.slices[i], e.arg_dict[n])
                              for i, e in enumerate(execs)]
                             for n in self.label_names] \
            if self.label_shapes else None
        self.param_arrays = per_exec(self.param_names, "arg_dict")
        self.grad_arrays = per_exec(self.param_names, "grad_dict") \
            if self.for_training else None
        self.input_grad_arrays = per_exec(self.data_names, "grad_dict") \
            if self.inputs_need_grad else None
        self.aux_arrays = per_exec(self.aux_names, "aux_dict")
        self.state_arrays = per_exec(self.state_names, "arg_dict")

    def reshape(self, data_shapes, label_shapes):
        """Rebind for new shapes, sharing the parameters (reference:
        :398)."""
        if data_shapes == self.data_shapes \
                and label_shapes == self.label_shapes:
            return
        self.bind_exec(data_shapes, label_shapes, shared_group=self,
                       reshape=True)

    def set_params(self, arg_params, aux_params, allow_extra=False):
        """Copy parameters into every executor (reference: :441)."""
        for exe in self.execs:
            exe.copy_params_from(arg_params, aux_params,
                                 allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """Copy the parameters out, averaged over the contexts
        (reference: :453)."""
        for name, block in zip(self.param_names, self.param_arrays):
            weight = _average(block)
            arg_params[name] = weight.astype(arg_params[name].dtype) \
                if name in arg_params else weight
        for name, block in zip(self.aux_names, self.aux_arrays):
            aux_params[name] = _average(block)

    def forward(self, data_batch, is_train=None):
        """Scatter the batch's slices and run every executor (reference:
        :422)."""
        _load_general(data_batch.data, self.data_arrays)
        if self.label_arrays is not None and data_batch.label:
            _load_general(data_batch.label, self.label_arrays)
        if is_train is None:
            is_train = self.for_training
        for exe in self.execs:
            exe.forward(is_train=is_train)

    def backward(self, out_grads=None):
        """Backward on every executor, each with its slice of
        ``out_grads`` (reference: :554)."""
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run "
                             "backward")
        if out_grads is None:
            for exe in self.execs:
                exe.backward()
            return
        if not isinstance(out_grads, (list, tuple)):
            out_grads = [out_grads]
        for i, exe in enumerate(self.execs):
            exe.backward(out_grads=[g[self.slices[i]] for g in out_grads])

    def get_outputs(self, merge_multi_context=True):
        """The outputs, one list a context per output, concatenated
        along the batch axis when merged (reference: :475)."""
        outputs = [[exe.outputs[i] for exe in self.execs]
                   for i in range(self.num_outputs)]
        if merge_multi_context:
            return _merge_multi_context(outputs, self.output_layouts)
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        """The data inputs' gradients (reference: :530)."""
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True")
        if merge_multi_context:
            return _merge_multi_context(self.input_grad_arrays,
                                        self.data_layouts)
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
        """Update the metric once a context, on its slice of the labels
        (reference: :583)."""
        for i, (exe, islice) in enumerate(zip(self.execs, self.slices)):
            if pre_sliced:
                labels_slice = labels[i]
            else:
                labels_slice = [label[islice] for label in labels or []]
            labels_ = dict(zip(self.label_names, labels_slice))
            preds = dict(zip(self.output_names, exe.outputs))
            eval_metric.update_dict(labels_, preds)


def _average(block):
    """One argument's arrays averaged over the contexts, on the first
    one's device (a copy either way)."""
    weight = block[0].copy()
    if len(block) > 1:
        for w in block[1:]:
            weight._data = weight._data + w._data.to(weight._data.device)
        weight._data = weight._data / len(block)
    return weight


def _merge_multi_context(outputs, major_axis):
    """Concatenate per-context arrays along the batch axis, on the first
    context's device (reference: executor_group.py
    _merge_multi_context)."""
    import torch
    from ..ndarray import NDArray
    rets = []
    for tensors, axis in zip(outputs, major_axis):
        if len(tensors) == 1 or axis < 0:
            rets.append(tensors[0])
            continue
        dev = tensors[0]._data.device
        rets.append(NDArray(torch.cat([t._data.to(dev) for t in tensors],
                                      dim=axis)))
    return rets
