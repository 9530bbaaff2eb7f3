"""Module — symbolic training on one device.

Counterpart of ``mxnet_tpu/module/module.py`` (reference:
python/mxnet/module/module.py:40): ``bind``, ``init_params``,
``init_optimizer``, ``forward``/``backward``/``update``,
``update_metric``, ``get_outputs``, ``get_params``/``set_params``, and
the checkpoint surface: ``Module.load``, ``save_checkpoint`` (routed
through a ``checkpoint.CheckpointManager`` too when one is given or
``MXNET_CKPT_DIR`` is set), ``save_optimizer_states``/
``load_optimizer_states``.

``bind(shared_module=...)`` shares the shared module's parameter and
aux arrays (the same NDArray objects, so a kvstore pull into one is seen
by all) and its master copies, as ``BucketingModule`` binds a bucket;
``borrow_optimizer`` takes another module's optimizer, kvstore and
updater.  Unlike the JAX package, a module bound to a shared module does
not copy the shared module's master copies into the shared arrays: they
go stale while the arrays train, and the copy would undo every step
taken before the new bucket was bound (the reference's ``bind`` skips
it under ``shared_module`` too).

``init_optimizer`` picks the update path as the JAX package does:
``kvstore="tpu"`` (update on the kvstore, one executor) installs the
executor's fused step, so each ``forward(is_train=True)`` runs forward,
backward and the optimizer sweep and ``update()`` has nothing left to
do; ``"local"`` updates each array with the module's own ``Updater``,
and ``"device"`` through the kvstore's.  ``_allow_exec_fusion = False``
(what ``BucketingModule`` sets, since its buckets share the weights)
keeps ``"tpu"`` on the kvstore's fused store.  The default context is the
current one (``gpu(0)`` outside a ``with`` block); without a GPU the
module raises unless given ``cpu()``.

Optimizer states: under the fused step the ``.states`` file holds the
executor's slots, one state per weight under the index the ``local``
path's ``Updater`` gives it, so a file written under ``kvstore="tpu"``
(either ``MXNET_PALLAS_FUSED_OPT``) loads under ``"local"`` and the other
way round.  (The JAX package writes its kvstore's updater there, which
the fused step never used: an empty dict.)
"""
from __future__ import annotations

import logging
import pickle
import warnings

from .. import optimizer as opt
from .._atomic_io import atomic_write
from ..base import MXNetError
from ..context import Context, current_context
from ..initializer import InitDesc, Uniform
from ..io import DataDesc
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint)
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


def _parse_data_desc(data_names, label_names, data_shapes, label_shapes):
    """Normalise shapes to DataDesc lists (reference: module base)."""
    def _desc(x):
        if isinstance(x, DataDesc):
            return x
        return DataDesc(x[0], tuple(x[1]), *(x[2:] if len(x) > 2 else ()))

    data_shapes = [_desc(x) for x in data_shapes]
    label_shapes = [_desc(x) for x in label_shapes] \
        if label_shapes is not None and len(label_shapes) else None
    return data_shapes, label_shapes


class Module(BaseModule):
    """Module over a Symbol (reference: module.py:40)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None,
                 compute_dtype=None):
        super().__init__(logger=logger)
        # compute_dtype="bfloat16": the executor's mixed precision, fp32
        # masters and bf16 compute, the labels kept fp32
        self._compute_dtype = compute_dtype
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context = [context]
        self._context = list(context)
        for c in self._context:
            Context(c).torch_device     # raises for a GPU without CUDA
        if work_load_list is None:
            work_load_list = [1] * len(self._context)
        if len(work_load_list) != len(self._context):
            raise ValueError("work_load_list needs one entry a context")
        self._work_load_list = work_load_list
        self._compression_params = compression_params
        self._symbol = symbol
        groups = {}
        for typename, names in (("data", data_names), ("label", label_names),
                                ("state", state_names),
                                ("fixed_param", fixed_param_names)):
            names = list(names) if names is not None else []
            _check_input_names(symbol, names, typename,
                               throw=typename != "label")
            groups[typename] = names
        self._data_names = groups["data"]
        self._label_names = groups["label"]
        self._state_names = groups["state"]
        self._fixed_param_names = groups["fixed_param"]
        non_params = set(self._data_names + self._label_names
                         + self._state_names)
        self._param_names = [a for a in symbol.list_arguments()
                             if a not in non_params]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = self._kvstore = self._updater = None
        self._update_on_kvstore = None
        self._exec_group = None
        self._data_shapes = self._label_shapes = None
        self._fused_exec_update = False
        self._preload_opt_states = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module from ``prefix-symbol.json`` and ``prefix-%04d.params``
        (reference: module.py:126), its parameters loaded onto its
        context; with ``load_optimizer_states`` the ``.states`` file is
        read when ``init_optimizer`` runs (``fit`` with ``begin_epoch``
        resumes)."""
        context = kwargs.get("context")
        ctx = context[0] if isinstance(context, (list, tuple)) else context
        sym, args, auxs = load_checkpoint(prefix, epoch, ctx=ctx)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        manager=None):
        """Write ``prefix-symbol.json``, ``prefix-%04d.params`` and, if
        asked, ``prefix-%04d.states`` (reference: module.py:161), each
        atomically.  With a ``checkpoint.CheckpointManager`` — given, or
        the process-default one when ``MXNET_CKPT_DIR`` is set — the
        save is ALSO routed through it (one sharded, integrity-checked
        checkpoint with the full resume state); ``manager=False``
        suppresses the routing."""
        self._symbol.save("%s-symbol.json" % prefix)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        logging.info("Saved checkpoint to \"%s\"", param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info("Saved optimizer state to \"%s\"", state_name)
        if manager is None:
            from .. import config as _config
            if _config.get("MXNET_CKPT_DIR"):
                from .. import checkpoint as _checkpoint
                manager = _checkpoint.default_manager()
        if manager:   # False suppresses, None means "not configured"
            manager.save_module(self, epoch=epoch)

    def save_optimizer_states(self, fname):
        """Write the optimizer's states to ``fname`` (reference:
        module.py save_optimizer_states)."""
        if not self.optimizer_initialized:
            raise RuntimeError("call init_optimizer first")
        if self._fused_exec_update:
            names = self._exec_group.param_names
            slots = self._exec_group.execs[0].optimizer_slots()
            atomic_write(fname, pickle.dumps(
                {i: opt.slots_state(slots[n]) for i, n in enumerate(names)
                 if n in slots}))
        elif self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            atomic_write(fname, self._updater.get_states())

    def load_optimizer_states(self, fname):
        """Read states written by ``save_optimizer_states`` (reference:
        module.py load_optimizer_states)."""
        if not self.optimizer_initialized:
            raise RuntimeError("call init_optimizer first")
        if self._fused_exec_update:
            with open(fname, "rb") as f:
                states = pickle.load(f)
            names = self._exec_group.param_names
            self._exec_group.execs[0].load_optimizer_slots(
                {names[i]: opt.state_slots(st) for i, st in states.items()})
        elif self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        """``[(name, shape)]`` of the outputs at the bound shapes."""
        if not self.binded:
            raise RuntimeError("bind the module first")
        known = {d.name: d.shape for d in self._data_shapes}
        if self._label_shapes:
            known.update({d.name: d.shape for d in self._label_shapes})
        _, out_shapes, _ = self._symbol.infer_shape(**known)
        return list(zip(self._output_names, out_shapes))

    def _reset_bind(self):
        self.binded = False
        self._exec_group = None
        self._data_shapes = None
        self._label_shapes = None

    def get_params(self):
        """``(arg_params, aux_params)``: copies of the bound values
        (reference: module.py get_params)."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("bind and initialise the module first")
        if self._params_dirty:
            self._exec_group.get_params(self._arg_params, self._aux_params)
            self._params_dirty = False
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Reference: module.py:259.  Given arrays are copied in; the rest
        are filled by ``initializer`` under MXNet's name rules."""
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and "
                          "force_init=False. init_params call ignored.",
                          stacklevel=2)
            return
        if not self.binded:
            raise RuntimeError("call bind before initializing the "
                               "parameters")
        attrs = self._symbol.attr_dict()
        for own, given in ((self._arg_params, arg_params),
                           (self._aux_params, aux_params)):
            for name, arr in sorted(own.items()):
                desc = InitDesc(name, attrs.get(name, None))
                src = None if given is None else given.get(name)
                if src is not None:
                    if src is not arr:
                        src.copyto(arr)
                    continue
                if given is not None and not allow_missing:
                    raise RuntimeError("%s is not presented" % name)
                if initializer is None:
                    if given is not None:
                        continue
                    raise RuntimeError("no initializer given and %s has no "
                                       "source value" % name)
                initializer(desc, arr)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=allow_extra)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the executor (reference: module.py:364); with
        ``shared_module`` (a bound, initialised Module) its parameter and
        aux arrays and its master copies are shared."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        if not for_training and inputs_need_grad:
            raise ValueError("inputs_need_grad needs for_training")
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self._data_names, self._label_names, data_shapes, label_shapes)
        shared_group = None
        if shared_module is not None:
            if not (isinstance(shared_module, Module) and shared_module.binded
                    and shared_module.params_initialized):
                raise AssertionError(
                    "shared_module must be a bound, initialized Module")
            shared_group = shared_module._exec_group
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group=shared_group, logger=self.logger,
            fixed_param_names=self._fixed_param_names, grad_req=grad_req,
            state_names=self._state_names,
            compute_dtype=self._compute_dtype,
            cast_exclude=tuple(self._label_names))
        self.binded = True
        if shared_module is not None:
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self.params_initialized = True
            return
        if self._arg_params is None:
            # master copies, apart from the executor's arrays
            self._arg_params = {n: a[0].copy() for n, a in zip(
                self._param_names, self._exec_group.param_arrays)}
            self._aux_params = {n: a[0].copy() for n, a in zip(
                self._aux_names, self._exec_group.aux_arrays)}
        if self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind for new input shapes, sharing the parameters
        (reference: module.py reshape)."""
        if not self.binded:
            raise RuntimeError("bind the module first")
        if self._fused_exec_update:
            raise MXNetError("a module whose executor runs the fused "
                             "optimizer step keeps its bound shapes; "
                             "pad the batch instead")
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self._data_names, self._label_names, data_shapes, label_shapes)
        self._exec_group.reshape(self._data_shapes, self._label_shapes)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Reference: module.py:473."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("bind and initialise the module first")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, "
                                "ignoring...")
            return
        if self._params_dirty:
            self.get_params()
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        batch_size = self._exec_group.batch_size
        if kvstore and "dist" in kvstore.type and "_sync" in kvstore.type:
            # the reference's rule (module.py init_optimizer): a
            # synchronous dist store sums every rank's batch, so the
            # gradient is rescaled by the global batch (the JAX package
            # tests "_async" here, ROADMAP queue 3)
            batch_size *= kvstore.num_workers
        rescale_grad = 1.0 / batch_size
        names = self._exec_group.param_names
        idx2name = dict(enumerate(names))
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        else:
            if not isinstance(optimizer, opt.Optimizer):
                raise TypeError("optimizer must be a name or an Optimizer")
            if optimizer.rescale_grad != rescale_grad:
                warnings.warn(
                    "Optimizer created manually outside Module but "
                    "rescale_grad is not normalized to 1.0/batch_size (%s "
                    "vs. %s). Is this intended?"
                    % (optimizer.rescale_grad, rescale_grad), stacklevel=2)
            if not optimizer.idx2name:
                optimizer.idx2name = idx2name.copy()
        self._optimizer, self._kvstore = optimizer, kvstore
        self._update_on_kvstore, self._updater = update_on_kvstore, None
        if kvstore:
            if self._compression_params:
                kvstore.set_gradient_compression(self._compression_params)
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._param_names,
                                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt.get_updater(optimizer)
        # kvstore=tpu on one device: the optimizer runs inside the
        # executor's training forward (the fused step)
        self._fused_exec_update = False
        if kvstore is not None and kvstore.type == "tpu" \
                and update_on_kvstore \
                and getattr(self, "_allow_exec_fusion", True):
            # compression follows the module wherever its update runs:
            # the kvstore's codec runs inside the fused step too
            self._fused_exec_update = \
                self._exec_group.execs[0].install_fused_update(
                    self._optimizer, param_names=self._exec_group.param_names,
                    compression_params=kvstore._compression_params)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Use ``shared_module``'s optimizer, kvstore and updater
        (reference: module.py borrow_optimizer; BucketingModule)."""
        if not shared_module.optimizer_initialized:
            raise RuntimeError("the shared module has no optimizer yet")
        for attr in ("_optimizer", "_kvstore", "_update_on_kvstore",
                     "_updater"):
            setattr(self, attr, getattr(shared_module, attr))
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        """Reference: module.py forward.  A batch of other input shapes
        (a bucket, a last partial batch) rebinds the executor first,
        from the batch's ``provide_data``/``provide_label`` where it has
        them."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("bind and initialise the module first")
        curr = tuple(d.shape for d in self._data_shapes)
        new = tuple(tuple(d.shape) for d in data_batch.data)
        if curr != new:
            new_dshape = getattr(data_batch, "provide_data", None) or \
                [(d.name, shp) for d, shp in zip(self._data_shapes, new)]
            new_lshape = getattr(data_batch, "provide_label", None)
            if not new_lshape and getattr(data_batch, "label", None):
                new_lshape = [(d.name, lab.shape) for d, lab in
                              zip(self._label_shapes, data_batch.label)]
            self.reshape(new_dshape, new_lshape or None)
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        """Reference: module.py backward."""
        self._exec_group.backward(out_grads=out_grads)

    def get_input_grads(self, merge_multi_context=True):
        """The gradients of the data inputs (``inputs_need_grad``)."""
        if not (self.binded and self.params_initialized
                and self.inputs_need_grad):
            raise RuntimeError("bind with inputs_need_grad=True first")
        return self._exec_group.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update(self):
        """Apply the optimizer to the gradients (reference: module.py:631);
        nothing to do after a fused step."""
        if not self.optimizer_initialized:
            raise RuntimeError("call init_optimizer first")
        self._params_dirty = True
        if self._fused_exec_update and \
                self._exec_group.execs[0].updates_applied:
            return
        if self._update_on_kvstore:
            _update_params_on_kvstore(self._exec_group.param_arrays,
                                      self._exec_group.grad_arrays,
                                      self._kvstore,
                                      self._exec_group.param_names)
        else:
            _update_params(self._exec_group.param_arrays,
                           self._exec_group.grad_arrays,
                           updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore,
                           param_names=self._exec_group.param_names)

    def get_outputs(self, merge_multi_context=True):
        return self._exec_group.get_outputs(
            merge_multi_context=merge_multi_context)

    def install_monitor(self, mon):
        """Install ``mon`` on the bound executor (reference:
        module.py:496)."""
        if not self.binded:
            raise RuntimeError("bind the module before installing a "
                               "monitor")
        self._exec_group.install_monitor(mon)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._exec_group.update_metric(eval_metric, labels, pre_sliced)
