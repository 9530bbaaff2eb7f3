"""BaseModule — the canonical training loop.

Counterpart of ``mxnet_tpu/module/base_module.py`` (reference:
python/mxnet/module/base_module.py:81): ``forward_backward``, ``score``,
``iter_predict``/``predict`` and ``fit`` (bind, init_params,
init_optimizer, then per batch forward_backward / update / update_metric,
``prepare`` of the next batch (where a ``BucketingModule`` binds its
bucket) and the batch-end callbacks, and per epoch the parameter sync
and epoch-end callbacks), and
``save_params``/``load_params`` (the ``arg:``/``aux:`` container).
``fit(monitor=...)`` installs the monitor after binding and brackets each
step with its ``tic`` and ``toc_print``, as the JAX package does.
``MXNET_TELEMETRY_STEP_LOG`` adds a ``telemetry.StepLogger`` to the
batch-end callbacks (closed when ``fit`` returns or raises), and each
step's forward, backward and update is one ``fit.step`` span while
tracing is on; under an armed fault plan each step is the ``fit.step``
site, with the global batch published as the plan's step.

``fit(checkpoint_manager=...)`` (or, without one, the process-default
manager when ``MXNET_CKPT_DIR`` is set) saves as the JAX package does:
every ``period_steps`` batches (captured before the next batch is
fetched, so the cursor points past the trained batch), every
``period_epochs`` epochs (the final one blocking), and, with
``MXNET_CKPT_ON_SIGTERM``, one synchronous save at the first safe point
after a SIGTERM, then exit 143.  ``fit(elastic=True)`` runs the loop
under ``fault.elastic``'s supervisor: a recoverable failure (an
infrastructure error, an injected fault, the SIGTERM exit 143) restores
the newest checkpoint and re-enters, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import logging
import time
import warnings

from .. import config as _config
from .. import metric
from .. import ndarray
from .. import telemetry
from ..fault import hooks as _fault
from ..telemetry import tracing as _tracing
from ..base import MXNetError
from ..initializer import Uniform
from ..model import BatchEndParam

__all__ = ["BaseModule"]

_PARAM_SUFFIXES = ("_weight", "_bias", "_gamma", "_beta")


def _check_input_names(symbol, names, typename, throw):
    """Declared data/label names must be arguments of the graph
    (reference: base_module.py:34)."""
    args = set(symbol.list_arguments())
    missing = [n for n in names if n not in args]
    if not missing:
        return
    inputs = [a for a in symbol.list_arguments()
              if not a.endswith(_PARAM_SUFFIXES)]
    msg = ("%s_names=%r includes %r, which is not an argument of the "
           "symbol. Graph inputs are: %s"
           % (typename, list(names), missing[0], ", ".join(inputs)))
    if throw:
        raise ValueError(msg)
    warnings.warn(msg)


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


class BaseModule:
    """Base class for modules (reference: base_module.py:81)."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    def forward_backward(self, data_batch):
        """Reference: base_module.py:191."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """Evaluate on ``eval_data`` (reference: base_module.py:208)."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("bind and initialise the module first")
        eval_metric = eval_metric if isinstance(eval_metric,
                                                metric.EvalMetric) \
            else metric.create(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, nbatch, batch)`` a batch, the pad rows cut
        off (reference: base_module.py:266)."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("bind and initialise the module first")
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad]
                       for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, sparse_row_id_fn=None):
        """The outputs over ``eval_data``, the pad rows cut off, joined
        along the batch axis unless ``merge_batches`` is False
        (reference: base_module.py:310)."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("bind and initialise the module first")
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            output_list.append([out[0:out.shape[0] - pad].copy()
                                for out in self.get_outputs()])
        if not output_list:
            return output_list
        if not merge_batches:
            return output_list
        num_outputs = len(output_list[0])
        if any(len(out) != num_outputs for out in output_list):
            raise ValueError("Cannot merge batches, as num of outputs is "
                             "not the same in mini-batches. Maybe bucketing "
                             "is used?")
        merged = [ndarray.concatenate([out[i] for out in output_list])
                  for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None, checkpoint_manager=None,
            elastic=False):
        """The canonical train loop (reference: base_module.py:395).

        ``checkpoint_manager``: a ``checkpoint.CheckpointManager`` for
        preemption-safe periodic saves (see the module docstring); None
        with ``MXNET_CKPT_DIR`` set uses the process-default manager.

        ``elastic=True`` runs the loop under
        :class:`~mxnet_tpu_torch.fault.ElasticSupervisor`: recoverable
        failures (infrastructure errors, injected faults, the SIGTERM
        exit-143 preemption path) restore the newest checkpoint —
        params, optimizer, RNG, iterator cursor — and re-enter with
        exponential backoff, up to ``MXNET_FAULT_RETRIES`` times; a
        checkpoint manager is then required."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        if elastic:
            from ..fault.elastic import elastic_fit
            return elastic_fit(
                self, train_data, checkpoint_manager=checkpoint_manager,
                eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=optimizer, optimizer_params=optimizer_params,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback,
                initializer=initializer, arg_params=arg_params,
                aux_params=aux_params, allow_missing=allow_missing,
                force_rebind=force_rebind, force_init=force_init,
                begin_epoch=begin_epoch, num_epoch=num_epoch,
                validation_metric=validation_metric, monitor=monitor,
                sparse_row_id_fn=sparse_row_id_fn)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric.EvalMetric):
            eval_metric = metric.create(eval_metric)
        batch_end_cbs = list(_as_list(batch_end_callback)) \
            if batch_end_callback is not None else []
        # MXNET_TELEMETRY_STEP_LOG: per-step JSONL of throughput and
        # counter deltas, as one more batch-end callback
        step_logger = None
        step_log_path = _config.get("MXNET_TELEMETRY_STEP_LOG")
        if step_log_path:
            step_logger = telemetry.StepLogger(
                step_log_path,
                batch_size=getattr(train_data, "batch_size", None),
                interval=_config.get("MXNET_TELEMETRY_STEP_INTERVAL"))
            batch_end_cbs.append(step_logger)
        # an explicit manager wins; else MXNET_CKPT_DIR selects the
        # process-default one
        ckpt_mgr = checkpoint_manager
        if ckpt_mgr is None and _config.get("MXNET_CKPT_DIR"):
            from .. import checkpoint as _checkpoint
            ckpt_mgr = _checkpoint.default_manager()
        try:
            self._fit_epochs(train_data, eval_data, eval_metric,
                             validation_metric, batch_end_cbs,
                             epoch_end_callback, eval_end_callback,
                             eval_batch_end_callback, monitor,
                             sparse_row_id_fn, begin_epoch, num_epoch,
                             ckpt_mgr)
        finally:
            if step_logger is not None:
                step_logger.close()
            if ckpt_mgr is not None:
                # drain the last async save: a job that exits right
                # after fit() keeps its newest snapshot
                ckpt_mgr.wait()

    def _fit_epochs(self, train_data, eval_data, eval_metric,
                    validation_metric, batch_end_cbs, epoch_end_callback,
                    eval_end_callback, eval_batch_end_callback, monitor,
                    sparse_row_id_fn, begin_epoch, num_epoch, ckpt_mgr=None):
        # preemption: SIGTERM only sets a flag (a save inside the handler
        # could re-take locks the interrupted thread holds); the batch
        # loop polls it at safe points and saves there
        progress = {"epoch": begin_epoch, "nbatch": 0}
        scope = contextlib.nullcontext(None)
        if ckpt_mgr is not None and _config.get("MXNET_CKPT_ON_SIGTERM"):
            from .. import checkpoint as _checkpoint
            scope = _checkpoint.sigterm_flag_scope()
        with scope as sigterm:
            self._fit_epochs_inner(
                train_data, eval_data, eval_metric, validation_metric,
                batch_end_cbs, epoch_end_callback, eval_end_callback,
                eval_batch_end_callback, monitor, sparse_row_id_fn,
                begin_epoch, num_epoch, ckpt_mgr, progress, sigterm)
            # a signal that landed after the last in-loop poll (during
            # final evaluation, say) still gets its grace-window save
            if sigterm is not None and sigterm["signaled"]:
                self._preemption_save(ckpt_mgr, progress, train_data)

    def _preemption_save(self, ckpt_mgr, progress, train_data):
        """One guaranteed synchronous save of the current loop position,
        then exit 143 (the preemption convention), at a safe point on
        the training thread — never inside the signal handler."""
        # the loop prefetches one batch ahead; when that batch is fetched
        # but not yet trained ("pending"), the cursor overstates progress
        # by one batch — rewind it for the capture so resume re-trains
        # (never skips) that batch
        rewound = False
        if progress.get("pending") and \
                isinstance(getattr(train_data, "cursor", None), int) \
                and getattr(train_data, "batch_size", 0):
            train_data.cursor -= train_data.batch_size
            rewound = True
        try:
            ckpt_mgr.save_module(self, epoch=progress["epoch"],
                                 nbatch=progress["nbatch"],
                                 train_data=train_data, block=True)
        except Exception:   # noqa: BLE001 — logged; the exit stands
            self.logger.exception("checkpoint: SIGTERM save failed")
        finally:
            if rewound:
                train_data.cursor += train_data.batch_size
        self.logger.info("SIGTERM: checkpoint saved; exiting 143")
        raise SystemExit(143)

    def _fit_epochs_inner(self, train_data, eval_data, eval_metric,
                          validation_metric, batch_end_cbs,
                          epoch_end_callback, eval_end_callback,
                          eval_batch_end_callback, monitor,
                          sparse_row_id_fn, begin_epoch, num_epoch,
                          ckpt_mgr=None, progress=None, sigterm=None):
        # the fault plan's step address: a global batch counter across
        # epochs, so a plan can name an exact batch
        global_batch = 0
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            epoch_metrics = []
            batches = iter(train_data)
            data_batch = next(batches, None)
            nbatch = 0
            if progress is not None:
                progress.update(epoch=epoch, nbatch=0,
                                pending=data_batch is not None)
            while data_batch is not None:
                with _tracing.span("fit.step", epoch=epoch,
                                   batch=global_batch):
                    if _fault.ACTIVE[0]:
                        _fault.set_step(global_batch)
                        _fault.fire("fit.step", epoch=epoch)
                    global_batch += 1
                    if monitor is not None:
                        monitor.tic()
                    self.forward_backward(data_batch)
                    self.update()
                self.update_metric(eval_metric, data_batch.label)
                if progress is not None:
                    # batch (epoch, nbatch) is applied and the iterator
                    # has advanced past exactly nbatch+1 batches
                    progress.update(epoch=epoch, nbatch=nbatch + 1,
                                    pending=False)
                if ckpt_mgr is not None and ckpt_mgr.period_steps > 0 \
                        and (nbatch + 1) % ckpt_mgr.period_steps == 0:
                    # save BEFORE the prefetch advances the iterator, so
                    # the captured cursor points past the trained batch;
                    # the capture stages to the host before the next
                    # step is launched, the write overlaps the next steps
                    # (a refusal, one save already in flight, retries at
                    # the next period)
                    ckpt_mgr.save_module(self, epoch=epoch,
                                         nbatch=nbatch + 1,
                                         train_data=train_data)
                # fetch the next batch only after this step is queued: an
                # iterator may reuse the current batch's buffers
                upcoming = next(batches, None)
                if upcoming is not None:
                    self.prepare(upcoming, sparse_row_id_fn=sparse_row_id_fn)
                    if progress is not None:
                        # fetched but untrained: a SIGTERM save rewinds
                        # the cursor over this batch
                        progress["pending"] = True
                if monitor is not None:
                    monitor.toc_print()
                if upcoming is None:
                    # the epoch totals, before a callback can reset them
                    epoch_metrics = eval_metric.get_name_value()
                for callback in batch_end_cbs:
                    callback(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals()))
                if sigterm is not None and sigterm["signaled"]:
                    # preemption: save at this safe point and exit
                    self._preemption_save(ckpt_mgr, progress, train_data)
                nbatch += 1
                data_batch = upcoming
            for name, val in epoch_metrics:
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)

            # sync aux params across devices
            arg_params_, aux_params_ = self.get_params()
            self.set_params(arg_params_, aux_params_)
            if epoch_end_callback is not None:
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_params_, aux_params_)
            if ckpt_mgr is not None and ckpt_mgr.period_epochs > 0 \
                    and (epoch + 1) % ckpt_mgr.period_epochs == 0:
                # an epoch-boundary snapshot means "start of epoch+1": no
                # iterator position (it resets below); the final epoch's
                # save blocks, so the end state cannot lose a skip race
                # against an in-flight periodic save
                ckpt_mgr.save_module(self, epoch=epoch + 1, nbatch=0,
                                     block=(epoch + 1 == num_epoch))
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
                if eval_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=0,
                                           eval_metric=validation_metric,
                                           locals=locals())
                    for callback in _as_list(eval_end_callback):
                        callback(params)
            train_data.reset()
            if progress is not None:
                # epoch boundary: "start of epoch+1", nothing prefetched
                progress.update(epoch=epoch + 1, nbatch=0, pending=False)
            if sigterm is not None and sigterm["signaled"]:
                # a SIGTERM during epoch-end work: save before another
                # epoch starts
                self._preemption_save(ckpt_mgr, progress, train_data)

    def install_monitor(self, mon):  # pragma: no cover - abstract
        raise NotImplementedError()

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Get ready for ``data_batch`` (reference: base_module.py
        prepare); a ``BucketingModule`` binds the batch's bucket here."""

    def get_states(self, merge_multi_context=True):
        """No states: a module's state inputs come with stateful
        executors, which no module here has (reference: base_module.py
        get_states)."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("bind and initialise the module first")
        if merge_multi_context:
            raise MXNetError("merge_multi_context=True is not supported "
                             "for get_states")
        return []

    def set_states(self, states=None, value=None):
        if not (self.binded and self.params_initialized):
            raise RuntimeError("bind and initialise the module first")
        if states or value:
            raise MXNetError("this module has no states to set")

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        """Reference: base_module.py set_params."""
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        """Write the parameters as one ``arg:``/``aux:`` container
        (reference: base_module.py save_params)."""
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        ndarray.save(fname, save_dict)

    def export_serving(self, name, registry, version=None,
                       input_shapes=None):
        """Register this module's symbol and CURRENT params into a
        serving registry (a ``ModelRegistry``, or a ``ModelServer``,
        whose registry is used) without a checkpoint round trip;
        ``input_shapes`` defaults to the bound ``data_shapes``.  Returns
        the registered version (reference: the JAX package's
        ``export_serving``)."""
        if hasattr(registry, "registry"):    # a ModelServer
            registry = registry.registry
        arg_params, aux_params = self.get_params()
        if input_shapes is None:
            input_shapes = {d[0]: tuple(d[1]) for d in self.data_shapes}
        return registry.add(name, self.symbol, arg_params, aux_params,
                            input_shapes, version=version)

    def load_params(self, fname):
        """Set the parameters from a container ``save_params`` wrote
        (reference: base_module.py load_params), read onto the module's
        context."""
        save_dict = ndarray.load(fname, ctx=self._context[0])
        arg_params, aux_params = {}, {}
        for k, value in save_dict.items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)
