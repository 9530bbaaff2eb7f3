"""Elastic preemptible training — survive the fault, keep the curve.

Counterpart of ``mxnet_tpu/fault/elastic.py`` (reference: the
TensorFlow paper's fault-tolerance design, arxiv 1605.08695 — periodic
checkpoints + re-execution on worker loss).  The port's checkpoint
manager resumes a ``Module.fit`` bit for bit (params, optimizer slots,
RNG chain, iterator cursor and shuffle order); this is the RUNTIME that
exploits it while the job runs: catch the death, decide it is
survivable, wait out the backoff, restore the newest complete
checkpoint and re-enter the loop without skipping or doubling a batch.

- :class:`ElasticSupervisor` — the budgeted retry loop: classify the
  failure (preemption exit 143 and infrastructure errors are
  recoverable; programming errors are not), sleep the shared
  :class:`~.backoff.BackoffPolicy`, recover, re-enter.  Exhaustion
  degrades LOUDLY — :class:`ElasticError` chains the last failure and
  ``mxnet_fault_gave_up_total`` ticks — and never hangs.
- :class:`ProcessSupervisor` — the same loop over a whole worker
  process: death by signal and exit 143 relaunch, any other exit is a
  bug.
- :func:`elastic_fit` — the ``Module.fit(elastic=True)`` body: each
  re-entry restores the latest checkpoint, so the resumed epoch
  continues from the exact batch the snapshot captured.
- :func:`run_elastic` — the ``ParallelTrainer`` driver: the factory may
  hand back a trainer on a DIFFERENT mesh each attempt (a sub-mesh of the
  world's ranks, wider or narrower); ``checkpoint.check_restore_compat``
  vets the (checkpoint, new topology) pair before anything binds, and the
  restore reshards.  Every rank of the world runs the loop (the mesh and
  its groups are built collectively); a rank outside the attempt's mesh
  steps nothing and records no loss.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..telemetry import flight as _flight
from ..telemetry import tracing as _trace
from . import hooks
from .backoff import BackoffPolicy
from .plan import FaultInjected

__all__ = ["ElasticError", "ElasticSupervisor", "ProcessSupervisor",
           "elastic_fit", "run_elastic", "RECOVERABLE", "PREEMPTION_EXIT"]

# failure classes worth a restore-and-retry: infrastructure errors,
# framework errors (a poisoned collective surfaces as MXNetError), and
# injected faults.  Programming errors (TypeError, AssertionError,
# KeyboardInterrupt) are NOT here — burning a retry budget on a bug
# only delays the traceback.
RECOVERABLE = (OSError, ConnectionError, TimeoutError, MXNetError,
               RuntimeError, FaultInjected)

# the preemption convention: fit's SIGTERM grace path exits 143
PREEMPTION_EXIT = 143


def _metrics():
    from .. import telemetry
    return {
        "retries": telemetry.counter(
            "mxnet_fault_retries_total",
            "elastic-training restore-and-retry cycles entered"),
        "recoveries": telemetry.counter(
            "mxnet_fault_recoveries_total",
            "elastic-training runs that completed after >= 1 retry"),
        "gave_up": telemetry.counter(
            "mxnet_fault_gave_up_total",
            "elastic-training runs that exhausted the retry budget"),
    }


class ElasticError(MXNetError):
    """The retry budget is exhausted (or the checkpoint cannot land on
    the new topology); ``__cause__`` chains the final failure."""


class ElasticSupervisor:
    """Budgeted catch/backoff/recover/re-enter loop (see module
    docstring).  ``retries``/``backoff`` default from the
    ``MXNET_FAULT_RETRIES`` / ``MXNET_FAULT_BACKOFF_*`` knobs."""

    def __init__(self, retries=None, backoff=None, recoverable=RECOVERABLE,
                 logger=None):
        from .. import config as _config
        self.retries = int(_config.get("MXNET_FAULT_RETRIES")
                           if retries is None else retries)
        self.backoff = backoff if backoff is not None else BackoffPolicy()
        self.recoverable = tuple(recoverable)
        self.logger = logger or logging.getLogger("mxnet_tpu_torch.fault")

    def is_recoverable(self, exc):
        """Preemption exits (143) and the recoverable families — but
        never :class:`ElasticError` itself (an exhausted or
        incompatible inner loop must not feed an outer budget)."""
        if isinstance(exc, ElasticError):
            return False
        if isinstance(exc, SystemExit):
            return exc.code == PREEMPTION_EXIT
        return isinstance(exc, self.recoverable)

    def run(self, attempt, recover=None):
        """``attempt(restart)`` until it returns, with up to
        ``retries`` recovered failures.  ``recover(exc, restart)`` runs
        after the backoff sleep, before re-entry (rebuild state the
        failure may have poisoned).  Returns ``attempt``'s result."""
        m = _metrics()
        restart = 0
        while True:
            try:
                result = attempt(restart)
            except BaseException as exc:  # incl. SystemExit(143)
                if not self.is_recoverable(exc):
                    raise
                if restart >= self.retries:
                    m["gave_up"].inc()
                    self.logger.error(
                        "elastic: retry budget exhausted after %d "
                        "restart(s); giving up (%s: %s)", restart,
                        type(exc).__name__, exc)
                    _flight.incident(
                        "elastic_error", restarts=restart,
                        error="%s: %s" % (type(exc).__name__, exc))
                    raise ElasticError(
                        "elastic training gave up after %d restart(s); "
                        "last failure: %s: %s"
                        % (restart, type(exc).__name__, exc)) from exc
                m["retries"].inc()
                _flight.record("elastic_retry", restart=restart + 1,
                               error=type(exc).__name__)
                self.logger.warning(
                    "elastic: recoverable failure (%s: %s); restore-and-"
                    "retry %d/%d after backoff", type(exc).__name__, exc,
                    restart + 1, self.retries)
                self.backoff.sleep_for(restart)
                if recover is not None:
                    recover(exc, restart)
                restart += 1
                continue
            if restart:
                m["recoveries"].inc()
                self.logger.info(
                    "elastic: run completed after %d restart(s)", restart)
            return result


class ProcessSupervisor:
    """:class:`ElasticSupervisor`'s cross-process twin: supervise a
    whole WORKER PROCESS instead of an in-process attempt.

    The multi-host drills SIGKILL real subprocesses mid-step (a
    preempted VM takes no cleanup path), and the thing that respawns
    the survivor set on a new mesh width lives HERE, not in the test
    harness: ``launch(restart)`` starts attempt ``restart`` — on
    whatever width the fleet has now — waits for it, and returns its
    exit code.  Death by signal (``rc < 0``) and the preemption exit
    (143) are recoverable: sleep the budgeted
    :class:`~.backoff.BackoffPolicy`, relaunch.  ``rc == 0`` completes;
    any other exit is a worker BUG and raises :class:`ElasticError`
    immediately — burning restarts on a deterministic failure only
    delays the traceback.  Returns the exit-code list (last entry 0).
    """

    def __init__(self, retries=None, backoff=None, logger=None):
        from .. import config as _config
        self.retries = int(_config.get("MXNET_FAULT_RETRIES")
                           if retries is None else retries)
        self.backoff = backoff if backoff is not None else BackoffPolicy()
        self.logger = logger or logging.getLogger("mxnet_tpu_torch.fault")

    @staticmethod
    def is_recoverable(rc):
        return rc < 0 or rc == PREEMPTION_EXIT

    def run(self, launch):
        m = _metrics()
        rcs = []
        restart = 0
        while True:
            rc = int(launch(restart))
            rcs.append(rc)
            if rc == 0:
                if restart:
                    m["recoveries"].inc()
                    self.logger.info(
                        "elastic: worker fleet completed after %d "
                        "relaunch(es)", restart)
                return rcs
            if not self.is_recoverable(rc):
                _flight.incident("elastic_error", rc=rc,
                                 deterministic=True)
                raise ElasticError(
                    "worker process failed deterministically (rc=%d) — "
                    "not a preemption, not relaunching" % rc)
            if restart >= self.retries:
                m["gave_up"].inc()
                _flight.incident("elastic_error", restarts=restart,
                                 rc=rc)
                raise ElasticError(
                    "elastic fleet gave up after %d relaunch(es); last "
                    "worker exit rc=%d" % (restart, rc))
            m["retries"].inc()
            _flight.record("elastic_retry", restart=restart + 1, rc=rc)
            self.logger.warning(
                "elastic: worker died rc=%d (signal/preemption); "
                "relaunch %d/%d after backoff", rc, restart + 1,
                self.retries)
            self.backoff.sleep_for(restart)
            restart += 1


# ---------------------------------------------------------------------------
# Module.fit(elastic=True)
# ---------------------------------------------------------------------------

def elastic_fit(module, train_data, checkpoint_manager=None, retries=None,
                backoff=None, resume=True, **fit_kwargs):
    """Run ``module.fit`` under an :class:`ElasticSupervisor`.

    Each (re-)entry restores the newest complete checkpoint — params,
    optimizer slots + schedule position, RNG chain, iterator cursor and
    shuffle order — so a resumed epoch continues from the exact batch
    the snapshot captured: no batch skipped, none doubled.  A SIGTERM that lands mid-epoch takes
    fit's grace-window save + exit-143 path, which the supervisor
    classifies as preemption and turns into restore-and-continue.

    ``checkpoint_manager`` (or ``MXNET_CKPT_DIR``) is REQUIRED —
    elastic semantics without durable state would silently re-run
    epochs.  ``resume=True`` also restores on the FIRST attempt, so a
    restarted process picks up where its predecessor died."""
    if checkpoint_manager is None:
        from .. import checkpoint as _checkpoint
        checkpoint_manager = _checkpoint.default_manager()
    if checkpoint_manager is None:
        raise ValueError(
            "fit(elastic=True) needs a checkpoint manager (argument or "
            "MXNET_CKPT_DIR): elastic resume is checkpoint restore")
    supervisor = ElasticSupervisor(retries=retries, backoff=backoff)
    begin = {"epoch": int(fit_kwargs.pop("begin_epoch", 0))}
    fit_kwargs.pop("elastic", None)

    def attempt(restart):
        if (restart or resume) and \
                checkpoint_manager.latest_step() is not None:
            state = checkpoint_manager.restore_latest(
                module, train_data=train_data)
            if state is not None:
                begin["epoch"] = state.epoch
                logging.info(
                    "elastic: restored checkpoint (epoch %d, batch %d); "
                    "re-entering fit", state.epoch, state.nbatch)
        return module.fit(train_data, begin_epoch=begin["epoch"],
                          checkpoint_manager=checkpoint_manager,
                          **fit_kwargs)

    return supervisor.run(attempt)


# ---------------------------------------------------------------------------
# ParallelTrainer elastic driver
# ---------------------------------------------------------------------------

def _latest_trainer_state(store):
    """Newest readable ``ParallelTrainerState`` in ``store`` ->
    ``(step, state)`` or ``(None, None)``; walks back past bit rot and
    foreign payload kinds like the manager's restore does."""
    from ..checkpoint.state import ParallelTrainerState
    from ..checkpoint.store import IntegrityError
    for s in reversed(store.steps()):
        try:
            manifest, arrays, blobs = store.read(s, verify=True)
        except (IntegrityError, OSError, ValueError) as exc:
            logging.warning(
                "elastic: checkpoint step %d unreadable (%s); trying "
                "older", s, exc)
            continue
        meta = manifest.get("meta", {})
        if meta.get("kind") != ParallelTrainerState.kind:
            continue
        return int(s), ParallelTrainerState.from_payload(arrays, blobs,
                                                         meta)
    return None, None


def run_elastic(trainer_factory, data_fn, num_steps, manager,
                save_every=1, supervisor=None, retries=None, backoff=None,
                on_restore=None, loss_log=None):
    """Elastic step loop over a :class:`~..parallel.ParallelTrainer`.

    - ``trainer_factory(restart)`` builds the trainer for attempt
      ``restart``, on another mesh if the fleet shrank or grew; the
      checkpoint payload is mesh-independent and the restore reshards.
    - ``data_fn(step) -> (data, label)`` must be a pure function of the
      global step (the global batch): a replayed step consumes exactly
      the batch the lost step would have.
    - checkpoints commit synchronously every ``save_every`` steps under
      step id ``step + 1`` (= completed steps), so the resume point is
      always a step boundary.

    Returns the per-step loss list (floats, length ``num_steps``; None
    for a step this rank did not run).  ``loss_log`` (a path) appends one
    ``{"step": s, "loss": x}`` JSON line per step as it completes.
    Raises :class:`ElasticError` on budget exhaustion or when
    ``check_restore_compat`` rejects the (checkpoint, new topology) pair
    — loudly, never a silent re-init."""
    from ..checkpoint import CheckpointManager
    from ..checkpoint.compat import check_restore_compat
    if isinstance(manager, str):
        manager = CheckpointManager(directory=manager)
    supervisor = supervisor or ElasticSupervisor(retries=retries,
                                                 backoff=backoff)
    losses = {}   # step -> float, shared across attempts

    def attempt(restart):
        trainer = trainer_factory(restart)
        start = 0
        step_id, state = _latest_trainer_state(manager.store)
        if state is not None:
            verdict = check_restore_compat(state, trainer)
            if not verdict["compatible"]:
                _flight.incident("elastic_error", step=step_id,
                                 problems=verdict["problems"])
                raise ElasticError(
                    "checkpoint step %s cannot restore onto the new "
                    "topology: %s" % (step_id, verdict["problems"]))
            if on_restore is not None:
                on_restore(step_id, verdict)
            state.restore_into(trainer)
            start = step_id
            logging.info(
                "elastic: resumed ParallelTrainer at step %d on mesh %s"
                " (notes: %s)", start,
                dict(zip(trainer.mesh.axis_names,
                         trainer.mesh.devices.shape)),
                verdict.get("notes", []))
        for step in range(start, int(num_steps)):
            hooks.set_step(step)
            with _trace.span("elastic.step", step=step):
                if hooks.ACTIVE[0]:
                    # plans address this site by step to die at an exact
                    # batch
                    hooks.fire("elastic.step", step=step)
                x, y = data_fn(step)
                loss = trainer.step(x, y)
            if loss is None:
                continue
            # the loss curve is the product (compared against an
            # uninterrupted run), and the read bounds how far the loop
            # runs ahead of the synchronous save below
            losses[step] = float(loss.asnumpy())
            if loss_log:
                import json
                with open(loss_log, "a") as f:
                    f.write(json.dumps({"step": step,
                                        "loss": losses[step]}) + "\n")
                    f.flush()
            if (step + 1) % max(1, int(save_every)) == 0 \
                    or step + 1 == int(num_steps):
                trainer.save_checkpoint(manager, step=step + 1, block=True)
        return [losses.get(s) for s in range(int(num_steps))]

    return supervisor.run(attempt)
