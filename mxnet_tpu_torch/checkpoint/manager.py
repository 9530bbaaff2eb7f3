"""CheckpointManager — policy layer over store + state + async writer
(counterpart of ``mxnet_tpu/checkpoint/manager.py``).

One manager owns one checkpoint directory: it assigns monotonically
increasing commit step ids (a high-water mark that survives retention
deletions), decides sync vs async per ``MXNET_CKPT_ASYNC``, applies the
retention ladder, collects orphan temp dirs at startup, and exposes the
restore path that always lands on the newest checkpoint that passes
integrity verification — falling back to older complete checkpoints
when the newest one is bit-rotted, never to a partial one (partials are
unreachable by construction: the store only commits via directory
rename).

``sigterm_save_scope`` is the preemption hook: while active (the fit
loop wraps itself in one when ``MXNET_CKPT_ON_SIGTERM`` is on), SIGTERM
triggers one final SYNCHRONOUS save of the current training position
before the process exits with the conventional 143 — on a preemptible
fleet the grace window between SIGTERM and SIGKILL is exactly for
this.
"""
from __future__ import annotations

import contextlib
import logging
import signal
import threading
import time

from .. import config as _config
from .. import profiler
from .. import telemetry
from .async_ckpt import AsyncCheckpointer, write_checkpoint
from .async_ckpt import _metrics as _async_metrics
from .state import TrainState
from .store import CheckpointError, CheckpointStore, RetentionPolicy

__all__ = ["CheckpointManager", "default_manager", "sigterm_flag_scope"]


def _restore_metrics():
    return {
        "restores": telemetry.counter(
            "mxnet_checkpoint_restores_total",
            "successful checkpoint restores"),
        "restore_failures": telemetry.counter(
            "mxnet_checkpoint_restore_failures_total",
            "checkpoints skipped during restore (integrity/read failure)"),
        "restore_seconds": telemetry.histogram(
            "mxnet_checkpoint_restore_seconds",
            "wall seconds per restore (read+verify+load)"),
    }


class CheckpointManager:
    """Durable, resumable training state for one checkpoint directory.

    All knobs default from the ``MXNET_CKPT_*`` registry so a manager
    constructed bare (``CheckpointManager()`` with ``MXNET_CKPT_DIR``
    set) matches the one ``fit`` builds implicitly."""

    def __init__(self, directory=None, keep_last=None, keep_every=None,
                 async_save=None, period_steps=None, period_epochs=None):
        if directory is None:
            directory = _config.get("MXNET_CKPT_DIR")
        if not directory:
            raise ValueError(
                "CheckpointManager needs a directory (argument or "
                "MXNET_CKPT_DIR)")
        if keep_last is None:
            keep_last = _config.get("MXNET_CKPT_KEEP_LAST")
        if keep_every is None:
            keep_every = _config.get("MXNET_CKPT_KEEP_EVERY")
        if async_save is None:
            async_save = _config.get("MXNET_CKPT_ASYNC")
        if period_steps is None:
            period_steps = _config.get("MXNET_CKPT_PERIOD_STEPS")
        if period_epochs is None:
            period_epochs = _config.get("MXNET_CKPT_PERIOD_EPOCHS")
        self.store = CheckpointStore(directory)
        self.retention = RetentionPolicy(keep_last=keep_last,
                                         keep_every=keep_every)
        self.async_save = bool(async_save)
        self.period_steps = int(period_steps or 0)
        self.period_epochs = int(period_epochs or 0)
        self._async = AsyncCheckpointer(self.store, retention=self.retention)
        self._lock = threading.Lock()
        # commit-sequence high-water mark: starts past everything on
        # disk so resumed jobs keep appending, and never reuses an id
        # even after retention deletes old directories
        latest = self.store.latest()
        self._next_step = (latest + 1) if latest is not None else 1  # guarded-by: _lock
        self.store.gc_orphans()

    # -- save ----------------------------------------------------------------
    def _claim_step(self, requested=None):
        with self._lock:
            # floor on what is actually on disk: a SECOND manager over
            # the same directory (explicit + process-default) may have
            # committed since this one initialized its high-water mark,
            # and reusing a committed id would fail the write
            latest = self.store.latest()
            floor = (latest + 1) if latest is not None else 1
            step = max(int(requested or 0), self._next_step, floor)
            self._next_step = step + 1
            return step

    def save_state(self, state, step=None, block=False):
        """Persist a pre-captured :class:`TrainState`.

        ``block=False`` (the periodic path): hand off to the async
        writer when enabled; returns False when refused because a save
        is already in flight (the next period retries).  ``block=True``
        (SIGTERM, final epoch): a GUARANTEED save — any in-flight write
        is drained first, then this snapshot commits synchronously;
        always returns True or raises."""
        arrays, blobs, meta = state.to_payload()
        if block or not self.async_save:
            if block:
                self._async.wait()
            step = self._claim_step(step)
            state.wait()
            write_checkpoint(self.store, step, arrays, blobs=blobs,
                             meta=meta, retention=self.retention)
            return True
        step = self._claim_step(step)
        return self._async.save(step, arrays, blobs=blobs, meta=meta,
                                ready=state.wait)

    def save_module(self, module, epoch=0, nbatch=0, global_step=None,
                    train_data=None, block=False):
        """Capture ``module`` (+ loop/RNG/iterator state) and persist it
        — THE save entry point for fit hooks and callbacks.  The capture
        runs on the caller's thread and queues its copies to the host
        without waiting for them; with ``async_save`` the write runs on
        the writer's thread, which waits for them first.  A periodic
        save the busy writer would refuse is refused before capturing
        (the JAX package captures, then refuses)."""
        if not block and self.async_save and self._async.in_flight:
            _async_metrics()["skipped"].inc()
            return False
        state = TrainState.capture(module, epoch=epoch, nbatch=nbatch,
                                   global_step=global_step,
                                   train_data=train_data)
        return self.save_state(state, block=block)

    # -- restore -------------------------------------------------------------
    def restore_latest(self, module=None, train_data=None, restore_rng=True):
        """Load the newest checkpoint that verifies, walking backwards
        past corrupt ones; returns the :class:`TrainState` (restored
        into ``module`` when given) or None when nothing restorable
        exists."""
        m = _restore_metrics()
        for step in reversed(self.store.steps()):
            t0 = time.perf_counter()
            try:
                with profiler.scope("checkpoint:restore", cat="checkpoint",
                                    args={"step": int(step)}):
                    manifest, arrays, blobs = self.store.read(step,
                                                              verify=True)
            # CheckpointError too (a transient manifest read): the JAX
            # package lets it escape the walk, and the restore fails
            # although an older checkpoint reads
            except (CheckpointError, OSError, ValueError) as exc:
                m["restore_failures"].inc()
                logging.warning(
                    "checkpoint: step %d unreadable (%s); trying older",
                    step, exc)
                continue
            state = TrainState.from_payload(arrays, blobs,
                                            manifest.get("meta", {}))
            if module is not None:
                state.restore_into(module, train_data=train_data,
                                   restore_rng=restore_rng)
            m["restores"].inc()
            m["restore_seconds"].observe(time.perf_counter() - t0)
            logging.info("checkpoint: restored step %d (epoch %d, batch %d)",
                         step, state.epoch, state.nbatch)
            return state
        return None

    # -- introspection / lifecycle -------------------------------------------
    def latest_step(self):
        return self.store.latest()

    def steps(self):
        return self.store.steps()

    def wait(self, timeout=None):
        """Join any in-flight async save."""
        return self._async.wait(timeout)

    def last_error(self):
        return self._async.last_error()

    def close(self):
        """Drain the writer (call at end of training)."""
        self.wait()


# ---------------------------------------------------------------------------
# process-default manager — what Module.save_checkpoint and fit() reach
# for when MXNET_CKPT_DIR is set and no explicit manager was passed
# ---------------------------------------------------------------------------
_DEFAULT_LOCK = threading.Lock()
_DEFAULT = {}   # guarded-by: _DEFAULT_LOCK — directory -> CheckpointManager


def default_manager(directory=None):
    """The shared manager for ``directory`` (default ``MXNET_CKPT_DIR``),
    or None when no directory is configured.  One manager per directory
    per process, so the at-most-one-in-flight guarantee holds across
    every implicit save site."""
    if directory is None:
        directory = _config.get("MXNET_CKPT_DIR")
    if not directory:
        return None
    with _DEFAULT_LOCK:
        mgr = _DEFAULT.get(directory)
        if mgr is None:
            mgr = CheckpointManager(directory=directory)
            _DEFAULT[directory] = mgr
        return mgr


@contextlib.contextmanager
def sigterm_flag_scope():
    """While active, SIGTERM sets the yielded flag (``{"signaled":
    True}``) instead of acting inside the handler — the preemption
    grace-window hook, deadlock-free.

    A Python signal handler runs between bytecodes of the interrupted
    main thread; performing the save inline there would re-acquire
    non-reentrant locks that thread may already hold (telemetry counter
    locks fire on every batch, the manager's own step lock during a
    periodic save) and deadlock for the whole grace window.  So the
    handler only flips a flag; the consumer (the fit batch loop) polls
    it at safe points — outside every lock — saves synchronously, and
    exits with the conventional 143.

    Signal handlers are a main-thread-only facility; on other threads
    the scope yields a flag that never sets (periodic saves still
    run)."""
    flag = {"signaled": False}
    if threading.current_thread() is not threading.main_thread():
        yield flag
        return
    prev = signal.getsignal(signal.SIGTERM)

    def _handler(signum, frame):
        # async-signal-safe by construction: one dict store, no locks
        flag["signaled"] = True

    try:
        signal.signal(signal.SIGTERM, _handler)
    except ValueError:
        # late thread-context change (embedded interpreters)
        yield flag
        return
    try:
        yield flag
    finally:
        signal.signal(signal.SIGTERM, prev)
