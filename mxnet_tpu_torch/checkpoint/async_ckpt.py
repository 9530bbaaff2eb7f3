"""AsyncCheckpointer — serialization off the step path (counterpart of
``mxnet_tpu/checkpoint/async_ckpt.py``).

The legacy ``save_checkpoint`` stalls training for the full
device-sync + serialize + write round trip.  Here the split is:

- **staging** (caller thread, cheap): ``TrainState.capture`` copies
  the device arrays to the host, synchronously, before the caller
  launches the next step — the only part that must see a quiescent
  training state (the fused step updates the weights in place on the
  device, so a copy still in flight could read the next step's);
- **serialization + hashing + commit** (background thread): handed to
  a worker wrapped in ``engine.worker_scope``, so a failed save
  delivers its error to the checkpointer's failure surface (telemetry
  counter + ``last_error()``) instead of killing the thread or
  poisoning unrelated sync points — the ThreadedEngine contract.

At most ONE save is in flight: a save requested while another runs is
refused (returns False, counted in ``mxnet_checkpoint_skipped_total``)
rather than queued — checkpoints are snapshots, and a queue of stale
snapshots behind a slow disk is pure write amplification.  The caller
(the fit hook, ``module_checkpoint``) simply tries again next period.

Retention runs on the worker thread after each commit, followed by
orphan GC — the collection point for temp dirs left by crashed writers.
"""
from __future__ import annotations

import logging
import threading
import time

from .. import engine
from .. import profiler
from .. import telemetry

__all__ = ["AsyncCheckpointer", "write_checkpoint"]


def _metrics():
    """The ``mxnet_checkpoint_*`` family (created on first use; the
    registry dedupes).  Checkpointing is not a per-step hot path, so —
    like serving — it records unconditionally."""
    return {
        "saves": telemetry.counter(
            "mxnet_checkpoint_saves_total",
            "committed checkpoint saves"),
        "failures": telemetry.counter(
            "mxnet_checkpoint_failures_total",
            "checkpoint saves that failed before commit"),
        "skipped": telemetry.counter(
            "mxnet_checkpoint_skipped_total",
            "save requests refused because one was already in flight"),
        "bytes": telemetry.counter(
            "mxnet_checkpoint_bytes",
            "total payload bytes committed across all saves"),
        "save_seconds": telemetry.histogram(
            "mxnet_checkpoint_save_seconds",
            "wall seconds per committed save (serialize+hash+commit)"),
        "retained": telemetry.gauge(
            "mxnet_checkpoint_retained",
            "complete checkpoints on disk after retention"),
    }


def write_checkpoint(store, step, arrays, blobs=None, meta=None,
                     retention=None):
    """Serialize + commit one checkpoint synchronously, with telemetry
    and a ``checkpoint:save`` profiler span; the one write path both the
    sync manager and the async worker use.  Failures are counted and
    re-raised (the async worker's ``worker_scope`` catches them)."""
    m = _metrics()
    t0 = time.perf_counter()
    try:
        with profiler.scope("checkpoint:save", cat="checkpoint",
                            args={"step": int(step)}):
            path = store.write(step, arrays, blobs=blobs, meta=meta)
    except Exception:
        m["failures"].inc()
        raise
    elapsed = time.perf_counter() - t0
    m["saves"].inc()
    m["bytes"].inc(store.total_bytes(step))
    m["save_seconds"].observe(elapsed)
    if retention is not None:
        retention.apply(store)
    store.gc_orphans()
    m["retained"].set(len(store.steps()))
    logging.info("checkpoint: committed step %d to %s (%.3fs)",
                 int(step), path, elapsed)
    return path


class AsyncCheckpointer:
    """Background writer over a :class:`CheckpointStore` enforcing
    at-most-one in-flight save."""

    def __init__(self, store, retention=None):
        self.store = store
        self.retention = retention
        self._lock = threading.Lock()
        self._inflight = None     # guarded-by: _lock — live writer thread
        self._last_error = None   # guarded-by: _lock — newest failed save's exc
        self._saves_started = 0   # guarded-by: _lock

    def save(self, step, arrays, blobs=None, meta=None, block=False,
             ready=None):
        """Enqueue one pre-staged save; returns True when accepted,
        False when refused because a save is already in flight.
        ``ready()``, when given, runs on the writer's thread first (it
        waits for the staging copies to land: ``TrainState.wait``)."""
        with self._lock:
            if self._inflight is not None and self._inflight.is_alive():
                _metrics()["skipped"].inc()
                return False
            thread = threading.Thread(
                target=self._run, args=(step, arrays, blobs, meta, ready),
                name="ckpt-save-%d" % int(step), daemon=True)
            self._inflight = thread
            self._saves_started += 1
        thread.start()
        if block:
            thread.join()
        return True

    def _run(self, step, arrays, blobs, meta, ready=None):
        with engine.worker_scope(deliver=self._deliver):
            # a fault on the writer thread must land in
            # _deliver (failure counted, training untouched), never
            # poison global sync points — the containment this scope
            # exists to prove
            from ..fault import hooks as _fault
            from ..telemetry import tracing as _tracing
            with _tracing.span("checkpoint.async.worker", step=int(step)):
                if _fault.ACTIVE[0]:
                    _fault.fire("checkpoint.async.worker", step=step)
                if ready is not None:
                    ready()
                write_checkpoint(self.store, step, arrays, blobs=blobs,
                                 meta=meta, retention=self.retention)

    def _deliver(self, exc):
        """Failure surface: the error is recorded here (telemetry
        already counted it in ``write_checkpoint``) and reported as
        delivered, so it does NOT poison global sync points — training
        is healthy, only the snapshot was lost, and the next periodic
        save retries."""
        with self._lock:
            self._last_error = exc
        logging.warning("checkpoint: async save failed (%s: %s); training "
                        "continues, next periodic save retries",
                        type(exc).__name__, exc)
        return True

    def wait(self, timeout=None):
        """Join the in-flight save, if any; True when none remains."""
        with self._lock:
            thread = self._inflight
        if thread is None:
            return True
        thread.join(timeout)
        return not thread.is_alive()

    def last_error(self):
        """The most recent failed save's exception, or None (cleared by
        :meth:`clear_error`)."""
        with self._lock:
            return self._last_error

    def clear_error(self):
        with self._lock:
            self._last_error = None

    @property
    def in_flight(self):
        with self._lock:
            return self._inflight is not None and self._inflight.is_alive()
