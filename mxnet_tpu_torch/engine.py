"""Engine control and deferred worker exceptions.

Counterpart of ``mxnet_tpu/engine.py`` (reference: python/mxnet/engine.py
and the threaded engine's exception model, src/engine/threaded_engine.h,
threaded_engine.cc:463-467).  PyTorch queues device work on a stream as
it is issued, so there is no dependency engine to configure:

- ``naive()`` is the reference's NaiveEngine oracle: inside the scope
  every imperative op (``imperative.invoke``) waits for its stream
  before it returns, so an op's failure or cost shows at the op.
- ``bulk(size)`` / ``set_bulk_size`` record the requested size, as the
  JAX package does; nothing here fuses ops.
- Deferred exceptions: work off the main thread (the serving batcher,
  any caller of ``record_exception``) stores its error here, and every
  sync point (``nd.waitall()``, ``NDArray.wait_to_read()``,
  ``.asnumpy()``) rethrows it once and clears it.  An exception that
  reaches no receiver also dumps the flight recorder
  (``telemetry.flight.incident("worker_exception")``) while tracing is
  on.
"""
from __future__ import annotations

import contextlib
import logging
import threading

__all__ = ["bulk", "set_bulk_size", "record_exception", "check_raise",
           "clear_exception", "consume_exception", "naive",
           "naive_scope_active", "worker_scope"]

_SCOPE_LOCK = threading.Lock()
_NAIVE_DEPTH = [0]   # guarded-by: _SCOPE_LOCK
_BULK_SIZE = [0]     # guarded-by: _SCOPE_LOCK

_EXC_LOCK = threading.Lock()
_DEFERRED_EXC = []   # guarded-by: _EXC_LOCK — the first exception wins


@contextlib.contextmanager
def naive():
    """Serial execution: every imperative op waits for the device before
    returning (the reference's NaiveEngine, src/engine/naive_engine.cc)."""
    with _SCOPE_LOCK:
        _NAIVE_DEPTH[0] += 1
    try:
        yield
    finally:
        with _SCOPE_LOCK:
            _NAIVE_DEPTH[0] -= 1


def naive_scope_active():
    return _NAIVE_DEPTH[0] > 0


def set_bulk_size(size):
    """Record the bulking limit and return the previous one (reference:
    engine.py set_bulk_size)."""
    with _SCOPE_LOCK:
        prev = _BULK_SIZE[0]
        _BULK_SIZE[0] = int(size)
    return prev


@contextlib.contextmanager
def bulk(size):
    """Bulk scope (reference: engine.py:26-60): the size is recorded for
    the scope and the previous one restored after it."""
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)


def record_exception(exc):
    """Store an exception raised on a worker thread; the next sync point
    rethrows it (reference: ThreadedEngine::OnCompleteStatic)."""
    with _EXC_LOCK:
        if not _DEFERRED_EXC:
            _DEFERRED_EXC.append(exc)


def check_raise():
    """Rethrow the deferred worker exception, if any, clearing it
    (reference: the rethrow at WaitForVar/WaitForAll)."""
    if _DEFERRED_EXC:                       # unlocked fast path
        with _EXC_LOCK:
            if _DEFERRED_EXC:
                raise _DEFERRED_EXC.pop()


def clear_exception():
    with _EXC_LOCK:
        _DEFERRED_EXC.clear()


def consume_exception(exc):
    """Drop ``exc`` if it is the recorded exception: its caller delivers
    it directly, so no sync point raises it a second time."""
    with _EXC_LOCK:
        if _DEFERRED_EXC and _DEFERRED_EXC[0] is exc:
            _DEFERRED_EXC.clear()


@contextlib.contextmanager
def worker_scope(deliver=None):
    """A failed job poisons its own waiters, never the worker loop.

    An exception raised in the scope does not propagate: it is handed to
    ``deliver(exc)`` (the serving batcher fails that batch's request
    futures).  When ``deliver`` is absent, reports no live receiver or
    raises itself, the exception is recorded (:func:`record_exception`)
    and surfaces at the next sync point."""
    try:
        yield
    except Exception as exc:   # noqa: BLE001 — the worker loop must survive
        delivered = False
        if deliver is not None:
            try:
                delivered = bool(deliver(exc))
            except Exception:   # noqa: BLE001 — a broken deliver is orphaned
                logging.exception("worker_scope: deliver() raised")
        if not delivered:
            logging.error("worker exception with no receiver; it is "
                          "raised at the next sync point", exc_info=exc)
            # an orphaned worker failure is an incident: nothing owns it
            # until the next sync point, so dump the flight ring now
            from .telemetry import flight as _flight
            _flight.incident("worker_exception",
                             error="%s: %s" % (type(exc).__name__, exc))
            record_exception(exc)
