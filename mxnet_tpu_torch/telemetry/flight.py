"""Incident flight recorder — the serving stack's black box.

Counterpart of ``mxnet_tpu/telemetry/flight.py``, taken over whole; the
port records into it at the same control-plane sites: the engine's
orphaned worker exceptions, brownout, canaries, quotas, faults and
elastic retries.

Counters say *how often* the control plane acted; the flight recorder
says *in what order, with what inputs*.  A bounded ring holds the last
N control-plane events — shed/brownout transitions, canary decisions,
quota rejections, fault injections, elastic retries — and on an
incident trigger (canary rollback, ledger imbalance, brownout entry,
``ElasticError``, worker-scope exception) the whole ring plus the
tail-retained anomalous trace set is dumped atomically to one
self-contained JSON post-mortem artifact.

Contract mirrors :mod:`.tracing`: gated on the same ``ACTIVE`` flag
(one boolean on the off path), ``record`` never raises and never
blocks beyond a tiny ring lock, dumps are capped per process
(``MXNET_TRACE_FLIGHT_DUMPS``) so a crash loop cannot fill a disk.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from . import tracing as _tracing

__all__ = ["record", "incident", "events", "dumps_written", "reset"]

_lock = threading.Lock()
_RING = deque(maxlen=512)         # guarded-by: _lock — control-plane events
_STATE = {
    "dumps": 0,                   # guarded-by: _lock — incidents written
    "dump_cap": 8,
    "configured": False,
}


def _configure_locked():
    if _STATE["configured"]:
        return
    global _RING
    try:
        from .. import config as _config
        cap = int(_config.get("MXNET_TRACE_FLIGHT_RING"))
        _STATE["dump_cap"] = int(_config.get("MXNET_TRACE_FLIGHT_DUMPS"))
        if cap != _RING.maxlen:
            _RING = deque(_RING, maxlen=max(16, cap))
    except Exception:
        # config unavailable this early is fine — defaults hold
        pass
    _STATE["configured"] = True


def record(kind, /, **fields):
    """Append one control-plane event.  Free (one boolean) while
    tracing is disarmed; never raises — the recorder must not be able
    to take down the path it is observing (``kind`` is positional-only
    so no caller field name can collide at binding time)."""
    if not _tracing.ACTIVE[0]:
        return
    try:
        ev = {}
        for k, v in fields.items():
            ev[k] = v if isinstance(v, (str, int, float, bool, type(None),
                                        dict, list)) else str(v)
        # reserved keys win over same-named caller fields
        ev["ts"] = time.time()
        ev["kind"] = str(kind)
        with _lock:
            _configure_locked()
            _RING.append(ev)
    except Exception:
        # observability must never become the failure
        pass


def events():
    """Snapshot of the ring, oldest first."""
    with _lock:
        return [dict(e) for e in _RING]


def dumps_written():
    with _lock:
        return _STATE["dumps"]


def incident(trigger, /, **detail):
    """Dump the black box: ring events + the anomalous retained traces,
    written atomically to ``MXNET_TRACE_DIR/incident-<trigger>-<pid>-<n>.json``.

    Returns the path written, or None (disarmed / no trace dir / cap
    reached / write failed — an incident dump failing must not mask the
    incident itself)."""
    if not _tracing.ACTIVE[0]:
        return None
    try:
        d = _tracing._STATE["dir"]
        with _lock:
            _configure_locked()
            if not d or _STATE["dumps"] >= _STATE["dump_cap"]:
                return None
            _STATE["dumps"] += 1
            n = _STATE["dumps"]
            evs = [dict(e) for e in _RING]
        payload = {
            "incident": str(trigger),
            "ts": time.time(),
            "pid": os.getpid(),
            "detail": {k: v if isinstance(v, (str, int, float, bool,
                                              type(None), dict, list))
                       else str(v) for k, v in detail.items()},
            "events": evs,
            "anomalous": _tracing.anomalous(),
            "traces": _tracing.retained_traces(),
        }
        path = os.path.join(d, "incident-%s-%d-%d.json"
                            % (str(trigger), os.getpid(), n))
        from .. import _atomic_io
        _atomic_io.atomic_write(
            path, json.dumps(payload, sort_keys=True,
                             default=str).encode("utf-8"))
        return path
    except Exception:
        # a failed dump must not escalate the incident it records
        return None


def reset():
    with _lock:
        _RING.clear()
        _STATE["dumps"] = 0
        _STATE["configured"] = False
