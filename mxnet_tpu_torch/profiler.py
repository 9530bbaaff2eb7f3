"""Profiler — chrome://tracing output + custom instrumentation.

Counterpart of ``mxnet_tpu/profiler.py`` (reference:
``python/mxnet/profiler.py``: set_config:28, set_state, dump/dumps,
pause/resume, Domain/Task/Frame/Counter/Marker :151-300), with the same
API.  Host-side spans and the custom instrumentation objects land in one
chrome-trace JSON dump; ``dumps`` appends the telemetry registry's
counters (``'C'`` events) and the tracing ring's spans.

Device side: ``set_config(jax_trace_dir=...)`` (the JAX package's
keyword, so the same user code runs on both) makes ``set_state("run")``
start a ``torch.profiler`` session (CUDA activity where a card is
present, else the CPU's), and ``set_state("stop")`` writes its chrome
trace to ``<dir>/device-trace-<pid>.json`` and keeps its kernel,
memcpy and memset events, which ``dumps`` then carries beside the host
spans (under ``pid`` ``"device"``; their timestamps are the profiler's
clock, not this module's).  Env autostart: MXNET_PROFILER_AUTOSTART.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

__all__ = ["set_config", "profiler_set_config", "set_state",
           "profiler_set_state", "dump", "dumps", "dump_profile", "pause",
           "resume", "scope", "Domain", "Task", "Frame", "Event", "Counter",
           "Marker"]

_STATE = {
    "running": False,
    "paused": False,
    "filename": "profile.json",
    "jax_trace_dir": None,
    "device_session": None,    # the running torch.profiler session
    "device_events": [],       # kernels of the last finished session
    "device_trace": None,      # the file it was written to
    "events": [],
    "lock": threading.Lock(),
    "start_time": None,
}


def _now_us():
    return time.perf_counter_ns() / 1000.0


def set_config(**kwargs):
    """Configure profiler (reference: profiler.py:28 set_config).

    Accepts the reference kwargs (profile_symbolic, profile_imperative,
    profile_memory, profile_api, filename, aggregate_stats...) plus
    ``jax_trace_dir`` to also capture a device trace (``torch.profiler``
    here)."""
    _STATE["filename"] = kwargs.get("filename", _STATE["filename"])
    _STATE["jax_trace_dir"] = kwargs.get("jax_trace_dir",
                                         _STATE["jax_trace_dir"])
    _STATE["config"] = dict(kwargs)


profiler_set_config = set_config


def set_state(state="stop", profile_process="worker"):
    """Start/stop profiling (reference: profiler.py set_state)."""
    assert state in ("stop", "run")
    if state == "run" and not _STATE["running"]:
        _STATE["running"] = True
        _STATE["start_time"] = _now_us()
        if _STATE["jax_trace_dir"]:
            _start_device_trace()
    elif state == "stop" and _STATE["running"]:
        _STATE["running"] = False
        if _STATE["device_session"] is not None:
            _stop_device_trace()


# the device events a dump keeps, by the chrome-trace category Kineto
# gives them
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _start_device_trace():
    import torch
    from torch.profiler import ProfilerActivity, profile
    activity = (ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU)
    session = profile(activities=[activity])
    session.start()
    _STATE["device_session"] = session


# how long the card sits idle before a device trace stops: stopped right
# after the last kernels, the trace lost some of their records in 2 of 6
# runs of phase 19's profiled fit, and in none of 6 after this wait
# (``time_variants.py trace_drop``, NVIDIA H100)
_DEVICE_TRACE_SETTLE_S = 0.5


def _stop_device_trace():
    """Stop the session, write its chrome trace into the trace dir and
    keep its device events for ``dumps``."""
    import torch
    session, _STATE["device_session"] = _STATE["device_session"], None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        time.sleep(_DEVICE_TRACE_SETTLE_S)
    session.stop()
    d = _STATE["jax_trace_dir"]
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "device-trace-%d.json" % os.getpid())
    session.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    evs = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
    kept = [dict(e, pid="device") for e in evs
            if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    with _STATE["lock"]:
        _STATE["device_events"] = kept
    _STATE["device_trace"] = path


profiler_set_state = set_state


def is_running():
    return _STATE["running"] and not _STATE["paused"]


def pause(profile_process="worker"):
    """Reference: profiler.py pause."""
    _STATE["paused"] = True


def resume(profile_process="worker"):
    """Reference: profiler.py resume."""
    _STATE["paused"] = False


def _record(name, cat, ph, ts=None, args=None, dur=None, pid=0, tid=None):
    if not is_running():
        return
    ev = {"name": name, "cat": cat, "ph": ph,
          "ts": ts if ts is not None else _now_us(), "pid": pid,
          "tid": tid if tid is not None else threading.get_ident() % 100000}
    if args:
        ev["args"] = args
    if dur is not None:
        ev["dur"] = dur
    with _STATE["lock"]:
        _STATE["events"].append(ev)


def record_span(name, start_us, end_us, cat="operator", args=None):
    """Record a complete span (used by instrumented internals)."""
    _record(name, cat, "X", ts=start_us, dur=end_us - start_us, args=args)


@contextlib.contextmanager
def scope(name, cat="task", args=None):
    """Span context manager for instrumented internals — one complete
    'X' chrome-trace event over the enclosed block (the serving
    micro-batcher wraps each executed batch in one of these).  Near-free
    when the profiler is stopped: two perf_counter reads and a dropped
    _record."""
    t0 = _now_us()
    try:
        yield
    finally:
        record_span(name, t0, _now_us(), cat=cat, args=args)


def dumps(reset=False):
    """Return chrome-trace JSON string (reference: profiler.py dumps).

    Telemetry bridge: the metrics registry's scalar totals are appended
    as ``'C'`` counter events, so one dumped trace carries spans AND
    counters, and the last device trace's kernels after them."""
    try:
        from . import telemetry as _telemetry
        extra = _telemetry.chrome_counter_events(_now_us())
    except Exception:
        extra = []
    try:
        # same bridge for request tracing: completed spans ride the
        # profiler dump as 'X' events keyed by trace id (the JSONL shards
        # are the per-process view; this is the one-file view)
        from .telemetry import tracing as _tracing
        extra += _tracing.chrome_events()
    except Exception:
        pass
    with _STATE["lock"]:
        events = (list(_STATE["events"]) + extra
                  + list(_STATE["device_events"]))
        if reset:
            _STATE["events"] = []
            _STATE["device_events"] = []
    return json.dumps({"traceEvents": events, "displayTimeUnit": "ms"},
                      indent=2)


def dump(finished=True, profile_process="worker"):
    """Write chrome-trace JSON to the configured file (reference:
    profiler.py dump).

    ``finished=True`` matches the reference contract: profiling is over
    — the profiler (and a device trace) stops first, so the dump holds
    the device events, and the dumped events are cleared so a later
    window starts clean.
    ``finished=False`` is a mid-run flush that keeps everything going."""
    if finished and _STATE["running"]:
        set_state("stop")   # one stop sequence (device trace incl.)
    with open(_STATE["filename"], "w") as f:
        f.write(dumps(reset=finished))


dump_profile = dump  # deprecated alias (reference keeps it)


class Domain:
    """Profiling domain (reference: profiler.py:151)."""

    def __init__(self, name):
        self.name = name

    def __str__(self):
        return self.name

    def new_task(self, name):
        return Task(self, name)

    def new_frame(self, name):
        return Frame(self, name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)


class _Span:
    """start/stop span base (Task/Frame/Event share this shape)."""

    _cat = "task"

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name
        self._start = None

    def start(self):
        self._start = _now_us()

    def stop(self):
        if self._start is not None:
            record_span(self.name, self._start, _now_us(), cat=self._cat,
                        args={"domain": str(self.domain)})
            self._start = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()

    def __str__(self):
        return self.name


class Task(_Span):
    """Reference: profiler.py Task."""
    _cat = "task"


class Frame(_Span):
    """Reference: profiler.py Frame."""
    _cat = "frame"


class Event(_Span):
    """Reference: profiler.py Event (no domain)."""
    _cat = "event"

    def __init__(self, name):
        super().__init__(None, name)


class Counter:
    """Numeric counter series (reference: profiler.py Counter).

    increment/decrement are read-modify-writes on ``_value`` shared
    across threads (serving's queue-depth counter is poked from every
    client thread), so they hold a per-counter lock."""

    def __init__(self, domain, name, value=None):
        self.domain = domain
        self.name = name
        self._value = 0
        self._lock = threading.Lock()
        if value is not None:
            self.set_value(value)

    def _set_locked(self, value):
        self._value = value
        _record(self.name, "counter", "C",
                args={self.name: value, "domain": str(self.domain)})

    def set_value(self, value):
        with self._lock:
            self._set_locked(value)

    def increment(self, delta=1):
        with self._lock:
            self._set_locked(self._value + delta)

    def decrement(self, delta=1):
        with self._lock:
            self._set_locked(self._value - delta)

    def __iadd__(self, v):
        self.increment(v)
        return self

    def __isub__(self, v):
        self.decrement(v)
        return self

    def __str__(self):
        return self.name


class Marker:
    """Instant marker (reference: profiler.py Marker)."""

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name

    def mark(self, scope="process"):
        _record(self.name, "marker", "i",
                args={"domain": str(self.domain), "scope": scope})


from . import config as _config  # noqa: E402

if _config.get("MXNET_PROFILER_AUTOSTART"):
    set_state("run")
