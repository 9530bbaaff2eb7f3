"""Request-scoped tracing with tail sampling.

Counterpart of ``mxnet_tpu/telemetry/tracing.py``, taken over whole
(Dapper, research.google/pubs/pub36356: a serving system is debuggable
when every request carries a trace id across process boundaries and the
collector keeps the anomalous traces, not a uniform sample):

- a :class:`TraceContext` (trace_id, span_id, baggage) is minted at the
  request front door (``ModelServer.infer``) and propagated through the
  seams a request crosses (queue wait, batch dispatch, the executor
  cache, execute), and across processes as a ``_trace`` header in a
  ``meta`` dict (:func:`inject`/:func:`extract`); training records
  ``fit.step``, ``io.prefetch`` and ``kvstore.*`` spans on each
  thread's background trace;
- completed spans land in a per-process bounded ring and are exported
  with tail-based sampling: a trace marked anomalous (:func:`mark`, a
  non-ok status, a root slower than ``MXNET_TRACE_P99_FACTOR`` times its
  running p99) is always kept, healthy ones by a seeded per-trace hash at
  the ``MXNET_TRACE_SAMPLE`` rate;
- exporters: JSONL shards (``trace-<pid>.jsonl`` under
  ``MXNET_TRACE_DIR``, appended by :func:`flush` and at exit), and
  chrome-trace events riding the profiler's dump.

Gating: ``ACTIVE`` is a one-element list; a hot call site may guard with
``if _trace.ACTIVE[0]:`` and :func:`span` itself returns the shared
no-op singleton while disarmed, so the off path costs one boolean
check.  Arming is ``MXNET_TRACE`` / :func:`enable`.

A near-leaf: stdlib only, config imported inside :func:`enable`, so the
lowest layers (``_atomic_io``) can reach it without cycles.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
import zlib
from collections import OrderedDict, deque

__all__ = ["ACTIVE", "TraceContext", "Span", "enable", "disable",
           "enabled", "mint", "current", "use", "span", "start_span",
           "add_span", "mark", "complete", "inject", "extract", "keep",
           "flush",
           "export_jsonl", "chrome_events", "snapshot", "anomalous",
           "retained_traces", "reset", "shard_path"]

# one-boolean fast path: hot call sites guard
# on ACTIVE[0]; span()/mark()/inject() re-check it themselves so cold
# call sites may call unconditionally
ACTIVE = [False]

_lock = threading.Lock()
_tls = threading.local()

# caps for the marker/root bookkeeping maps (bounded memory even under
# a pathological anomaly storm)
_MARK_CAP = 2048

_STATE = {
    "sample": 0.01,        # healthy-trace keep rate at export
    "seed": 0,             # sampling hash seed (reproducible keeps)
    "dir": None,           # shard/incident directory (None = no export)
    "p99_factor": 3.0,     # root span slower than factor*p99 -> anomaly
    "ring_cap": 4096,
    "exported": 0,         # guarded-by: _lock — spans written to shard
    "dropped": 0,          # guarded-by: _lock — sampled-out spans
}
_RING = deque(maxlen=4096)        # guarded-by: _lock — finished spans
_ANOMALOUS = OrderedDict()        # guarded-by: _lock — trace_id -> reason
_ROOTS_DONE = OrderedDict()       # guarded-by: _lock — trace_id -> True
_P99 = {}     # guarded-by: _lock — name -> [deque(durs), threshold, n]
_ATEXIT = [False]

# id source: a C-level counter, not the module lock — ids are minted
# several times per request on the serving hot path, and next() on a
# shared count is atomic under the GIL
_SEQ = itertools.count(1)


def _new_id():
    return "%x-%x" % (os.getpid(), next(_SEQ))


class TraceContext:
    """One request's identity on the wire: the trace id, the span to
    parent new work under, and the baggage every span inherits
    (tenant / priority / deadline / model-version)."""

    __slots__ = ("trace_id", "span_id", "baggage")

    def __init__(self, trace_id, span_id=None, baggage=None):
        self.trace_id = str(trace_id)
        self.span_id = span_id
        self.baggage = dict(baggage or {})

    def child(self, span_id):
        """The context a span hands to ITS children."""
        return TraceContext(self.trace_id, span_id, self.baggage)

    def __repr__(self):
        return "TraceContext(%s/%s)" % (self.trace_id, self.span_id)


def mint(**baggage):
    """A fresh root context (the front doors call this once per
    request).  Baggage keys ride every span of the trace and cross
    process boundaries via :func:`inject`."""
    tid = "t-%d-%s" % (os.getpid(), _new_id())
    return TraceContext(tid, None, baggage)


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current():
    """The thread's innermost active context, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def _ambient():
    """Per-thread background context for spans recorded outside any
    request (training steps, watcher polls): one stable trace per
    thread, so a whole thread's background activity samples in or out
    together."""
    ctx = getattr(_tls, "ambient", None)
    if ctx is None:
        ctx = _tls.ambient = TraceContext(
            "bg-%d-%d" % (os.getpid(), threading.get_ident() % 100000))
        with _lock:
            # background traces have no root request span; treat them
            # as always export-eligible
            _done_locked(ctx.trace_id)
    return ctx


class use:
    """Context manager installing ``ctx`` as the thread's current
    context (the replica loop / batcher set the request's context
    here so nested spans parent correctly).  ``use(None)`` is a no-op
    — extraction misses stay cheap."""

    __slots__ = ("ctx",)

    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        if self.ctx is not None:
            _stack().append(self.ctx)
        return self.ctx

    def __exit__(self, *exc_info):
        if self.ctx is not None:
            st = _stack()
            if st:
                st.pop()
        return False


class _Noop:
    """The disarmed singleton: ``span()`` returns THIS exact object
    whenever tracing is off, so the off path allocates nothing (tested
    by identity)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        return False

    def finish(self, status=None, **tags):
        return None

    def tag(self, **tags):
        return self

    @property
    def ctx(self):
        return None


_NOOP = _Noop()


class Span:
    """One timed unit of work inside a trace.  Lexical use (``with
    span(...)``) pushes its child context so nested spans parent
    automatically; non-lexical spans (a request's root, owned by its
    future) come from :func:`start_span` and are owned by whoever
    stores them: a local one is finished in a try/finally."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "baggage",
                 "tags", "status", "_ts", "_t0", "_done", "_pushed")

    def __init__(self, name, parent_ctx, tags):
        if parent_ctx is None:
            parent_ctx = _ambient()
        self.name = str(name)
        self.trace_id = parent_ctx.trace_id
        self.parent_id = parent_ctx.span_id
        self.span_id = _new_id()
        self.baggage = parent_ctx.baggage
        self.tags = tags
        self.status = "ok"
        self._ts = time.time()
        self._t0 = time.perf_counter()
        self._done = False
        self._pushed = False

    @property
    def ctx(self):
        return TraceContext(self.trace_id, self.span_id, self.baggage)

    def tag(self, **tags):
        self.tags.update(tags)
        return self

    def __enter__(self):
        _stack().append(self.ctx)
        self._pushed = True
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._pushed:
            st = _stack()
            if st:
                st.pop()
            self._pushed = False
        self.finish(status=None if exc_type is None
                    else exc_type.__name__)
        return False

    def finish(self, status=None, **tags):
        """Close the span (idempotent — first call wins) and land it in
        the ring.  A non-``ok``/None status marks the whole trace
        anomalous, the tail-sampling retention trigger."""
        if self._done:
            return
        self._done = True
        if tags:
            self.tags.update(tags)
        if status is not None:
            self.status = str(status)
        dur_ms = (time.perf_counter() - self._t0) * 1000.0
        rec = {"trace": self.trace_id, "span": self.span_id,
               "parent": self.parent_id, "name": self.name,
               "ts": self._ts, "dur_ms": round(dur_ms, 4),
               "status": self.status, "pid": os.getpid()}
        if self.baggage:
            rec["baggage"] = dict(self.baggage)
        if self.tags:
            rec["tags"] = {k: _jsonable(v) for k, v in self.tags.items()}
        with _lock:
            _RING.append(rec)
            if self.status != "ok":
                _mark_locked(self.trace_id, self.status)
            if self.parent_id is None \
                    and not self.trace_id.startswith("bg-"):
                _done_locked(self.trace_id)
                self._p99_check_locked(dur_ms)

    def _p99_check_locked(self, dur_ms):
        """Compare against a CACHED p99 threshold, re-derived every 16
        roots — sorting the window on every finish would put an
        O(n log n) pass inside the ring lock on the request hot path."""
        ent = _P99.get(self.name)
        if ent is None:
            ent = _P99[self.name] = [deque(maxlen=128), None, 0]
        hist, threshold, _n = ent
        if threshold is not None and dur_ms > threshold:
            _mark_locked(self.trace_id, "p99_exceeded")
        hist.append(dur_ms)
        ent[2] += 1
        if len(hist) >= 16 and ent[2] % 16 == 0:
            ranked = sorted(hist)
            p99 = ranked[min(len(ranked) - 1, int(len(ranked) * 0.99))]
            ent[1] = p99 * _STATE["p99_factor"]


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def span(name, ctx=None, **tags):
    """A lexical span: ``with span("transport.send", peer=rid): ...``.
    Returns the shared no-op singleton while tracing is off — the one
    boolean check the off path pays."""
    if not ACTIVE[0]:
        return _NOOP
    return Span(name, ctx if ctx is not None else current(), tags)


def start_span(name, ctx=None, **tags):
    """A non-lexical span the caller owns: finish it in a try/finally
    or hand it to a field that finishes on every terminal path."""
    if not ACTIVE[0]:
        return _NOOP
    return Span(name, ctx if ctx is not None else current(), tags)


def add_span(name, ctx, ts, dur_ms, status="ok", **tags):
    """Record an already-elapsed span retroactively (queue wait is
    measured when the batcher pops the request, not with a live object
    per queued entry)."""
    if not ACTIVE[0] or ctx is None:
        return
    rec = {"trace": ctx.trace_id, "span": _new_id(),
           "parent": ctx.span_id, "name": str(name), "ts": float(ts),
           "dur_ms": round(float(dur_ms), 4), "status": str(status),
           "pid": os.getpid()}
    if ctx.baggage:
        rec["baggage"] = dict(ctx.baggage)
    if tags:
        rec["tags"] = {k: _jsonable(v) for k, v in tags.items()}
    with _lock:
        _RING.append(rec)
        if status != "ok":
            _mark_locked(ctx.trace_id, status)


def _mark_locked(trace_id, reason):
    if trace_id not in _ANOMALOUS:
        while len(_ANOMALOUS) >= _MARK_CAP:
            _ANOMALOUS.popitem(last=False)
        _ANOMALOUS[trace_id] = str(reason)


def _done_locked(trace_id):
    if trace_id not in _ROOTS_DONE:
        while len(_ROOTS_DONE) >= _MARK_CAP:
            _ROOTS_DONE.popitem(last=False)
        _ROOTS_DONE[trace_id] = True


def mark(reason, ctx=None):
    """Flag the (current) trace anomalous: shed, failed,
    deadline-exceeded, canary-routed, fault-injected, resubmitted...
    Marked traces are ALWAYS retained by the exporter."""
    if not ACTIVE[0]:
        return
    if ctx is None:
        ctx = current()
    if ctx is None:
        ctx = _ambient()
    with _lock:
        _mark_locked(ctx.trace_id, reason)


def anomalous():
    """``{trace_id: reason}`` snapshot of the marked set."""
    with _lock:
        return dict(_ANOMALOUS)


def complete(ctx):
    """Declare a trace export-eligible in THIS process.  A replica
    serving a routed request records spans whose root lives in the
    front door's process — without this, the local exporter would park
    them as in-flight forever (the root can never finish here) and a
    later SIGKILL would lose them despite the per-request flush."""
    if not ACTIVE[0] or ctx is None:
        return
    with _lock:
        _done_locked(ctx.trace_id)


# -- cross-process propagation ----------------------------------------------
_HEADER = "_trace"


def inject(meta, ctx=None):
    """Stamp ``ctx`` (default: current) into a transport ``meta`` dict
    as the reserved ``_trace`` header; returns ``meta``."""
    if not ACTIVE[0]:
        return meta
    if ctx is None:
        ctx = current()
    if ctx is not None:
        meta[_HEADER] = {"id": ctx.trace_id, "span": ctx.span_id,
                         "baggage": dict(ctx.baggage)}
    return meta


def extract(meta):
    """Rebuild the sender's context from a ``meta`` dict, or None —
    the receiving process parents its spans under the sender's."""
    h = meta.get(_HEADER) if isinstance(meta, dict) else None
    if not isinstance(h, dict) or "id" not in h:
        return None
    return TraceContext(h["id"], h.get("span"), h.get("baggage"))


# -- tail sampling + export -------------------------------------------------
def keep(trace_id):
    """The retention verdict for one trace: marked-anomalous traces
    always survive; healthy ones by a seeded per-trace hash (pure in
    (seed, trace_id) — reproducible across runs and processes)."""
    with _lock:
        if trace_id in _ANOMALOUS:
            return True
        sample = _STATE["sample"]
        seed = _STATE["seed"]
    if sample >= 1.0:
        return True
    if sample <= 0.0:
        return False
    h = zlib.crc32(("%s:%s" % (seed, trace_id)).encode())
    return (h / float(0xFFFFFFFF)) < sample


def shard_path():
    """This process's JSONL shard (``trace-<pid>.jsonl``), or None."""
    d = _STATE["dir"]
    if not d:
        return None
    return os.path.join(d, "trace-%d.jsonl" % os.getpid())


def export_jsonl(path=None, drain=True):
    """Append export-eligible spans to the shard as JSON lines.

    A span is eligible once its trace's ROOT span has finished (tail
    sampling needs the whole trace's verdict); eligible spans of kept
    traces are written, of sampled-out traces dropped, and spans of
    still-in-flight traces stay in the ring for the next flush.
    Returns the number of spans written."""
    if path is None:
        path = shard_path()
    with _lock:
        spans = list(_RING)
        if drain:
            _RING.clear()
        done = dict(_ROOTS_DONE)
    out, stay, drop = [], [], 0
    verdicts = {}
    for rec in spans:
        tid = rec["trace"]
        if tid not in done:
            stay.append(rec)
            continue
        if tid not in verdicts:
            verdicts[tid] = keep(tid)
        if verdicts[tid]:
            out.append(rec)
        else:
            drop += 1
    if drain:
        with _lock:
            # re-park the in-flight spans (bounded: the deque cap still
            # applies, oldest spill first)
            for rec in stay:
                _RING.append(rec)
            _STATE["dropped"] += drop
            _STATE["exported"] += len(out)
    if out and path:
        anom = anomalous()
        with open(path, "a", encoding="utf-8") as f:
            for rec in out:
                if rec["trace"] in anom:
                    rec = dict(rec, anomaly=anom[rec["trace"]])
                f.write(json.dumps(rec, sort_keys=True) + "\n")
    return len(out)


def flush():
    """Incremental shard append — replica loops call this so a later
    SIGKILL cannot lose already-served requests' spans."""
    if not ACTIVE[0]:
        return 0
    return export_jsonl()


def chrome_events():
    """The ring's spans as chrome-trace ``'X'`` events (profiler.dumps
    appends these, so one dumped trace carries profiler spans, counter
    totals AND request spans — the merged view)."""
    with _lock:
        spans = list(_RING)
    evs = []
    for rec in spans:
        args = {"trace": rec["trace"], "span": rec["span"],
                "parent": rec["parent"], "status": rec["status"]}
        args.update(rec.get("tags") or {})
        evs.append({"name": rec["name"], "cat": "trace", "ph": "X",
                    "ts": rec["ts"] * 1e6, "dur": rec["dur_ms"] * 1000.0,
                    "pid": rec["pid"],
                    "tid": zlib.crc32(rec["trace"].encode()) % 100000,
                    "args": args})
    return evs


def snapshot():
    """The in-ring spans (tests / flight recorder peeks)."""
    with _lock:
        return [dict(r) for r in _RING]


def retained_traces():
    """``{trace_id: [spans]}`` of the ANOMALOUS traces still in the
    ring — the flight recorder attaches exactly these to an incident
    dump."""
    with _lock:
        anom = set(_ANOMALOUS)
        spans = [dict(r) for r in _RING if r["trace"] in anom]
    out = {}
    for rec in spans:
        out.setdefault(rec["trace"], []).append(rec)
    return out


def stats():
    with _lock:
        return {"ring": len(_RING), "anomalous": len(_ANOMALOUS),
                "exported": _STATE["exported"],
                "dropped": _STATE["dropped"],
                "sample": _STATE["sample"], "dir": _STATE["dir"]}


# -- arming -----------------------------------------------------------------
def enabled():
    return ACTIVE[0]


def enable(sample=None, seed=None, ring=None, trace_dir=None,
           p99_factor=None):
    """Arm tracing process-wide.  Defaults come from the
    ``MXNET_TRACE_*`` knobs; explicit arguments win (tests/drills)."""
    from .. import config as _config
    global _RING
    with _lock:
        _STATE["sample"] = float(
            _config.get("MXNET_TRACE_SAMPLE") if sample is None
            else sample)
        _STATE["seed"] = int(
            _config.get("MXNET_TRACE_SEED") if seed is None else seed)
        _STATE["p99_factor"] = float(
            _config.get("MXNET_TRACE_P99_FACTOR") if p99_factor is None
            else p99_factor)
        cap = int(_config.get("MXNET_TRACE_RING") if ring is None
                  else ring)
        if cap != _RING.maxlen:
            _RING = deque(_RING, maxlen=max(16, cap))
        _STATE["ring_cap"] = _RING.maxlen
        d = (_config.get("MXNET_TRACE_DIR") if trace_dir is None
             else trace_dir)
        _STATE["dir"] = str(d) if d else None
    if _STATE["dir"]:
        os.makedirs(_STATE["dir"], exist_ok=True)
    if not _ATEXIT[0]:
        import atexit
        atexit.register(_atexit_flush)
        _ATEXIT[0] = True
    ACTIVE[0] = True


def disable():
    ACTIVE[0] = False


def _atexit_flush():
    try:
        if _STATE["dir"]:
            export_jsonl()
    except Exception:
        pass


def reset():
    """Drop every span, mark and counter (tests)."""
    with _lock:
        _RING.clear()
        _ANOMALOUS.clear()
        _ROOTS_DONE.clear()
        _P99.clear()
        _STATE["exported"] = 0
        _STATE["dropped"] = 0
