"""ModelServer — dynamic micro-batching over a bucketed executor cache.

Counterpart of ``mxnet_tpu/serving/server.py`` (TF-Serving's
``BatchingSession`` over the MXNet predict contract): callers see a
per-request ``infer()``; one batcher thread drains a bounded queue,
coalesces requests for the same model version, pads the rows up to a
shape bucket and runs ONE forward of the bucket's bound predictor, on
the server's device.

Production behaviors, each with a typed error and a /stats counter:

- **deadlines** — every request carries one (default
  ``MXNET_SERVING_DEFAULT_TIMEOUT_MS``); expired requests fail with
  ``DeadlineExceeded`` and are skipped by the batcher;
- **backpressure** — the queue is bounded
  (``MXNET_SERVING_QUEUE_DEPTH``); submissions beyond it are rejected
  with ``QueueFull`` carrying a live ``retry_after_s`` hint;
- **fault isolation** — a batch runs inside ``engine.worker_scope``: a
  poisoned batch fails ITS OWN requests' futures and the batcher keeps
  serving (the ``serving.worker`` fault site drills it);
- **observability** — ``stats()`` snapshots the queue, the batch
  occupancy, p50/p99 latency, the executor cache, the per-model
  sections, canaries, brownout and the compile cache; the telemetry
  registry mirrors the counts under ``mxnet_serving_*``, each executed
  batch is one ``serving:batch`` profiler span, and with tracing on a
  request is a ``serving.request`` trace.

Multi-tenant hardening, as in the JAX package:

- **admission control** — ``set_quota`` registers per-model queue
  depth / in-flight / executor-cache reservations; one tenant's burst
  is rejected with ITS OWN ``QueueFull`` while other tenants keep being
  admitted.  Batch scheduling round-robins across models with queued
  work, so one tenant's deep backlog cannot starve another's;
- **SLO-aware load-shedding** — requests carry a priority class
  (0 = most important); under brownout the batcher sheds already-doomed
  work (the deadline cannot be met given the model's measured execute
  time), dispatch size shrinks, the hold-open window is skipped, and
  the lowest priority classes are rejected at submit / shed from the
  queue — every shed decision is counted per model+class+reason
  (``mxnet_serving_sheds_total``);
- **canary auto-rollback** — ``promote_version`` stages a new version
  behind a seeded traffic fraction with a health gate (non-finite
  sentinel, error rate, p99 vs baseline) deciding full promotion vs
  automatic rollback; the registry default moves only AFTER the gate
  passes (``serving/canary.py``);
- **warmup** — ``warmup``, ``warmup_version`` (the checkpoint watcher's
  pre-promotion step) and ``warmup_from_manifest`` (a restarted
  server's replay of the warmup manifest) bind each bucket's predictor
  and run its first forward, where cuDNN picks its engines, before live
  traffic; each plan is timed in ``mxnet_serving_warmup_seconds``.

- **generative serving** — ``add_generative_model`` registers a
  ``TransformerLM`` (or its ``generative_spec()``) with a decode slot
  pool on the server's device; ``infer_stream`` returns a
  ``TokenStream`` fed by the model's continuous-batching
  ``DecodeScheduler`` (``serving/generate/``), with ``set_slot_quota``
  and ``warmup_generative``; its prefill grid cells share this server's
  executor cache and warmup manifest, its loops stop with the batcher,
  and ``stats()["generative"]`` holds each scheduler's snapshot.

The sanitizer hooks and the tuning database's ``stats()`` block (with
``plan_spec``, the analysis feed) come with later slices.

Threading: ONE batcher thread issues all one-shot device work, on the
server's device and its current stream; ``asnumpy()`` of the outputs is
the synchronisation point.  Each generative model's decode thread issues
its own, on the same device and stream.  Client threads only enqueue
and wait.
"""
from __future__ import annotations

import random as _random
import threading
import time

import numpy as np
import torch

from .. import config
from .. import engine
from .. import profiler
from .. import telemetry
from ..context import resolve
from ..fault import hooks as _fault
from ..io import pad_batch
from ..telemetry import flight as _flight
from ..telemetry import tracing as _trace
from .bucketing import pick_bucket, shape_buckets
from .cache import ExecutorCache
from .canary import CanaryState
from .errors import (BadRequest, DeadlineExceeded, ModelNotFound,
                     QueueFull, ServerClosed)
from .manifest import WarmupManifest
from .registry import ModelRegistry

__all__ = ["InferenceFuture", "ModelServer"]


def _now_ms():
    return time.monotonic() * 1000.0


class InferenceFuture:
    """Result handle for one queued request.

    ``result()`` blocks until the batcher delivers or the request's
    deadline passes — deadline expiry CANCELS the request (the batcher
    will skip it) and raises ``DeadlineExceeded``, so a timed-out
    client never consumes accelerator time retroactively."""

    __slots__ = ("_ev", "_lock", "_result", "_exc", "_cancelled",
                 "_deadline", "_hint", "_span")

    def __init__(self, deadline_ms, hint=None):
        self._ev = threading.Event()
        self._lock = threading.Lock()
        self._result = None
        self._exc = None
        self._cancelled = False
        self._deadline = deadline_ms
        # live backoff-hint supplier (the server's _retry_after_s),
        # consulted at expiry so the hint reflects the queue NOW, not
        # at submit time
        self._hint = hint
        # the request's trace root: ownership transfers
        # here at submit, and every terminal path below closes it —
        # deliver, fail, prune, brownout-shed, stop-leftovers and
        # client-side expiry all funnel through these three methods
        self._span = None

    def done(self):
        return self._ev.is_set()

    def cancelled(self):
        return self._cancelled

    def _set_result(self, value):
        """Deliver; False when the client already gave up (cancelled)."""
        with self._lock:
            if self._cancelled or self._ev.is_set():
                return False
            self._result = value
            self._ev.set()
        if self._span is not None:
            self._span.finish()
        return True

    def _set_exception(self, exc):
        with self._lock:
            if self._cancelled or self._ev.is_set():
                return False
            self._exc = exc
            self._ev.set()
        if self._span is not None:
            # a failed/shed/expired request is an anomalous trace —
            # the non-ok status retains it through tail sampling
            self._span.finish(status=type(exc).__name__)
        return True

    def _expired(self, now_ms):
        return now_ms > self._deadline and not self._ev.is_set()

    def wait(self, timeout_s=None):
        return self._ev.wait(timeout_s)

    def result(self):
        remaining = (self._deadline - _now_ms()) / 1000.0
        self._ev.wait(max(0.0, remaining))
        # hint BEFORE taking _lock: the supplier acquires server locks
        # (_cv/_mlock), and the batcher delivers into this future's
        # _lock while holding _cv — hint-under-_lock would be an ABBA
        # deadlock with _prune_locked.  Racing a late delivery is fine:
        # the hint is simply unused then.
        hint = None
        if not self._ev.is_set() and self._hint is not None:
            hint = self._hint()
        with self._lock:
            expired = not self._ev.is_set()
            if expired:
                self._cancelled = True
        if expired:
            if self._span is not None:
                self._span.finish(status="deadline")
            raise DeadlineExceeded(
                "deadline passed before a result was delivered",
                retry_after_s=hint)
        if self._exc is not None:
            raise self._exc
        return self._result


class _Request:
    __slots__ = ("entry", "inputs", "rows", "future", "gkey", "t_submit",
                 "solo", "priority", "trace")

    def __init__(self, entry, inputs, rows, future, t_submit, solo=False,
                 priority=0):
        self.trace = None       # the request's trace context, or None
        self.entry = entry
        self.inputs = inputs
        self.rows = rows
        self.future = future
        self.priority = int(priority)
        # id(entry) pins the EXACT registry object: an unload +
        # re-register of the same version number while requests are
        # queued must not co-batch old-entry and new-entry requests.
        # (self.entry keeps the object alive, so the id cannot be
        # recycled while the request exists.)
        self.gkey = (entry.name, entry.version, id(entry))
        self.t_submit = t_submit
        # solo requests are never coalesced: warmup uses this so an
        # exactly-bucket-sized dummy cannot merge with live traffic
        # into a DIFFERENT bucket, leaving the intended one cold
        self.solo = solo


class ModelServer:
    """The serving front door: a model registry and one batcher thread,
    serving on ``ctx`` (default the current context; without a GPU pass
    ``ctx=cpu()``, or construction raises).

    >>> srv = ModelServer(max_batch=32, ctx=gpu(0))
    >>> srv.load_model("resnet", "m-symbol.json", "m-0001.params",
    ...                {"data": (1, 3, 224, 224)})
    >>> srv.start(); srv.warmup("resnet")
    >>> probs = srv.infer("resnet", {"data": x})[0]
    """

    def __init__(self, registry=None, max_batch=None, queue_depth=None,
                 batch_wait_ms=None, default_timeout_ms=None,
                 cache_size=None, buckets=None, manifest_path=None,
                 canary_fraction=None, ctx=None):
        self.device = resolve(ctx)
        self._backend = "gpu" if self.device.type == "cuda" else "cpu"
        self.registry = registry if registry is not None else ModelRegistry()
        if buckets is not None:
            self._buckets = sorted({int(b) for b in buckets})
            if not self._buckets or self._buckets[0] < 1:
                raise ValueError("buckets must be a non-empty list of "
                                 "sizes >= 1, got %r" % (buckets,))
            if max_batch is not None and int(max_batch) != self._buckets[-1]:
                raise ValueError(
                    "conflicting config: max_batch=%d but the explicit "
                    "bucket ladder tops out at %d"
                    % (int(max_batch), self._buckets[-1]))
        else:
            self._buckets = shape_buckets(
                max_batch if max_batch is not None
                else config.tuned("MXNET_SERVING_MAX_BATCH"))
        self._max_batch = self._buckets[-1]
        self._queue_depth = int(queue_depth if queue_depth is not None
                                else config.get("MXNET_SERVING_QUEUE_DEPTH"))
        self._batch_wait_ms = float(
            batch_wait_ms if batch_wait_ms is not None
            else config.get("MXNET_SERVING_BATCH_WAIT_MS"))
        self._default_timeout_ms = float(
            default_timeout_ms if default_timeout_ms is not None
            else config.get("MXNET_SERVING_DEFAULT_TIMEOUT_MS"))
        if manifest_path is None:
            manifest_path = config.get("MXNET_COMPILE_CACHE_MANIFEST")
        # the warmup manifest records every bound (model, bucket) key —
        # the cache-miss hook catches live-traffic binds warmup never
        # saw — so a restarted replica can replay last run's working set
        self.manifest = WarmupManifest(manifest_path) if manifest_path \
            else None
        self.cache = ExecutorCache(
            cache_size if cache_size is not None
            else config.get("MXNET_SERVING_EXECUTOR_CACHE"),
            on_miss=(self._record_manifest if self.manifest is not None
                     else None), ctx=self.device)
        self._cv = threading.Condition(threading.Lock())
        self._queue = []                # guarded-by: _cv
        self._depths = {}               # guarded-by: _cv — model -> queued
        self._rr_last = ""              # guarded-by: _cv — RR cursor
        self._stopping = False
        self._drain = True
        self._thread = None
        # -- generative serving (serving/generate/) ------------------------
        self._generative = {}           # guarded-by: _cv — name -> sched
        # -- admission control / shedding policy ---------------------------
        self._model_quotas = {}         # guarded-by: _cv — name -> dict
        self._default_model_queue = int(
            config.get("MXNET_SERVING_MODEL_QUEUE_DEPTH"))
        self._default_model_inflight = int(
            config.get("MXNET_SERVING_MODEL_INFLIGHT"))
        self._priority_classes = max(
            1, int(config.get("MXNET_SERVING_PRIORITY_CLASSES")))
        self._default_priority = min(
            self._priority_classes - 1,
            max(0, int(config.get("MXNET_SERVING_DEFAULT_PRIORITY"))))
        self._brownout_high = max(1, int(round(
            float(config.get("MXNET_SERVING_BROWNOUT_HIGH"))
            * self._queue_depth)))
        self._brownout_low = max(0, int(round(
            float(config.get("MXNET_SERVING_BROWNOUT_LOW"))
            * self._queue_depth)))
        if self._brownout_low >= self._brownout_high:
            raise ValueError(
                "brownout hysteresis needs a gap: low watermark %d "
                "(MXNET_SERVING_BROWNOUT_LOW) must be below high "
                "watermark %d (MXNET_SERVING_BROWNOUT_HIGH) — equal or "
                "inverted watermarks would flap enter/exit per submit"
                % (self._brownout_low, self._brownout_high))
        self._brownout_max_batch = int(
            config.get("MXNET_SERVING_BROWNOUT_MAX_BATCH"))
        self._brownout_reject_class = int(
            config.get("MXNET_SERVING_BROWNOUT_REJECT_CLASS"))
        self._brownout = False          # guarded-by: _cv
        self._brownout_entered = 0      # guarded-by: _cv
        # -- canary staged promotion ---------------------------------------
        self._canary_fraction = float(
            canary_fraction if canary_fraction is not None
            else config.get("MXNET_SERVING_CANARY_FRACTION"))
        self._canary_lock = threading.Lock()
        self._canaries = {}             # guarded-by: _canary_lock
        self._canary_rng = {}           # guarded-by: _canary_lock
        self._canary_history = {}       # guarded-by: _canary_lock
        # -- metrics --------------------------------------------------------
        # dual-written: per-instance ints back stats() — an EXACT
        # per-server view even with several servers alive in one process
        # — while the process-wide telemetry registry mirrors every
        # increment under mxnet_serving_* so serving and training share
        # one metric namespace (snapshot()/Prometheus see cross-server
        # totals).
        self._t_requests = telemetry.counter(
            "mxnet_serving_requests_total",
            "serving requests by outcome (submitted/served/failed/"
            "rejected_queue_full/expired)")
        self._t_batches = telemetry.counter(
            "mxnet_serving_batches_total",
            "executed micro-batches per shape bucket")
        self._t_batch_rows = telemetry.counter(
            "mxnet_serving_batch_rows_total",
            "rows dispatched per shape bucket (fill = rows / "
            "(batches * bucket))")
        self._t_queue_depth = telemetry.gauge(
            "mxnet_serving_queue_depth",
            "requests currently queued for the batcher")
        self._t_latency = telemetry.histogram(
            "mxnet_serving_latency_ms",
            "submit-to-result latency of served requests",
            buckets=telemetry.exponential_buckets(0.5, 2.0, 14))
        self._t_sheds = telemetry.counter(
            "mxnet_serving_sheds_total",
            "load-shedding decisions by model, priority class and "
            "reason (doomed/brownout_reject/brownout_queue)")
        self._t_brownout = telemetry.gauge(
            "mxnet_serving_brownout",
            "1 while the server is in declared brownout (queue above "
            "the high watermark: shrunk dispatch, lowest classes shed)")
        self._t_canary = telemetry.gauge(
            "mxnet_serving_canary_state",
            "per-model canary state: 0 none, 1 canarying, 2 last "
            "decision promoted, -1 last decision rolled back")
        self._mlock = threading.Lock()
        self._req_counts = {o: 0           # guarded-by: _mlock
                            for o in ("submitted", "served", "failed",
                                      "rejected_queue_full", "expired",
                                      "retried", "shed")}
        self._model_req = {}               # guarded-by: _mlock
        self._inflight = {}                # guarded-by: _mlock
        self._shed_counts = {}             # guarded-by: _mlock
        self._exec_ms = {}                 # guarded-by: _mlock
        self._exec_est = {}                # guarded-by: _mlock — medians
        # client-side submit retry (MXNET_SERVING_SUBMIT_RETRIES, off by
        # default): jittered sleeps floored at the server's live
        # retry_after_s hint; base = one batch window, the natural
        # drain cadence of the queue
        from ..fault.backoff import BackoffPolicy
        self._submit_backoff = BackoffPolicy(
            retries=0, base_s=max(self._batch_wait_ms, 1.0) / 1000.0)
        self._batch_hist = {}              # guarded-by: _mlock
        self._latencies = {}               # guarded-by: _mlock — per model
        self._lat_cap = 4096
        self._queue_peak = 0               # guarded-by: _mlock
        self._model_queue_peak = {}        # guarded-by: _mlock
        self._domain = profiler.Domain("serving")
        self._q_counter = self._domain.new_counter("serving_queue_depth")

    _TERMINAL = frozenset(("served", "failed", "expired", "shed"))

    def _record_manifest(self, entry, bucket):
        """The cache's miss hook: one bound key into the manifest, under
        this server's backend."""
        self.manifest.record(entry, bucket, backend=self._backend)

    def _req_inc(self, outcome, n=1, model=None):
        """Count a request outcome, per model when one is known.  The
        ledger invariant the chaos soaks assert: per model AND
        globally, submitted == served + failed + expired + shed —
        every ACCEPTED request lands in exactly one terminal outcome
        (rejected_* outcomes were never accepted)."""
        if not n:
            return
        with self._mlock:
            self._req_counts[outcome] += n
            if model is not None:
                per = self._model_req.setdefault(
                    model, dict.fromkeys(self._req_counts, 0))
                per[outcome] = per.get(outcome, 0) + n
                if outcome in self._TERMINAL:
                    left = self._inflight.get(model, 0) - n
                    self._inflight[model] = max(0, left)
        if model is not None:
            self._t_requests.labels(outcome=outcome, model=model).inc(n)
        else:
            self._t_requests.labels(outcome=outcome).inc(n)

    def _shed_inc(self, model, cls, reason, n=1):
        """Every shed decision is visible per model+class+reason —
        brownout must be a DECLARED mode, not a mystery error spike."""
        with self._mlock:
            key = (model, int(cls), reason)
            self._shed_counts[key] = self._shed_counts.get(key, 0) + n
        self._t_sheds.labels(model=model, cls=str(int(cls)),
                             reason=reason).inc(n)
        _flight.record("shed", model=model, cls=int(cls), reason=reason,
                       n=n)

    # -- model management ---------------------------------------------------
    def load_model(self, name, symbol_file, param_file, input_shapes,
                   version=None):
        """Register a checkpoint (``prefix-symbol.json`` and
        ``prefix-NNNN.params``, or their contents), its parameters read
        onto the server's device."""
        return self.registry.load(name, symbol_file, param_file,
                                  input_shapes, version=version,
                                  ctx=self.device)

    def add_model(self, name, symbol, arg_params, aux_params, input_shapes,
                  version=None):
        """Register a model; its parameters must live on the server's
        device (``convert.params_from_numpy(..., ctx)`` puts them there)."""
        return self.registry.add(name, symbol, arg_params, aux_params,
                                 input_shapes, version=version)

    def set_default_version(self, name, version):
        self.registry.set_default(name, version)

    def unload_model(self, name, version=None):
        """Unload + drop the version's cached executors (hot-swap tail)."""
        self.registry.unload(name, version)
        self.cache.invalidate(name, version)

    def watch_checkpoints(self, directory, name, poll_interval=None,
                          set_default=True, start=True):
        """Registry ``watch_checkpoints`` with THIS server wired in as
        the warmer: each newly committed checkpoint version is warmed
        (manifest buckets, else the ladder) BEFORE promotion, so a hot
        swap never exposes live traffic to a cold bucket."""
        return self.registry.watch_checkpoints(
            directory, name, poll_interval=poll_interval,
            set_default=set_default, start=start, server=self)

    # -- admission control --------------------------------------------------
    def set_quota(self, name, queue_depth=None, inflight=None,
                  cache_entries=None):
        """Register per-model admission quotas for ``name``:

        - ``queue_depth`` — max requests of this model queued at once;
          beyond it submits are rejected with ``QueueFull`` carrying
          THIS model's ``retry_after_s`` (other models keep admitting);
        - ``inflight`` — max accepted-but-unresolved requests (queued +
          executing), the end-to-end occupancy cap;
        - ``cache_entries`` — executor-cache slots RESERVED for this
          model (``ExecutorCache.set_quota``): its hot executors can
          never be evicted by another tenant's bind storm.

        ``None`` leaves a field at the ``MXNET_SERVING_MODEL_*`` knob
        default; ``0`` disables that cap explicitly.  Returns the
        effective quota dict."""
        q = {"queue_depth": (self._default_model_queue
                             if queue_depth is None else int(queue_depth)),
             "inflight": (self._default_model_inflight
                          if inflight is None else int(inflight))}
        with self._cv:
            self._model_quotas[name] = q
        if cache_entries is not None:
            self.cache.set_quota(name, cache_entries)
            q = dict(q, cache_entries=int(cache_entries))
        return q

    def _quota_for_locked(self, name):
        q = self._model_quotas.get(name)
        if q is not None:
            return q
        return {"queue_depth": self._default_model_queue,
                "inflight": self._default_model_inflight}

    # -- canary staged promotion --------------------------------------------
    def promote_version(self, name, version, fraction=None):
        """The watcher's promote step, staged: with a canary fraction
        configured (``MXNET_SERVING_CANARY_FRACTION`` / ctor /
        ``fraction``) and an existing default version to protect, the
        new version receives only that fraction of unversioned traffic
        until the health gate decides; otherwise this is a direct
        ``set_default``.  Returns the live ``CanaryState`` or
        None when promotion was direct."""
        version = int(version)
        frac = self._canary_fraction if fraction is None else float(fraction)
        try:
            baseline = self.registry.get(name).version
        except ModelNotFound:
            baseline = None
        if frac <= 0.0 or baseline is None or baseline == version:
            self.registry.set_default(name, version)
            return None
        return self.begin_canary(name, version, fraction=frac)

    def begin_canary(self, name, version, fraction=None,
                     min_requests=None, max_error_rate=None,
                     p99_factor=None, timeout_s=None):
        """Start routing ``fraction`` of model ``name``'s unversioned
        traffic to ``version`` while the registry default stays on the
        current baseline; the health gate (canary.py) promotes or
        rolls back automatically.  A still-undecided previous canary
        for the same model is rolled back as superseded first."""
        version = int(version)
        entry = self.registry.get(name, version)   # loud when unknown
        baseline = self.registry.get(name).version
        if baseline == version:
            raise BadRequest(
                "model %r version %d is already the serving default; "
                "nothing to canary" % (name, version))
        cfg = config
        st = CanaryState(
            name, baseline, version,
            self._canary_fraction if fraction is None else float(fraction),
            int(min_requests if min_requests is not None
                else cfg.get("MXNET_SERVING_CANARY_MIN_REQUESTS")),
            float(max_error_rate if max_error_rate is not None
                  else cfg.get("MXNET_SERVING_CANARY_MAX_ERROR_RATE")),
            float(p99_factor if p99_factor is not None
                  else cfg.get("MXNET_SERVING_CANARY_P99_FACTOR")),
            float(timeout_s if timeout_s is not None
                  else cfg.get("MXNET_SERVING_CANARY_TIMEOUT_S")),
            baseline_seed_lat=self._recent_latencies(name))
        superseded = None
        with self._canary_lock:
            prev = self._canaries.get(name)
            if prev is not None and prev.decision is None:
                prev.decide("rolled_back", "superseded")
                self._finish_canary_locked(prev)
                superseded = prev
            self._canaries[name] = st
            # seeded per (model, version): the routing draw sequence —
            # and therefore the drill — is reproducible
            self._canary_rng[name] = _random.Random(
                "canary:%s:%d" % (name, version))
        if superseded is not None:
            # same cleanup as a gate-decided rollback: an abandoned
            # candidate's bound executors and params must not linger
            # against the tenant's own cache quota (unload first, same
            # ordering constraint as _maybe_decide_canary's apply)
            try:
                self.registry.unload(name, superseded.canary_version)
            except ModelNotFound:
                pass   # operator raced us; nothing to free
            self.cache.invalidate(name, superseded.canary_version)
        self._t_canary.labels(model=name).set(1)
        del entry
        return st

    def canary_status(self, name=None):
        """Live + recent canary evidence (also surfaced in stats())."""
        with self._canary_lock:
            live = {n: st.describe() for n, st in self._canaries.items()}
            hist = {n: list(h) for n, h in self._canary_history.items()}
        if name is not None:
            return {"live": live.get(name),
                    "history": hist.get(name, [])}
        return {"live": live, "history": hist}

    def tick_canaries(self):
        """Evaluate time-based canary gates (budget timeout).  Called
        by the batcher after every executed batch and by the
        checkpoint watcher each poll; safe to call from anywhere."""
        with self._canary_lock:
            pending = [st for st in self._canaries.values()
                       if st.decision is None]
        for st in pending:
            self._maybe_decide_canary(st)

    def _recent_latencies(self, name, n=64):
        with self._mlock:
            return list(self._latencies.get(name, ()))[-n:]

    def _canary_route(self, name, entry):
        """Routing decision for an UNVERSIONED request: a seeded draw
        sends ``fraction`` of the baseline's traffic to the canary
        version.  Requests pinning an explicit version bypass this —
        a pinned client asked for those exact weights."""
        with self._canary_lock:
            st = self._canaries.get(name)
            if st is None or st.decision is not None \
                    or entry.version != st.baseline_version:
                return entry
            if self._canary_rng[name].random() >= st.fraction:
                return entry
            st.routed += 1
            version = st.canary_version
        if _fault.ACTIVE[0]:
            with _trace.span("serving.canary.route", model=name,
                             version=version):
                # a fault here must fail only THIS request's
                # submit, never the baseline path or the batcher
                _fault.fire("serving.canary.route", model=name,
                            version=version)
        try:
            return self.registry.get(name, version)
        except ModelNotFound:
            return entry   # rolled back between draw and resolve

    def _canary_observe(self, entry, served=0, failed=0, latencies=(),
                        nonfinite=False):
        """Batch-outcome evidence feed (batcher thread)."""
        with self._canary_lock:
            st = self._canaries.get(entry.name)
            if st is None or st.decision is not None:
                return
            st.record(entry.version, served=served, failed=failed,
                      latencies=latencies, nonfinite=nonfinite)
        self._maybe_decide_canary(st)

    def _maybe_decide_canary(self, st):
        """Run the health gate; apply a terminal verdict.  The verdict
        is STAMPED under the canary lock (claiming it against races)
        but APPLIED outside any lock — set_default/unload take the
        registry and cache locks, and an apply failure reverts the
        stamp so the next observation retries."""
        with self._canary_lock:
            if st.decision is not None:
                return
            verdict = st.evaluate()
            if verdict is None:
                return
            decision, reason = verdict
            st.decide(decision, reason)
        try:
            with _trace.span("serving.canary.decide", model=st.name,
                             version=st.canary_version,
                             decision=decision, reason=reason):
                if _fault.ACTIVE[0]:
                    _fault.fire("serving.canary.promote", model=st.name,
                                version=st.canary_version,
                                decision=decision)
                if decision == "promoted":
                    self.registry.set_default(st.name, st.canary_version)
                else:
                    # unload BEFORE invalidate, as the JAX package: a
                    # request that resolves the version after the
                    # invalidate finds it gone
                    try:
                        self.registry.unload(st.name, st.canary_version)
                    except ModelNotFound:
                        pass   # already unloaded (operator raced us)
                    self.cache.invalidate(st.name, st.canary_version)
        # contain-and-retry: the decision runs on the batcher thread
        # inside _execute — an injected/transient promotion failure
        # must fail the PROMOTION (stamp reverted below, retried on
        # the next observation/tick), never the innocent in-flight
        # batch above it (an injected serving.canary.promote fault
        # drills it)
        except Exception as exc:   # noqa: BLE001 — reverted, retried
            import logging
            logging.warning(
                "canary %s of model %r version %d failed to apply "
                "(%s: %s); will retry", decision, st.name,
                st.canary_version, type(exc).__name__, exc)
            with self._canary_lock:
                st.decision = None
                st.reason = None
                st.decided_s = None
            return
        with self._canary_lock:
            self._finish_canary_locked(st)
            desc = st.describe()
        if decision == "rolled_back":
            # incident trigger: one self-contained post-mortem — the
            # gate's inputs (describe()) + the flight ring + the
            # retained anomalous traces, including the victim requests
            _flight.incident("canary_rollback", **desc)
        import logging
        logging.info("canary of model %r: version %d %s (%s)",
                     st.name, st.canary_version, st.decision, st.reason)

    def _finish_canary_locked(self, st):
        if self._canaries.get(st.name) is st:
            del self._canaries[st.name]
        hist = self._canary_history.setdefault(st.name, [])
        hist.append(st.describe())
        del hist[:-8]
        self._t_canary.labels(model=st.name).set(
            2 if st.decision == "promoted" else -1)
        telemetry.counter(
            "mxnet_serving_canary_decisions_total",
            "terminal canary verdicts by model, decision and reason"
        ).labels(model=st.name, decision=st.decision,
                 reason=st.reason).inc()
        _flight.record("canary_decision", **st.describe())

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        with self._cv:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stopping = False
            self._drain = True
            self._thread = threading.Thread(
                target=self._worker, name="mxnet-serving-batcher",
                daemon=True)
            self._thread.start()
        return self

    def stop(self, drain=True):
        """Stop the batcher; ``drain`` serves out the queue first,
        otherwise queued requests fail with ``ServerClosed``."""
        with self._cv:
            self._stopping = True
            self._drain = bool(drain)
            self._cv.notify_all()
            t = self._thread
            gens = list(self._generative.values())
        # the generative decode loops stop alongside the batcher; their
        # pending and running streams settle terminally (failed), so the
        # per-tenant ledgers balance across a stop
        for sched in gens:
            sched.stop(drain=drain)
        if t is not None:
            t.join(timeout=60.0)
        with self._cv:
            leftovers = list(self._queue)
            del self._queue[:]
            self._depths.clear()
        for r in leftovers:
            # leftovers are terminal outcomes too: the ledger must
            # balance and the per-model inflight budget must release,
            # or a stop/start cycle leaves quota'd tenants rejected
            # forever
            name = r.entry.name
            if r.future._set_exception(ServerClosed("server stopped")):
                self._req_inc("failed", model=name)
            else:
                self._req_inc("expired", model=name)
        with self._mlock:
            counts = dict(self._req_counts)
        if counts["submitted"] != (counts["served"] + counts["failed"]
                                   + counts["expired"] + counts["shed"]):
            # the exactly-once invariant broke: black-box time
            _flight.incident("ledger_imbalance", scope="server",
                             **counts)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc_info):
        self.stop()

    # -- request path -------------------------------------------------------
    def infer(self, name, inputs, version=None, timeout_ms=None,
              retries=None, priority=None):
        """Blocking inference: returns the model's outputs as a list of
        numpy arrays whose batch axis matches the request's rows.
        ``retries``/``priority`` — see :meth:`infer_async`."""
        return self.infer_async(name, inputs, version=version,
                                timeout_ms=timeout_ms, retries=retries,
                                priority=priority).result()

    def infer_async(self, name, inputs, version=None, timeout_ms=None,
                    retries=None, priority=None, _solo=False):
        """Enqueue a request; returns an :class:`InferenceFuture`.

        ``inputs`` maps input name -> array; a single-input model also
        accepts the bare array.  Arrays may carry a leading batch axis
        (1..max_batch rows) or be a single sample (the batch axis is
        added).  Raises ``QueueFull``/``BadRequest``/``ModelNotFound``
        synchronously — a rejected request was never enqueued.

        ``priority`` (default ``MXNET_SERVING_DEFAULT_PRIORITY``): SLO
        class 0..MXNET_SERVING_PRIORITY_CLASSES-1, 0 most important.
        Under brownout the lowest classes are shed first — batch
        composition and result delivery are otherwise identical.

        ``retries`` (default ``MXNET_SERVING_SUBMIT_RETRIES``, 0 = off):
        re-submit after ``QueueFull`` up to this many times, sleeping
        the rejection's live ``retry_after_s`` hint with
        ``BackoffPolicy`` jitter; only the submit is retried — an
        ACCEPTED request is never duplicated."""
        if retries is None:
            retries = config.get("MXNET_SERVING_SUBMIT_RETRIES")
        budget = max(0, int(retries))
        attempt = 0
        while True:
            try:
                return self._submit_async(name, inputs, version=version,
                                          timeout_ms=timeout_ms,
                                          priority=priority, _solo=_solo)
            except QueueFull as exc:
                if attempt >= budget:
                    raise
                self._req_inc("retried", model=name)
                self._submit_backoff.sleep_for(
                    attempt, floor_s=exc.retry_after_s or 0.0)
                attempt += 1

    def _retry_after_s(self, model=None, depth=None):
        """Server-side backoff hint: seconds until the CURRENT backlog
        plausibly clears — queued batches ahead times the recent
        request service time (median submit-to-result, which includes
        queue wait, so the estimate errs long — an honest hint for a
        shedding server), floored at one batch window.  With ``model``
        the history AND the backlog are that model's own — a slow
        tenant's service times must not inflate every tenant's backoff.
        An estimate, not a promise: the client adds jitter and bounds
        its own retries."""
        if depth is None:
            with self._cv:
                depth = (self._depths.get(model, 0) if model is not None
                         else len(self._queue))
        with self._mlock:
            if model is not None:
                lats = list(self._latencies.get(model, ()))[-32:]
            else:            # cross-model view: flatten recent history
                lats = [v for hist in self._latencies.values()
                        for v in hist[-8:]]
        per_batch_s = (float(np.median(lats)) / 1000.0 if lats
                       else self._batch_wait_ms / 1000.0)
        batches_ahead = 1 + depth // max(1, self._max_batch)
        floor = self._batch_wait_ms / 1000.0
        return min(max(batches_ahead * per_batch_s, floor, 0.001), 60.0)

    def _submit_async(self, name, inputs, version=None, timeout_ms=None,
                      priority=None, _solo=False):
        entry = self.registry.get(name, version)
        canary_routed = False
        if version is None and not _solo:
            baseline_entry = entry
            entry = self._canary_route(name, entry)
            canary_routed = entry is not baseline_entry
        priority = self._default_priority if priority is None \
            else int(priority)
        if not 0 <= priority < self._priority_classes:
            raise BadRequest(
                "priority class %d outside 0..%d "
                "(MXNET_SERVING_PRIORITY_CLASSES)"
                % (priority, self._priority_classes - 1))
        if not isinstance(inputs, dict):
            if len(entry.input_names) != 1:
                raise BadRequest(
                    "model %r has inputs %s; pass a dict"
                    % (name, entry.input_names))
            inputs = {entry.input_names[0]: inputs}
        missing = [k for k in entry.input_names if k not in inputs]
        unknown = [k for k in inputs if k not in entry.sample_shapes]
        if missing or unknown:
            raise BadRequest(
                "model %r inputs are %s (missing %s, unknown %s)"
                % (name, entry.input_names, missing, unknown))
        arrs, rows = {}, None
        for k in entry.input_names:
            a = np.asarray(inputs[k], dtype=np.float32)
            want = entry.sample_shapes[k]
            if a.ndim == len(want):
                a = a[None]
            if a.ndim != len(want) + 1 or a.shape[1:] != want:
                raise BadRequest(
                    "input %r expects sample shape %s, got array of "
                    "shape %s" % (k, want, a.shape))
            if rows is None:
                rows = a.shape[0]
            elif a.shape[0] != rows:
                raise BadRequest(
                    "inconsistent batch rows across inputs: %d vs %d"
                    % (rows, a.shape[0]))
            arrs[k] = a
        if rows == 0:
            raise BadRequest("empty request (0 rows)")
        if rows > self._max_batch:
            raise BadRequest(
                "request rows %d exceed the largest shape bucket %d; "
                "split the request" % (rows, self._max_batch))
        timeout = self._default_timeout_ms if timeout_ms is None \
            else float(timeout_ms)
        now = _now_ms()
        name = entry.name
        fut = InferenceFuture(now + timeout,
                              hint=lambda: self._retry_after_s(name))
        req = _Request(entry, arrs, rows, fut, now, solo=_solo,
                       priority=priority)
        if _trace.ACTIVE[0]:
            # the request's trace root: joins the caller's context when
            # one exists (a fleet replica serving a routed request),
            # else mints a fresh trace.  The future owns the span; the
            # batcher parents its retro queue/execute spans on req.trace
            _ctx = _trace.current() or _trace.mint(
                model=name, priority=priority)
            _root = _trace.start_span(
                "serving.request", ctx=_ctx, model=name,
                version=entry.version, rows=rows, priority=priority,
                deadline_ms=timeout)
            if canary_routed:
                _trace.mark("canary_routed", _ctx)
                _root.tag(canary=True)
            fut._span = _root
            req.trace = _root.ctx
        reject = None          # (shed?, message, depth for the hint)
        with self._cv:
            if self._stopping:
                raise ServerClosed("server is stopping")
            # warmup solo dummies are operator actions, not tenant
            # traffic: they bypass the per-model quotas (a full tenant
            # queue must not block warming that tenant's executors) —
            # the global depth bound still applies
            quota = self._quota_for_locked(name) if not _solo \
                else {"queue_depth": 0, "inflight": 0}
            mdepth = self._depths.get(name, 0)
            if len(self._queue) >= self._queue_depth:
                reject = (False, "serving queue at capacity (%d "
                          "requests); retry later" % self._queue_depth,
                          len(self._queue))
            elif quota["queue_depth"] and mdepth >= quota["queue_depth"]:
                reject = (False, "model %r queue quota at capacity "
                          "(%d requests); other models are unaffected "
                          "— retry later" % (name, quota["queue_depth"]),
                          mdepth)
            elif quota["inflight"]:
                with self._mlock:
                    infl = self._inflight.get(name, 0)
                if infl >= quota["inflight"]:
                    reject = (False, "model %r in-flight quota at "
                              "capacity (%d unresolved requests); "
                              "retry later" % (name, quota["inflight"]),
                              mdepth)
            if reject is None and self._brownout and not _solo \
                    and priority >= self._brownout_reject_class:
                reject = (True, "brownout: shedding priority class %d "
                          "(queue above the high watermark); retry "
                          "later" % priority, mdepth)
            if reject is None:
                self._queue.append(req)
                self._depths[name] = mdepth + 1
                with self._mlock:
                    self._inflight[name] = self._inflight.get(name, 0) + 1
                depth = len(self._queue)
                self._update_brownout_locked()
                self._cv.notify_all()
        if reject is not None:
            shed, msg, hint_depth = reject
            # hint computed OUTSIDE _cv (it takes _mlock; keep the lock
            # graph one-directional)
            self._req_inc("rejected_queue_full", model=name)
            if shed:
                self._shed_inc(name, priority, "brownout_reject")
            if fut._span is not None:
                fut._span.finish(status="rejected_queue_full",
                                 brownout=shed)
            _flight.record("reject", model=name, priority=priority,
                           brownout=shed, depth=hint_depth)
            raise QueueFull(
                msg, retry_after_s=self._retry_after_s(
                    name, depth=hint_depth))
        self._req_inc("submitted", model=name)
        with self._mlock:
            if depth > self._queue_peak:
                self._queue_peak = depth
            if mdepth + 1 > self._model_queue_peak.get(name, 0):
                self._model_queue_peak[name] = mdepth + 1
        self._q_counter.set_value(depth)
        self._t_queue_depth.set(depth)
        self._t_queue_depth.labels(model=name).set(mdepth + 1)
        return fut

    def warmup(self, name=None, version=None, buckets=None,
               timeout_ms=600000.0):
        """Bind AND run every (model, bucket) predictor once, so live
        traffic never pays a bind or a first-call cost (cuDNN's engine
        choice for the shape, the kernels' build); returns the (name,
        version, bucket) triples warmed.

        Executors are stateful and single-owner: when the batcher is
        running, warmup dispatches THROUGH it (one exactly-bucket-sized
        dummy request at a time, blocking) so a live request can never
        race warmup's forward on the same predictor.  Only a not-yet-
        started server warms inline.

        Warmed keys land in the warmup manifest (via the executor
        cache's miss hook) for the next restart to replay."""
        names = [name] if name is not None \
            else sorted(self.registry.describe())
        if buckets is not None:
            rogue = [b for b in buckets if int(b) not in self._buckets]
            if rogue:
                raise ValueError(
                    "warmup buckets %s are not on the ladder %s — "
                    "steady-state traffic only ever selects ladder "
                    "rungs, so warming them would not prevent any "
                    "cold forward" % (rogue, self._buckets))
        plan = []
        for n in names:
            entry = self.registry.get(n, version)
            plan.append((entry, [int(b) for b in (
                buckets if buckets is not None else self._buckets)]))
        return self._warm(plan, timeout_ms)

    def warmup_from_manifest(self, name=None, version=None,
                             timeout_ms=600000.0):
        """Replay the warmup manifest: warm exactly the (model, bucket)
        working set a previous process recorded, matched by PROGRAM
        identity (symbol sha256) so a hot-swapped version of the same
        architecture replays its predecessor's keys.  Returns the
        warmed triples — empty when there is no manifest, it is
        unreadable, or nothing recorded matches a registered model
        (callers then fall back to :meth:`warmup`'s full ladder)."""
        if self.manifest is None:
            return []
        names = [name] if name is not None \
            else sorted(self.registry.describe())
        plan = []
        for n in names:
            entry = self.registry.get(n, version)
            recorded = self.manifest.buckets_for(n, entry.symbol_sha,
                                                 backend=self._backend)
            on_ladder = [b for b in recorded if b in self._buckets]
            dropped = sorted(set(recorded) - set(on_ladder))
            if dropped:
                import logging
                logging.warning(
                    "warmup manifest buckets %s for model %r are off the "
                    "current ladder %s (config drift since the manifest "
                    "was written); skipping them", dropped, n,
                    self._buckets)
            if on_ladder:
                plan.append((entry, on_ladder))
        return self._warm(plan, timeout_ms)

    def warmup_version(self, name, version, timeout_ms=600000.0):
        """Warm ONE version's executors — the checkpoint watcher's
        pre-warm-then-promote step.  Buckets come from the manifest
        (the working set live traffic actually used) when recorded for
        this program, else the full ladder."""
        entry = self.registry.get(name, version)
        bucket_list = list(self._buckets)
        if self.manifest is not None:
            recorded = [b for b in
                        self.manifest.buckets_for(
                            name, entry.symbol_sha, backend=self._backend)
                        if b in self._buckets]
            if recorded:
                bucket_list = recorded
        return self._warm([(entry, bucket_list)], timeout_ms)

    # -- generative serving (serving/generate/) -----------------------------

    def add_generative_model(self, name, spec, slots=None, max_len=None,
                             prefill_batch=None, eos_id=None,
                             queue_depth=None, brownout_ms=None,
                             version=1):
        """Register a generative deployment: ``spec`` is a
        ``TransformerLM`` block (or its ``generative_spec()`` export),
        run on this server's device.  Allocates the slot pool's KV-cache
        up front and wires the model's prefill grid through THIS server's
        executor cache and warmup manifest — generative and one-shot
        tenants share one LRU, one quota policy, one miss counter, one
        restart working set.  Returns the model's ``DecodeScheduler``.

        Call :meth:`warmup_generative` (or let the first requests pay
        the binds) before latency-sensitive traffic."""
        from .generate import DecodeScheduler, GenerativeModel
        if max_len is None:
            knob = int(config.get("MXNET_SERVING_GEN_MAX_LEN"))
            max_len = knob if knob > 0 else None
        gm = GenerativeModel(name, spec, max_len=max_len,
                             prefill_batch=prefill_batch, eos_id=eos_id,
                             version=version, ctx=self.device)
        sched = DecodeScheduler(gm, self.cache, slots=slots,
                                queue_depth=queue_depth,
                                brownout_ms=brownout_ms)
        with self._cv:
            if name in self._generative:
                raise ValueError(
                    "generative model %r already registered; stop it "
                    "first (one scheduler owns one slot pool)" % name)
            if self._stopping:
                raise ServerClosed("server is stopping")
            self._generative[name] = sched
        return sched

    def _gen_sched(self, name):
        with self._cv:
            sched = self._generative.get(name)
        if sched is None:
            raise ModelNotFound(
                "no generative model %r (add_generative_model first; "
                "one-shot models use infer/infer_async)" % name)
        return sched

    def infer_stream(self, name, prompt, max_new_tokens=None,
                     priority=None, tenant="default", timeout_ms=None):
        """Submit one generation; returns a ``TokenStream`` yielding
        token ids as decode steps commit them (``for tok in stream``)
        or collecting the sequence with ``stream.result()``.

        ``priority`` uses the server's classes (0 = most important;
        higher classes shed first under brownout), ``tenant`` scopes the
        exactly-once ledger and any decode-slot quota, and
        ``timeout_ms`` is an end-to-end deadline — a generation that
        overruns it mid-decode frees its slot and its stream ends
        ``expired`` with ``DeadlineExceeded``."""
        return self._gen_sched(name).submit(
            prompt, max_new_tokens=max_new_tokens, priority=priority,
            tenant=tenant, timeout_ms=timeout_ms)

    def set_slot_quota(self, name, tenant, slots):
        """Cap ``tenant``'s concurrently held decode slots on generative
        model ``name`` — the slot-pool member of the quota family
        (queue/inflight/cache quotas: :meth:`set_quota`)."""
        self._gen_sched(name).set_slot_quota(tenant, slots)

    def warmup_generative(self, name=None, from_manifest=False):
        """Bind and run every generative program before traffic: the
        prefill (batch, length) grid — through the executor cache, so
        cells land in the warmup manifest — plus one admit per length
        rung and the decode step, on a scratch state (live slots are
        left alone).  ``from_manifest=True`` narrows prefill to the grid
        cells a previous run recorded (``WarmupManifest.grid_for``), the
        generative analogue of :meth:`warmup_from_manifest`.  Returns
        ``{name: cells warmed}``."""
        with self._cv:
            items = {n: s for n, s in sorted(self._generative.items())
                     if name is None or n == name}
        if name is not None and not items:
            raise ModelNotFound("no generative model %r" % name)
        warmed = {}
        for n, sched in items.items():
            grid = None
            if from_manifest and self.manifest is not None:
                recorded = self.manifest.grid_for(
                    n, sched.model.symbol_sha, backend=self._backend)
                on_grid = [c for c in recorded
                           if c in set(sched.model.grid())]
                dropped = sorted(set(recorded) - set(on_grid))
                if dropped:
                    import logging
                    logging.warning(
                        "manifest grid cells %s for generative model "
                        "%r are off the current grid (ladder drift); "
                        "skipping them", dropped, n)
                grid = on_grid or None
            warmed[n] = sched.warmup(grid=grid)
        return warmed

    def _warm(self, plan, timeout_ms):
        """Execute a warmup plan of (entry, buckets) pairs: bind each
        bucket's predictor and run its first forward (where cuDNN picks
        its engines for that shape), timing the plan into
        ``mxnet_serving_warmup_seconds{mode=warm|cold}`` — warm when the
        compile cache ran no ``nvcc`` during the plan, cold otherwise."""
        from .. import compile_cache
        with self._cv:
            batcher_owns = self._thread is not None \
                and self._thread.is_alive() and not self._stopping
        before = compile_cache.stats(refresh=False)
        t0 = time.perf_counter()
        warmed = []
        for entry, bucket_list in plan:
            for b in bucket_list:
                feed = {k: np.zeros((b,) + s, np.float32)
                        for k, s in entry.sample_shapes.items()}
                if batcher_owns:
                    self.infer_async(entry.name, feed,
                                     version=entry.version,
                                     timeout_ms=timeout_ms,
                                     _solo=True).result()
                else:
                    pred = self.cache.get(entry, b)
                    pred.forward(**feed)
                    for i in range(entry.num_outputs):
                        pred.get_output(i).asnumpy()
                warmed.append((entry.name, entry.version, b))
        if warmed:
            wall = time.perf_counter() - t0
            after = compile_cache.stats(refresh=False)
            mode = "warm" if after["misses"] == before["misses"] \
                else "cold"
            telemetry.histogram(
                "mxnet_serving_warmup_seconds",
                "wall time of warmup plans by mode: warm = every bind "
                "hit the persistent compile cache, cold = at least one "
                "real compile (or cache off)",
                buckets=telemetry.exponential_buckets(0.01, 4.0, 10)
            ).labels(mode=mode).observe(wall)
        return warmed

    # -- batcher ------------------------------------------------------------
    def _worker(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            batch = self._collect_batch()
            if batch is None:
                return
            reqs, entry, bucket = batch

            def deliver(exc, _reqs=reqs, _entry=entry):
                got, gone = 0, 0
                for r in _reqs:
                    if r.future._set_exception(exc):
                        got += 1
                    else:
                        gone += 1       # client already cancelled
                self._req_inc("failed", got, model=_entry.name)
                self._req_inc("expired", gone, model=_entry.name)
                if self._canaries:
                    self._canary_observe(_entry, failed=got + gone)
                return got > 0

            # batch assembly crosses request traces; the dispatch span
            # parents under the LEADER request's context (first traced
            # request in the batch) so cache get/bind, execute and the
            # worker fault site all nest inside that request's trace
            lead = next((r.trace for r in reqs if r.trace is not None),
                        None)
            with _trace.use(lead), \
                    _trace.span("serving.dispatch", model=entry.name,
                                bucket=bucket, reqs=len(reqs)), \
                    engine.worker_scope(deliver):
                # a fault on the batcher thread fails THIS
                # batch's futures through deliver() and the loop keeps
                # serving — the poisoned-batch isolation contract
                if _fault.ACTIVE[0]:
                    _fault.fire("serving.worker", model=entry.name,
                                bucket=bucket)
                self._execute(reqs, entry, bucket)
            if self._canaries:
                self.tick_canaries()

    def _collect_batch(self):
        with self._cv:
            while True:
                if self._stopping and not self._drain:
                    return None     # stop() fails the remaining queue
                self._prune_locked()
                self._update_brownout_locked()
                head = self._next_head_locked()
                if head is not None:
                    rows_cap = self._rows_cap_locked(head)
                    window = head.t_submit + self._batch_wait_ms - _now_ms()
                    if (not head.solo and not self._stopping and
                            not self._brownout and window > 0 and
                            self._rows_queued_locked(head.gkey)
                            < rows_cap):
                        # hold the head open for co-batchable arrivals
                        # (brownout dispatches immediately: under
                        # pressure, latency beats fill)
                        self._cv.wait(window / 1000.0)
                        continue
                    return self._pop_batch_locked(head, rows_cap)
                if self._stopping:
                    return None
                self._cv.wait(0.1)

    def _next_head_locked(self):
        """Fair scheduling: round-robin over the MODELS with queued
        work (strict FIFO lets one tenant's deep backlog starve
        everyone else's shallow one), then the highest-priority oldest
        request of the chosen model."""
        if not self._queue:
            return None
        names = sorted({r.entry.name for r in self._queue})
        chosen = next((n for n in names if n > self._rr_last), names[0])
        self._rr_last = chosen
        return min((r for r in self._queue if r.entry.name == chosen),
                   key=lambda r: (r.priority, r.t_submit))

    def _rows_cap_locked(self, head):
        """Coalescing cap for this dispatch: the ladder max, shrunk to
        MXNET_SERVING_BROWNOUT_MAX_BATCH during brownout (smaller
        programs turn the queue over faster when the server is
        saturated).  A single oversized request still dispatches at
        its own size — requests are never split."""
        cap = self._max_batch
        if self._brownout and self._brownout_max_batch > 0:
            cap = min(cap, self._brownout_max_batch)
        return max(cap, head.rows)

    def _exec_estimates_ms(self):
        """Per-model batch-execute estimates for the doomed test —
        medians CACHED by ``_execute`` when a sample lands (the prune
        path runs under ``_cv`` on every batcher wakeup; recomputing
        np.median there would tax every submitting client).  No
        history -> no estimate -> never doomed (cold start must not
        shed)."""
        with self._mlock:
            return dict(self._exec_est)

    def _prune_locked(self):
        """Drop cancelled/expired requests before they cost a dispatch,
        and — under brownout — SHED already-doomed ones: a queued
        request whose remaining deadline is under its model's measured
        execute time can only expire AFTER spending accelerator rows,
        so shedding it helps every request behind it.  Scoped to
        brownout because the estimate is a whole-batch median: at low
        load a small request would ride a much cheaper dispatch than
        the median batch, and mis-shedding meetable work is worse than
        letting the deadline machinery handle it."""
        now = _now_ms()
        est = (self._exec_estimates_ms()
               if self._queue and self._brownout else {})
        keep, removed = [], []
        for r in self._queue:
            name = r.entry.name
            if r.future.cancelled():
                self._req_inc("expired", model=name)
                removed.append(r)
                continue
            if r.future._expired(now):
                r.future._set_exception(DeadlineExceeded(
                    "deadline passed while queued",
                    retry_after_s=self._retry_after_s(
                        name, depth=self._depths.get(name, 0))))
                self._req_inc("expired", model=name)
                removed.append(r)
                continue
            doom = est.get(name)
            if doom is not None and not r.solo \
                    and (r.future._deadline - now) < doom:
                r.future._set_exception(DeadlineExceeded(
                    "shed: deadline unmeetable (%.0f ms left, model "
                    "executes in ~%.0f ms)"
                    % (r.future._deadline - now, doom),
                    retry_after_s=self._retry_after_s(
                        name, depth=self._depths.get(name, 0))))
                self._req_inc("shed", model=name)
                self._shed_inc(name, r.priority, "doomed")
                removed.append(r)
                continue
            keep.append(r)
        if removed:
            self._queue[:] = keep
            self._note_removed_locked(removed)

    def _update_brownout_locked(self):
        """Hysteresis watermarks over the global queue depth; entering
        brownout additionally sheds queued requests of the reject
        classes (newest first — they would be rejected at submit now
        anyway, and the oldest accepted work has waited longest)."""
        depth = len(self._queue)
        if not self._brownout and depth >= self._brownout_high:
            self._brownout = True
            self._brownout_entered += 1
            self._t_brownout.set(1)
            telemetry.counter(
                "mxnet_serving_brownout_transitions_total",
                "brownout mode entries/exits by direction"
            ).labels(dir="enter").inc()
            _flight.record("brownout", dir="enter", depth=depth,
                           high=self._brownout_high)
            # incident trigger (rare by construction — hysteresis — and
            # capped at MXNET_TRACE_FLIGHT_DUMPS per process); runs
            # under _cv, the price of dumping the ring exactly at entry
            _flight.incident("brownout_entry", depth=depth,
                             high=self._brownout_high,
                             low=self._brownout_low)
        elif self._brownout and depth <= self._brownout_low:
            self._brownout = False
            self._t_brownout.set(0)
            telemetry.counter(
                "mxnet_serving_brownout_transitions_total",
                "brownout mode entries/exits by direction"
            ).labels(dir="exit").inc()
            _flight.record("brownout", dir="exit", depth=depth,
                           low=self._brownout_low)
        if not self._brownout or depth <= self._brownout_high:
            return
        sheddable = sorted(
            (r for r in self._queue
             if not r.solo and r.priority >= self._brownout_reject_class),
            key=lambda r: -r.t_submit)
        removed = []
        for r in sheddable:
            if len(self._queue) - len(removed) <= self._brownout_high:
                break
            name = r.entry.name
            # DeadlineExceeded, not QueueFull: this request WAS
            # accepted (QueueFull's contract is "never enqueued", and
            # the submit-retry loop could never catch an exception
            # raised from result()) — like a doomed shed, the request
            # is gone and the hint prices a FRESH submission
            r.future._set_exception(DeadlineExceeded(
                "brownout: shed from queue (priority class %d)"
                % r.priority,
                retry_after_s=self._retry_after_s(
                    name, depth=self._depths.get(name, 0))))
            self._req_inc("shed", model=name)
            self._shed_inc(name, r.priority, "brownout_queue")
            removed.append(r)
        if removed:
            gone = {id(r) for r in removed}
            self._queue[:] = [r for r in self._queue if id(r) not in gone]
            self._note_removed_locked(removed)

    def _note_removed_locked(self, reqs):
        """Queue-depth bookkeeping for every removal path."""
        for r in reqs:
            name = r.entry.name
            left = self._depths.get(name, 0) - 1
            if left > 0:
                self._depths[name] = left
            else:
                self._depths.pop(name, None)
            self._t_queue_depth.labels(model=name).set(max(0, left))
        self._q_counter.set_value(len(self._queue))
        self._t_queue_depth.set(len(self._queue))

    def _rows_queued_locked(self, gkey):
        return sum(r.rows for r in self._queue if r.gkey == gkey)

    def _pop_batch_locked(self, head, rows_cap):
        if head.solo:            # exactly this request, exactly its bucket
            self._queue.remove(head)
            self._note_removed_locked([head])
            return [head], head.entry, pick_bucket(head.rows, self._buckets)
        cands = sorted(
            (r for r in self._queue if not r.solo and r.gkey == head.gkey),
            key=lambda r: (r.priority, r.t_submit))
        taken, rows = [], 0
        for r in cands:
            if rows + r.rows <= rows_cap:
                taken.append(r)
                rows += r.rows
        gone = {id(r) for r in taken}
        self._queue[:] = [r for r in self._queue if id(r) not in gone]
        self._note_removed_locked(taken)
        return taken, head.entry, pick_bucket(rows, self._buckets)

    def _execute(self, reqs, entry, bucket):
        rows_total = sum(r.rows for r in reqs)
        name = entry.name
        span_args = {"model": name, "version": entry.version,
                     "bucket": bucket, "rows": rows_total}
        t_exec0 = _now_ms()
        with _trace.span("serving.batch", model=name, bucket=bucket,
                         rows=rows_total):
            with profiler.scope("serving:batch", cat="serving",
                                args=span_args):
                pred = self.cache.get(entry, bucket)
                feed = {}
                for k in entry.input_names:
                    feed[k], _ = pad_batch(
                        [r.inputs[k] for r in reqs], bucket)
                pred.forward(**feed)
                outs = [pred.get_output(i).asnumpy()
                        for i in range(entry.num_outputs)]
            if _fault.ACTIVE[0] and self._is_canary_version(
                    name, entry.version):
                # the poisoned-canary site — kind=nan
                # corrupts this batch's outputs in place (a silently-bad
                # checkpoint), kind=raise fails the batch (an erroring
                # one); the health gate below must catch either within
                # its budget.  Hand the plan writable copies (canary
                # batches under an armed plan only)
                outs = [o.copy() if getattr(o, "flags", None) is not None
                        and not o.flags.writeable else o for o in outs]
                _fault.fire("serving.canary.execute", model=name,
                            version=entry.version, arrays=outs)
        t_done = _now_ms()
        # the non-finite sentinel runs BEFORE delivery: a client
        # unblocked by a poisoned result could submit its next request
        # ahead of the rollback and have it routed to — and rebind —
        # the doomed version; deciding first closes that window for
        # serial clients (concurrent already-routed requests still
        # execute on their held entry, which is correct but costs a
        # lazy rebind)
        is_canary = self._canaries and \
            self._is_canary_version(name, entry.version)
        if is_canary:
            nonfinite = any(not np.isfinite(o).all() for o in outs
                            if getattr(o, "dtype", None) is not None
                            and o.dtype.kind == "f")
            if nonfinite:
                self._canary_observe(entry, nonfinite=True)
        served_lats = []
        off = 0
        for r in reqs:
            sl = [o[off:off + r.rows] for o in outs]
            off += r.rows
            if _trace.ACTIVE[0] and r.trace is not None:
                # retroactive per-request attribution: queue wait and
                # execute, as children of each request's own root (no
                # live span object per queued request — two cheap ring
                # appends at delivery)
                wall = time.time()
                _trace.add_span(
                    "serving.queue", r.trace,
                    wall - (t_done - r.t_submit) / 1e3,
                    t_exec0 - r.t_submit)
                _trace.add_span(
                    "serving.execute", r.trace,
                    wall - (t_done - t_exec0) / 1e3,
                    t_done - t_exec0, bucket=bucket)
            if r.future._set_result(sl):
                lat = t_done - r.t_submit
                self._req_inc("served", model=name)
                self._t_latency.observe(
                    lat, exemplar=r.trace.trace_id
                    if r.trace is not None else None)
                served_lats.append(lat)
                with self._mlock:
                    hist = self._latencies.setdefault(name, [])
                    hist.append(lat)
                    if len(hist) > self._lat_cap:
                        del hist[:-self._lat_cap]
            else:
                self._req_inc("expired", model=name)
        with self._mlock:
            h = self._batch_hist.setdefault(bucket, [0, 0])
            h[0] += 1
            h[1] += rows_total
            eh = self._exec_ms.setdefault(name, [])
            eh.append(t_done - t_exec0)
            if len(eh) > 256:
                del eh[:-256]
            self._exec_est[name] = float(np.median(eh[-32:]))
        self._t_batches.labels(bucket=bucket).inc()
        self._t_batch_rows.labels(bucket=bucket).inc(rows_total)
        # unlocked emptiness probe: no live canary (the overwhelming
        # steady state) costs one dict truthiness check, no isfinite
        # sweep and no lock.  The sentinel already ran pre-delivery;
        # this records serve counts + latencies for the rate/p99 gates.
        if self._canaries:
            self._canary_observe(entry, served=len(served_lats),
                                 latencies=served_lats)

    def _is_canary_version(self, name, version):
        with self._canary_lock:
            st = self._canaries.get(name)
            return (st is not None and st.decision is None
                    and version == st.canary_version)

    # -- observability ------------------------------------------------------
    def stats(self):
        """One consistent /stats snapshot (all counters since start).

        Every counter here is mirrored into the process-wide telemetry
        registry under the ``mxnet_serving_*`` names, so the same
        numbers (summed across servers) appear in
        ``telemetry.snapshot()`` and the Prometheus exposition."""
        with self._cv:
            depth = len(self._queue)
            depths = dict(self._depths)
            brownout = {"active": self._brownout,
                        "entered": self._brownout_entered,
                        "high_watermark": self._brownout_high,
                        "low_watermark": self._brownout_low,
                        "max_batch": (self._brownout_max_batch
                                      or self._max_batch),
                        "reject_class": self._brownout_reject_class}
            quotas = {n: dict(q) for n, q in self._model_quotas.items()}
        with self._mlock:
            all_lats = {n: list(h) for n, h in self._latencies.items()}
            peak = self._queue_peak
            model_peaks = dict(self._model_queue_peak)
            req = dict(self._req_counts)
            per_req = {n: dict(c) for n, c in self._model_req.items()}
            inflight = dict(self._inflight)
            sheds = dict(self._shed_counts)
            hist = {b: tuple(nr) for b, nr in self._batch_hist.items()}
        lats = [v for h in all_lats.values() for v in h]
        occupancy = {
            b: {"batches": n, "rows": r,
                "fill": round(r / float(n * b), 4)}
            for b, (n, r) in sorted(hist.items())}

        def _pct(vals, q):
            return round(float(np.percentile(vals, q)), 3) if vals else None

        snap = {
            "device": str(self.device),
            "queue": {"depth": depth, "peak": peak,
                      "limit": self._queue_depth},
            "requests": {
                "submitted": req["submitted"],
                "served": req["served"],
                "failed": req["failed"],
                "rejected_queue_full": req["rejected_queue_full"],
                "expired": req["expired"],
                "retried": req["retried"],
                "shed": req["shed"]},
            "batches": {"count": sum(n for n, _r in hist.values()),
                        "rows": sum(r for _n, r in hist.values()),
                        "occupancy": occupancy},
            "buckets": list(self._buckets),
            "brownout": brownout,
        }
        snap["latency_ms"] = {
            "count": len(lats),
            "p50": _pct(lats, 50),
            "p99": _pct(lats, 99),
        }
        # per-model sections: one row per tenant this server has seen,
        # self-contained enough to debug a single tenant's complaint
        # without grepping the shared series
        shed_rows = {}
        for (n, cls, reason), c in sorted(sheds.items()):
            shed_rows.setdefault(n, []).append(
                {"class": cls, "reason": reason, "count": c})
        canaries = self.canary_status()
        names = (set(per_req) | set(depths) | set(quotas)
                 | set(all_lats) | set(shed_rows))
        per_model = {}
        for n in sorted(names):
            mh = all_lats.get(n, [])
            per_model[n] = {
                "requests": per_req.get(
                    n, dict.fromkeys(self._req_counts, 0)),
                "queue_depth": depths.get(n, 0),
                "queue_peak": model_peaks.get(n, 0),
                "inflight": inflight.get(n, 0),
                "quota": quotas.get(n),
                "sheds": shed_rows.get(n, []),
                "latency_ms": {"count": len(mh), "p50": _pct(mh, 50),
                               "p99": _pct(mh, 99)},
                "retry_after_s": round(
                    self._retry_after_s(n, depth=depths.get(n, 0)), 4),
                "canary": canaries["live"].get(n),
            }
        snap["per_model"] = per_model
        snap["sheds_total"] = sum(sheds.values())
        snap["canaries"] = canaries
        snap["executor_cache"] = self.cache.stats()
        from .. import compile_cache
        # cheap form: counters + last-sweep sizes, no directory walk —
        # stats() is a monitoring poll and the cache dir may be a
        # network mount
        snap["compile_cache"] = compile_cache.stats(refresh=False)
        snap["warmup_manifest"] = {
            "path": self.manifest.path,
            "entries": len(self.manifest),
        } if self.manifest is not None else None
        snap["models"] = self.registry.describe()
        with self._cv:
            gens = dict(self._generative)
        if gens:
            snap["generative"] = {n: s.stats()
                                  for n, s in sorted(gens.items())}
        return snap
