"""ModelServer — dynamic micro-batching over a bucketed executor cache.

Counterpart of ``mxnet_tpu/serving/server.py`` (TF-Serving's
``BatchingSession`` over the MXNet predict contract): callers see a
per-request ``infer()``; one batcher thread drains a bounded queue,
coalesces requests for the same model version, pads the rows up to a
shape bucket and runs ONE forward of the bucket's bound predictor, on
the server's device.

Kept from the JAX package, each with its typed error and stats counter:

- deadlines: every request carries one; an expired request fails with
  ``DeadlineExceeded`` and is skipped by the batcher;
- backpressure: the queue is bounded; a submission beyond it raises
  ``QueueFull`` and is not enqueued;
- fault isolation: a batch runs inside ``engine.worker_scope``, so a
  failed batch fails its own futures and the batcher keeps serving;
- ``stats()``: request outcomes, latency p50/p99, the batch histogram
  and executor-cache counts.

Observability, as in the JAX package: the per-instance counts back
``stats()`` and the telemetry registry mirrors them under
``mxnet_serving_*`` (requests by outcome and model, batches and rows by
bucket, queue depth, latency with the request's trace id as exemplar);
each executed batch is one ``serving:batch`` profiler span, and with
tracing on a request is a ``serving.request`` trace with
``serving.dispatch``, ``serving.batch``, ``serving.cache.get``,
``serving.queue`` and ``serving.execute`` spans under it.

Left for later slices: canary promotion, brownout and shedding (and
their metric families), per-model quotas, generative serving, the
warmup manifest, fault hooks, sanitizers and the tuning database.

Threading: ONE batcher thread issues all device work, on the server's
device and its current stream; ``asnumpy()`` of the outputs is the
synchronisation point.  Client threads only enqueue and wait.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import config
from .. import engine
from .. import profiler
from .. import telemetry
from ..context import resolve
from ..io import pad_batch
from .bucketing import pick_bucket, shape_buckets
from .cache import ExecutorCache
from .errors import BadRequest, DeadlineExceeded, QueueFull, ServerClosed
from .registry import ModelRegistry
from ..telemetry import tracing as _trace

__all__ = ["InferenceFuture", "ModelServer"]


def _now_ms():
    return time.monotonic() * 1000.0


class InferenceFuture:
    """Result handle for one queued request.  ``result()`` blocks until
    the batcher delivers or the deadline passes; expiry cancels the
    request (the batcher skips it) and raises ``DeadlineExceeded``."""

    __slots__ = ("_ev", "_lock", "_result", "_exc", "_cancelled",
                 "_deadline", "_span")

    def __init__(self, deadline_ms):
        self._ev = threading.Event()
        self._lock = threading.Lock()
        self._result = None
        self._exc = None
        self._cancelled = False
        self._deadline = deadline_ms
        # the request's trace root: owned here from submit, closed by
        # every terminal path (deliver, fail, expiry)
        self._span = None

    def cancelled(self):
        return self._cancelled

    def _set_result(self, value):
        """Deliver; False when the client already gave up."""
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
            # a failed or expired request is an anomalous trace: the
            # non-ok status keeps it through tail sampling
            self._span.finish(status=type(exc).__name__)
        return True

    def _expired(self, now_ms):
        return now_ms > self._deadline and not self._ev.is_set()

    def result(self):
        self._ev.wait(max(0.0, (self._deadline - _now_ms()) / 1000.0))
        with self._lock:
            expired = not self._ev.is_set()
            if expired:
                self._cancelled = True
        if expired:
            if self._span is not None:
                self._span.finish(status="deadline")
            raise DeadlineExceeded(
                "deadline passed before a result was delivered")
        if self._exc is not None:
            raise self._exc
        return self._result


class _Request:
    __slots__ = ("entry", "inputs", "rows", "future", "gkey", "t_submit",
                 "solo", "trace")

    def __init__(self, entry, inputs, rows, future, t_submit, solo=False):
        self.trace = None       # the request's trace context, or None
        self.entry = entry
        self.inputs = inputs
        self.rows = rows
        self.future = future
        # id(entry) pins the exact registry object: requests for an old
        # and a re-registered entry of one version never share a batch
        self.gkey = (entry.name, entry.version, id(entry))
        self.t_submit = t_submit
        # solo requests (warmup dummies) are never coalesced, so each
        # lands in exactly the bucket it was sized for
        self.solo = solo


class ModelServer:
    """The serving front door: a model registry and one batcher thread,
    serving on ``ctx`` (default the current context; without a GPU pass
    ``ctx=cpu()``, or construction raises).

    >>> srv = ModelServer(max_batch=32, ctx=gpu(0))
    >>> srv.add_model("resnet", sym, arg_params, aux_params,
    ...               {"data": (1, 3, 224, 224)})
    >>> srv.start(); srv.warmup("resnet")
    >>> probs = srv.infer("resnet", {"data": x})[0]
    """

    def __init__(self, registry=None, max_batch=None, queue_depth=None,
                 batch_wait_ms=None, default_timeout_ms=None,
                 cache_size=None, buckets=None, ctx=None):
        self.device = resolve(ctx)
        self.registry = registry if registry is not None else ModelRegistry()
        if buckets is not None:
            self._buckets = sorted({int(b) for b in buckets})
            if not self._buckets or self._buckets[0] < 1:
                raise ValueError("buckets must be a non-empty list of sizes "
                                 ">= 1, got %r" % (buckets,))
            if max_batch is not None and int(max_batch) != self._buckets[-1]:
                raise ValueError(
                    "conflicting config: max_batch=%d but the bucket ladder "
                    "tops out at %d" % (int(max_batch), self._buckets[-1]))
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
        self.cache = ExecutorCache(
            cache_size if cache_size is not None
            else config.get("MXNET_SERVING_EXECUTOR_CACHE"), ctx=self.device)
        self._cv = threading.Condition(threading.Lock())
        self._queue = []                # guarded-by: _cv
        self._stopping = False          # guarded-by: _cv
        self._drain = True              # guarded-by: _cv
        self._thread = None             # guarded-by: _cv
        self._mlock = threading.Lock()
        self._req_counts = dict.fromkeys(   # guarded-by: _mlock
            ("submitted", "served", "failed", "rejected_queue_full",
             "expired"), 0)
        self._latencies = []            # guarded-by: _mlock
        self._lat_cap = 4096
        self._batch_hist = {}           # guarded-by: _mlock — bucket -> [n, rows]
        self._queue_peak = 0            # guarded-by: _mlock
        # the registry's mirrors of the counts above (process-wide: the
        # totals of every live server)
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
        self._domain = profiler.Domain("serving")
        self._q_counter = self._domain.new_counter("serving_queue_depth")

    def _req_inc(self, outcome, n=1, model=None):
        if not n:
            return
        with self._mlock:
            self._req_counts[outcome] += n
        if model is not None:
            self._t_requests.labels(outcome=outcome, model=model).inc(n)
        else:
            self._t_requests.labels(outcome=outcome).inc(n)

    def _note_depth_locked(self):
        """Mirror the queue depth (profiler counter and gauge)."""
        self._q_counter.set_value(len(self._queue))
        self._t_queue_depth.set(len(self._queue))

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
        if t is not None:
            t.join(timeout=60.0)
        with self._cv:
            leftovers = list(self._queue)
            del self._queue[:]
            self._note_depth_locked()
        for r in leftovers:
            if r.future._set_exception(ServerClosed("server stopped")):
                self._req_inc("failed", model=r.entry.name)
            else:
                self._req_inc("expired", model=r.entry.name)

    # -- request path -------------------------------------------------------
    def infer(self, name, inputs, version=None, timeout_ms=None):
        """Blocking inference: the model's outputs as a list of numpy
        arrays whose batch axis matches the request's rows."""
        return self.infer_async(name, inputs, version=version,
                                timeout_ms=timeout_ms).result()

    def infer_async(self, name, inputs, version=None, timeout_ms=None,
                    _solo=False):
        """Enqueue a request; returns an :class:`InferenceFuture`.

        ``inputs`` maps input name -> array (a single-input model also
        takes the bare array), with a leading batch axis of 1..max_batch
        rows or as one sample.  Raises ``QueueFull``, ``BadRequest`` or
        ``ModelNotFound`` at once: a rejected request was never queued."""
        entry = self.registry.get(name, version)
        if not isinstance(inputs, dict):
            if len(entry.input_names) != 1:
                raise BadRequest("model %r has inputs %s; pass a dict"
                                 % (name, entry.input_names))
            inputs = {entry.input_names[0]: inputs}
        missing = [k for k in entry.input_names if k not in inputs]
        unknown = [k for k in inputs if k not in entry.sample_shapes]
        if missing or unknown:
            raise BadRequest("model %r inputs are %s (missing %s, unknown %s)"
                             % (name, entry.input_names, missing, unknown))
        arrs, rows = {}, None
        for k in entry.input_names:
            a = np.asarray(inputs[k], dtype=np.float32)
            want = entry.sample_shapes[k]
            if a.ndim == len(want):
                a = a[None]
            if a.ndim != len(want) + 1 or a.shape[1:] != want:
                raise BadRequest("input %r expects sample shape %s, got "
                                 "array of shape %s" % (k, want, a.shape))
            if rows is None:
                rows = a.shape[0]
            elif a.shape[0] != rows:
                raise BadRequest("inconsistent batch rows across inputs: "
                                 "%d vs %d" % (rows, a.shape[0]))
            arrs[k] = a
        if rows == 0:
            raise BadRequest("empty request (0 rows)")
        if rows > self._max_batch:
            raise BadRequest("request rows %d exceed the largest shape "
                             "bucket %d; split the request"
                             % (rows, self._max_batch))
        timeout = self._default_timeout_ms if timeout_ms is None \
            else float(timeout_ms)
        now = _now_ms()
        fut = InferenceFuture(now + timeout)
        req = _Request(entry, arrs, rows, fut, now, solo=_solo)
        if _trace.ACTIVE[0]:
            # the request's trace root: joins the caller's context where
            # there is one, else a fresh trace; the future owns the span
            # and the batcher parents its spans on req.trace
            ctx = _trace.current() or _trace.mint(model=name)
            root = _trace.start_span(
                "serving.request", ctx=ctx, model=name,
                version=entry.version, rows=rows, deadline_ms=timeout)
            fut._span = root
            req.trace = root.ctx
        with self._cv:
            stopping = self._stopping
            full = len(self._queue) >= self._queue_depth
            if not (stopping or full):
                self._queue.append(req)
                depth = len(self._queue)
                self._note_depth_locked()
                self._cv.notify_all()
        if stopping or full:
            err = (ServerClosed("server is stopping") if stopping else
                   QueueFull("serving queue at capacity (%d requests); "
                             "retry later" % self._queue_depth,
                             retry_after_s=self._batch_wait_ms / 1000.0))
            fut._set_exception(err)     # closes the trace root
            if not stopping:
                self._req_inc("rejected_queue_full", model=name)
            raise err
        self._req_inc("submitted", model=name)
        with self._mlock:
            self._queue_peak = max(self._queue_peak, depth)
        return fut

    def warmup(self, name=None, version=None, buckets=None,
               timeout_ms=600000.0):
        """Bind AND run every (model, bucket) predictor once, so live
        traffic never pays a bind or a first-call cost (cuDNN algorithm
        selection, the kernels' build); returns the (name, version,
        bucket) triples warmed.  With the batcher running, each dummy
        goes THROUGH it as a solo request, so warmup never races a live
        forward on the same predictor."""
        names = [name] if name is not None \
            else sorted(self.registry.describe())
        ladder = [int(b) for b in (buckets if buckets is not None
                                   else self._buckets)]
        rogue = [b for b in ladder if b not in self._buckets]
        if rogue:
            raise ValueError("warmup buckets %s are not on the ladder %s"
                             % (rogue, self._buckets))
        with self._cv:
            batcher_owns = self._thread is not None \
                and self._thread.is_alive() and not self._stopping
        warmed = []
        for n in names:
            entry = self.registry.get(n, version)
            for b in ladder:
                feed = {k: np.zeros((b,) + s, np.float32)
                        for k, s in entry.sample_shapes.items()}
                if batcher_owns:
                    self.infer_async(entry.name, feed, version=entry.version,
                                     timeout_ms=timeout_ms,
                                     _solo=True).result()
                else:
                    pred = self.cache.get(entry, b)
                    pred.forward(**feed)
                    for i in range(entry.num_outputs):
                        pred.get_output(i).asnumpy()
                warmed.append((entry.name, entry.version, b))
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

            def deliver(exc, _reqs=reqs, _name=entry.name):
                got = sum(1 for r in _reqs if r.future._set_exception(exc))
                self._req_inc("failed", got, model=_name)
                self._req_inc("expired", len(_reqs) - got, model=_name)
                return got > 0

            # the dispatch span parents under the first traced request
            # of the batch, so the cache lookup and the execute nest in
            # that request's trace
            lead = next((r.trace for r in reqs if r.trace is not None),
                        None)
            with _trace.use(lead), \
                    _trace.span("serving.dispatch", model=entry.name,
                                bucket=bucket, reqs=len(reqs)), \
                    engine.worker_scope(deliver):
                self._execute(reqs, entry, bucket)

    def _collect_batch(self):
        with self._cv:
            while True:
                if self._stopping and not self._drain:
                    return None
                self._prune_locked()
                if self._queue:
                    head = self._queue[0]
                    window = head.t_submit + self._batch_wait_ms - _now_ms()
                    if (not head.solo and not self._stopping and window > 0
                            and self._rows_queued_locked(head.gkey)
                            < self._max_batch):
                        # hold the head open for co-batchable arrivals
                        self._cv.wait(window / 1000.0)
                        continue
                    return self._pop_batch_locked(head)
                if self._stopping:
                    return None
                self._cv.wait(0.1)

    def _prune_locked(self):
        """Drop cancelled and expired requests before they cost a
        dispatch."""
        now = _now_ms()
        keep = []
        for r in self._queue:
            if r.future.cancelled():
                self._req_inc("expired", model=r.entry.name)
            elif r.future._expired(now):
                r.future._set_exception(
                    DeadlineExceeded("deadline passed while queued"))
                self._req_inc("expired", model=r.entry.name)
            else:
                keep.append(r)
        if len(keep) != len(self._queue):
            self._queue[:] = keep
            self._note_depth_locked()

    def _rows_queued_locked(self, gkey):
        return sum(r.rows for r in self._queue if r.gkey == gkey)

    def _pop_batch_locked(self, head):
        if head.solo:            # exactly this request, exactly its bucket
            self._queue.remove(head)
            self._note_depth_locked()
            return [head], head.entry, pick_bucket(head.rows, self._buckets)
        taken, rows = [], 0
        for r in self._queue:
            if not r.solo and r.gkey == head.gkey \
                    and rows + r.rows <= self._max_batch:
                taken.append(r)
                rows += r.rows
        gone = {id(r) for r in taken}
        self._queue[:] = [r for r in self._queue if id(r) not in gone]
        self._note_depth_locked()
        return taken, head.entry, pick_bucket(rows, self._buckets)

    def _execute(self, reqs, entry, bucket):
        rows_total = sum(r.rows for r in reqs)
        name = entry.name
        t_exec0 = _now_ms()
        with _trace.span("serving.batch", model=name, bucket=bucket,
                         rows=rows_total), \
                profiler.scope("serving:batch", cat="serving",
                               args={"model": name,
                                     "version": entry.version,
                                     "bucket": bucket, "rows": rows_total}):
            pred = self.cache.get(entry, bucket)
            feed = {k: pad_batch([r.inputs[k] for r in reqs], bucket)[0]
                    for k in entry.input_names}
            pred.forward(**feed)
            outs = [pred.get_output(i).asnumpy()
                    for i in range(entry.num_outputs)]
        t_done = _now_ms()
        off = 0
        lats = []
        for r in reqs:
            if _trace.ACTIVE[0] and r.trace is not None:
                # queue wait and execute, recorded after the fact as
                # children of each request's own root
                wall = time.time()
                _trace.add_span("serving.queue", r.trace,
                                wall - (t_done - r.t_submit) / 1e3,
                                t_exec0 - r.t_submit)
                _trace.add_span("serving.execute", r.trace,
                                wall - (t_done - t_exec0) / 1e3,
                                t_done - t_exec0, bucket=bucket)
            if r.future._set_result([o[off:off + r.rows] for o in outs]):
                lat = t_done - r.t_submit
                lats.append(lat)
                self._t_latency.observe(
                    lat, exemplar=r.trace.trace_id
                    if r.trace is not None else None)
            off += r.rows
        self._req_inc("served", len(lats), model=name)
        self._req_inc("expired", len(reqs) - len(lats), model=name)
        with self._mlock:
            self._latencies.extend(lats)
            del self._latencies[:-self._lat_cap]
            h = self._batch_hist.setdefault(bucket, [0, 0])
            h[0] += 1
            h[1] += rows_total
        self._t_batches.labels(bucket=bucket).inc()
        self._t_batch_rows.labels(bucket=bucket).inc(rows_total)

    # -- observability ------------------------------------------------------
    def stats(self):
        """One snapshot of the counters since construction."""
        with self._cv:
            depth = len(self._queue)
        with self._mlock:
            req = dict(self._req_counts)
            lats = list(self._latencies)
            hist = {b: tuple(v) for b, v in self._batch_hist.items()}
            peak = self._queue_peak

        def pct(q):
            return round(float(np.percentile(lats, q)), 3) if lats else None

        return {
            "device": str(self.device),
            "queue": {"depth": depth, "peak": peak,
                      "limit": self._queue_depth},
            "requests": req,
            "latency_ms": {"count": len(lats), "p50": pct(50),
                           "p99": pct(99)},
            "batches": {
                "count": sum(n for n, _ in hist.values()),
                "rows": sum(r for _, r in hist.values()),
                "occupancy": {b: {"batches": n, "rows": r,
                                  "fill": round(r / float(n * b), 4)}
                              for b, (n, r) in sorted(hist.items())}},
            "buckets": list(self._buckets),
            "executor_cache": self.cache.stats(),
            "models": self.registry.describe(),
        }
