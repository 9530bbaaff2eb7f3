"""FleetFrontDoor — a health-routed replica set over the transport seam.

Counterpart of ``mxnet_tpu/serving/fleet.py`` (reference precedent:
TF-Serving deployments put a router in front of N model-server replicas,
arxiv 1712.06139 §3; the parameter-server paper's server groups survive
node death the same way).  The front door for :class:`~.server.ModelServer`
replicas, on the :class:`~..parallel.transport.SpoolTransport` seam so
every hop is fault-addressable per (site, peer):

- **routing**: round robin over HEALTHY replicas only;
- **health**: each replica is judged by the :class:`~.canary.CanaryState`
  gate, its own window as the "canary" and the rest of the fleet's
  latencies as the "baseline": error rate, p99 against the fleet and
  non-finite outputs eject it as a bad canary rolls back;
- **ejection and re-admission**: an ejected replica is probed on a
  budgeted :class:`~..fault.BackoffPolicy` schedule
  (``MXNET_FLEET_PROBE_RETRIES`` probes); a pong re-admits it with a
  fresh window, an exhausted budget marks it dead;
- **exactly-once ledger**: every request gets ONE id and ONE terminal
  outcome (served, failed or expired).  A dead or partitioned replica
  triggers resubmission of the SAME id to the next healthy replica; the
  response demux drops any late duplicate (the first terminal result
  wins);
- **remote hints**: typed rejections cross the wire through
  :func:`encode_error`/:func:`decode_error` with ``retry_after_s``, and
  the front door's ``QueueFull`` retry honours the REMOTE replica's hint
  as its backoff floor.

Replicas come in two shapes: :func:`local_replica` (a daemon thread
around an in-process ``ModelServer``) and :func:`spawn_replica`
(``python -m mxnet_tpu_torch.serving.fleet --replica``, a process the
drills SIGKILL mid-request).  Both run :func:`replica_loop`.  A spawned
replica serves on the card unless ``ctx`` asks for the CPU (the JAX
package's child forces its CPU platform; this one does not): a child
asked for a GPU that finds none raises at start, exits non-zero, and
the front door ejects it.  Outputs cross the spool as numpy.
"""
from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

from .. import config
from ..fault.backoff import BackoffPolicy
from ..parallel.transport import SpoolTransport
from ..telemetry import flight as _flight
from ..telemetry import tracing as _trace
from .canary import CanaryState
from .errors import (BadRequest, DeadlineExceeded, ModelNotFound, QueueFull,
                     ServerClosed, ServingError, _RetryHinted)

__all__ = ["FleetFrontDoor", "ReplicaHandle", "replica_loop",
           "local_replica", "spawn_replica", "encode_error", "decode_error"]

_ERR_TYPES = {c.__name__: c for c in
              (ServingError, ModelNotFound, QueueFull, DeadlineExceeded,
               ServerClosed, BadRequest)}


def encode_error(exc):
    """Project a serving exception onto a JSON-able dict that survives
    the transport; unknown types degrade to the ``ServingError`` root
    (the taxonomy, not the class identity, is the wire contract)."""
    name = type(exc).__name__
    out = {"type": name if name in _ERR_TYPES else "ServingError",
           "message": str(exc)}
    hint = getattr(exc, "retry_after_s", None)
    if hint is not None:
        out["retry_after_s"] = float(hint)
    return out


def decode_error(d):
    """Rebuild the typed exception on the client side — a remote
    ``QueueFull`` must be caught by the same handlers as a local one,
    and its ``retry_after_s`` hint must survive the round trip."""
    cls = _ERR_TYPES.get(d.get("type"), ServingError)
    msg = d.get("message", "remote serving error")
    if issubclass(cls, _RetryHinted):
        return cls(msg, retry_after_s=d.get("retry_after_s"))
    return cls(msg)


def replica_loop(server, transport, front=0, stop_event=None,
                 idle_timeout_s=0.25):
    """Serve front-door messages until a ``stop`` message (or
    ``stop_event``): ``infer`` runs the wrapped ``ModelServer``,
    ``probe`` answers the re-admission ping.  Every reply reuses the
    request's id and goes back reliably — a ``lost_ack`` on the result
    link resends under one message id and the front door's dedup
    absorbs it."""
    while stop_event is None or not stop_event.is_set():
        for m in transport.recv_wait(timeout_s=idle_timeout_s):
            if m.kind == "stop":
                return
            if m.kind == "probe":
                transport.send_reliable(front, "result",
                                        meta={"id": m.meta["id"],
                                              "ok": True, "probe": True})
                continue
            if m.kind != "infer":
                continue
            meta = {"id": m.meta["id"]}
            # stitch into the front door's trace (the frame's _trace
            # header); a request resubmitted after a replica death is
            # anomalous by definition, and the SURVIVOR retains it
            hdr_ctx = _trace.extract(m.meta)
            resub = int(m.meta.get("resubmits") or 0)
            with _trace.use(hdr_ctx), \
                    _trace.span("replica.serve", req=m.meta["id"],
                                model=m.meta.get("model"),
                                resubmits=resub) as _sp:
                if resub and hdr_ctx is not None:
                    _trace.mark("resubmitted", hdr_ctx)
                try:
                    outs = server.infer(m.meta["model"], dict(m.arrays),
                                        timeout_ms=m.meta.get("timeout_ms"),
                                        priority=m.meta.get("priority"))
                    meta["ok"] = True
                    arrays = {"out%03d" % i: np.asarray(o)
                              for i, o in enumerate(outs)}
                    transport.send_reliable(front, "result", meta=meta,
                                            arrays=arrays)
                except Exception as exc:  # typed errors cross the wire
                    _sp.finish(status=type(exc).__name__)
                    meta["ok"] = False
                    meta["error"] = encode_error(exc)
                    try:
                        transport.send_reliable(front, "result", meta=meta)
                    except ConnectionError:
                        pass  # result link dead: the front door resubmits
            if _trace.ACTIVE[0]:
                # this process's share of the trace is done (its root
                # finishes in the front door): persist it NOW, so a later
                # SIGKILL cannot lose spans of served requests
                _trace.complete(hdr_ctx)
                _trace.flush()


class ReplicaHandle:
    """The front door's grip on one replica backend: its rank (= the
    transport address), and either a daemon thread or a subprocess to
    liveness-check / kill / stop."""

    def __init__(self, rid, proc=None, thread=None, stop_event=None):
        self.rid = int(rid)
        self.proc = proc
        self.thread = thread
        self.stop_event = stop_event

    def alive(self):
        if self.proc is not None:
            return self.proc.poll() is None
        if self.thread is not None:
            return self.thread.is_alive()
        return True

    def kill(self):
        """SIGKILL a process replica mid-request (the chaos drills'
        host-death move); thread replicas only support clean stop."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)

    def stop(self):
        if self.stop_event is not None:
            self.stop_event.set()
        if self.thread is not None:
            self.thread.join(timeout=5)
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except Exception:
                self.proc.kill()


def local_replica(root, rid, world, server):
    """Thread-backed replica around an in-process (started)
    ``ModelServer`` — the fast-test and soak-harness shape."""
    transport = SpoolTransport(root, rid, world)
    stop = threading.Event()
    t = threading.Thread(target=replica_loop, args=(server, transport),
                         kwargs={"stop_event": stop},
                         name="mxnet-fleet-replica-%d" % rid, daemon=True)
    t.start()
    return ReplicaHandle(rid, thread=t, stop_event=stop)


def spawn_replica(root, rid, world, seed=0, env=None, fault_plan=None,
                  ctx=None):
    """Subprocess replica: ``python -m mxnet_tpu_torch.serving.fleet
    --replica`` builds the standard linear test model (deterministic in
    ``seed``, so every replica computes the same function and routing
    is invisible to clients).  ``fault_plan`` ships a seeded plan into
    the child via ``MXNET_FAULT_PLAN``; ``ctx`` (a Context, default
    ``gpu(0)``) is where the child serves."""
    import subprocess
    import sys
    child = dict(os.environ if env is None else env)
    # a custom env inherits the parent's tuning switch and database
    # location unless the caller pinned them
    for tune_key in ("MXNET_TUNE", "MXNET_TUNE_DB_DIR"):
        val = os.environ.get(tune_key)
        if val is not None:
            child.setdefault(tune_key, val)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    child["PYTHONPATH"] = repo + os.pathsep + child.get("PYTHONPATH", "")
    if fault_plan is not None:
        child["MXNET_FAULT_PLAN"] = json.dumps(fault_plan)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.serving.fleet", "--replica",
         "--root", str(root), "--rank", str(rid), "--world", str(world),
         "--seed", str(seed), "--ctx", _ctx_arg(ctx)],
        env=child, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return ReplicaHandle(rid, proc=proc)


def _ctx_arg(ctx):
    """``cpu`` or ``gpu:N`` for the child's ``--ctx``."""
    from ..context import Context
    c = Context(ctx) if ctx is not None else Context("gpu", 0)
    return "%s:%d" % (c.device_type, c.device_id)


class _Pending:
    """One in-flight request slot the rx thread completes."""

    __slots__ = ("event", "arrays", "error", "done", "rid", "latency_ms",
                 "t0")

    def __init__(self):
        self.event = threading.Event()
        self.arrays = None
        self.error = None
        self.done = False
        self.rid = None
        self.latency_ms = None
        self.t0 = time.monotonic()


class _ReplicaState:
    """Per-replica health bookkeeping (guarded by the fleet lock)."""

    __slots__ = ("status", "reason", "window", "probes", "next_probe_s",
                 "backoff")

    def __init__(self, backoff):
        self.status = "healthy"      # healthy | ejected | dead
        self.reason = None
        self.window = {"served": 0, "failed": 0, "lat": [], "nonfinite": 0}
        self.probes = 0
        self.next_probe_s = 0.0
        self.backoff = backoff

    def reset_window(self):
        self.window = {"served": 0, "failed": 0, "lat": [], "nonfinite": 0}


class FleetFrontDoor:
    """Route requests across replicas; keep the ledger exactly-once.

    ``root`` is the shared transport directory; the front door is rank
    0, replicas are ranks 1..N (``add_replica``).  ``infer`` blocks —
    the fleet's concurrency comes from calling it on many threads, as a
    real RPC front door would."""

    def __init__(self, root, world, request_timeout_s=30.0,
                 submit_retries=None, probe_retries=None,
                 health_interval_s=None, health_min_requests=8,
                 max_error_rate=0.5, p99_factor=4.0, submit_backoff=None,
                 probe_timeout_s=2.0):
        self._transport = SpoolTransport(root, 0, world)
        self._request_timeout_s = float(request_timeout_s)
        self._probe_timeout_s = float(probe_timeout_s)
        self._submit_retries = int(
            config.get("MXNET_FLEET_SUBMIT_RETRIES")
            if submit_retries is None else submit_retries)
        self._probe_retries = int(
            config.get("MXNET_FLEET_PROBE_RETRIES")
            if probe_retries is None else probe_retries)
        self._health_interval_s = float(
            config.get("MXNET_FLEET_HEALTH_INTERVAL_S")
            if health_interval_s is None else health_interval_s)
        self._health_min_requests = int(health_min_requests)
        self._max_error_rate = float(max_error_rate)
        self._p99_factor = float(p99_factor)
        self._submit_backoff = submit_backoff or BackoffPolicy(
            base_s=0.01, max_s=0.5)
        self._lock = threading.Lock()
        self._handles = {}           # rid -> ReplicaHandle
        self._health = {}            # rid -> _ReplicaState
        self._pending = {}           # request id -> _Pending
        self._rr = 0
        self._req_no = 0
        self._ledger = {"submitted": 0, "served": 0, "failed": 0,
                        "expired": 0, "resubmitted": 0, "retried": 0,
                        "duplicates_dropped": 0, "ejections": 0,
                        "readmissions": 0, "hint_floors": 0}
        self._last_hint = None
        self._stop = threading.Event()
        self._rx = threading.Thread(target=self._rx_loop,
                                    name="mxnet-fleet-rx", daemon=True)
        self._rx.start()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="mxnet-fleet-health",
            daemon=True)
        self._health_thread.start()

    # -- membership ---------------------------------------------------------
    def add_replica(self, handle):
        with self._lock:
            self._handles[handle.rid] = handle
            self._health[handle.rid] = _ReplicaState(
                BackoffPolicy(base_s=0.02, max_s=0.5))
        return handle

    def healthy_replicas(self):
        with self._lock:
            return sorted(r for r, h in self._health.items()
                          if h.status == "healthy")

    def replica_status(self):
        with self._lock:
            return {r: (h.status, h.reason)
                    for r, h in self._health.items()}

    def _pick(self):
        with self._lock:
            live = sorted(r for r, h in self._health.items()
                          if h.status == "healthy")
            if not live:
                return None
            self._rr += 1
            return live[self._rr % len(live)]

    # -- request path -------------------------------------------------------
    def infer(self, name, inputs, timeout_ms=None, priority=None):
        """Route one request; exactly one terminal outcome per call.
        Replica death or partition mid-request resubmits the SAME id to
        the next healthy replica; a remote ``QueueFull`` is retried up
        to ``MXNET_FLEET_SUBMIT_RETRIES`` times honoring the replica's
        live ``retry_after_s`` hint as the backoff floor."""
        if not isinstance(inputs, dict):
            inputs = {"data": inputs}
        arrays = {k: np.asarray(v) for k, v in inputs.items()}
        with self._lock:
            self._req_no += 1
            req_id = "req-%d-%06d" % (os.getpid(), self._req_no)
            self._ledger["submitted"] += 1
        meta = {"id": req_id, "model": str(name)}
        if timeout_ms is not None:
            meta["timeout_ms"] = float(timeout_ms)
        if priority is not None:
            meta["priority"] = int(priority)
        queue_retries = 0
        # the request's trace root: every route attempt, transport frame
        # and (via the _trace header) remote replica span parents here
        _root = _trace.start_span(
            "fleet.infer", ctx=_trace.mint(model=str(name),
                                           priority=priority)
            if _trace.ACTIVE[0] else None, req=req_id)
        try:
            with _trace.use(_root.ctx):
                while True:
                    rid = self._pick()
                    if rid is None:
                        self._finish(req_id, "failed")
                        _root.finish(status="no_replicas")
                        raise ServingError(
                            "fleet: no healthy replicas "
                            "(status %r)" % (self.replica_status(),))
                    pend = _Pending()
                    with self._lock:
                        self._pending[req_id] = pend
                    # one span per route ATTEMPT: a dead replica closes
                    # this one "replica_dead" and the next attempt opens
                    # a sibling — the merged trace shows route -> death
                    # -> resubmit -> serve as four children of the root
                    with _trace.span("fleet.route", rid=rid,
                                     req=req_id) as _rsp:
                        try:
                            self._transport.send_reliable(
                                rid, "infer", meta=meta, arrays=arrays)
                        except ConnectionError:
                            # link to THIS replica is down: eject + next
                            _rsp.finish(status="unreachable")
                            self._eject(rid, "unreachable")
                            with self._lock:
                                self._ledger["resubmitted"] += 1
                            meta["resubmits"] = meta.get("resubmits",
                                                         0) + 1
                            continue
                        # wait in slices so a SIGKILLed replica is
                        # noticed in ~100ms, not after the full timeout
                        deadline = (time.monotonic()
                                    + self._request_timeout_s)
                        got = False
                        while True:
                            if pend.event.wait(0.1):
                                got = True
                                break
                            if not self._handle_alive(rid) \
                                    or time.monotonic() >= deadline:
                                break
                        if not got:
                            if not self._handle_alive(rid):
                                # replica died holding the request: same
                                # id to the next replica — the ledger
                                # entry survives, and so does the TRACE:
                                # the resubmitted frame carries the same
                                # trace id, so the survivor stitches in
                                _rsp.finish(status="replica_dead")
                                self._eject(rid, "dead")
                                with self._lock:
                                    self._ledger["resubmitted"] += 1
                                meta["resubmits"] = meta.get(
                                    "resubmits", 0) + 1
                                continue
                            _rsp.finish(status="timeout")
                            self._finish(req_id, "expired")
                            _root.finish(status="deadline")
                            raise DeadlineExceeded(
                                "fleet: no response for %r from replica "
                                "%d within %.1fs"
                                % (req_id, rid, self._request_timeout_s))
                        _rsp.finish(
                            rid_served=pend.rid if pend.rid is not None
                            else rid)
                    self._observe(pend.rid if pend.rid is not None
                                  else rid, pend)
                    if pend.error is not None:
                        exc = decode_error(pend.error)
                        if (isinstance(exc, QueueFull)
                                and queue_retries < self._submit_retries):
                            with self._lock:
                                self._ledger["retried"] += 1
                                if exc.retry_after_s is not None:
                                    self._ledger["hint_floors"] += 1
                                    self._last_hint = exc.retry_after_s
                            self._submit_backoff.sleep_for(
                                queue_retries,
                                floor_s=exc.retry_after_s or 0.0)
                            queue_retries += 1
                            continue
                        self._finish(req_id, "failed")
                        _root.finish(status=type(exc).__name__)
                        raise exc
                    self._finish(req_id, "served")
                    _root.finish()
                    return [pend.arrays[k] for k in sorted(pend.arrays)]
        finally:
            # catch-all for escapes that bypassed a terminal finish
            # (idempotent: the happy/typed paths already closed it)
            _root.finish(status="aborted")
            with self._lock:
                self._pending.pop(req_id, None)

    def _finish(self, req_id, outcome):
        with self._lock:
            self._ledger[outcome] += 1

    def _handle_alive(self, rid):
        with self._lock:
            h = self._handles.get(rid)
        return h is not None and h.alive()

    # -- response demux -----------------------------------------------------
    def _rx_loop(self):
        while not self._stop.is_set():
            msgs = self._transport.recv_wait(timeout_s=0.1)
            for m in msgs:
                if m.kind != "result":
                    continue
                with self._lock:
                    pend = self._pending.get(m.meta.get("id"))
                    if pend is None or pend.done:
                        # late result from a replica we already gave up
                        # on (resubmitted elsewhere, or expired): the
                        # first terminal outcome won — drop, count
                        self._ledger["duplicates_dropped"] += 1
                        continue
                    pend.done = True
                    pend.rid = m.sender
                    pend.latency_ms = (time.monotonic() - pend.t0) * 1000.0
                if m.meta.get("ok"):
                    pend.arrays = dict(m.arrays)
                else:
                    pend.error = m.meta.get("error") or {}
                pend.event.set()

    # -- health gate --------------------------------------------------------
    def _observe(self, rid, pend):
        """Fold one completed request into the replica's health window
        (latency, failure, non-finite outputs)."""
        with self._lock:
            st = self._health.get(rid)
            if st is None:
                return
            w = st.window
            if pend.error is not None:
                w["failed"] += 1
            else:
                w["served"] += 1
                if any(not np.all(np.isfinite(a))
                       for a in (pend.arrays or {}).values()
                       if np.issubdtype(np.asarray(a).dtype,
                                        np.floating)):
                    w["nonfinite"] += 1
            if pend.latency_ms is not None:
                w["lat"].append(pend.latency_ms)

    def _gate(self, rid, st, fleet_lat):
        """Judge one replica's window with the canary gate: the replica
        is the 'canary', the rest of the fleet the 'baseline'."""
        w = st.window
        if w["served"] + w["failed"] < self._health_min_requests \
                and not w["nonfinite"]:
            return None
        gate = CanaryState(
            "replica-%d" % rid, baseline_version=0, canary_version=1,
            fraction=1.0, min_requests=self._health_min_requests,
            max_error_rate=self._max_error_rate,
            p99_factor=self._p99_factor, timeout_s=0.0,
            baseline_seed_lat=fleet_lat)
        gate.record(1, served=w["served"], failed=w["failed"],
                    latencies=w["lat"], nonfinite=bool(w["nonfinite"]))
        gate.record(0, latencies=fleet_lat)
        verdict = gate.evaluate()
        return verdict

    def _eject(self, rid, reason):
        with self._lock:
            st = self._health.get(rid)
            if st is None or st.status != "healthy":
                return
            st.status = "ejected"
            st.reason = reason
            st.probes = 0
            st.next_probe_s = time.monotonic()
            st.reset_window()
            self._ledger["ejections"] += 1
        _flight.record("replica_ejected", rid=rid, reason=reason)

    def _health_loop(self):
        while not self._stop.wait(self._health_interval_s):
            with self._lock:
                snapshot = list(self._health.items())
                fleet_lat = [v for r, h in snapshot
                             if h.status == "healthy"
                             for v in h.window["lat"][-64:]]
            for rid, st in snapshot:
                if st.status == "healthy":
                    if not self._handle_alive(rid):
                        self._eject(rid, "dead")
                        continue
                    other = [v for r2, h2 in snapshot
                             if r2 != rid and h2.status == "healthy"
                             for v in h2.window["lat"][-64:]]
                    verdict = self._gate(rid, st, other or fleet_lat)
                    if verdict and verdict[0] == "rolled_back":
                        self._eject(rid, verdict[1])
                    elif verdict:
                        with self._lock:
                            st.reset_window()   # healthy: fresh window
                elif st.status == "ejected":
                    self._probe(rid, st)

    def _probe(self, rid, st):
        """One budgeted re-admission probe per health tick once the
        backoff schedule says so; a pong re-admits, an exhausted budget
        marks the replica dead."""
        now = time.monotonic()
        if now < st.next_probe_s:
            return
        if st.probes > self._probe_retries:
            with self._lock:
                st.status = "dead"
            return
        if not self._handle_alive(rid):
            with self._lock:
                st.status = "dead"
                st.reason = st.reason or "dead"
            return
        with self._lock:
            self._req_no += 1
            probe_id = "probe-%d-%06d" % (os.getpid(), self._req_no)
            pend = _Pending()
            self._pending[probe_id] = pend
            st.next_probe_s = now + st.backoff.delay(st.probes)
            st.probes += 1
        try:
            self._transport.send_reliable(rid, "probe",
                                          meta={"id": probe_id})
            if pend.event.wait(self._probe_timeout_s) \
                    and pend.error is None:
                with self._lock:
                    st.status = "healthy"
                    st.reason = None
                    st.reset_window()
                    self._ledger["readmissions"] += 1
                _flight.record("replica_readmitted", rid=rid)
        except ConnectionError:
            pass  # still partitioned; next tick probes again
        finally:
            with self._lock:
                self._pending.pop(probe_id, None)

    # -- observability / shutdown -------------------------------------------
    def stats(self):
        with self._lock:
            out = dict(self._ledger)
            out["last_retry_after_s"] = self._last_hint
        out["transport"] = self._transport.stats()
        out["replicas"] = self.replica_status()
        return out

    def ledger_balanced(self):
        """The exactly-once invariant the chaos soak pins: every
        submitted request reached exactly one terminal outcome."""
        with self._lock:
            led = dict(self._ledger)
        return led["submitted"] == (led["served"] + led["failed"]
                                    + led["expired"])

    def close(self):
        self._stop.set()
        self._rx.join(timeout=5)
        self._health_thread.join(timeout=5)
        if not self.ledger_balanced():
            with self._lock:
                led = dict(self._ledger)
            _flight.incident("ledger_imbalance", scope="fleet", **led)
        with self._lock:
            handles = list(self._handles.values())
        for h in handles:
            try:
                self._transport.send(h.rid, "stop", meta={"id": "stop"})
            except ConnectionError:
                pass
            h.stop()
        self._transport.close()


def _replica_main(argv):
    """``python -m mxnet_tpu_torch.serving.fleet --replica``: build the
    standard linear test model on ``--ctx`` and serve the front door
    until told to stop.  ``MXNET_FAULT_PLAN`` (if set) armed itself at
    import, so the drills' seeded weather reaches this process's
    transport too."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--replica", action="store_true")
    ap.add_argument("--root", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ctx", default="gpu:0")
    args = ap.parse_args(argv)
    from .. import nd, sym
    from ..context import Context
    from .server import ModelServer
    dev_type, _, dev_id = args.ctx.partition(":")
    ctx = Context(dev_type, int(dev_id or 0))
    ctx.torch_device     # raises at once when the card is missing
    data = sym.Variable("data")
    fc = sym.FullyConnected(data, num_hidden=4, name="fc")
    out = sym.softmax(fc, name="prob")
    rng = np.random.RandomState(args.seed)
    params = {"fc_weight": nd.array(rng.randn(4, 6).astype(np.float32),
                                    ctx=ctx),
              "fc_bias": nd.array(rng.randn(4).astype(np.float32),
                                  ctx=ctx)}
    srv = ModelServer(batch_wait_ms=1.0, queue_depth=64,
                      default_timeout_ms=30000.0, ctx=ctx)
    srv.add_model("m", out, params, {}, {"data": (1, 6)})
    transport = SpoolTransport(args.root, args.rank, args.world)
    with srv:
        replica_loop(srv, transport)


if __name__ == "__main__":
    import sys
    _replica_main(sys.argv[1:])
