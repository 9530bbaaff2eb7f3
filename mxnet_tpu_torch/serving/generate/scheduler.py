"""DecodeScheduler — continuous batching over a fixed slot pool.

Counterpart of ``mxnet_tpu/serving/generate/scheduler.py``.  The
scheduling unit is the decode STEP, not the request: every loop
iteration (one thread per generative model, beside the server's single
batcher) admits waiting prompts into free slots, runs ONE fixed-shape
decode step over the whole pool on the model's device, and retires slots
whose generations hit EOS / their token budget / their deadline — so a
512-token generation occupies one lane for 512 steps while 16-token
requests flow through the other lanes beside it (no convoy).

SLO integration, the server's vocabulary:

- priority classes (``MXNET_SERVING_PRIORITY_CLASSES``) order both
  queue admission into slots and brownout shedding;
- per-tenant SLOT quotas join the queue/inflight/cache quotas: a
  tenant at its slot cap waits even when slots are free;
- brownout is PREDICTIVE, priced in tokens: estimated drain time =
  (remaining tokens in flight + tokens requested by the queue) x the
  live per-token median.  Past ``MXNET_SERVING_GEN_BROWNOUT_MS`` the
  scheduler sheds queued requests of class >=
  ``MXNET_SERVING_BROWNOUT_REJECT_CLASS`` (hysteresis: exits at half
  the budget);
- the exactly-once ledger is per tenant: ``submitted == served +
  failed + expired + shed`` at every instant a request is terminal,
  enforced by ``TokenStream.finish``'s first-call-wins transition.

Fault drill: ``serving.decode.step`` fires once per ACTIVE slot per
step (ctx: model, slot, tenant) between computing the step and
committing its tokens.  A raise poisons exactly that slot — its stream
fails, its slot frees, its cursor never advances — while every other
slot's token commits the same step.

Device traffic: a prefill's K/V histories stay on the device and are
admitted in place; only the first tokens and each step's next tokens
cross to the host, because the streams need them.
"""
from __future__ import annotations

import statistics
import threading
import time
from collections import deque

import numpy as np

from ... import telemetry
from ...fault import hooks as _fault
from ...telemetry import tracing as _trace
from ..bucketing import pick_bucket
from ..errors import BadRequest, DeadlineExceeded, QueueFull, ServerClosed
from .stream import TokenStream

__all__ = ["DecodeScheduler"]


class DecodeScheduler:
    """Per-model continuous-batching decode loop."""

    def __init__(self, model, exec_cache, slots=None, queue_depth=None,
                 brownout_ms=None):
        from ... import config as _cfg
        self.model = model
        self.cache = exec_cache
        self.slots = int(slots if slots is not None
                         else _cfg.get("MXNET_SERVING_GEN_SLOTS"))
        self.queue_depth = int(
            queue_depth if queue_depth is not None
            else _cfg.get("MXNET_SERVING_GEN_QUEUE_DEPTH"))
        self.default_new_tokens = int(
            _cfg.tuned("MXNET_SERVING_GEN_MAX_NEW_TOKENS"))
        self.brownout_ms = float(
            brownout_ms if brownout_ms is not None
            else _cfg.get("MXNET_SERVING_GEN_BROWNOUT_MS"))
        self._classes = max(1, int(
            _cfg.get("MXNET_SERVING_PRIORITY_CLASSES")))
        self._default_priority = min(self._classes - 1, max(0, int(
            _cfg.get("MXNET_SERVING_DEFAULT_PRIORITY"))))
        self._reject_class = int(
            _cfg.get("MXNET_SERVING_BROWNOUT_REJECT_CLASS"))
        self._default_slot_quota = int(
            _cfg.get("MXNET_SERVING_GEN_SLOT_QUOTA"))
        self.state = model.make_state(self.slots)
        # re-entrant: a caller may hold it across several submits so the
        # loop admits them together
        self._cv = threading.Condition(threading.RLock())
        self._pending = []        # guarded-by: _cv — [(stream, prompt)]
        self._slot_meta = {}      # guarded-by: _cv — slot -> meta dict
        self._ledger = {}         # guarded-by: _cv — tenant -> counts
        self._slot_quotas = {}    # guarded-by: _cv — tenant -> slots
        self._brownout = False    # guarded-by: _cv
        self._sheds = 0           # guarded-by: _cv
        self._rejected_full = 0   # guarded-by: _cv
        self._steps = 0           # guarded-by: _cv
        self._closed = False      # guarded-by: _cv
        self._thread = None       # guarded-by: _cv
        # producer-thread-only: recent per-token step costs (seconds)
        self._token_costs = deque(maxlen=512)
        self._t_ttft = telemetry.histogram(
            "mxnet_serving_ttft_seconds",
            "submit -> first streamed token (queueing + prefill)",
            buckets=telemetry.exponential_buckets(0.001, 2, 14))
        self._t_per_token = telemetry.histogram(
            "mxnet_serving_per_token_seconds",
            "decode-step cost per committed token",
            buckets=telemetry.exponential_buckets(0.0005, 2, 13))
        self._t_slots = telemetry.gauge(
            "mxnet_serving_decode_slots",
            "decode slot pool occupancy by state (busy|free)")
        self._publish_slots_locked()

    # -- admission ---------------------------------------------------

    def set_slot_quota(self, tenant, slots):
        """Cap concurrent decode slots for ``tenant`` (None / <= 0
        clears back to the MXNET_SERVING_GEN_SLOT_QUOTA default)."""
        with self._cv:
            if slots is None or int(slots) <= 0:
                self._slot_quotas.pop(tenant, None)
            else:
                self._slot_quotas[tenant] = int(slots)

    def submit(self, prompt, max_new_tokens=None, priority=None,
               tenant="default", timeout_ms=None):
        """Queue one generation; returns its :class:`TokenStream`."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise BadRequest("empty prompt")
        if prompt.size > self.model.max_len:
            raise BadRequest(
                "prompt of %d tokens exceeds the %d-token KV window"
                % (prompt.size, self.model.max_len))
        if max_new_tokens is None:
            max_new_tokens = self.default_new_tokens
        if int(max_new_tokens) < 1:
            raise BadRequest("max_new_tokens must be >= 1")
        if priority is None:
            priority = self._default_priority
        priority = min(self._classes - 1, max(0, int(priority)))
        deadline = (time.monotonic() + float(timeout_ms) / 1000.0
                    if timeout_ms is not None else None)
        stream = TokenStream(self.model.name, tenant, priority,
                             max_new_tokens, deadline=deadline)
        if _trace.ACTIVE[0]:
            ctx = _trace.current() or _trace.mint(
                model=self.model.name, tenant=tenant)
            root = _trace.start_span(
                "gen.request", ctx=ctx, model=self.model.name,
                tenant=tenant, priority=int(priority),
                max_new_tokens=int(max_new_tokens))
            stream._span = root
            stream.trace = root.ctx
        with self._cv:
            if self._closed:
                if stream._span is not None:
                    stream._span.finish(status="closed")
                raise ServerClosed("scheduler for %r is stopped"
                                   % self.model.name)
            if len(self._pending) >= self.queue_depth:
                self._rejected_full += 1
                if stream._span is not None:
                    stream._span.finish(status="rejected_queue_full")
                raise QueueFull(
                    "generative queue for %r full (%d pending)"
                    % (self.model.name, len(self._pending)),
                    retry_after_s=self._retry_after_locked())
            led = self._ledger_locked(tenant)
            led["submitted"] += 1
            if self._brownout and priority >= self._reject_class:
                # shed at the door: a request that never started costs
                # zero decode steps — the cheapest possible shed
                led["shed"] += 1
                self._sheds += 1
                stream.finish("shed", QueueFull(
                    "brownout: class %d shed by %r"
                    % (priority, self.model.name),
                    retry_after_s=self._retry_after_locked()))
                return stream
            self._pending.append((stream, prompt))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="mxnet-gen-decode-%s" % self.model.name)
                self._thread.start()
            self._cv.notify_all()
        return stream

    def _ledger_locked(self, tenant):
        led = self._ledger.get(tenant)
        if led is None:
            led = {"submitted": 0, "served": 0, "failed": 0,
                   "expired": 0, "shed": 0}
            self._ledger[tenant] = led
        return led

    def _retry_after_locked(self):
        med = self._median_token_cost()
        backlog = len(self._pending) + len(self._slot_meta)
        est = med * self.default_new_tokens * backlog / max(1, self.slots)
        return max(0.01, min(est, 30.0))

    def _median_token_cost(self):
        if not self._token_costs:
            return 0.005
        return statistics.median(self._token_costs)

    # -- the decode loop ---------------------------------------------

    def _run(self):
        while True:
            with self._cv:
                if self._closed:
                    return
                now = time.monotonic()
                self._expire_locked(now)
                self._update_brownout_locked()
                batch = self._pick_admissions_locked()
                stepping = bool(self._slot_meta)
                if not batch and not stepping:
                    self._cv.wait(timeout=0.05)
                    continue
            if batch:
                self._do_prefill(batch)
            if stepping:
                self._do_step()

    def _expire_locked(self, now):
        keep = []
        for stream, prompt in self._pending:
            if stream.deadline is not None and now > stream.deadline:
                self._finish_locked(stream, "expired", DeadlineExceeded(
                    "generation expired before admission"))
            else:
                keep.append((stream, prompt))
        self._pending = keep
        for slot in list(self._slot_meta):
            meta = self._slot_meta[slot]
            s = meta["stream"]
            if s.deadline is not None and now > s.deadline:
                self._finish_locked(s, "expired", DeadlineExceeded(
                    "generation expired after %d tokens" % s.n_tokens))
                self._release_locked(slot)

    def _update_brownout_locked(self):
        if self.brownout_ms <= 0:
            return
        med = self._median_token_cost()
        remaining = sum(
            m["stream"].max_new_tokens - self.state.n_generated(
                s, m["prompt_len"]) - 1
            for s, m in self._slot_meta.items())
        queued = sum(s.max_new_tokens for s, _ in self._pending)
        drain_ms = (max(0, remaining) + queued) * med * 1000.0 \
            / max(1, self.slots)
        if not self._brownout and drain_ms > self.brownout_ms:
            self._brownout = True
        elif self._brownout and drain_ms < self.brownout_ms / 2.0:
            self._brownout = False
        if self._brownout:
            keep = []
            for stream, prompt in self._pending:
                if stream.priority >= self._reject_class:
                    led = self._finish_locked(stream, "shed", QueueFull(
                        "brownout: predicted drain %.0fms over the "
                        "%.0fms budget" % (drain_ms, self.brownout_ms),
                        retry_after_s=self._retry_after_locked()))
                    if led:
                        self._sheds += 1
                else:
                    keep.append((stream, prompt))
            self._pending = keep

    def _tenant_slots_locked(self, tenant):
        return sum(1 for m in self._slot_meta.values()
                   if m["stream"].tenant == tenant)

    def _pick_admissions_locked(self):
        """Choose this iteration's prefill batch: highest class first
        (stable FIFO within a class), all sharing ONE length rung so
        the batch fits a single grid cell, capped by free slots, the
        batch ladder, and each tenant's slot quota."""
        free = self.state.free_slots()
        if not free or not self._pending:
            return None
        order = sorted(range(len(self._pending)),
                       key=lambda i: (self._pending[i][0].priority, i))
        max_b = self.model.batch_ladder[-1]
        picked, rung = [], None
        quota_used = {}
        for i in order:
            stream, prompt = self._pending[i]
            t = pick_bucket(prompt.size, self.model.len_ladder)
            if rung is None:
                rung = t
            elif t != rung:
                continue
            tenant = stream.tenant
            quota = self._slot_quotas.get(
                tenant, self._default_slot_quota)
            if quota and quota > 0:
                used = (self._tenant_slots_locked(tenant)
                        + quota_used.get(tenant, 0))
                if used >= quota:
                    continue
            quota_used[tenant] = quota_used.get(tenant, 0) + 1
            picked.append(i)
            if len(picked) >= min(len(free), max_b):
                break
        if not picked:
            return None
        batch = [self._pending[i] for i in picked]
        for i in sorted(picked, reverse=True):
            del self._pending[i]
        slots = free[:len(batch)]
        return {"rung": rung, "batch": batch, "slots": slots}

    def _do_prefill(self, adm):
        """Prefill the admitted prompts (one grid cell) and seat them
        in their slots.  Runs OUTSIDE the lock — a cold cell binds
        here."""
        batch, slots, rung = adm["batch"], adm["slots"], adm["rung"]
        b_rung = pick_bucket(len(batch), self.model.batch_ladder)
        cell = (b_rung, rung)
        toks = np.zeros((b_rung, rung), np.int32)
        lens = np.ones(b_rung, np.int32)
        for row, (stream, prompt) in enumerate(batch):
            toks[row, :prompt.size] = prompt
            lens[row] = prompt.size
        try:
            first, k_hist, v_hist = self.model.prefill(
                self.cache, cell, toks, lens)
            # the histories stay on the device; the first tokens cross
            first = first.cpu().numpy()
        except Exception as exc:
            # a poisoned prefill (fault drill / OOM) fails only the
            # batch that needed it; slots stay free, the loop goes on
            with self._cv:
                for stream, _ in batch:
                    self._finish_locked(stream, "failed", exc)
                self._cv.notify_all()
            return
        with self._cv:
            for row, (stream, prompt) in enumerate(batch):
                slot = slots[row]
                self.model.admit(self.state, slot, k_hist[:, row],
                                 v_hist[:, row])
                self.state.occupy(slot, prompt.size, first[row])
                meta = {"stream": stream, "prompt_len": prompt.size}
                if _trace.ACTIVE[0] and stream.trace is not None:
                    # one span per slot-occupancy epoch, not per token
                    meta["span"] = _trace.start_span(
                        "gen.occupy", ctx=stream.trace, slot=int(slot),
                        tenant=stream.tenant)
                self._slot_meta[slot] = meta
                stream.put(first[row])
                if stream.ttft_s is not None:
                    self._t_ttft.observe(stream.ttft_s)
                    self._t_ttft.labels(
                        model=self.model.name).observe(stream.ttft_s)
                self._retire_if_done_locked(slot, first[row])
            self._publish_slots_locked()
            self._cv.notify_all()

    def _do_step(self):
        """ONE decode step over the whole pool, then commit per slot —
        the fault site sits between compute and commit so a poisoned
        slot's token is simply never committed."""
        with _trace.span("gen.decode_step",
                         model=self.model.name) as _sp:
            t0 = time.perf_counter()
            nxt = self.model.decode_step(self.state)
            dt = time.perf_counter() - t0
            with self._cv:
                self._steps += 1
                active = [s for s in list(self._slot_meta)
                          if self.state.active[s]]
                _sp.tag(active=len(active))
                per_tok = dt / max(1, len(active))
                for slot in active:
                    meta = self._slot_meta[slot]
                    stream = meta["stream"]
                    if _fault.ACTIVE[0]:
                        try:
                            _fault.fire("serving.decode.step",
                                        model=self.model.name,
                                        slot=slot,
                                        tenant=stream.tenant)
                        except Exception as exc:
                            self._finish_locked(stream, "failed", exc)
                            self._release_locked(slot)
                            continue
                    tok = int(nxt[slot])
                    self.state.advance(slot, tok)
                    stream.put(tok)
                    self._token_costs.append(per_tok)
                    self._t_per_token.observe(per_tok)
                    self._t_per_token.labels(
                        model=self.model.name).observe(per_tok)
                    self._retire_if_done_locked(slot, tok)
                self._publish_slots_locked()
                self._cv.notify_all()

    def _retire_if_done_locked(self, slot, last_token):
        meta = self._slot_meta.get(slot)
        if meta is None:
            return
        stream = meta["stream"]
        eos = (self.model.eos_id is not None
               and int(last_token) == int(self.model.eos_id))
        if eos or stream.n_tokens >= stream.max_new_tokens:
            self._finish_locked(stream, "served")
            self._release_locked(slot)

    def _finish_locked(self, stream, outcome, error=None):
        if stream.finish(outcome, error):
            self._ledger_locked(stream.tenant)[outcome] += 1
            return True
        return False

    def _release_locked(self, slot):
        self.state.release(slot)
        meta = self._slot_meta.pop(slot, None)
        if meta is not None:
            span = meta.get("span")
            if span is not None:
                span.finish(tokens=meta["stream"].n_tokens)
        self._publish_slots_locked()

    def _publish_slots_locked(self):
        busy = len(self._slot_meta)
        self._t_slots.labels(model=self.model.name,
                             state="busy").set(busy)
        self._t_slots.labels(model=self.model.name,
                             state="free").set(self.slots - busy)

    # -- lifecycle + introspection -----------------------------------

    def warmup(self, grid=None):
        """Bind and run the working set before traffic (delegates to the
        model so prefill cells land in the executor cache/manifest; the
        live slots are left alone, see ``GenerativeModel.warmup``)."""
        return self.model.warmup(self.cache, self.state, grid=grid)

    def stop(self, drain=True, timeout=30.0):
        with self._cv:
            self._closed = True
            thread = self._thread
            self._cv.notify_all()
        if thread is not None:
            thread.join(timeout=timeout)
        with self._cv:
            err = ServerClosed("scheduler for %r stopped"
                               % self.model.name)
            for stream, _ in self._pending:
                self._finish_locked(stream, "failed", err)
            self._pending = []
            for slot in list(self._slot_meta):
                self._finish_locked(self._slot_meta[slot]["stream"],
                                    "failed", err)
                self._release_locked(slot)

    def ledgers(self):
        with self._cv:
            return {t: dict(c) for t, c in sorted(self._ledger.items())}

    def stats(self):
        with self._cv:
            busy = len(self._slot_meta)
            return {
                "slots": self.slots,
                "busy": busy,
                "free": self.slots - busy,
                "pending": len(self._pending),
                "steps": self._steps,
                "brownout": self._brownout,
                "sheds": self._sheds,
                "rejected_queue_full": self._rejected_full,
                "per_token_median_s": self._median_token_cost(),
                "ledgers": {t: dict(c)
                            for t, c in sorted(self._ledger.items())},
                "compiles": self.model.compile_stats(),
            }
