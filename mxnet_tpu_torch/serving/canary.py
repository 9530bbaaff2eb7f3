"""Canary state for staged version promotion with auto-rollback
(counterpart of ``mxnet_tpu/serving/canary.py``).

Reference: TF-Serving's staged rollout story (arxiv 1605.08695 §4.3 —
"we deploy a new model version alongside the old and shift traffic
gradually") made executable: ``ModelServer.promote_version`` routes a
configured fraction of a model's unversioned traffic to the candidate
version while the registry DEFAULT stays on the baseline, and a health
gate decides full promotion vs automatic rollback.  Because the
default never moves until the gate passes, "rollback" is simply
*stopping the experiment* — no traffic ever depended on the candidate.

The gate (thresholds are ``MXNET_SERVING_CANARY_*`` knobs, overridable
per call):

- **non-finite sentinel** — ANY NaN/Inf in a canary batch's outputs
  rolls back immediately (a poisoned checkpoint fails silently long
  before its error rate moves; drilled by the fault plan's ``nan`` kind
  at the ``serving.canary.execute`` site);
- **error rate** — after ``min_requests`` canary completions, failed /
  completed above ``max_error_rate`` rolls back;
- **p99 vs baseline** — canary p99 latency above ``p99_factor`` × the
  baseline version's p99 (measured over the SAME window; pre-canary
  history seeds the baseline when the window is thin) rolls back;
- **budget** — a canary that cannot gather ``min_requests`` within
  ``timeout_s`` is decided on whatever evidence exists (healthy →
  promote: a traffic-starved model must not pin to stale weights
  forever).

All mutation happens under the owning server's canary lock; this
module holds pure state + the decision function so the gate is unit-
testable without a server.
"""
from __future__ import annotations

import time

__all__ = ["CanaryState"]


class CanaryState:
    """One in-flight staged promotion of ``canary_version`` over
    ``baseline_version`` for model ``name``."""

    __slots__ = ("name", "baseline_version", "canary_version", "fraction",
                 "min_requests", "max_error_rate", "p99_factor",
                 "timeout_s", "started_s", "decided_s", "decision",
                 "reason", "served", "failed", "nonfinite_batches",
                 "canary_lat", "baseline_lat", "baseline_seed", "routed")

    def __init__(self, name, baseline_version, canary_version, fraction,
                 min_requests, max_error_rate, p99_factor, timeout_s,
                 baseline_seed_lat=()):
        self.name = name
        self.baseline_version = int(baseline_version)
        self.canary_version = int(canary_version)
        self.fraction = float(fraction)
        self.min_requests = int(min_requests)
        self.max_error_rate = float(max_error_rate)
        self.p99_factor = float(p99_factor)
        self.timeout_s = float(timeout_s)
        self.started_s = time.monotonic()
        self.decided_s = None
        self.decision = None       # None | "promoted" | "rolled_back"
        self.reason = None
        self.served = 0
        self.failed = 0
        self.nonfinite_batches = 0
        self.routed = 0
        self.canary_lat = []
        self.baseline_lat = []
        # pre-canary history of the baseline version: the p99 gate's
        # FALLBACK only — once the window holds enough live baseline
        # samples the seed is ignored, so a load spike coinciding with
        # canary start raises both sides' p99 together instead of the
        # idle-period seed dragging the baseline down and firing a
        # spurious rollback
        self.baseline_seed = list(baseline_seed_lat)

    # -- evidence (caller holds the server's canary lock) -------------------
    def record(self, version, served=0, failed=0, latencies=(),
               nonfinite=False):
        if version == self.canary_version:
            self.served += served
            self.failed += failed
            self.canary_lat.extend(latencies)
            if nonfinite:
                self.nonfinite_batches += 1
        elif version == self.baseline_version:
            self.baseline_lat.extend(latencies)

    @property
    def completed(self):
        return self.served + self.failed

    def error_rate(self):
        done = self.completed
        return (self.failed / float(done)) if done else 0.0

    @staticmethod
    def _p99(lat):
        if not lat:
            return None
        s = sorted(lat)
        return s[min(len(s) - 1, int(0.99 * len(s)))]

    def evaluate(self, now_s=None):
        """The health gate: returns ``None`` (keep canarying) or the
        terminal ``(decision, reason)`` pair.  Pure — the caller
        applies the decision (set_default / unload) and stamps it via
        :meth:`decide`."""
        if self.decision is not None:
            return self.decision, self.reason
        if self.nonfinite_batches:
            return "rolled_back", "nonfinite_outputs"
        now_s = time.monotonic() if now_s is None else now_s
        timed_out = (now_s - self.started_s) >= self.timeout_s
        if self.completed < self.min_requests and not timed_out:
            return None                      # still gathering evidence
        if self.error_rate() > self.max_error_rate:
            return "rolled_back", "error_rate"
        base = (self.baseline_lat if len(self.baseline_lat) >= 8
                else self.baseline_lat + self.baseline_seed)
        c_p99, b_p99 = self._p99(self.canary_lat), self._p99(base)
        if c_p99 is not None and b_p99 is not None \
                and c_p99 > self.p99_factor * b_p99:
            return "rolled_back", "p99_vs_baseline"
        if self.completed == 0 and timed_out:
            # zero evidence either way: keep the experiment open is
            # wrong (stale weights forever) and promoting blind is
            # wrong — roll back, the watcher will stage the NEXT
            # committed version
            return "rolled_back", "no_traffic"
        return "promoted", "timeout_healthy" if timed_out else "healthy"

    def decide(self, decision, reason):
        self.decision = decision
        self.reason = reason
        self.decided_s = time.monotonic()

    def describe(self):
        """The stats()/bench evidence row."""
        return {
            "baseline_version": self.baseline_version,
            "canary_version": self.canary_version,
            "fraction": self.fraction,
            "routed": self.routed,
            "served": self.served,
            "failed": self.failed,
            "error_rate": round(self.error_rate(), 4),
            "nonfinite_batches": self.nonfinite_batches,
            "canary_p99_ms": self._p99(self.canary_lat),
            "baseline_p99_ms": self._p99(
                self.baseline_lat if len(self.baseline_lat) >= 8
                else self.baseline_lat + self.baseline_seed),
            "decision": self.decision,
            "reason": self.reason,
            "decision_latency_s": (
                round(self.decided_s - self.started_s, 4)
                if self.decided_s is not None else None),
        }
