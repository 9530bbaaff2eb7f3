"""FaultPlan — deterministic, site/step-addressed fault schedules
(counterpart of ``mxnet_tpu/fault/plan.py``; the same plan JSON drives
the same sites in the same order in both packages).

Reference precedent: the fault-tolerance drills of the TensorFlow paper
(arxiv 1605.08695 §4.3 — checkpoint + re-execution on worker loss is a
*designed-for* path, so it must be executable on demand) and the
reference parameter server's assumption that workers die
(arxiv 1512.01274).  A fault path that is never driven is a fault path
that does not work; this module makes every "can't happen often"
branch in the tree happen exactly when a test says so.

A plan is a seeded schedule over NAMED INJECTION SITES — stable strings
threaded through the layers that must degrade gracefully (catalog in
``docs/faq/fault_tolerance.md``)::

    {"seed": 0,
     "rules": [
       {"site": "checkpoint.store.commit", "kind": "io_error",
        "after": 1, "every": 2, "times": 3},
       {"site": "elastic.step", "kind": "sigterm", "step": 7},
       {"site": "atomic_io.commit", "kind": "torn_write", "times": 1}]}

Rule vocabulary (unknown keys are a loud ``ValueError`` — a typoed
schedule must not silently drill nothing):

- ``site``: fnmatch pattern over site names (``"kvstore.*"``);
- ``kind``: one of ``raise`` / ``io_error`` / ``enospc`` /
  ``torn_write`` / ``delay`` / ``sigterm`` / ``sigkill`` / ``exit``;
- ``after``/``every``/``times``: fire on hits ``after+1``,
  ``after+1+every``, ... at this site, at most ``times`` times
  (``times: 0`` = unlimited);
- ``step``: only while the driving loop's published step
  (``hooks.set_step``) equals this value — the step-addressed form the
  elastic drill uses to kill at an exact batch;
- ``p``: probability per otherwise-matching hit, drawn from a PER-RULE
  ``random.Random(seed, index)`` chain — pseudo-random but exactly
  reproducible given the plan (chaos-soak mode);
- ``where``: dict of fnmatch patterns over the site's ``ctx`` kwargs
  (``{"model": "tenantA"}``) — the multi-tenant form: one tenant's
  site hits match, everyone else's pass through untouched.  A ctx key
  the site never publishes simply never matches (loudness lives in the
  site catalog, not the rule);
- ``exc`` (kind=raise): exception class name from :data:`EXC_NAMES`;
- ``delay_s`` (kind=delay), ``code`` (kind=exit), ``message``.

``kind=nan`` corrupts the float arrays a site passes as
``ctx["arrays"]`` in place (non-float payloads are left untouched) —
the poisoned-canary drill: a model version that silently emits
non-finite outputs, which the serving health gate must catch.

Network-shaped kinds (the multi-host drills — sites live in
``parallel/transport.py``, addressable per (site, peer) via ``where``
on the ``peer`` ctx key):

- ``partition`` — ``ConnectionError`` at the site.  At a PRE-delivery
  site (``transport.send``) the message is dropped on the floor: the
  link is down.
- ``slow_link`` — sleeps ``delay_s``: a congested or lossy-and-
  retransmitting link, latency without loss.
- ``lost_ack`` — ``ConnectionError`` raised at a POST-delivery site
  (``transport.send.ack``): the message LANDED but the sender believes
  it failed, so an at-least-once sender retries and the receiver's
  dedup must absorb the duplicate — the exactly-once drill.
- ``reorder`` — raises :class:`Reorder`, a control-flow signal (not an
  error) the transport catches to hold the message back and deliver it
  AFTER the next one: a genuine adjacent swap, not just jitter.

Determinism contract: with the same plan, the same sequence of site
hits and the same published steps, exactly the same faults fire.
``FaultPlan(spec, trace=True)`` records the live hit sequence and
:meth:`FaultPlan.replay` re-runs it through a fresh plan of the same
spec — the witness that a chaos soak's fault timeline is a pure
function of (plan, hit sequence), replayable from the seed.
"""
from __future__ import annotations

import errno
import fnmatch
import json
import os
import random
import signal
import threading
import time

from . import hooks

__all__ = ["FaultInjected", "Reorder", "FaultPlan", "install",
           "uninstall", "installed", "active_plan", "backoff_seed",
           "KINDS", "EXC_NAMES"]

KINDS = ("raise", "io_error", "enospc", "torn_write", "delay",
         "sigterm", "sigkill", "exit", "nan",
         "partition", "slow_link", "lost_ack", "reorder")

_RULE_KEYS = frozenset(("site", "kind", "after", "every", "times", "step",
                        "p", "exc", "delay_s", "code", "message", "where"))


class FaultInjected(Exception):
    """The default injected failure (kind=raise with no ``exc``).

    Deliberately NOT an ``MXNetError``: an injected fault should
    exercise the same broad recovery paths a real infrastructure error
    would, and sites that catch narrow framework errors must not
    accidentally swallow it unless the drill asked them to (pick
    ``exc`` for that)."""


class Reorder(Exception):
    """Control-flow signal of ``kind=reorder`` — NOT a failure.  A
    transport send site that sees this must hold the message back and
    deliver it after the next one (an adjacent swap).  Deliberately a
    bare ``Exception``: nothing classifies it as recoverable weather,
    so a site that forgets to catch it fails a drill loudly instead of
    silently converting reordering into retries."""


def _exc_names():
    """Name -> class for kind=raise.  ``IntegrityError`` resolves
    lazily: checkpoint.store imports this package's hooks, so a
    module-level import here would cycle."""
    from ..base import MXNetError
    from ..checkpoint.store import IntegrityError
    return {
        "FaultInjected": FaultInjected,
        "OSError": OSError,
        "IOError": OSError,
        "RuntimeError": RuntimeError,
        "ValueError": ValueError,
        "TimeoutError": TimeoutError,
        "ConnectionError": ConnectionError,
        "MXNetError": MXNetError,
        "IntegrityError": IntegrityError,
    }


EXC_NAMES = ("FaultInjected", "OSError", "IOError", "RuntimeError",
             "ValueError", "TimeoutError", "ConnectionError", "MXNetError",
             "IntegrityError")


class _Rule:
    __slots__ = ("site", "kind", "after", "every", "times", "step", "p",
                 "exc", "delay_s", "code", "message", "where", "fired",
                 "rng", "index")

    def __init__(self, spec, index, seed):
        unknown = set(spec) - _RULE_KEYS
        if unknown:
            raise ValueError("fault rule %d has unknown key(s) %s"
                             % (index, sorted(unknown)))
        if "site" not in spec:
            raise ValueError("fault rule %d needs a 'site'" % index)
        self.site = str(spec["site"])
        self.kind = str(spec.get("kind", "raise"))
        if self.kind not in KINDS:
            raise ValueError("fault rule %d kind %r is not one of %s"
                             % (index, self.kind, list(KINDS)))
        self.after = int(spec.get("after", 0))
        self.every = max(1, int(spec.get("every", 1)))
        self.times = int(spec.get("times", 1))
        self.step = (int(spec["step"])
                     if spec.get("step") is not None else None)
        self.p = float(spec.get("p", 1.0))
        self.exc = str(spec.get("exc", "FaultInjected"))
        if self.kind == "raise" and self.exc not in EXC_NAMES:
            raise ValueError("fault rule %d exc %r is not one of %s"
                             % (index, self.exc, list(EXC_NAMES)))
        self.delay_s = float(spec.get("delay_s", 0.05))
        self.code = int(spec.get("code", 137))
        self.message = spec.get("message") or ""
        where = spec.get("where") or {}
        if not isinstance(where, dict):
            raise ValueError("fault rule %d 'where' must be a dict of "
                             "ctx-key -> fnmatch pattern, got %r"
                             % (index, where))
        self.where = {str(k): str(v) for k, v in where.items()}
        self.index = index
        self.fired = 0
        # per-rule chain: reproducible regardless of how many OTHER
        # rules consumed randomness (str seed: stable across processes,
        # unlike tuple-hash seeding)
        self.rng = random.Random("%d:%d" % (seed, index))

    def wants(self, site, hit_no, step, ctx):
        """Deterministic match verdict for hit ``hit_no`` (1-based) of
        ``site``.  Consumes this rule's RNG only on otherwise-matching
        hits, so the draw sequence is a pure function of the hit (and
        ctx) sequence."""
        if not fnmatch.fnmatchcase(site, self.site):
            return False
        if self.step is not None and step != self.step:
            return False
        for k, pat in self.where.items():
            v = ctx.get(k)
            if v is None or not fnmatch.fnmatchcase(str(v), pat):
                return False
        k = hit_no - self.after
        if k <= 0 or (k - 1) % self.every:
            return False
        if self.times and self.fired >= self.times:
            return False
        if self.p < 1.0 and self.rng.random() >= self.p:
            return False
        return True

    def describe(self):
        return {"site": self.site, "kind": self.kind, "fired": self.fired}


class FaultPlan:
    """A parsed, armed-able fault schedule (see module docstring)."""

    def __init__(self, spec, trace=False):
        if isinstance(spec, str):
            spec = json.loads(spec)
        spec = dict(spec or {})
        unknown = set(spec) - {"seed", "rules"}
        if unknown:
            raise ValueError("fault plan has unknown key(s) %s"
                             % sorted(unknown))
        self.seed = int(spec.get("seed", 0))
        self._spec = {"seed": self.seed,
                      "rules": [dict(r) for r in spec.get("rules", [])]}
        self._rules = [_Rule(r, i, self.seed)
                       for i, r in enumerate(self._spec["rules"])]
        self._lock = threading.Lock()
        self._hits = {}       # guarded-by: _lock — site -> hit count
        self._injected = []   # guarded-by: _lock — (site, kind, rule idx)
        self._backoff_seq = 0  # guarded-by: _lock — BackoffPolicy chain
        # hit trace (drills): (site, step, str-projected ctx) per fire,
        # in decision order — the replay witness's input
        self._trace = [] if trace else None

    @classmethod
    def from_env(cls):
        """Parse ``MXNET_FAULT_PLAN``: inline JSON, or ``@/path`` to a
        JSON file; None when the knob is unset/empty."""
        from .. import config as _config
        raw = _config.get("MXNET_FAULT_PLAN")
        if not raw:
            return None
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        # env-armed processes are DRILLED processes: always carry the
        # hit trace so a surviving worker can report the replay witness
        # (plan.replay() == stats()["injected"]) before it exits
        return cls(raw, trace=True)

    # -- the hot entry (bound to hooks.fire while installed) -----------------
    def fire(self, site, **ctx):
        """One site hit: decide under the lock, ACT outside it — an
        action may sleep, raise, or kill the process, and must never do
        so while holding plan state."""
        step = hooks.STEP[0]
        with self._lock:
            actions = self._decide_locked(site, step, ctx)
        for rule in actions:
            self._count(site, rule.kind)
            self._record(site, rule, ctx)
            self._act(rule, site, ctx)

    def _decide_locked(self, site, step, ctx):
        """The pure decision half of :meth:`fire` (caller holds
        ``_lock``): count the hit, match rules, log injections, record
        the trace.  Shared verbatim by the live path and
        :meth:`replay` so the witness replays the real logic, not a
        reimplementation."""
        n = self._hits.get(site, 0) + 1
        self._hits[site] = n
        if self._trace is not None:
            self._trace.append(
                (site, step,
                 {k: str(v) for k, v in ctx.items()
                  if isinstance(v, (str, int, float, bool))}))
        actions = []
        for rule in self._rules:
            if rule.wants(site, n, step, ctx):
                rule.fired += 1
                self._injected.append((site, rule.kind, rule.index))
                actions.append(rule)
        return actions

    @staticmethod
    def _count(site, kind):
        from .. import telemetry
        telemetry.counter(
            "mxnet_fault_injected_total",
            "faults injected by the armed MXNET_FAULT_PLAN, by site "
            "and kind (docs/faq/fault_tolerance.md)"
        ).labels(site=site, kind=kind).inc()

    @staticmethod
    def _record(site, rule, ctx):
        """Anomaly breadcrumbs BEFORE acting: a kill-kind action never
        returns, and the marked trace + flight-recorder event are what
        the post-mortem reads (lazy import — fault must stay importable
        below telemetry)."""
        from ..telemetry import flight, tracing
        if not tracing.ACTIVE[0]:
            return
        tracing.mark("fault_injected")
        fields = {k: str(v) for k, v in ctx.items()
                  if isinstance(v, (str, int, float, bool))}
        # explicit keys win over same-named fire-context keys (a
        # where-matcher like kind="infer" rides in ctx)
        fields.update(site=site, fault_kind=rule.kind, rule=rule.index)
        flight.record("fault", **fields)

    def _act(self, rule, site, ctx):
        tag = rule.message or (
            "graftfault: injected %s at site %r (rule %d)"
            % (rule.kind, site, rule.index))
        if rule.kind in ("delay", "slow_link"):
            time.sleep(rule.delay_s)
            return
        if rule.kind in ("partition", "lost_ack"):
            # the site's placement carries the semantics: pre-delivery
            # (transport.send) drops the message, post-delivery
            # (transport.send.ack) makes the sender retry a LANDED one
            peer = ctx.get("peer")
            raise ConnectionError(
                tag + (" (peer %s)" % peer if peer is not None else ""))
        if rule.kind == "reorder":
            raise Reorder(tag)
        if rule.kind == "nan":
            # corrupt the site's float payload in place — silent bad
            # outputs, the failure mode a health gate's non-finite
            # sentinel (not an exception handler) must catch
            for a in ctx.get("arrays") or ():
                dt = getattr(a, "dtype", None)
                if dt is not None and getattr(dt, "kind", "") == "f":
                    a[...] = float("nan")
            return
        if rule.kind == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
            return   # delivery is async; the site continues to its poll
        if rule.kind == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)   # never returns
            return   # pragma: no cover
        if rule.kind == "exit":
            os._exit(rule.code)   # hard death, no cleanup — by design
        if rule.kind == "torn_write":
            f = ctx.get("file")
            if f is not None and not f.closed:
                # leave a half-written temp file behind, then fail the
                # write exactly as a full disk / yanked mount would —
                # the commit protocol under test must keep the partial
                # file invisible at the final name
                f.flush()
                size = f.tell()
                f.truncate(max(size // 2, 0))
            raise OSError(errno.EIO, tag)
        if rule.kind == "io_error":
            raise OSError(errno.EIO, tag)
        if rule.kind == "enospc":
            raise OSError(errno.ENOSPC, tag)
        exc_cls = _exc_names()[rule.exc]
        if issubclass(exc_cls, OSError):
            raise exc_cls(errno.EIO, tag)
        raise exc_cls(tag)

    # -- introspection -------------------------------------------------------
    def stats(self):
        """Site hit counts + every injection performed, in order — the
        drill's proof that the schedule actually fired."""
        with self._lock:
            return {
                "hits": dict(self._hits),
                "injected": [{"site": s, "kind": k, "rule": i}
                             for s, k, i in self._injected],
                "rules": [r.describe() for r in self._rules],
            }

    def injected_count(self, site=None, kind=None):
        with self._lock:
            return sum(1 for s, k, _i in self._injected
                       if (site is None or fnmatch.fnmatchcase(s, site))
                       and (kind is None or k == kind))

    def trace(self):
        """The recorded hit sequence (``trace=True`` plans only):
        ``[(site, step, ctx), ...]`` in decision order."""
        with self._lock:
            return list(self._trace or ())

    def replay(self, trace=None):
        """Re-run a hit trace through a FRESH plan of the same spec and
        return its injected log — the determinism witness: a live soak's
        thread timing decides WHICH hits happen in what order, but given
        that hit sequence the fault timeline is a pure function of the
        plan, so ``plan.replay() == plan.stats()["injected"]`` must hold
        exactly.  (Traced ctx is str-projected; ``where`` matching strs
        its operands anyway, so decisions replay faithfully.)"""
        if trace is None:
            trace = self.trace()
        fresh = FaultPlan(self._spec)
        for site, step, ctx in trace:
            with fresh._lock:
                fresh._decide_locked(site, step, ctx)
        return fresh.stats()["injected"]

    def next_backoff_seed(self):
        """Per-plan seed chain for :class:`~.backoff.BackoffPolicy`
        instances created while this plan is armed: the Nth policy of a
        replayed drill gets the same jitter stream both times (same
        ``"seed:backoff:index"`` idiom as the per-rule ``p`` chains)."""
        with self._lock:
            self._backoff_seq += 1
            return "%d:backoff:%d" % (self.seed, self._backoff_seq)


# ---------------------------------------------------------------------------
# arming
# ---------------------------------------------------------------------------
_STATE = {"plan": None}   # guarded-by: _STATE_LOCK
_STATE_LOCK = threading.Lock()


def install(plan=None):
    """Arm ``plan`` (default: parse ``MXNET_FAULT_PLAN``) process-wide:
    every instrumented site starts consulting it.  Returns the armed
    plan, or None when there was nothing to arm."""
    if plan is None:
        plan = FaultPlan.from_env()
    with _STATE_LOCK:
        if plan is None:
            return None
        _STATE["plan"] = plan
        hooks.fire = plan.fire
        hooks.ACTIVE[0] = True
        return plan


def uninstall():
    """Disarm: sites go back to the one-boolean fast path."""
    with _STATE_LOCK:
        hooks.ACTIVE[0] = False
        hooks.fire = lambda site, **ctx: None
        hooks.STEP[0] = -1
        _STATE["plan"] = None


def installed():
    """The armed plan, or None."""
    with _STATE_LOCK:
        return _STATE["plan"]


def backoff_seed():
    """Default seed for a :class:`~.backoff.BackoffPolicy` created with
    no explicit seed: the armed plan's per-policy chain (so two replays
    of one seeded plan produce identical drill timelines), or 0 when no
    plan is armed (the historical default)."""
    plan = installed()
    return plan.next_backoff_seed() if plan is not None else 0


class active_plan:
    """Context manager arming a plan for a scope (tests, drills).
    Exit RESTORES whatever plan was armed before — a scoped drill
    inside an env-armed process (the audit's fault leg runs under
    whatever the operator exported) must not disarm the outer plan."""

    def __init__(self, plan):
        self.plan = plan if isinstance(plan, FaultPlan) else FaultPlan(plan)
        self._prev = None

    def __enter__(self):
        self._prev = installed()
        install(self.plan)
        return self.plan

    def __exit__(self, *exc_info):
        if self._prev is not None:
            install(self._prev)
        else:
            uninstall()
