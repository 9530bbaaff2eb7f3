"""BackoffPolicy — one retry/backoff vocabulary for the whole package
(counterpart of ``mxnet_tpu/fault/backoff.py``).

The checkpoint watcher and the serving client retry instantiate this
one policy — exponential delays with a multiplicative cap and seeded
jitter, held to the JAX package's delays from the same seed by
``tests/test_torch_fault.py``.

Defaults come from the ``MXNET_FAULT_RETRIES`` /
``MXNET_FAULT_BACKOFF_*`` knobs so a fleet tunes every retry surface
in one place; call sites override only what their latency budget
demands (the watcher keeps delays under its poll interval).

Jitter model: each delay is ``base * multiplier**attempt`` clamped to
``max_s``, then scaled by a uniform draw from ``[1-j, 1+j]``
— full-range decorrelation so a fleet of preempted workers does not
reconverge on the same retry instant (the thundering-herd the hint in
``QueueFull.retry_after_s`` would otherwise create).  The draw chain
is ``random.Random(seed)``-owned, so tests assert exact sequences.

Determinism under seeded plans: with no explicit ``seed`` the policy
asks the armed :class:`~.plan.FaultPlan` for the next link of its
per-policy chain (``"seed:backoff:N"``, the same idiom as the per-rule
``p`` chains) — two replays of the same plan hand the Nth policy the
same jitter stream, so a drill's retry timeline replays identically.
No plan armed → seed 0, the historical default.  Global ``random`` is
never consulted.
"""
from __future__ import annotations

import random
import time

__all__ = ["BackoffPolicy"]


class BackoffPolicy:
    """Exponential backoff with cap and seeded jitter.

    ``retries`` is the number of RETRIES (attempts = retries + 1).
    ``call`` is the canonical consumer; ``delay``/``sleep_for`` serve
    loops that cannot be expressed as one callable (the elastic
    supervisor's rebuild-restore-retry cycle)."""

    def __init__(self, retries=None, base_s=None, max_s=None,
                 multiplier=2.0, jitter=None, seed=None, sleep=time.sleep):
        from .. import config as _config
        if retries is None:
            retries = _config.get("MXNET_FAULT_RETRIES")
        if base_s is None:
            base_s = _config.get("MXNET_FAULT_BACKOFF_BASE_S")
        if max_s is None:
            max_s = _config.get("MXNET_FAULT_BACKOFF_MAX_S")
        if jitter is None:
            jitter = _config.get("MXNET_FAULT_BACKOFF_JITTER")
        if seed is None:
            # the armed plan's per-policy chain (module docstring) —
            # NEVER global random: replayed drills must re-draw the
            # exact jitter sequence
            from .plan import backoff_seed
            seed = backoff_seed()
        self.retries = max(0, int(retries))
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.multiplier = float(multiplier)
        self.jitter = min(max(float(jitter), 0.0), 1.0)
        self._rng = random.Random(seed)
        self._sleep = sleep

    def delay(self, attempt):
        """Jittered delay before retry ``attempt`` (0-based).  Always
        within ``[raw * (1-jitter), raw * (1+jitter)]`` where ``raw``
        is the capped exponential — the bound the unit test holds."""
        raw = min(self.base_s * (self.multiplier ** attempt), self.max_s)
        if self.jitter:
            raw *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(raw, 0.0)

    def sleep_for(self, attempt, floor_s=0.0):
        """Sleep the jittered delay (at least ``floor_s`` — e.g. a
        server-provided ``retry_after_s`` hint); returns the slept
        duration."""
        d = max(self.delay(attempt), float(floor_s))
        self._sleep(d)
        return d

    def call(self, fn, retry_on=(OSError,), abort_on=(), retries=None,
             on_retry=None, floor_s=0.0):
        """Run ``fn()`` with up to ``retries`` retried failures.

        Only exceptions matching ``retry_on`` are retried; anything
        else propagates immediately (a programming error must not burn
        a retry budget).  ``abort_on`` wins over ``retry_on`` — the
        carve-out for a PERMANENT subclass of a transient family (a
        checkpoint ``IntegrityError`` is a ``CheckpointError``, but no
        amount of re-reading fixes bit rot).  ``on_retry(exc, attempt)``
        observes each retry (telemetry, logging).  The final failure
        re-raises the LAST exception — never a swallowed None."""
        budget = self.retries if retries is None else max(0, int(retries))
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on as exc:
                if abort_on and isinstance(exc, abort_on):
                    raise
                if attempt >= budget:
                    raise
                if on_retry is not None:
                    on_retry(exc, attempt)
                self.sleep_for(attempt, floor_s=floor_s)
                attempt += 1
