"""TokenStream — the streaming half of ``infer_stream``.

Counterpart of ``mxnet_tpu/serving/generate/stream.py``, host-only.  A
thread-safe single-producer (the decode scheduler) / single-consumer (the
caller) token channel with an exactly-once terminal state.  The
scheduler pushes tokens as decode steps commit them and finishes the
stream with exactly one of the ledger outcomes (``served`` / ``failed``
/ ``expired`` / ``shed``); the consumer iterates tokens as they arrive
or blocks for the whole sequence with ``result()``.

``ttft_s`` (submit -> first token, i.e. queueing + prefill) and
``token_latencies_s`` (inter-token gaps) are stamped by the producer,
so the scheduler's histograms and a client's percentiles read the same
clocks.
"""
from __future__ import annotations

import threading
import time

from ..errors import DeadlineExceeded, ServingError

__all__ = ["TokenStream"]


class TokenStream:
    """Iterable of generated token ids with a terminal outcome."""

    _PENDING = "pending"

    def __init__(self, model, tenant, priority, max_new_tokens,
                 deadline=None):
        self.model = model
        self.tenant = tenant
        self.priority = int(priority)
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = deadline            # monotonic seconds or None
        self.submitted_s = time.monotonic()
        self.ttft_s = None                  # guarded-by: _cv
        self.token_latencies_s = []         # guarded-by: _cv
        self._tokens = []                   # guarded-by: _cv
        self._state = self._PENDING         # guarded-by: _cv
        self._error = None                  # guarded-by: _cv
        self._read = 0                      # consumer cursor (1 thread)
        self._last_emit_s = None            # producer-only
        self._cv = threading.Condition()
        self.trace = None                   # TraceContext, set at submit
        self._span = None                   # root span; finish() closes

    # -- producer side (decode scheduler) ----------------------------

    def put(self, token):
        now = time.monotonic()
        with self._cv:
            if self._state != self._PENDING:
                return
            if self.ttft_s is None:
                self.ttft_s = now - self.submitted_s
            else:
                self.token_latencies_s.append(now - self._last_emit_s)
            self._last_emit_s = now
            self._tokens.append(int(token))
            self._cv.notify_all()

    def finish(self, outcome, error=None):
        """Terminal transition — first call wins, later calls are
        no-ops, so a request can never settle into two ledger cells."""
        with self._cv:
            if self._state != self._PENDING:
                return False
            self._state = outcome
            self._error = error
            n = len(self._tokens)
            self._cv.notify_all()
        span = self._span
        if span is not None:
            span.finish(status="ok" if outcome == "served"
                        else str(outcome), tokens=n)
        return True

    @property
    def n_tokens(self):
        with self._cv:
            return len(self._tokens)

    # -- consumer side -----------------------------------------------

    @property
    def state(self):
        with self._cv:
            return self._state

    def done(self):
        return self.state != self._PENDING

    def __iter__(self):
        return self

    def __next__(self):
        with self._cv:
            while True:
                if self._read < len(self._tokens):
                    tok = self._tokens[self._read]
                    self._read += 1
                    return tok
                if self._state != self._PENDING:
                    if self._error is not None:
                        raise self._error
                    raise StopIteration
                self._cv.wait(timeout=0.1)

    def result(self, timeout=None):
        """Block until terminal; the full generated sequence on
        ``served``, the terminal error otherwise."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._state == self._PENDING:
                left = None if end is None else end - time.monotonic()
                if left is not None and left <= 0:
                    raise DeadlineExceeded(
                        "stream still pending after %.3fs wait"
                        % timeout)
                self._cv.wait(timeout=0.1 if left is None
                              else min(0.1, left))
            if self._error is not None:
                raise self._error
            if self._state != "served":
                raise ServingError("stream ended %s" % self._state)
            return list(self._tokens)
