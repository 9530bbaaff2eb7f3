"""Per-step structured JSONL emitter.

Counterpart of ``mxnet_tpu/telemetry/step_logger.py``, taken over whole:
the records carry the same keys, ``*_delta`` included.

One line per (interval of) training step(s), carrying throughput plus
the registry counter deltas that explain it — compile count, transfer
bytes, kvstore traffic — so a slow step is attributable from the log
alone (the TF-paper debuggability contract, arxiv 1605.08695 §5).

Usable two ways:

- directly, as a ``batch_end_callback``: it accepts the same
  ``BatchEndParam`` every callback receives;
- automatically: ``BaseModule.fit`` installs one when
  ``MXNET_TELEMETRY_STEP_LOG`` names a path.

Each emit also bridges the registry's scalar metrics into the
profiler's chrome-trace stream as ``'C'`` counter events (only while a
trace is running), so one trace shows spans and counters together.
"""
from __future__ import annotations

import json
import time

__all__ = ["StepLogger"]

# counters whose per-interval deltas ride along in every record (only
# those present in the registry are emitted)
_DELTA_METRICS = (
    "mxnet_xla_compiles_total",
    "mxnet_transfer_d2h_bytes_total",
    "mxnet_transfer_d2h_total",
    "mxnet_kvstore_ops_total",
    "mxnet_kvstore_bytes_total",
    "mxnet_io_batches_total",
    "mxnet_collective_ops_total",
    "mxnet_collective_bytes_total",
)


class StepLogger:
    """Append one JSON object per ``interval`` steps to ``path``."""

    def __init__(self, path, batch_size=None, interval=1):
        self.path = path
        self.batch_size = batch_size
        self.interval = max(int(interval or 1), 1)
        self._fh = None
        self._step = 0
        self._tick = None
        self._last_totals = None

    def _ensure_open(self):
        if self._fh is None:
            self._fh = open(self.path, "a")
        return self._fh

    def __call__(self, param=None):
        """Batch-end hook (``param`` is a ``BatchEndParam`` or None)."""
        self._step += 1
        if self._step % self.interval:
            return
        from . import get_registry, publish_to_profiler
        now = time.time()
        totals = get_registry().scalar_totals()
        record = {
            "ts": round(now, 6),
            "step": self._step,
        }
        if param is not None:
            record["epoch"] = getattr(param, "epoch", None)
            record["nbatch"] = getattr(param, "nbatch", None)
            eval_metric = getattr(param, "eval_metric", None)
            if eval_metric is not None:
                try:
                    record["metrics"] = {
                        n: float(v)
                        for n, v in eval_metric.get_name_value()}
                except Exception:
                    pass
        if self.batch_size:
            record["samples"] = self.interval * self.batch_size
            if self._tick is not None and now > self._tick:
                record["samples_per_sec"] = round(
                    record["samples"] / (now - self._tick), 3)
        self._tick = now
        last = self._last_totals or {}
        for name in _DELTA_METRICS:
            if name in totals:
                record[name] = totals[name]
                record[name.replace("_total", "") + "_delta"] = \
                    totals[name] - last.get(name, 0)
        self._last_totals = totals
        fh = self._ensure_open()
        fh.write(json.dumps(record) + "\n")
        fh.flush()
        publish_to_profiler()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
