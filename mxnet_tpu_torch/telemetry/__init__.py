"""Runtime telemetry: the process-wide metrics registry and its hooks.

Counterpart of ``mxnet_tpu/telemetry/``, with the same family names,
label keys and exposition, so code written for the JAX package reads
the port's output unchanged.  The costs that decide a step's time on
the card (the executor's first dispatch of each program and shape,
device->host copies, input-pipeline stalls, kvstore traffic, the
hand-written kernels' launches) are recorded by the executor, ndarray,
io, kvstore, ``ops.cuda_kernels`` and serving layers, and read back
three ways:

- ``snapshot()``: one JSON view of every series;
- ``prometheus_text()`` / ``write_prometheus()``: text exposition for
  scrapers (format-checked by ``validate_exposition``), written at exit
  to ``MXNET_TELEMETRY_PROM_FILE`` when that is set;
- ``StepLogger``: per-step JSONL with counter deltas, installed by
  ``module.fit`` when ``MXNET_TELEMETRY_STEP_LOG`` is set, which also
  bridges the counters into a running profiler trace as ``'C'`` events.

Gating: instrumentation in training hot paths (executor dispatch,
``asnumpy``, iterator ``next``, kvstore push/pull, kernel launches)
records only when ``enabled()``: one boolean check on the disabled
path, toggled by ``MXNET_TELEMETRY`` or ``enable()``/``disable()``.
The serving layer records unconditionally: its ``stats()`` surface
always existed and the registry mirrors it.

Where the JAX package counts a traced program once, the port counts
each eager launch or dispatch: ``mxnet_pallas_kernel_calls_total``
rises once per kernel launch, and ``mxnet_xla_compiles_total`` once per
first dispatch of an executor's (program, shapes) pair, the JAX
executor's fallback signature set (there is no jit cache to probe).
"""
from __future__ import annotations

import atexit

from .registry import (Counter, Gauge, Histogram, MetricFamily,
                       MetricsRegistry, exponential_buckets,
                       validate_exposition)
from .step_logger import StepLogger
from . import tracing, flight

__all__ = ["Counter", "Gauge", "Histogram", "MetricFamily",
           "MetricsRegistry", "StepLogger", "counter", "gauge",
           "histogram", "get_registry", "snapshot", "snapshot_json",
           "prometheus_text", "write_prometheus", "validate_exposition",
           "exponential_buckets", "enabled", "enable", "disable",
           "reset", "scalar_totals", "publish_to_profiler",
           "chrome_counter_events", "tracing", "flight"]

_REGISTRY = MetricsRegistry()
_ENABLED = [False]


def get_registry():
    """The process-wide registry every subsystem records into."""
    return _REGISTRY


def counter(name, help=""):
    return _REGISTRY.counter(name, help)


def gauge(name, help=""):
    return _REGISTRY.gauge(name, help)


def histogram(name, help="", buckets=None):
    return _REGISTRY.histogram(name, help, buckets=buckets)


def snapshot():
    return _REGISTRY.snapshot()


def snapshot_json(**kwargs):
    return _REGISTRY.snapshot_json(**kwargs)


def prometheus_text():
    return _REGISTRY.prometheus_text()


def scalar_totals():
    return _REGISTRY.scalar_totals()


def reset():
    _REGISTRY.reset()


def enabled():
    """Is hot-path instrumentation on?  (One list read — the cost the
    disabled fast path pays.)"""
    return _ENABLED[0]


def enable(on=True):
    _ENABLED[0] = bool(on)


def disable():
    enable(False)


def write_prometheus(path=None):
    """Write the exposition to ``path`` (default:
    ``MXNET_TELEMETRY_PROM_FILE``); returns the path written or None."""
    if path is None:
        from .. import config as _config
        path = _config.get("MXNET_TELEMETRY_PROM_FILE")
    if not path:
        return None
    with open(path, "w") as f:
        f.write(prometheus_text())
    return path


def chrome_counter_events(ts=None):
    """The registry's scalar metrics as chrome-trace ``'C'`` counter
    events (profiler.dumps appends these so a dumped trace carries the
    final counter totals alongside its spans)."""
    if ts is None:
        import time
        ts = time.perf_counter_ns() / 1000.0
    return [{"name": name, "cat": "telemetry", "ph": "C", "ts": ts,
             "pid": 0, "tid": 0, "args": {name: value}}
            for name, value in _REGISTRY.scalar_totals().items()]


def publish_to_profiler():
    """Record one ``'C'`` sample per scalar metric into a RUNNING
    profiler trace (no-op otherwise) — the per-step time-series feed."""
    from .. import profiler
    if not profiler.is_running():
        return
    for name, value in _REGISTRY.scalar_totals().items():
        profiler._record(name, "telemetry", "C", args={name: value})


def _atexit_write():
    try:
        write_prometheus()
    except Exception:
        pass


atexit.register(_atexit_write)

# honor the env knob at import so subprocesses (bench legs) need no code
from .. import config as _config  # noqa: E402

_REGISTRY.set_label_cap(_config.get("MXNET_TELEMETRY_LABEL_CAP"))

if _config.get("MXNET_TELEMETRY"):
    enable()

if _config.get("MXNET_TRACE"):
    tracing.enable()
