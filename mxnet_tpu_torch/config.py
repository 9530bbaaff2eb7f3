"""Environment-variable configuration registry.

Counterpart of ``mxnet_tpu/config.py``: variables are declared with
``register_env`` and read with ``get``.  ``tuned`` keeps the JAX
package's call shape but resolves env -> default only; the tuning
database arrives with a later slice.  Only the knobs this package reads
are registered, with the JAX package's defaults.  ``list_env`` prints the
registry as a table and ``check_unknown`` names ``MXNET_*`` variables
set in the environment that nothing registered (likely typos).
"""
from __future__ import annotations

import os
from collections import OrderedDict

from .base import getenv

__all__ = ["register_env", "get", "tuned", "EnvVar", "list_env",
           "check_unknown"]


class EnvVar:
    __slots__ = ("name", "typ", "default", "description")

    def __init__(self, name, typ, default, description):
        self.name = name
        self.typ = typ
        self.default = default
        self.description = description


_REGISTRY = OrderedDict()


def register_env(name, typ=str, default=None, description=""):
    """Declare a configuration variable."""
    _REGISTRY[name] = EnvVar(name, typ, default, description)
    return _REGISTRY[name]


def get(name):
    """Read a registered variable with its declared type and default."""
    if name not in _REGISTRY:
        raise KeyError("unregistered env var %r; declare it with "
                       "register_env" % name)
    var = _REGISTRY[name]
    return getenv(name, var.default, var.typ)


def tuned(name):
    """Resolve a tunable knob: the environment, else the default (the
    JAX package consults its tuning database in between; that database
    is not ported yet)."""
    return get(name)


def list_env():
    """The registry as a markdown table (reference: docs/faq/env_var.md)."""
    lines = ["| variable | type | default | description |",
             "| --- | --- | --- | --- |"]
    for var in _REGISTRY.values():
        lines.append("| %s | %s | %r | %s |" % (
            var.name, var.typ.__name__, var.default, var.description))
    return "\n".join(lines)


def check_unknown(prefix="MXNET_"):
    """Variables starting with ``prefix`` set in the environment but never
    registered, sorted."""
    return sorted(k for k in os.environ
                  if k.startswith(prefix) and k not in _REGISTRY)


register_env("MXNET_PALLAS_BN_RELU", str, "auto",
             "executor eval-graph peephole: inference BatchNorm+ReLU as "
             "one scale_bias_relu CUDA kernel: auto = on for tensors on "
             "the GPU, 1 = force (the plain version on CPU tensors), "
             "0 = off (per-op path)")
register_env("MXNET_PALLAS_SOFTMAX", str, "auto",
             "SoftmaxOutput forward through the softmax_lastaxis CUDA "
             "kernel, and masked attention (local_attention's einsum "
             "route) through bias_softmax: auto = on for tensors on the "
             "GPU, 1 = force (the plain versions on CPU tensors), 0 = off "
             "(torch.softmax)")
register_env("MXNET_PALLAS_NORM", str, "auto",
             "LayerNorm over the last axis through the layernorm_fwd CUDA "
             "kernel: auto = on for tensors on the GPU, 1 = force (the "
             "plain version on CPU tensors), 0 = off (the plain reduction "
             "chain)")
register_env("MXNET_PALLAS_FUSED_OPT", str, "auto",
             "executor fused step (Module with kvstore='tpu'): the "
             "one-sweep optimizer CUDA kernels over flat fp32 buckets: "
             "auto = on for weights on the GPU, 1 = force (the plain "
             "versions on CPU tensors), 0 = off (the per-array path, "
             "which launches no kernel)")
register_env("MXNET_SERVING_MAX_BATCH", int, 8,
             "largest serving shape bucket; the micro-batcher coalesces "
             "concurrent requests up to this many rows per dispatch")
register_env("MXNET_SERVING_QUEUE_DEPTH", int, 256,
             "bounded serving request queue; submissions beyond this "
             "depth are rejected with QueueFull")
register_env("MXNET_SERVING_BATCH_WAIT_MS", float, 2.0,
             "how long the micro-batcher holds a head-of-line request "
             "for co-batchable arrivals before dispatching a partial "
             "bucket")
register_env("MXNET_SERVING_DEFAULT_TIMEOUT_MS", float, 5000.0,
             "per-request serving deadline when infer() passes none")
register_env("MXNET_SERVING_EXECUTOR_CACHE", int, 16,
             "LRU capacity of the serving executor cache, in bound "
             "(model, version, bucket) predictors")
register_env("MXNET_PROFILER_AUTOSTART", bool, False,
             "start the profiler at import (reference: src/profiler)")
register_env("MXNET_PROFILER_MODE", int, 0,
             "profiler instrumentation mode bitmask")
register_env("MXNET_TELEMETRY", bool, False,
             "master switch for hot-path metrics instrumentation (an "
             "executor's first dispatch per program and shapes, "
             "device->host copies, io fetch latency, kvstore traffic, "
             "CUDA kernel launches); the registry itself is always live")
register_env("MXNET_TELEMETRY_STEP_LOG", str, None,
             "path for per-step JSONL emitted during fit() — one JSON "
             "object per step with samples/sec and counter deltas")
register_env("MXNET_TELEMETRY_STEP_INTERVAL", int, 1,
             "emit a step-JSONL record every N batches")
register_env("MXNET_TELEMETRY_PROM_FILE", str, None,
             "write the registry's Prometheus text exposition to this "
             "path at process exit (telemetry.write_prometheus)")
register_env("MXNET_TELEMETRY_LABEL_CAP", int, 256,
             "label-cardinality cap per metric family: past this many "
             "distinct label sets, new ones collapse into the "
             "__overflow__ child and "
             "mxnet_telemetry_label_overflow_total{metric=...} counts "
             "the spill (0 = uncapped)")
register_env("MXNET_TRACE", bool, False,
             "master switch for request tracing and the flight recorder "
             "(telemetry/tracing.py): off, every span call site costs "
             "one boolean check; on, spans land in the per-process ring")
register_env("MXNET_TRACE_SAMPLE", float, 0.01,
             "tail-sampling keep rate for HEALTHY traces at export; "
             "anomalous traces (failed, deadline-exceeded, "
             "p99-exceeding, marked) are always retained regardless")
register_env("MXNET_TRACE_SEED", int, 0,
             "seed of the per-trace sampling hash — the keep decision "
             "is pure in (seed, trace_id), so runs and processes agree "
             "on which healthy traces survive")
register_env("MXNET_TRACE_RING", int, 4096,
             "finished-span ring capacity per process; spans of traces "
             "whose root has not finished stay ringed until flush, "
             "oldest spill first")
register_env("MXNET_TRACE_DIR", str, None,
             "directory for JSONL trace shards (trace-<pid>.jsonl, "
             "appended by flush()/atexit) and flight-recorder incident "
             "dumps; unset disables export but not in-ring tracing")
register_env("MXNET_TRACE_P99_FACTOR", float, 3.0,
             "a finished root span slower than this multiple of its "
             "name's running p99 estimate marks the trace anomalous "
             "(p99_exceeded) for tail retention")
register_env("MXNET_TRACE_FLIGHT_RING", int, 512,
             "flight-recorder ring capacity: last N control-plane "
             "events kept for incident dumps")
register_env("MXNET_TRACE_FLIGHT_DUMPS", int, 8,
             "max flight-recorder incident dumps per process — a "
             "crash-looping trigger cannot fill the disk")
