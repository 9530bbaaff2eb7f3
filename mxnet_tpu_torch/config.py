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
register_env("MXNET_PARALLEL_BUCKET_BYTES", int, 4194304,
             "gradient-collective bucket size cap for ParallelTrainer: "
             "replicated params are fused into flat buckets of at most "
             "this many bytes so each bucket's reduce can overlap the "
             "remaining backward; <= 0 puts everything in one bucket")
register_env("MXNET_PARALLEL_BUCKET_FIRST_BYTES", int, 1048576,
             "size cap of the FIRST bucket (the output-side params whose "
             "gradients finish earliest in backward); smaller than "
             "MXNET_PARALLEL_BUCKET_BYTES so the first collective "
             "launches as early as possible")
register_env("MXNET_PARALLEL_ZERO", int, 0,
             "default ZeRO stage for ParallelTrainer: 0 replicates "
             "optimizer state (all-reduce per bucket), 1 shards optimizer "
             "slots 1/mesh (full-gradient all-reduce), 2 also "
             "reduce-scatters gradients into the shards")
register_env("MXNET_PARALLEL_COMPRESSION", str, None,
             "default gradient-compression codec for ParallelTrainer "
             "bucket reductions: 2bit (reference kvstore quantizer), "
             "bf16, or fp8 — all with error-feedback residuals carried "
             "in trainer state; unset sends fp32")
register_env("MXNET_PARALLEL_COMPRESSION_THRESHOLD", float, 0.5,
             "quantization threshold of the 2bit codec (reference "
             "gradient_compression.cc pos/neg threshold)")
register_env("MXNET_KVSTORE_HEARTBEAT_DIR", str, None,
             "shared directory for dist-kvstore worker heartbeats "
             "(enables get_num_dead_node)")
register_env("MXNET_KVSTORE_ASYNC_DIR", str, None,
             "shared spool directory for the dist_async parameter "
             "server (coordinator applies pushes on arrival)")
register_env("MXNET_KVSTORE_ASYNC_MAX_PENDING", int, 64,
             "dist_async spool capacity: push blocks while this many "
             "spooled gradients await the server (bounds staleness and "
             "spool growth; 0 disables backpressure)")
register_env("MXNET_KVSTORE_ASYNC_BACKPRESSURE_TIMEOUT", float, 120.0,
             "seconds a dist_async push may block on a full spool "
             "before raising (a dead server thread, not staleness)")
register_env("MXNET_TRANSPORT_SEND_RETRIES", int, 4,
             "at-least-once resend budget of "
             "SpoolTransport.send_reliable (parallel/transport.py): "
             "link faults (partition, lost ack) are retried this many "
             "times on the shared BackoffPolicy, reusing one message "
             "id so the receiver's dedup keeps delivery exactly-once")
register_env("MXNET_TRANSPORT_POLL_S", float, 0.005,
             "SpoolTransport receive poll interval: how often "
             "recv_wait re-scans the inbox while empty")
register_env("MXNET_FLEET_HEALTH_INTERVAL_S", float, 0.2,
             "replica health-beat period of the fleet front door "
             "(serving/fleet.py): each tick judges every healthy "
             "replica's window and probes the ejected ones")
register_env("MXNET_FLEET_PROBE_RETRIES", int, 5,
             "re-admission probe budget for an ejected fleet replica: "
             "the front door probes it on BackoffPolicy delays this "
             "many times before declaring it dead for good")
register_env("MXNET_FLEET_SUBMIT_RETRIES", int, 3,
             "front-door resubmit budget per request: a remote "
             "QueueFull re-routes the SAME request id up to this many "
             "times (honoring the remote retry_after_s hint); the "
             "ledger dedups, so a client never sees a duplicate")
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
register_env("MXNET_CKPT_DIR", str, None,
             "checkpoint directory; when set, fit() checkpoints into it "
             "via a CheckpointManager and Module.save_checkpoint mirrors "
             "saves there (the checkpoint package)")
register_env("MXNET_CKPT_PERIOD_STEPS", int, 0,
             "save a checkpoint every N training batches during fit() "
             "(0 disables step-periodic saves)")
register_env("MXNET_CKPT_PERIOD_EPOCHS", int, 1,
             "save a checkpoint every N epochs at epoch end during "
             "fit() (0 disables epoch-periodic saves)")
register_env("MXNET_CKPT_KEEP_LAST", int, 5,
             "retention: keep this many most-recent complete "
             "checkpoints (<= 0 keeps everything)")
register_env("MXNET_CKPT_KEEP_EVERY", int, 0,
             "retention: additionally pin every checkpoint whose step "
             "id divides by K, forever (0 disables)")
register_env("MXNET_CKPT_ASYNC", bool, True,
             "serialize checkpoints on a background worker (at most one "
             "in flight); 0 saves synchronously on the training thread")
register_env("MXNET_CKPT_ON_SIGTERM", bool, True,
             "during fit(), SIGTERM triggers one final synchronous "
             "checkpoint before exiting (preemption grace-window save)")
register_env("MXNET_CKPT_WATCH_INTERVAL_S", float, 10.0,
             "poll period of serving ModelRegistry.watch_checkpoints "
             "for newly committed checkpoint versions")
register_env("MXNET_COMPILE_CACHE_DIR", str, None,
             "directory of the built CUDA kernel libraries "
             "(libmxtt_<name>.so and its .hash, one nvcc a source); "
             "unset, the package's own _build/; a restarted process "
             "whose hashes match loads them instead of running nvcc")
register_env("MXNET_COMPILE_CACHE_MIN_COMPILE_SECS", float, 0.0,
             "kept for the JAX package's call shape: every nvcc build is "
             "persisted, whatever it took")
register_env("MXNET_COMPILE_CACHE_MIN_ENTRY_BYTES", int, 0,
             "kept for the JAX package's call shape: every built "
             "library is persisted, whatever its size")
register_env("MXNET_COMPILE_CACHE_MAX_BYTES", int, 1073741824,
             "compile-cache size cap; hygiene sweeps LRU-evict built "
             "libraries by recency until the cache fits (<= 0 disables "
             "the cap)")
register_env("MXNET_COMPILE_CACHE_MANIFEST", str, None,
             "path of the serving warmup manifest: ModelServer records "
             "its (model, bucket) executor key set there and a "
             "restarted replica replays it, running each bucket's first "
             "forward before live traffic")
register_env("MXNET_FAULT_PLAN", str, None,
             "deterministic fault-injection schedule: inline JSON or "
             "@/path/to/plan.json; armed at import, every instrumented "
             "site then consults it (fault/plan.py has the rule "
             "vocabulary); unset = one boolean per site")
register_env("MXNET_FAULT_RETRIES", int, 3,
             "default retry budget of the shared BackoffPolicy "
             "(fault/backoff.py): elastic training restarts, watcher "
             "transient reads, kvstore weight reads, serving submit "
             "retries; per-call-site overrides win")
register_env("MXNET_FAULT_BACKOFF_BASE_S", float, 0.5,
             "first-retry delay of the shared BackoffPolicy; "
             "subsequent delays multiply by 2 up to "
             "MXNET_FAULT_BACKOFF_MAX_S")
register_env("MXNET_FAULT_BACKOFF_MAX_S", float, 30.0,
             "cap on any single BackoffPolicy delay")
register_env("MXNET_FAULT_BACKOFF_JITTER", float, 0.25,
             "jitter fraction of BackoffPolicy delays (each delay is "
             "scaled by a seeded uniform draw from [1-j, 1+j]) so a "
             "preempted fleet does not retry in lockstep")
register_env("MXNET_SERVING_SUBMIT_RETRIES", int, 0,
             "opt-in client-side retry budget for serving submissions "
             "rejected with QueueFull: infer()/infer_async() re-submit "
             "up to this many times, sleeping the error's retry_after_s "
             "hint with BackoffPolicy jitter; 0 (default) surfaces "
             "QueueFull to the caller unchanged")
register_env("MXNET_SERVING_MODEL_QUEUE_DEPTH", int, 0,
             "default per-model queue quota: at most this many requests "
             "of one model queued at once, rejected with that model's "
             "own QueueFull/retry_after_s beyond it (0 = no per-model "
             "cap; the global MXNET_SERVING_QUEUE_DEPTH always applies); "
             "ModelServer.set_quota overrides per model")
register_env("MXNET_SERVING_MODEL_INFLIGHT", int, 0,
             "default per-model cap on accepted-but-unresolved requests "
             "(queued + executing); 0 = no cap; set_quota overrides")
register_env("MXNET_SERVING_PRIORITY_CLASSES", int, 3,
             "number of serving priority classes (0 = most important, "
             "N-1 = first shed under brownout)")
register_env("MXNET_SERVING_DEFAULT_PRIORITY", int, 1,
             "priority class assigned to requests that pass none")
register_env("MXNET_SERVING_BROWNOUT_HIGH", float, 0.75,
             "queue-fill fraction (of MXNET_SERVING_QUEUE_DEPTH) at "
             "which the server enters declared brownout: hold-open "
             "window skipped, dispatch shrunk to "
             "MXNET_SERVING_BROWNOUT_MAX_BATCH, priority classes >= "
             "MXNET_SERVING_BROWNOUT_REJECT_CLASS shed")
register_env("MXNET_SERVING_BROWNOUT_LOW", float, 0.25,
             "queue-fill fraction at which brownout exits (hysteresis: "
             "must be below MXNET_SERVING_BROWNOUT_HIGH)")
register_env("MXNET_SERVING_BROWNOUT_MAX_BATCH", int, 0,
             "dispatch-size cap while in brownout (smaller programs "
             "turn the queue over faster); 0 keeps the ladder max")
register_env("MXNET_SERVING_BROWNOUT_REJECT_CLASS", int, 2,
             "lowest priority class still ADMITTED during brownout: "
             "classes >= this are rejected at submit and shed from the "
             "queue, counted per model+class in "
             "mxnet_serving_sheds_total")
register_env("MXNET_SERVING_CANARY_FRACTION", float, 0.0,
             "staged-promotion traffic fraction: watcher-promoted "
             "checkpoint versions serve only this fraction of the "
             "model's unversioned traffic until the health gate "
             "decides promotion vs rollback; 0 (default) promotes "
             "directly")
register_env("MXNET_SERVING_CANARY_MIN_REQUESTS", int, 20,
             "canary completions required before the health gate "
             "decides (the evidence budget; the non-finite sentinel "
             "rolls back immediately regardless)")
register_env("MXNET_SERVING_CANARY_MAX_ERROR_RATE", float, 0.05,
             "canary failed/completed ratio above which the gate rolls "
             "back")
register_env("MXNET_SERVING_CANARY_P99_FACTOR", float, 3.0,
             "rollback when canary p99 latency exceeds this multiple "
             "of the baseline version's p99 over the same window")
register_env("MXNET_SERVING_GEN_SLOTS", int, 8,
             "decode slots per generative model: the fixed lane count "
             "of the continuous-batching pool (KV-cache is "
             "preallocated for all slots at add_generative_model)")
register_env("MXNET_SERVING_GEN_MAX_LEN", int, 0,
             "KV-cache window per decode slot in tokens; prompts "
             "longer than the window are rejected and generations "
             "past it attend to the most recent window (ring "
             "wrap-around); 0 uses the model's positional-table size")
register_env("MXNET_SERVING_GEN_MAX_NEW_TOKENS", int, 64,
             "default generation budget when infer_stream passes no "
             "max_new_tokens; a slot always frees at EOS or budget")
register_env("MXNET_SERVING_GEN_PREFILL_BATCH", int, 4,
             "max prompts coalesced into one prefill program; sets "
             "the batch axis of the prefill (batch, length) grid, so "
             "raising it multiplies warmup binds by one more rung")
register_env("MXNET_SERVING_GEN_QUEUE_DEPTH", int, 128,
             "pending generative requests per model beyond which "
             "submits are rejected with QueueFull/retry_after_s")
register_env("MXNET_SERVING_GEN_SLOT_QUOTA", int, 0,
             "default per-tenant cap on concurrently held decode "
             "slots (0 = no cap); DecodeScheduler.set_slot_quota "
             "overrides per tenant — a tenant at its cap queues even "
             "when slots are free")
register_env("MXNET_SERVING_GEN_BROWNOUT_MS", float, 0.0,
             "generative brownout budget: when (remaining in-flight "
             "tokens + queued token demand) x the live per-token "
             "median predicts a drain time above this, queued "
             "requests of class >= MXNET_SERVING_BROWNOUT_REJECT_CLASS "
             "are shed (hysteresis exits at half the budget); 0 "
             "disables token-priced brownout")
register_env("MXNET_SERVING_CANARY_TIMEOUT_S", float, 600.0,
             "canary decision budget: a canary that cannot gather "
             "min_requests within this window is decided on whatever "
             "evidence exists (healthy -> promote, zero traffic -> "
             "rollback)")
