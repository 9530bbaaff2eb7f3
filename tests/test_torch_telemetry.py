"""The port's telemetry against the JAX package's, on the CPU: the
registry (the same operations give the same ``snapshot()`` and the same
Prometheus exposition, byte for byte; ``validate_exposition`` accepts
and rejects the same texts), ``Module.fit``'s step log and exit-time
exposition in a fresh interpreter per package (the same lines and keys,
the same deltas for the events both packages count alike: batches,
device->host copies, kvstore pushes and pulls), the tracing spans that
fit leaves in its shard, and the port's own recording sites: the
executor's first dispatch per shape, the kernel counter's labels, and
nothing recorded while telemetry is off.  Also ``NDArray(x, ctx)``.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0


# -- the registry -----------------------------------------------------------
def _drive(mx, seed):
    """One seeded sequence of counter, gauge and histogram operations on
    a fresh registry with a label cap of 3."""
    reg = mx.telemetry.MetricsRegistry(label_cap=3)
    rng = np.random.RandomState(seed)
    c = reg.counter("mxnet_test_ops_total", "ops by kind")
    g = reg.gauge("mxnet_test_depth", "queue depth\nsecond line")
    h = reg.histogram("mxnet_test_seconds", "latency",
                      buckets=mx.telemetry.exponential_buckets(1e-3, 4, 5))
    plain = reg.counter("mxnet_test_plain_total")
    for i in range(40):
        kind = "k%d" % rng.randint(6)          # past the cap: overflow
        c.labels(op=kind, quote='a"b\\').inc(int(rng.randint(1, 4)))
        g.labels(pipeline="p%d" % (i % 2)).set(float(rng.randn()))
        g.inc(2)
        g.dec(0.5)
        h.observe(float(rng.exponential(0.01)), exemplar="t-%d" % i)
        h.labels(model="m%d" % (i % 4)).observe(float(rng.exponential()))
        plain.inc()
    return reg


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_snapshot_and_exposition_match_byte_for_byte(seed):
    j, t = _drive(jmx, seed), _drive(tmx, seed)
    assert json.dumps(t.snapshot()) == json.dumps(j.snapshot())
    text = t.prometheus_text()
    assert text == j.prometheus_text()
    assert t.scalar_totals() == j.scalar_totals()
    assert "__overflow__" in text
    assert "mxnet_telemetry_label_overflow_total" in text
    tmx.telemetry.validate_exposition(text)


GOOD = [
    "# TYPE a counter\na 1\n",
    '# HELP a x\n# TYPE a counter\na{k="v\\"w"} 2.5\n',
    '# TYPE h histogram\nh_bucket{le="1.0"} 1\nh_bucket{le="+Inf"} 2\n'
    "h_sum 3\nh_count 2\n",
    "# TYPE g gauge\ng -Inf\n".replace("-Inf", "-1e-3"),
]
BAD = [
    "a 1\n",                                          # no TYPE
    "# TYPE a counter\na one\n",                      # bad value
    "# TYPE a counter\na{k=v} 1\n",                   # bad label pair
    "# TYPE a kind\na 1\n",                           # bad TYPE
    '# TYPE h histogram\nh_bucket{le="1.0"} 3\nh_bucket{le="+Inf"} 2\n'
    "h_count 2\n",                                    # not cumulative
    '# TYPE h histogram\nh_bucket{le="1.0"} 1\nh_count 1\n',  # no +Inf
]


@pytest.mark.parametrize("text,ok", [(t, True) for t in GOOD]
                         + [(t, False) for t in BAD],
                         ids=["good%d" % i for i in range(len(GOOD))]
                         + ["bad%d" % i for i in range(len(BAD))])
def test_validate_exposition_accepts_and_rejects_alike(text, ok):
    for mx in (jmx, tmx):
        if ok:
            assert mx.telemetry.validate_exposition(text) == \
                jmx.telemetry.validate_exposition(text)
        else:
            with pytest.raises(ValueError):
                mx.telemetry.validate_exposition(text)


# -- fit in a fresh interpreter per package ------------------------------------
FIT = r"""
import json, os, sys
import numpy as np
pkg, out = sys.argv[1], sys.argv[2]
mx = __import__(pkg)
assert mx.telemetry.enabled() and mx.telemetry.tracing.ACTIVE[0]
rng = np.random.RandomState(0)
x = rng.randn(32, 10).astype(np.float32)
y = rng.randint(0, 3, 32).astype(np.float32)
data = mx.sym.var("data")
net = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
net = mx.sym.Activation(net, act_type="relu")
net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
net = mx.sym.SoftmaxOutput(net, name="softmax")
kw = {"context": mx.cpu()} if pkg == "mxnet_tpu_torch" else {}
for kv in ("local", "tpu"):
    os.environ["MXNET_TELEMETRY_STEP_LOG"] = os.path.join(out, kv + ".jsonl")
    # NDArray sources: both iterators copy them to the host once
    it = mx.io.NDArrayIter(mx.nd.array(x, ctx=mx.cpu()),
                           mx.nd.array(y, ctx=mx.cpu()), batch_size=8)
    mod = mx.mod.Module(net, **kw)
    mod.fit(it, num_epoch=2, kvstore=kv, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1})
snap = mx.telemetry.snapshot()
json.dump({k: v["type"] for k, v in snap.items()},
          open(os.path.join(out, "families.json"), "w"))
"""

SAME_EVENT = ("mxnet_io_batches_delta", "mxnet_kvstore_ops_delta",
              "mxnet_kvstore_bytes_delta", "mxnet_transfer_d2h_delta",
              "mxnet_transfer_d2h_bytes_delta")


@pytest.fixture(scope="module")
def fit_runs(tmp_path_factory):
    """Both packages' fits, run at once, each in its own interpreter
    with telemetry, the step log, the exit-time exposition and tracing
    (every trace kept, shards in a directory) armed by the env."""
    procs, dirs = {}, {}
    for pkg in ("mxnet_tpu", "mxnet_tpu_torch"):
        d = str(tmp_path_factory.mktemp(pkg))
        env = dict(os.environ, JAX_PLATFORMS="cpu", MXNET_TELEMETRY="1",
                   MXNET_TELEMETRY_PROM_FILE=os.path.join(d, "exit.prom"),
                   MXNET_TRACE="1", MXNET_TRACE_SAMPLE="1.0",
                   MXNET_TRACE_DIR=os.path.join(d, "trace"))
        env.pop("MXNET_TELEMETRY_STEP_LOG", None)
        procs[pkg] = subprocess.Popen(
            [sys.executable, "-c", FIT, pkg, d], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        dirs[pkg] = d
    for pkg, p in procs.items():
        _out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return dirs


def _lines(d, kv):
    with open(os.path.join(d, kv + ".jsonl")) as f:
        return [json.loads(l) for l in f]


@pytest.mark.parametrize("kv", ["local", "tpu"])
def test_fit_step_log_matches_the_jax_package(fit_runs, kv):
    j = _lines(fit_runs["mxnet_tpu"], kv)
    t = _lines(fit_runs["mxnet_tpu_torch"], kv)
    assert len(t) == len(j) == 8        # 4 batches x 2 epochs
    for a, b in zip(t, j):
        assert sorted(a) == sorted(b)
        for key in SAME_EVENT:
            assert a.get(key) == b.get(key), key
        assert a["step"] == b["step"] and a["samples"] == b["samples"]
    assert t[0]["mxnet_xla_compiles_delta"] >= 1
    assert all(l["mxnet_xla_compiles_delta"] == 0 for l in t[1:])
    if kv == "tpu":
        assert t[0]["mxnet_kvstore_ops_delta"] == 4


def test_exit_exposition_validates_with_the_same_families(fit_runs):
    texts, fams = {}, {}
    for pkg, d in fit_runs.items():
        with open(os.path.join(d, "exit.prom")) as f:
            texts[pkg] = f.read()
        with open(os.path.join(d, "families.json")) as f:
            fams[pkg] = json.load(f)
    tmx.telemetry.validate_exposition(texts["mxnet_tpu_torch"])
    shared = ("mxnet_io_batches_total", "mxnet_io_batch_fetch_seconds",
              "mxnet_kvstore_ops_total", "mxnet_kvstore_bytes_total",
              "mxnet_kvstore_op_seconds", "mxnet_transfer_d2h_total",
              "mxnet_transfer_d2h_bytes_total", "mxnet_xla_compiles_total",
              "mxnet_xla_compile_seconds", "mxnet_executor_binds_total")
    for name in shared:
        assert fams["mxnet_tpu_torch"].get(name) == \
            fams["mxnet_tpu"].get(name) is not None, name
    for name in ("mxnet_io_batches_total", "mxnet_kvstore_ops_total"):
        got = [l for l in texts["mxnet_tpu_torch"].splitlines()
               if l.startswith(name)]
        want = [l for l in texts["mxnet_tpu"].splitlines()
                if l.startswith(name)]
        assert got == want


def test_fit_spans_match_the_jax_package(fit_runs):
    names = {}
    for pkg, d in fit_runs.items():
        spans = []
        trace = os.path.join(d, "trace")
        for fn in os.listdir(trace):
            with open(os.path.join(trace, fn)) as f:
                spans += [json.loads(l) for l in f]
        names[pkg] = sorted(s["name"] for s in spans)
    assert names["mxnet_tpu_torch"].count("fit.step") == 16
    assert names["mxnet_tpu_torch"] == names["mxnet_tpu"]


# -- the port's recording sites -----------------------------------------------
@pytest.fixture
def telemetry_on():
    tmx.telemetry.reset()
    tmx.telemetry.enable()
    yield tmx.telemetry
    tmx.telemetry.disable()
    tmx.telemetry.reset()


def _mlp(mx):
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data, num_hidden=4, name="fc")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def test_executor_counts_the_first_dispatch_of_each_shape(telemetry_on):
    sym = _mlp(tmx)
    exe = sym.simple_bind(tmx.cpu(), grad_req="null", data=(2, 3))
    compiles = lambda: telemetry_on.snapshot()[  # noqa: E731
        "mxnet_xla_compiles_total"]["values"][0]["value"]
    x = np.ones((2, 3), np.float32)
    exe.forward(data=x)
    exe.forward(data=x)
    assert compiles() == 1
    exe.forward(is_train=True, data=x)
    assert compiles() == 2
    exe2 = sym.simple_bind(tmx.cpu(), grad_req="null", data=(5, 3))
    exe2.forward(data=np.ones((5, 3), np.float32))
    snap = telemetry_on.snapshot()
    assert compiles() == 3
    assert snap["mxnet_executor_binds_total"]["values"][0]["value"] == 2
    hist = snap["mxnet_xla_compile_seconds"]["values"][0]
    assert hist["count"] == 3


def _pallas_labels():
    with open(os.path.join(REPO, "mxnet_tpu", "ops",
                           "pallas_kernels.py")) as f:
        return set(re.findall(r'_count\("(\w+)"\)', f.read()))


def test_kernel_counter_takes_the_jax_packages_labels(telemetry_on):
    """Every wrapper's label is the name the JAX package counts its
    Pallas kernel under, and every such name has a wrapper; a launch
    adds one to its label (on the CPU no kernel launches, so ``_count``
    is called as ``_launch`` calls it)."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    assert set(ck._TELEMETRY_LABEL) == set(ck.kernel_calls())
    assert set(ck._TELEMETRY_LABEL.values()) == _pallas_labels()
    before = ck.kernel_calls()
    try:
        for name in ck._TELEMETRY_LABEL:
            ck._count(name)
        ck._count("sgd_mom_sweep")
    finally:
        ck.reset_kernel_calls()
        with ck._COUNT_LOCK:
            ck._CALLS.update(before)
    fam = telemetry_on.snapshot()["mxnet_pallas_kernel_calls_total"]
    got = {v["labels"]["kernel"]: v["value"] for v in fam["values"]}
    assert got == {"fused_scale_bias_relu": 1, "fused_softmax_fwd": 2,
                   "fused_softmax_bwd": 1, "fused_sgd": 1,
                   "fused_sgd_momentum": 2, "fused_adam": 1,
                   "fused_layernorm_fwd": 1, "fused_layernorm_bwd": 1,
                   "flash_attention_fwd": 1, "flash_attention_bwd": 2}


HOT_PATH = ("mxnet_executor_binds_total", "mxnet_xla_compiles_total",
            "mxnet_xla_compile_seconds", "mxnet_sync_waits_total",
            "mxnet_transfer_d2h_total", "mxnet_transfer_d2h_bytes_total",
            "mxnet_io_batches_total", "mxnet_io_batch_fetch_seconds",
            "mxnet_kvstore_ops_total", "mxnet_kvstore_bytes_total",
            "mxnet_kvstore_op_seconds", "mxnet_pallas_kernel_calls_total",
            "mxnet_speed_samples_per_sec", "mxnet_io_prefetch_depth")


def test_disabled_paths_record_nothing(tmp_path, monkeypatch):
    """With telemetry and tracing off: a fit through both kvstores, a
    prefetching iterator, the sync points and a kernel count leave no
    hot-path family, no span, no flight event and no step log."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.telemetry import flight, tracing
    monkeypatch.delenv("MXNET_TELEMETRY_STEP_LOG", raising=False)
    assert not tmx.telemetry.enabled() and not tracing.ACTIVE[0]
    tmx.telemetry.reset()
    tracing.reset()
    flight.reset()
    rng = np.random.RandomState(SEED)
    x = rng.randn(16, 3).astype(np.float32)
    y = rng.randint(0, 4, 16).astype(np.float32)
    with tmx.cpu():
        for kv in ("local", "tpu"):
            it = tmx.io.PrefetchingIter(tmx.io.NDArrayIter(x, y, 4))
            mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
            mod.fit(it, num_epoch=1, kvstore=kv,
                    batch_end_callback=tmx.callback.Speedometer(4, 1))
        a = tmx.nd.array(x)
        a.asnumpy()
        a.wait_to_read()
        tmx.nd.waitall()
    before = ck.kernel_calls()
    ck._count("softmax_lastaxis")
    with ck._COUNT_LOCK:
        ck._CALLS.update(before)
    snap = tmx.telemetry.snapshot()
    assert not set(HOT_PATH) & set(snap)
    assert tracing.span("x") is tracing._NOOP
    assert tracing.snapshot() == []
    flight.record("probe", a=1)
    assert flight.events() == []
    assert flight.incident("probe") is None


def test_ndarray_takes_a_context_as_the_jax_package_does():
    x = np.random.RandomState(SEED).randn(3, 4)
    for src in (x, x.astype(np.float32), [[1, 2], [3, 4]]):
        want = jmx.nd.NDArray(src, jmx.cpu())
        got = tmx.nd.NDArray(src, tmx.cpu())
        assert got.context == tmx.cpu()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    a = tmx.nd.array(x, ctx=tmx.cpu())
    b = tmx.nd.NDArray(a, tmx.cpu())
    np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
