"""The port's tracing, flight recorder and profiler against the JAX
package's, on the CPU: the same seed and sample rate keep the same
traces, ``inject``/``extract`` round-trip between the packages, the off
path is the no-op singleton, ``profiler.dumps()`` of the same scopes,
instrumentation objects and counters has the same event names and
phases.  Then the port alone: a served request's span tree, the flight
recorder's incident dumps (an orphaned worker exception among them),
and the profiler's device trace through ``torch.profiler``.
"""
import json
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.telemetry import flight as jflight
from mxnet_tpu.telemetry import tracing as jtracing
from mxnet_tpu_torch.telemetry import flight as tflight
from mxnet_tpu_torch.telemetry import tracing as ttracing

SEED = 0


@pytest.fixture
def armed(tmp_path):
    """Tracing armed in both packages, every state reset before and
    after."""
    for tr in (jtracing, ttracing):
        tr.reset()
    yield tmp_path
    for tr, fl in ((jtracing, jflight), (ttracing, tflight)):
        tr.disable()
        tr.reset()
        fl.reset()


@pytest.mark.parametrize("sample,seed", [(0.5, 7), (0.1, 0), (1.0, 3),
                                         (0.0, 3)])
def test_sampling_keeps_the_same_traces(armed, sample, seed):
    """200 root spans over five names, one marked anomalous in ten: both
    packages export the same traces."""
    kept = {}
    for name, tr in (("jax", jtracing), ("port", ttracing)):
        path = str(armed / ("%s.jsonl" % name))
        # no root may pass for slow: that verdict reads the clock
        tr.enable(sample=sample, seed=seed, trace_dir=None, p99_factor=1e9)
        for i in range(200):
            ctx = tr.TraceContext("t-fixed-%d" % i)
            with tr.span("op%d" % (i % 5), ctx=ctx) as sp:
                with tr.span("child"):
                    pass
                if i % 10 == 0:
                    tr.mark("shed", sp.ctx)
        assert [tr.keep("t-fixed-%d" % i) for i in range(5)] == \
            [tr.keep("t-fixed-%d" % i) for i in range(5)]
        tr.export_jsonl(path)
        with open(path) if os.path.exists(path) else open(os.devnull) as f:
            kept[name] = sorted((r["trace"], r["name"], r.get("anomaly"))
                                for r in map(json.loads, f))
        tr.disable()
    assert kept["port"] == kept["jax"]
    assert all(("t-fixed-%d" % i, "child", "shed") in kept["port"]
               for i in range(0, 200, 10))


def test_inject_extract_round_trip_between_the_packages(armed):
    for src, dst in ((ttracing, jtracing), (jtracing, ttracing),
                     (ttracing, ttracing)):
        src.enable(sample=1.0)
        ctx = src.mint(model="m", tenant="a")
        with src.use(ctx), src.span("send") as sp:
            meta = src.inject({"op": "infer"})
        back = dst.extract(meta)
        assert (back.trace_id, back.span_id, back.baggage) == \
            (sp.ctx.trace_id, sp.ctx.span_id, {"model": "m", "tenant": "a"})
        assert dst.extract({"op": "infer"}) is None
        src.disable()
    assert ttracing.inject({}, ttracing.mint()) == {}     # disarmed


def test_the_off_path_is_the_noop_singleton(armed):
    assert not ttracing.ACTIVE[0]
    assert ttracing.span("x") is ttracing._NOOP
    assert ttracing.start_span("x") is ttracing._NOOP
    with ttracing.span("x") as sp:
        assert sp.ctx is None
    ttracing.mark("shed")
    ttracing.add_span("x", ttracing.mint(), 0.0, 1.0)
    assert ttracing.snapshot() == [] and ttracing.anomalous() == {}


def _profile(mx):
    """A profiler window over the same scopes, instrumentation objects
    and telemetry counters; the dump's (name, phase) pairs."""
    mx.telemetry.reset()
    mx.profiler.set_config(filename=os.devnull)
    mx.profiler.set_state("run")
    try:
        with mx.profiler.scope("serving:batch", cat="serving"):
            pass
        dom = mx.profiler.Domain("d")
        task = dom.new_task("task")
        task.start()
        task.stop()
        with dom.new_frame("frame"):
            pass
        with mx.profiler.Event("event"):
            pass
        counter = dom.new_counter("queue", 1)
        counter += 2
        counter -= 1
        dom.new_marker("mark").mark()
        mx.profiler.pause()
        with mx.profiler.scope("paused"):
            pass
        mx.profiler.resume()
        mx.telemetry.counter("mxnet_probe_total", "probe").inc(3)
        mx.telemetry.gauge("mxnet_probe_depth").set(2)
        mx.telemetry.publish_to_profiler()
        dump = json.loads(mx.profiler.dumps(reset=True))
    finally:
        mx.profiler.set_state("stop")
        mx.telemetry.reset()
    return sorted((e["name"], e["ph"], e["cat"])
                  for e in dump["traceEvents"])


def test_profiler_dumps_the_same_events(armed):
    got, want = _profile(tmx), _profile(jmx)
    assert got == want
    assert ("mxnet_probe_total", "C", "telemetry") in got
    assert ("serving:batch", "X", "serving") in got
    assert not any(n == "paused" for n, _, _ in got)


def test_profiler_device_trace_on_the_cpu(tmp_path):
    """``jax_trace_dir`` starts a torch.profiler session at ``run`` and
    writes its chrome trace at ``stop``; ``dump(finished=True)`` stops
    first, so the dump carries the device events (none on the CPU)."""
    import torch
    out = str(tmp_path / "profile.json")
    tmx.profiler.set_config(jax_trace_dir=str(tmp_path / "dev"),
                            filename=out)
    tmx.profiler.set_state("run")
    try:
        assert tmx.profiler.is_running()
        with tmx.profiler.scope("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    finally:
        tmx.profiler.dump(finished=True)
        tmx.profiler.set_config(jax_trace_dir=None)
    assert not tmx.profiler.is_running()
    trace = tmx.profiler._STATE["device_trace"]
    assert trace == str(tmp_path / "dev" / ("device-trace-%d.json"
                                            % os.getpid()))
    with open(trace) as f:
        evs = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in evs)
    with open(out) as f:
        dumped = json.load(f)["traceEvents"]
    assert "matmul" in [e["name"] for e in dumped]
    assert not [e for e in dumped if e.get("pid") == "device"]


def test_served_request_is_one_trace(armed):
    """With tracing on, a served request's root ``serving.request`` holds
    the batcher's dispatch, batch, cache lookup, queue and execute
    spans."""
    from mxnet_tpu_torch.serving import ModelServer
    ttracing.enable(sample=1.0)
    data = tmx.sym.var("data")
    sym = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
        data, num_hidden=3, name="fc"), name="softmax")
    rng = np.random.RandomState(SEED)
    args, auxs = tmx.convert.params_from_numpy(
        {"fc_weight": rng.randn(3, 4).astype(np.float32),
         "fc_bias": np.zeros(3, np.float32)}, {}, tmx.cpu(), symbol=sym)
    srv = ModelServer(max_batch=2, ctx=tmx.cpu())
    srv.add_model("m", sym, args, auxs, {"data": (1, 4)})
    srv.start()
    try:
        out = srv.infer("m", {"data": rng.randn(1, 4).astype(np.float32)})
    finally:
        srv.stop()
    assert out[0].shape == (1, 3)
    spans = ttracing.snapshot()
    root = [s for s in spans if s["name"] == "serving.request"]
    assert len(root) == 1 and root[0]["parent"] is None
    tree = {s["name"]: s for s in spans if s["trace"] == root[0]["trace"]}
    assert set(tree) == {"serving.request", "serving.dispatch",
                         "serving.batch", "serving.cache.get",
                         "serving.queue", "serving.execute"}
    assert tree["serving.dispatch"]["parent"] == root[0]["span"]
    assert tree["serving.batch"]["parent"] == tree["serving.dispatch"]["span"]
    assert tree["serving.cache.get"]["parent"] == tree["serving.batch"]["span"]
    assert tree["serving.cache.get"]["tags"]["outcome"] == "miss"
    assert tree["serving.execute"]["parent"] == root[0]["span"]


def test_flight_incident_dumps_the_ring_and_anomalous_traces(armed):
    ttracing.enable(sample=0.0, trace_dir=str(armed))
    tflight.record("probe", model="m", obj=object())
    with ttracing.span("serving.request", ctx=ttracing.mint()) as sp:
        ttracing.mark("failed", sp.ctx)
    path = tflight.incident("audit_probe", depth=3)
    with open(path) as f:
        dump = json.load(f)
    assert dump["incident"] == "audit_probe" and dump["detail"] == {
        "depth": 3}
    assert [e["kind"] for e in dump["events"]] == ["probe"]
    assert list(dump["anomalous"].values()) == ["failed"]
    assert len(dump["traces"]) == 1
    assert tflight.dumps_written() == 1


def test_orphaned_worker_exception_dumps_an_incident(armed):
    ttracing.enable(sample=0.0, trace_dir=str(armed))
    with tmx.engine.worker_scope():
        raise RuntimeError("no receiver")
    with pytest.raises(RuntimeError):
        tmx.engine.check_raise()
    dumps = [f for f in os.listdir(str(armed))
             if f.startswith("incident-worker_exception")]
    assert len(dumps) == 1
    with open(os.path.join(str(armed), dumps[0])) as f:
        assert "no receiver" in json.load(f)["detail"]["error"]
