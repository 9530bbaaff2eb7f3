"""The port's fleet front door (``mxnet_tpu_torch/serving/fleet.py``)
against the JAX package's (the cases of ``tests/test_fleet.py`` from the
front door on): round robin and a balanced ledger, a replica death that
resubmits the same id, the remote retry hint, the error codec, probe
re-admission and death when the probe budget runs out, a process replica
(``spawn_replica`` with ``ctx=cpu()``), and the two-process smoke drill
with the port's ``--kv-worker`` child (told ``--ctx cpu``).  Answers are
held to the JAX fleet's on the same linear model within 1e-6.  Every
wait and child process has a time limit."""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.serving import fleet as jfleet
from mxnet_tpu_torch import fault, nd
from mxnet_tpu_torch.fault import BackoffPolicy
from mxnet_tpu_torch.serving import ModelNotFound, QueueFull, ServingError
from mxnet_tpu_torch.serving.fleet import (FleetFrontDoor, ReplicaHandle,
                                           decode_error, encode_error,
                                           local_replica, spawn_replica)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_DIM = 6
HID = 4
TOL = 1e-6


@pytest.fixture(autouse=True)
def _disarm():
    yield
    fault.uninstall()
    jmx.fault.uninstall()


def _model_server(mx, seed=0, **ctx):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=HID, name="fc")
    out = mx.sym.softmax(fc, name="prob")
    rng = np.random.RandomState(seed)
    params = {"fc_weight": mx.nd.array(rng.randn(HID, IN_DIM)
                                       .astype(np.float32), **ctx),
              "fc_bias": mx.nd.array(rng.randn(HID).astype(np.float32),
                                     **ctx)}
    srv = mx.serving.ModelServer(max_batch=8, batch_wait_ms=1.0,
                                 queue_depth=64, default_timeout_ms=30000.0,
                                 **ctx)
    srv.add_model("m", out, params, {}, {"data": (1, IN_DIM)})
    srv.start()
    return srv


def _port_server(seed=0):
    return _model_server(tmx, seed, ctx=tmx.cpu())


def _stop(*servers):
    for s in servers:
        s.stop(drain=False)
        s.cache.clear()


def _answers(mx, fleet, root, xs):
    fd = fleet.FleetFrontDoor(root, 3, request_timeout_s=10.0,
                              health_interval_s=5.0)
    servers = [_port_server() if mx is tmx else _model_server(mx)
               for _ in range(2)]
    try:
        for rid, srv in enumerate(servers, start=1):
            fd.add_replica(fleet.local_replica(root, rid, 3, srv))
        outs = [fd.infer("m", {"data": x}) for x in xs]
        return outs, fd.stats(), [s.stats()["requests"]["served"]
                                  for s in servers], fd.ledger_balanced()
    finally:
        fd.close()
        _stop(*servers)


def test_fleet_routes_round_robin_and_matches_the_jax_fleet(tmp_path):
    rng = np.random.RandomState(4)
    xs = [rng.randn(1 + i % 3, IN_DIM).astype(np.float32) for i in range(6)]
    po, pst, pserved, pbal = _answers(tmx, tmx.serving.fleet,
                                      str(tmp_path / "p"), xs)
    jo, jst, jserved, jbal = _answers(jmx, jfleet, str(tmp_path / "j"), xs)
    assert all(o[0].shape == (x.shape[0], HID) for o, x in zip(po, xs))
    for a, b in zip(po, jo):
        np.testing.assert_allclose(a[0], b[0], rtol=TOL, atol=TOL)
    assert all(n >= 1 for n in pserved) and pserved == jserved
    assert pst["submitted"] == pst["served"] == 6 and pbal and jbal
    keys = ("submitted", "served", "failed", "expired", "resubmitted")
    assert {k: pst[k] for k in keys} == {k: jst[k] for k in keys}


def test_replica_death_resubmits_same_id_no_duplicates(tmp_path):
    root = str(tmp_path)
    fd = FleetFrontDoor(root, 4, request_timeout_s=15.0,
                        health_interval_s=5.0)
    srv = _port_server()
    corpse = threading.Thread(target=lambda: None)
    corpse.start()
    corpse.join()
    try:
        fd.add_replica(ReplicaHandle(1, thread=corpse))
        fd.add_replica(local_replica(root, 2, 4, srv))
        x = np.zeros((1, IN_DIM), np.float32)
        for _ in range(4):
            assert fd.infer("m", {"data": x})[0].shape == (1, HID)
        st = fd.stats()
        assert st["submitted"] == 4 and st["served"] == 4
        assert st["resubmitted"] >= 1 and st["ejections"] >= 1
        assert fd.ledger_balanced()
        assert fd.replica_status()[1][0] in ("ejected", "dead")
    finally:
        fd.close()
        _stop(srv)


class _HintedServer:
    """Rejects with a hinted ``QueueFull`` twice, then serves."""

    def __init__(self):
        self.calls = 0

    def infer(self, name, inputs, timeout_ms=None, priority=None):
        self.calls += 1
        if self.calls <= 2:
            raise QueueFull("replica saturated", retry_after_s=0.123)
        return [np.ones((1, HID), np.float32)]


def test_remote_retry_after_hint_floors_client_backoff(tmp_path):
    sleeps = []
    bo = BackoffPolicy(retries=5, base_s=1e-4, max_s=2e-4, jitter=0.0,
                       seed=0, sleep=sleeps.append)
    fd = FleetFrontDoor(str(tmp_path), 2, request_timeout_s=10.0,
                        submit_retries=3, health_interval_s=5.0,
                        submit_backoff=bo)
    try:
        fd.add_replica(local_replica(str(tmp_path), 1, 2, _HintedServer()))
        out = fd.infer("m", np.zeros((1, IN_DIM), np.float32))
        np.testing.assert_allclose(out[0], 1.0)
        assert len(sleeps) == 2 and all(s >= 0.123 for s in sleeps)
        st = fd.stats()
        assert st["retried"] == 2 and st["hint_floors"] == 2
        assert st["last_retry_after_s"] == pytest.approx(0.123)
        assert st["served"] == 1 and fd.ledger_balanced()
    finally:
        fd.close()


def test_error_codec_matches_the_jax_package():
    e = decode_error(encode_error(QueueFull("busy", retry_after_s=0.5)))
    assert isinstance(e, QueueFull) and e.retry_after_s == 0.5
    assert isinstance(decode_error(encode_error(ModelNotFound("nope"))),
                      ModelNotFound)
    assert type(decode_error(encode_error(ValueError("boom")))) \
        is ServingError
    for exc in (QueueFull("busy", retry_after_s=0.5), ModelNotFound("x"),
                ValueError("boom")):
        assert encode_error(exc) == jfleet.encode_error(exc)
    wire = jfleet.encode_error(jmx.serving.QueueFull("b", retry_after_s=1.5))
    assert decode_error(wire).retry_after_s == 1.5


def test_ejected_replica_readmitted_by_probe(tmp_path):
    fd = FleetFrontDoor(str(tmp_path), 2, health_interval_s=0.05,
                        probe_retries=5)
    srv = _port_server()
    try:
        fd.add_replica(local_replica(str(tmp_path), 1, 2, srv))
        fd._eject(1, "drill")
        assert fd.replica_status()[1][0] == "ejected"
        deadline = time.monotonic() + 10
        while fd.replica_status()[1][0] != "healthy" \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fd.replica_status()[1] == ("healthy", None)
        assert fd.stats()["readmissions"] == 1
    finally:
        fd.close()
        _stop(srv)


def test_probe_budget_exhaustion_marks_dead(tmp_path):
    fd = FleetFrontDoor(str(tmp_path), 2, health_interval_s=0.03,
                        probe_retries=1, probe_timeout_s=0.05)
    stop = threading.Event()
    silent = threading.Thread(target=stop.wait, daemon=True)
    silent.start()
    try:
        fd.add_replica(ReplicaHandle(1, thread=silent, stop_event=stop))
        fd._eject(1, "drill")
        deadline = time.monotonic() + 10
        while fd.replica_status()[1][0] != "dead" \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fd.replica_status()[1] == ("dead", "drill")
    finally:
        fd.close()


def test_process_replica_serves_and_a_sigkill_resubmits(tmp_path):
    """``spawn_replica(..., ctx=cpu())``: the child builds the linear
    model from the seed (the JAX fleet's answers within 1e-6); SIGKILLed,
    it is ejected and the next request lands on the survivor."""
    root = str(tmp_path)
    fd = FleetFrontDoor(root, 3, request_timeout_s=30.0,
                        health_interval_s=0.1)
    srv = _port_server()
    try:
        proc = fd.add_replica(spawn_replica(root, 1, 3, seed=0,
                                            ctx=tmx.cpu()))
        x = np.random.RandomState(2).randn(2, IN_DIM).astype(np.float32)
        deadline = time.monotonic() + 120
        while True:
            try:
                got = fd.infer("m", x)
                break
            except ServingError:
                assert time.monotonic() < deadline, fd.replica_status()
                time.sleep(0.2)
        ref = _model_server(jmx)
        try:
            want = ref.infer("m", x)
        finally:
            _stop(ref)
        np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
        fd.add_replica(local_replica(root, 2, 3, srv))
        proc.kill()
        for _ in range(3):
            np.testing.assert_allclose(fd.infer("m", x)[0], want[0],
                                       rtol=TOL, atol=TOL)
        assert fd.replica_status()[1][0] in ("ejected", "dead")
        assert fd.ledger_balanced()
    finally:
        fd.close()
        _stop(srv)


def test_a_replica_without_the_card_it_was_asked_for_is_ejected(tmp_path):
    """No fallback hides the device: a child asked for a GPU on a machine
    without one exits at start, and the front door ejects it."""
    if tmx.num_gpus():
        pytest.skip("this machine has a card")
    root = str(tmp_path)
    fd = FleetFrontDoor(root, 2, request_timeout_s=30.0,
                        health_interval_s=0.05)
    try:
        h = fd.add_replica(spawn_replica(root, 1, 2, ctx=tmx.gpu(0)))
        h.proc.wait(timeout=120)
        assert h.proc.returncode not in (0, None)
        deadline = time.monotonic() + 10
        while fd.replica_status()[1][0] == "healthy" \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fd.replica_status()[1][0] in ("ejected", "dead")
    finally:
        fd.close()


SMOKE_PLAN = {
    "seed": 13,
    "rules": [
        {"site": "transport.send.ack", "kind": "lost_ack", "p": 0.35,
         "times": 0},
        {"site": "transport.send", "kind": "slow_link",
         "delay_s": 0.001, "p": 0.3, "times": 0},
        {"site": "transport.send", "kind": "reorder", "p": 0.2,
         "times": 0},
    ],
}


def test_two_process_smoke_drill(tmp_path):
    """Coordinator (this process) + one port ``--kv-worker`` subprocess
    on the CPU under seeded lost_ack/reorder weather: every acked
    gradient applied exactly once and the worker's replay witness
    holds."""
    pushes = 8
    report = str(tmp_path / "kv-report.json")
    env = dict(os.environ)
    env.update({"MXNET_KVSTORE_ASYNC_DIR": str(tmp_path),
                "DMLC_WORKER_ID": "1", "DMLC_NUM_WORKER": "2",
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
                "MXNET_FAULT_PLAN": json.dumps(SMOKE_PLAN)})
    saved = {k: os.environ.get(k) for k in ("MXNET_KVSTORE_ASYNC_DIR",
                                            "DMLC_WORKER_ID",
                                            "DMLC_NUM_WORKER")}
    os.environ.update({"MXNET_KVSTORE_ASYNC_DIR": str(tmp_path),
                       "DMLC_WORKER_ID": "0", "DMLC_NUM_WORKER": "2"})
    kv = None
    try:
        kv = tmx.kv.create("dist_async")
        kv._set_updater(lambda i, g, w: w.__isub__(0.1 * g))
        kv.init("w", nd.zeros((4,), ctx=tmx.cpu()))
        proc = subprocess.run(
            [sys.executable, "-u", "-m", "mxnet_tpu_torch.fault.drill",
             "--kv-worker", "--pushes", str(pushes), "--report", report,
             "--ctx", "cpu"],
            env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        with open(report) as f:
            rec = json.load(f)
        assert rec["final"] and rec["acked"] + rec["failed"] == pushes
        assert rec.get("injected", 0) >= 1
        assert rec.get("replay_identical") is True
        assert kv.wait_to_drain(timeout=30)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                kv._transport.stats()["received"] > len(kv._applied_log):
            time.sleep(0.02)
        ids = [i for _k, i in kv._applied_log]
        applied = len(ids)
        assert len(set(ids)) == applied
        assert rec["acked"] <= applied <= rec["acked"] + rec["failed"]
        got = nd.zeros((4,), ctx=tmx.cpu())
        kv.pull("w", out=got)
        np.testing.assert_allclose(got.asnumpy(), -0.1 * applied,
                                   rtol=1e-6)
    finally:
        if kv is not None:
            kv.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_the_linear_model_is_the_same_in_both_replicas():
    """The linear test model from a seed is the JAX replica's."""
    x = np.random.RandomState(9).randn(3, IN_DIM).astype(np.float32)
    p, j = _port_server(seed=3), _model_server(jmx, seed=3)
    try:
        np.testing.assert_allclose(p.infer("m", x)[0], j.infer("m", x)[0],
                                   rtol=TOL, atol=TOL)
    finally:
        _stop(p, j)


# -- phase 24's rehearsal ------------------------------------------------------

@pytest.mark.slow
def test_chip_smoke_fleet_phase_rehearses_on_the_cpu(tmp_path):
    """Phase 24 (a)-(d) at small width on the CPU: the front door over
    three ResNet replica processes (one SIGKILLed, a wave under network
    weather; the ledger exactly-once, every answer against a Predictor at
    its bucket), dist_async fit in two ``tools/launch.py`` workers (every
    push applied once, a worker's pull equal to the server's weights, the
    loss falling), ``Module(context=[cpu(0), cpu(0)])``'s first step
    against the one-executor-a-slice oracle, and the drills; the launch
    counts hold only on the card.  Slow: seven processes start, ~35 s;
    its parts run in tier 1 by themselves (the tests above, the
    transport, dist_async and drill files, and the next test)."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    cfg = dict(cs.FLEET, ctx="cpu", layers=8, image=(3, 16, 16),
               max_batch=8, requests=24, clients=4, async_batch=4,
               async_warmup=1, async_timed=2, mc_batch=4, mc_warmup=1,
               mc_timed=1, soak_s=2.0, soak_min_faults=20, timeout=240)
    sym = cs.resnet_symbol(cfg["layers"], cfg["image"])
    n_sites = len(cs.k3_sites(tmx, sym, 1, cfg["image"]))
    rec = cs.fleet_phase(tmx, ck, sym, n_sites, "cpu", cfg=cfg,
                         workdir_parent=str(tmp_path))
    fl, af, mc = rec["front_door"], rec["dist_async"], rec["multi_context"]
    assert fl["ledger"]["served"] == fl["ledger"]["submitted"] == 48
    assert fl["ledger"]["resubmitted"] >= 1
    assert fl["answers_max_abs_err"] <= cs.CROSS_SHAPE_TOL
    assert af["applied"] == af["expected"] == 2 * 3 * af["keys"]
    assert af["replay"]["bitwise"] == af["replay"]["arrays"] == af["keys"]
    assert mc["first_step"]["max_rel"] <= 1e-6
    assert rec["drills"]["parity"]["bitwise_equal_vs_per_array"]
    assert rec["launches_drill"] == {"sgd_sweep": 0, "sgd_mom_sweep": 0,
                                     "adam_sweep": 0}


def test_chip_smoke_multi_context_step_rehearses_on_the_cpu():
    """Phase 24 (c) alone at small width: ``Module(context=[cpu(0),
    cpu(0)])``'s first step within 1e-6 of one executor a slice with the
    gradients summed and the same per-array SGD, then the timed steps."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    cfg = dict(cs.FLEET, layers=8, image=(3, 16, 16), mc_batch=4,
               mc_warmup=1, mc_timed=1)
    sym = cs.resnet_symbol(cfg["layers"], cfg["image"])
    rec = cs.multi_context_fit(tmx, ck, sym, cfg, [tmx.cpu(0), tmx.cpu(0)])
    assert rec["slices"] == [[0, 2], [2, 4]]
    assert rec["first_step"]["max_rel"] <= 1e-6
    assert rec["first_step"]["bitwise"] >= 1
    assert rec["launches"] == dict.fromkeys(rec["launches"], 0)
