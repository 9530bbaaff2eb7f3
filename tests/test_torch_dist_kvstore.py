"""The port's ``dist_sync`` kvstore (``mxnet_tpu_torch.kvstore.KVStoreDist``)
over real rank processes: the JAX package's two-worker assertions
(``tests/test_dist_kvstore.py``), the ``transport.collective`` fault
site, and a ``dist_sync`` ``Module.fit`` at two ranks held to
``kvstore="device"`` on the whole global batch.  Each test's world (two
gloo ranks on the CPU, ``chip_smoke.run_ranks``) meets through a
``file://`` store under its own temporary directory.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

import chip_smoke as cs

torch.set_num_threads(1)


def _jtrainer(case):
    """``chip_smoke.par_case_trainer`` in the JAX package, on its first
    ``width`` devices."""
    return cs.par_case_trainer(jmx, case,
                               devices=jax.devices()[:case["width"]])


def test_dist_sync_two_ranks(tmp_path):
    seen = cs.run_ranks("chip_smoke:dist_kv_rank", 2, (str(tmp_path / "hb"),),
                        workdir=str(tmp_path), threads=1, timeout=240)
    for rank, s in enumerate(seen):
        assert (s["rank"], s["num_workers"], s["type"]) == (
            rank, 2, "KVStoreDist")
        # every rank holds rank 0's value after init
        np.testing.assert_array_equal(s["init"], 1.0)
        # with no updater the summed push (1 + 2) replaces the value
        np.testing.assert_array_equal(s["push"], 3.0)
        # a per-device list merges locally, then over the ranks
        np.testing.assert_array_equal(s["list_push"], 4.0)
        # the updater sees the summed gradient: -0.1 * (1 + 2)
        np.testing.assert_allclose(s["updater"], -0.3, rtol=1e-6)
        assert s["dead"] == 0


@pytest.mark.parametrize("compression", [None, {"type": "2bit",
                                                "threshold": 0.05}],
                         ids=["fp32", "2bit"])
def test_dist_sync_fit_equals_device_on_the_global_batch(tmp_path,
                                                        compression):
    """Two ranks, each on its half of every global batch of 16, under
    dist_sync: the replicas stay equal, the optimizer rescales by the
    global batch (the reference's rule) and the weights equal one
    process's kvstore="device" fit of the whole batches.  With 2bit
    compression each rank quantizes its own half's gradient before the
    sum, so the weights move otherwise (and still equally on both
    ranks)."""
    out = cs.run_ranks("chip_smoke:dist_fit_rank", 2, (16, 3, compression),
                       workdir=str(tmp_path), threads=1, timeout=240)
    assert out[0]["digest"] == out[1]["digest"]
    assert out[0]["rescale"] == out[0]["device_rescale"] == 1.0 / 16
    dist, dev = out[0]["dist"], out[0]["device"]
    big = max(float(np.abs(v).max()) for v in dev.values())
    worst = max(float(np.abs(dist[k] - dev[k]).max()) for k in dev)
    if compression is None:
        assert worst <= 1e-6 * big, worst
    else:
        assert worst > 1e-3 * big


def test_transport_collective_fault_site():
    """Every reduce of the dist store crosses one named site, so a plan
    can fail the step (here in a lone process: the site fires before the
    world of one skips the collective)."""
    from mxnet_tpu_torch import fault
    plan = {"rules": [{"site": "transport.collective", "kind": "raise",
                       "exc": "ConnectionError", "times": 1}]}
    with tmx.cpu():
        kv = tmx.kv.create("dist_sync")
        assert (kv.rank, kv.num_workers) == (0, 1)
        kv.init("w", tmx.nd.ones((3,)))
        with fault.active_plan(plan) as armed:
            with pytest.raises(ConnectionError):
                kv.push("w", tmx.nd.ones((3,)))
            kv.push("w", tmx.nd.ones((3,)))
            hits = armed.stats()["hits"]["transport.collective"]
            injected = armed.injected_count("transport.collective")
        out = tmx.nd.zeros((3,))
        kv.pull("w", out=out)
    # the failed push left the value alone; the second one replaced it
    np.testing.assert_array_equal(out.asnumpy(), 1.0)
    assert (hits, injected) == (2, 1)


@pytest.mark.parametrize("kind", ["local", "device", "tpu"])
def test_a_store_without_updater_keeps_the_merged_push(kind):
    """The reference's local store assigns the merged value when it runs
    no optimizer (kvstore_local.h ``local = merged``); the JAX package
    adds it into the stored value (ROADMAP queue 3), so this is held to
    numpy.  The stored value is a copy: the caller's array stays its own."""
    rng = np.random.RandomState(7)
    w0, g1, g2 = (rng.randn(3, 4).astype(np.float32) for _ in range(3))
    kv = tmx.kv.create(kind)
    kv.init("w", tmx.nd.array(w0, ctx=tmx.cpu()))
    a, b = tmx.nd.array(g1, ctx=tmx.cpu()), tmx.nd.array(g2, ctx=tmx.cpu())
    out = tmx.nd.zeros((3, 4), ctx=tmx.cpu())
    kv.push("w", [a, b])
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out.asnumpy(), g1 + g2)
    kv.push("w", a)
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out.asnumpy(), g1)
    a[:] = 0.0
    np.testing.assert_array_equal(out.asnumpy(), g1)


def test_create_and_roles_follow_the_jax_package(monkeypatch):
    with tmx.cpu():
        for name in ("dist_sync", "dist_device_sync", "dist"):
            assert type(tmx.kv.create(name)).__name__ == "KVStoreDist"
    kv, jkv = tmx.kv.create("dist_async"), jmx.kv.create("dist_async")
    assert type(kv).__name__ == type(jkv).__name__ == "KVStoreDistAsync"
    kv.close()
    jkv.close()
    with pytest.raises(tmx.MXNetError, match="unknown"):
        tmx.kv.create("dist_nope")
    for env in ({}, {"DMLC_ROLE": "server"}, {"DMLC_ROLE": "scheduler"},
                {"DMLC_ROLE": "worker", "DMLC_WORKER_ID": "3"},
                {"DMLC_WORKER_ID": "0"}):
        for k in ("DMLC_ROLE", "DMLC_WORKER_ID"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for fn in ("is_worker_node", "is_server_node", "is_scheduler_node"):
            assert getattr(tmx.kv, fn)() == getattr(jmx.kv, fn)(), (env, fn)


def test_lone_process_heartbeat_and_dead_nodes(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_HEARTBEAT_DIR", str(tmp_path / "hb"))
    with tmx.cpu():
        kv = tmx.kv.create("dist_sync")
        assert (tmp_path / "hb" / "worker-0.hb").exists()
        assert kv.get_num_dead_node(timeout_sec=300) == 0
        assert kv.get_num_dead_node(timeout_sec=-1) == 1
        kv.barrier()


LAUNCHED = r"""
import json, sys
import numpy as np
sys.path[:0] = [%(repo)r]
import mxnet_tpu_torch as mx
import chip_smoke as cs

with mx.cpu():
    # the script a user writes: no init call, no rank arithmetic
    case = {"net": "mlp", "opt": "adam", "opt_params": {"learning_rate": 0.05},
            "zero": 2, "width": 2, "steps": 3}
    tr = cs.par_case_trainer(mx, case)
    res = cs.par_case_run(mx, tr, case)
    kv = mx.kv.create("dist_sync")
    kv.init("w", mx.nd.array(np.full((2,), float(kv.rank + 1), np.float32)))
    out = mx.nd.zeros((2,))
    kv.pull("w", out=out)
    kv.barrier()
    with open(%(out)r + "/result-%%d.json" %% kv.rank, "w") as f:
        json.dump({"rank": kv.rank, "world": kv.num_workers,
                   "losses": res["losses"], "w": out.asnumpy().tolist()}, f)
mx.parallel.distributed.shutdown()
"""


REPO = os.path.dirname(os.path.abspath(cs.__file__))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launched_results(cmd, out):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable] + cmd, capture_output=True,
                          text=True, timeout=240, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    results = []
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name)) as f:
            results.append(json.load(f))
    return results


@pytest.mark.parametrize("launcher", ["tools/launch.py", "torchrun"])
def test_a_training_script_runs_unchanged_under_the_launchers(tmp_path,
                                                             launcher):
    """The same script under ``tools/launch.py -n 2 --launcher local``
    (its DMLC_* environment) and under torchrun (RANK, WORLD_SIZE,
    MASTER_ADDR): two ranks join one gloo world, ParallelTrainer steps the
    JAX package's numbers and dist_sync broadcasts rank 0's value."""
    script = tmp_path / "train.py"
    out = tmp_path / "results"
    out.mkdir()
    script.write_text(LAUNCHED % {"repo": REPO, "out": str(out)})
    if launcher == "torchrun":
        cmd = ["-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", str(script)]
    else:
        cmd = [os.path.join(REPO, "tools", "launch.py"), "-n", "2",
               "--launcher", "local", "--root-port", str(_free_port()),
               sys.executable, str(script)]
    got = _launched_results(cmd, str(out))
    assert [r["rank"] for r in got] == [0, 1]
    assert all(r["world"] == 2 for r in got)
    assert all(r["w"] == [1.0, 1.0] for r in got)
    case = {"net": "mlp", "opt": "adam",
            "opt_params": {"learning_rate": 0.05}, "zero": 2, "width": 2,
            "steps": 3}
    want = cs.par_case_run(jmx, _jtrainer(case), case)
    np.testing.assert_allclose(got[0]["losses"], want["losses"], rtol=0,
                               atol=1e-6)
    assert got[0]["losses"] == got[1]["losses"]


def test_sync_rescale_follows_the_reference_not_the_jax_package():
    """A synchronous dist store sums every worker's batch, so the
    reference's Module rescales the gradient by the global batch
    (``'_sync' in kvstore.type``); the JAX package tests ``'_async'``
    (``mxnet_tpu/module/module.py:319-320``), so its dist_sync update is
    num_workers times too large.  Two workers are simulated with a store
    that reports them."""
    def rescale(mx, ctx):
        class TwoWorkers(mx.kv.KVStore):
            @property
            def num_workers(self):
                return 2

        data = mx.sym.Variable("data")
        net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            data, num_hidden=3, name="fc"), name="softmax")
        with ctx:
            mod = mx.mod.Module(net, context=ctx)
            mod.bind([("data", (8, 5))], [("softmax_label", (8,))])
            mod.init_params()
            mod.init_optimizer(kvstore=TwoWorkers("dist_sync"),
                               optimizer="sgd")
        return mod._optimizer.rescale_grad

    assert rescale(tmx, tmx.cpu()) == 1.0 / 16
    assert rescale(jmx, jmx.cpu()) == 1.0 / 8
