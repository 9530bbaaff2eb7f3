"""The port's ``dist_async`` store (``KVStoreDistAsync``) and
``kvstore_server`` against the JAX package's (the async cases of
``tests/test_dist_kvstore.py``): update on arrival with the same updater
and pushes (bitwise in one process), a second worker process, the spool
bounded under a stalled server, the server roles, and
``Module.fit(kvstore="dist_async")``'s update-on-kvstore path.

The worker child asks for the CPU itself (``ctx=mx.cpu()`` on its
arrays); every child has a time limit."""
import glob
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASYNC_ENV = ("MXNET_KVSTORE_ASYNC_DIR", "DMLC_WORKER_ID", "DMLC_NUM_WORKER",
             "MXNET_KVSTORE_ASYNC_MAX_PENDING",
             "MXNET_KVSTORE_ASYNC_BACKPRESSURE_TIMEOUT", "DMLC_ROLE")


@pytest.fixture(autouse=True)
def _clean_env():
    saved = {k: os.environ.get(k) for k in ASYNC_ENV}
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _arrivals(mx, root, ctx):
    os.environ["MXNET_KVSTORE_ASYNC_DIR"] = root
    kv = mx.kv.create("dist_async")
    assert type(kv).__name__ == "KVStoreDistAsync"
    arrivals = []

    def updater(key_int, grad, weight):
        arrivals.append(float(grad.asnumpy()[0, 0]))
        weight -= 0.1 * grad

    kv._set_updater(updater)
    kv.init("w", mx.nd.zeros((2, 2), ctx=ctx))
    rng = np.random.RandomState(3)
    grads = [rng.randn(2, 2).astype(np.float32) for _ in range(3)]
    for g in grads:
        kv.push("w", mx.nd.array(g, ctx=ctx))
    deadline = time.time() + 10
    while len(arrivals) < 3 and time.time() < deadline:
        time.sleep(0.01)
    out = mx.nd.zeros((2, 2), ctx=ctx)
    kv.pull("w", out=out)
    log = list(kv._applied_log)
    kv.close()
    return arrivals, out.asnumpy(), grads, log


def test_update_on_arrival_matches_the_jax_package(tmp_path):
    """Pushes with no pull between them are applied on arrival, in
    arrival order, and the weight is the JAX store's bit for bit."""
    pa, pw, grads, plog = _arrivals(tmx, str(tmp_path / "p"), tmx.cpu())
    ja, jw, _, jlog = _arrivals(jmx, str(tmp_path / "j"), jmx.cpu())
    assert pa == ja == [float(g[0, 0]) for g in grads]
    np.testing.assert_array_equal(pw, jw)
    assert [k for k, _ in plog] == [k for k, _ in jlog] == ["w"] * 3


WORKER = r"""
import sys, time
import numpy as np
sys.path.insert(0, %(repo)r)
import mxnet_tpu_torch as mx
ctx = mx.cpu()
kv = mx.kv.create("dist_async")
kv.init("w", mx.nd.zeros((2, 3), ctx=ctx))   # adopts the coordinator's
kv.push("w", mx.nd.array(np.full((2, 3), 4.0, np.float32), ctx=ctx))
deadline = time.time() + 20
out = mx.nd.zeros((2, 3), ctx=ctx)
while time.time() < deadline:
    kv.pull("w", out=out)
    if abs(float(out.asnumpy()[0, 0]) - 1.0) < 1e-6:
        print("WORKER_SAW_UPDATE")
        break
    time.sleep(0.05)
else:
    raise SystemExit("worker never saw the update")
"""


def test_two_processes(tmp_path):
    """A second worker process spools a push; the coordinator applies it
    on arrival and the worker pulls the updated weights."""
    env = dict(os.environ, MXNET_KVSTORE_ASYNC_DIR=str(tmp_path),
               DMLC_WORKER_ID="1", DMLC_NUM_WORKER="2")
    os.environ.update({"MXNET_KVSTORE_ASYNC_DIR": str(tmp_path),
                       "DMLC_WORKER_ID": "0", "DMLC_NUM_WORKER": "2"})
    kv = tmx.kv.create("dist_async")
    try:
        kv._set_updater(lambda i, g, w: w.__isub__(0.25 * g))
        kv.init("w", tmx.nd.array(np.full((2, 3), 2.0, np.float32),
                                  ctx=tmx.cpu()))
        out = subprocess.run([sys.executable, "-c", WORKER % {"repo": REPO}],
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert "WORKER_SAW_UPDATE" in out.stdout, out.stderr[-2000:]
        got = tmx.nd.zeros((2, 3), ctx=tmx.cpu())
        kv.pull("w", out=got)
        np.testing.assert_array_equal(got.asnumpy(), 1.0)
    finally:
        kv.close()


def test_spool_bounded_under_a_stalled_server(tmp_path):
    """With the server thread stalled, concurrent pushers hit the cap,
    block, then raise past the backpressure timeout; the spool holds
    exactly the cap."""
    os.environ.update({"MXNET_KVSTORE_ASYNC_DIR": str(tmp_path),
                       "MXNET_KVSTORE_ASYNC_MAX_PENDING": "3",
                       "MXNET_KVSTORE_ASYNC_BACKPRESSURE_TIMEOUT": "1.0"})
    kv = tmx.kv.create("dist_async")
    kv.init("w", tmx.nd.zeros((2, 2), ctx=tmx.cpu()))
    kv._stop.set()
    kv._server.join(timeout=5)
    g = tmx.nd.array(np.ones((2, 2), np.float32), ctx=tmx.cpu())
    errors = []

    def spam():
        try:
            for _ in range(5):
                kv.push("w", g)
        except MXNetError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=spam) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(errors) == 4
    assert all("backpressure" in e for e in errors)
    assert len(glob.glob(str(tmp_path / "push" / "*.npz"))) == 3
    assert not kv.wait_to_drain(timeout=0.1)


def test_workers_need_a_shared_directory():
    os.environ.pop("MXNET_KVSTORE_ASYNC_DIR", None)
    os.environ.update({"DMLC_WORKER_ID": "1", "DMLC_NUM_WORKER": "2"})
    with pytest.raises(MXNetError, match="MXNET_KVSTORE_ASYNC_DIR"):
        tmx.kv.create("dist_async")


@pytest.mark.parametrize("role", ["worker", "server", "scheduler", ""])
def test_kvstore_server_roles_match_the_jax_package(role):
    os.environ["DMLC_ROLE"] = role
    assert tmx.kvstore_server._init_kvstore_server_module() == \
        jmx.kvstore_server._init_kvstore_server_module() == role
    srv = tmx.kvstore_server.KVStoreServer()
    assert srv.run() is None and srv.kvstore is None
    srv._controller()(0, "")
    assert srv.init_logging


def _fit(mx, root, ctx):
    os.environ.update({"MXNET_KVSTORE_ASYNC_DIR": root})
    rng = np.random.RandomState(0)
    X = rng.randn(12, 5).astype(np.float32)
    y = rng.randint(0, 3, 12).astype(np.float32)
    w = np.random.RandomState(1)
    arg = {"fc_weight": (w.randn(3, 5) * 0.5).astype(np.float32),
           "fc_bias": np.zeros(3, np.float32)}
    d = mx.sym.Variable("data")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        d, num_hidden=3, name="fc"), name="softmax")
    mod = mx.mod.Module(net, context=ctx)
    kv = mx.kv.create("dist_async")
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=4), num_epoch=2, kvstore=kv,
            optimizer="sgd", optimizer_params={"learning_rate": 0.1},
            arg_params={k: mx.nd.array(v, ctx=ctx) for k, v in arg.items()})
    assert mod._update_on_kvstore and kv.wait_to_drain(timeout=30)
    deadline = time.time() + 10
    while len(kv._applied_log) < 2 * 3 * 2 and time.time() < deadline:
        time.sleep(0.01)
    ids = [i for _, i in kv._applied_log]
    out = mx.nd.zeros((3, 5), ctx=ctx)
    kv.pull("fc_weight", out=out)
    got = out.asnumpy()
    np.testing.assert_array_equal(got, kv._store["fc_weight"].asnumpy())
    assert not np.array_equal(got, arg["fc_weight"])
    kv.close()
    return len(ids), len(set(ids))


def test_module_fit_on_dist_async_takes_the_kvstore_path(tmp_path):
    """``Module.fit(kvstore=dist_async)`` takes the update-on-kvstore
    path in both packages: every push (2 keys x 3 batches x 2 epochs)
    applied exactly once, and a pull reads the server's weights.  The
    weights themselves depend on how stale each pull was, which is
    timing, so they are not compared across the packages."""
    assert _fit(tmx, str(tmp_path / "p"), tmx.cpu()) == \
        _fit(jmx, str(tmp_path / "j"), jmx.cpu()) == (12, 12)


def _stale_rounds(mx, root, ctx, workers, momentum, rounds=60, batch=8):
    """``workers`` workers on one dist_async store, in rounds: each pulls
    the server's weights, then each pushes the summed gradient of the same
    least-squares batch at what it pulled, and the round ends when the
    server has applied every push.  All but the first push of a round
    are stale.  SGD at lr 0.02 with ``momentum`` and the reference's
    dist_async rescale, one worker's batch; the batch's curvature times
    the rate is 0.5 at most.  Returns the loss before each round and the
    weights after the last."""
    os.environ["MXNET_KVSTORE_ASYNC_DIR"] = root
    rng = np.random.RandomState(11)
    q, _ = np.linalg.qr(rng.randn(batch, 4))
    x = (q * np.array([25.0, 16.0, 9.0, 4.0]) ** 0.5 * batch ** 0.5) \
        .astype(np.float32)             # curvature x.T x / batch: 25..4
    y = x @ rng.randn(4).astype(np.float32)
    kv = mx.kv.create("dist_async")
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.02, momentum=momentum,
                                      rescale_grad=1.0 / batch))
    kv.init("w", mx.nd.zeros((4,), ctx=ctx))
    out = mx.nd.zeros((4,), ctx=ctx)
    losses = []
    for r in range(rounds):
        pulled = []
        for _ in range(workers):
            kv.pull("w", out=out)
            pulled.append(out.asnumpy().copy())
        losses.append(0.5 * float(np.mean((x @ pulled[0] - y) ** 2)))
        for w in pulled:
            kv.push("w", mx.nd.array(x.T @ (x @ w - y), ctx=ctx))
        deadline = time.time() + 10
        while len(kv._applied_log) < (r + 1) * workers:
            assert time.time() < deadline, "the server stopped applying"
            time.sleep(0.002)
    kv.pull("w", out=out)
    kv.close()
    return np.array(losses), out.asnumpy()


@pytest.mark.parametrize("workers,momentum,grows", [
    (1, 0.9, False), (2, 0.9, True), (2, 0.0, False)],
    ids=["one-worker-momentum", "two-stale-momentum", "two-stale-plain"])
def test_stale_pushes_with_momentum_diverge_in_both_packages(
        tmp_path, workers, momentum, grows):
    """Staleness acts as added momentum: at phase 5's SGD (lr 0.02,
    momentum 0.9, dist_async rescaled by one worker's batch) a batch on
    which one worker converges diverges once a second worker's pushes
    are a step stale, and converges again without the momentum.  The JAX
    package's store follows the same weights within 1e-6 of their
    largest, so the divergence is the update rule's, not the port's."""
    pl, pw = _stale_rounds(tmx, str(tmp_path / "p"), tmx.cpu(), workers,
                           momentum)
    jl, jw = _stale_rounds(jmx, str(tmp_path / "j"), jmx.cpu(), workers,
                           momentum)
    np.testing.assert_allclose(pw, jw, rtol=0,
                               atol=1e-6 * np.abs(jw).max())
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    for losses in (pl, jl):
        if grows:
            assert losses[-1] > 100 * losses[0], losses
        else:
            assert losses[-1] < 0.01 * losses[0], losses
