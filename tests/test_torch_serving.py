"""The port's ModelServer on the CPU, and the guards that keep the port
apart from JAX and off the CPU unless asked.

The model is a cifar ResNet-8 built by the JAX package and carried over
as JSON and numpy parameters.
"""
import ast
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.io import pad_batch
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.serving import (BadRequest, DeadlineExceeded,
                                     ModelNotFound, ModelServer, QueueFull,
                                     pick_bucket, shape_buckets)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "example", "image-classification",
                                "symbols"))
import resnet as jax_resnet  # noqa: E402

SHAPE = (3, 32, 32)


@pytest.fixture(scope="module")
def model():
    jsym = jax_resnet.get_symbol(10, 8, "3,32,32")
    arg_shapes, _, aux_shapes = jsym.infer_shape(data=(1,) + SHAPE)
    rng = np.random.RandomState(30)
    arg, aux = {}, {}
    for n, shp in zip(jsym.list_arguments(), arg_shapes):
        if n not in ("data", "softmax_label"):
            fan_in = max(1, int(np.prod(shp[1:])))
            arg[n] = (rng.randn(*shp) * np.sqrt(2.0 / fan_in)).astype(
                np.float32)
    for n, shp in zip(jsym.list_auxiliary_states(), aux_shapes):
        aux[n] = ((rng.rand(*shp) + 0.5) if n.endswith("_var")
                  else rng.randn(*shp) * 0.1).astype(np.float32)
    sym = tmx.sym.load_json(jsym.tojson())
    args, auxs = tmx.convert.params_from_numpy(arg, aux, tmx.cpu(),
                                               symbol=sym)
    return sym, args, auxs


def _predict(model, x):
    sym, args, auxs = model
    p = tmx.Predictor.from_parts(sym, args, auxs, {"data": x.shape},
                                 ctx=tmx.cpu())
    return p.forward(data=x).get_output(0).asnumpy()


def _server(model, **kw):
    sym, args, auxs = model
    srv = ModelServer(ctx=tmx.cpu(), **kw)
    srv.add_model("r8", sym, args, auxs, {"data": (1,) + SHAPE})
    return srv


def test_server_answers_equal_predictor_whatever_the_batch(model):
    srv = _server(model, max_batch=4, batch_wait_ms=50.0)
    srv.start()
    try:
        warmed = srv.warmup("r8")
        assert [b for (_, _, b) in warmed] == [1, 2, 4]
        rng = np.random.RandomState(31)
        rows = [1, 2, 3, 1, 2, 1]
        xs = [rng.randn(r, *SHAPE).astype(np.float32) for r in rows]
        futs = [srv.infer_async("r8", {"data": x}) for x in xs]
        outs = [f.result() for f in futs]
        for x, out in zip(xs, outs):
            assert len(out) == 1 and out[0].shape == (x.shape[0], 10)
            np.testing.assert_allclose(out[0], _predict(model, x),
                                       rtol=1e-5, atol=1e-6)
        # a bare sample (no batch axis) is one row
        single = srv.infer("r8", xs[0][0])[0]
        np.testing.assert_allclose(single, _predict(model, xs[0]),
                                   rtol=1e-5, atol=1e-6)
        st = srv.stats()
    finally:
        srv.stop()
    assert st["requests"]["submitted"] == 3 + len(rows) + 1
    assert st["requests"]["served"] == st["requests"]["submitted"]
    assert st["executor_cache"]["misses"] == 3      # one bind per bucket
    assert st["latency_ms"]["count"] == st["requests"]["served"]
    assert st["latency_ms"]["p50"] <= st["latency_ms"]["p99"]
    assert st["batches"]["rows"] == 7 + sum(rows) + 1
    assert set(st["batches"]["occupancy"]) <= {1, 2, 4}
    assert st["device"] == "cpu"


def test_server_concurrent_clients_ledger_balances(model):
    """More client threads than cores, with a short switch interval: every
    accepted request is served exactly once."""
    srv = _server(model, max_batch=4, batch_wait_ms=1.0)
    srv.start()
    errors, results = [], []
    lock = threading.Lock()
    rng = np.random.RandomState(32)
    xs = [rng.randn(1 + i % 3, *SHAPE).astype(np.float32) for i in range(24)]

    def client(x):
        try:
            out = srv.infer("r8", {"data": x}, timeout_ms=60000)[0]
            with lock:
                results.append((x, out))
        except Exception as exc:    # noqa: BLE001 — reported below
            with lock:
                errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(x,)) for x in xs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        srv.stop()
    assert not errors
    assert len(results) == len(xs)
    req = srv.stats()["requests"]
    assert req["submitted"] == req["served"] == len(xs)
    for x, out in results[:4]:
        np.testing.assert_allclose(out, _predict(model, x), rtol=1e-5,
                                   atol=1e-6)


def test_failed_batch_fails_its_futures_and_batcher_survives(model,
                                                             monkeypatch):
    srv = _server(model, max_batch=2)
    srv.start()
    try:
        calls = {"n": 0}
        real = srv.cache.get

        def flaky(entry, bucket):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("poisoned bind")
            return real(entry, bucket)

        monkeypatch.setattr(srv.cache, "get", flaky)
        x = np.zeros((1,) + SHAPE, np.float32)
        with pytest.raises(RuntimeError, match="poisoned"):
            srv.infer("r8", x)
        assert srv.infer("r8", x)[0].shape == (1, 10)
    finally:
        srv.stop()
    req = srv.stats()["requests"]
    assert req["failed"] == 1 and req["served"] == 1


def test_server_rejections_are_typed(model):
    srv = _server(model, max_batch=2, queue_depth=1)
    x = np.zeros((1,) + SHAPE, np.float32)
    with pytest.raises(ModelNotFound):
        srv.infer_async("nope", x)
    with pytest.raises(BadRequest, match="exceed"):
        srv.infer_async("r8", np.zeros((3,) + SHAPE, np.float32))
    with pytest.raises(BadRequest, match="sample shape"):
        srv.infer_async("r8", np.zeros((1, 3, 8, 8), np.float32))
    with pytest.raises(BadRequest, match="unknown"):
        srv.infer_async("r8", {"data": x, "extra": x})
    fut = srv.infer_async("r8", x, timeout_ms=1.0)   # batcher not started
    with pytest.raises(QueueFull):
        srv.infer_async("r8", x)
    with pytest.raises(DeadlineExceeded):
        fut.result()
    srv.stop()
    st = srv.stats()["requests"]
    assert st["rejected_queue_full"] == 1
    assert st["submitted"] == st["served"] + st["failed"] + st["expired"]


def test_warmup_inline_before_start(model):
    srv = _server(model, buckets=[1, 2])
    assert srv.warmup() == [("r8", 1, 1), ("r8", 1, 2)]
    assert srv.stats()["executor_cache"]["misses"] == 2
    with pytest.raises(ValueError, match="ladder"):
        srv.warmup(buckets=[3])


def test_buckets_and_pad_batch():
    assert shape_buckets(32) == [1, 2, 4, 8, 16, 32]
    assert shape_buckets(12) == [1, 2, 4, 8, 12]
    assert pick_bucket(3, [1, 2, 4]) == 4 and pick_bucket(5, [1, 2, 4]) is None
    batch, rows = pad_batch([np.ones((1, 2)), 2 * np.ones((2, 2))], 4)
    assert rows == 3 and batch.shape == (4, 2)
    assert (batch[3] == batch[2]).all()        # repeats the last row
    with pytest.raises(ValueError):
        pad_batch([np.ones((3, 2))], 2)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------
def test_import_leaves_jax_and_the_jax_package_out():
    code = ("import sys, mxnet_tpu_torch; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _forbidden_imports(source):
    tree = ast.parse(source)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            if top in ("jax", "jaxlib", "mxnet_tpu"):
                bad.append(m)
    return bad


def test_port_sources_never_import_jax_or_the_jax_package():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(os.path.join(REPO, "mxnet_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]    # build outputs
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 20
    found = {}
    for p in paths:
        with open(p) as f:
            found[p] = _forbidden_imports(f.read())
    assert not {p: b for p, b in found.items() if b}
    # the scan tells the port's own name apart from the JAX package's
    probe = ("import mxnet_tpu_torch\nfrom mxnet_tpu_torch.ops import nn\n"
             "import mxnet_tpu.ops as m\nfrom jax import numpy\n")
    assert _forbidden_imports(probe) == ["mxnet_tpu.ops", "jax"]


def test_entry_points_without_gpu_raise_naming_the_gpu(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sym, args, auxs = model
    with pytest.raises(MXNetError, match="GPU"):
        ModelServer()
    with pytest.raises(MXNetError, match="GPU"):
        tmx.Predictor.from_parts(sym, args, auxs, {"data": (1,) + SHAPE})
    with pytest.raises(MXNetError, match="GPU"):
        sym.simple_bind(data=(1,) + SHAPE)
    with pytest.raises(MXNetError, match="GPU"):
        tmx.nd.zeros((2, 2))
    assert tmx.tpu(0) == tmx.gpu(0)


def test_predictor_refuses_parameters_on_another_device(model):
    sym, args, auxs = model
    meta = {k: tmx.nd.NDArray(v._data.to("meta")) for k, v in args.items()}
    with pytest.raises(MXNetError, match="bound with"):
        tmx.Predictor.from_parts(sym, meta, auxs, {"data": (1,) + SHAPE},
                                 ctx=tmx.cpu())


def test_cpu_serving_launches_no_kernel(model, monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS_BN_RELU", "1")
    monkeypatch.setenv("MXNET_PALLAS_SOFTMAX", "1")
    ck.reset_kernel_calls()
    x = np.random.RandomState(33).randn(2, *SHAPE).astype(np.float32)
    forced = _predict(model, x)
    assert set(ck.kernel_calls().values()) == {0}
    monkeypatch.setenv("MXNET_PALLAS_BN_RELU", "0")
    monkeypatch.setenv("MXNET_PALLAS_SOFTMAX", "0")
    np.testing.assert_allclose(forced, _predict(model, x), rtol=0,
                               atol=1e-6)
