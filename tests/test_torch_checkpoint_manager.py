"""The port's ``checkpoint/`` package against the JAX package's, on the CPU.

The store's layout is the JAX package's: a checkpoint either package
writes, the other reads with equal arrays, and the two write the same
shard bytes and the same manifest entries for the same arrays (bf16
included: the port writes a bfloat16 tensor's 16-bit words, the bytes the
JAX package writes for an ``ml_dtypes.bfloat16`` array).  A
``CheckpointManager`` checkpoint of a Module moves both ways too.

Then the JAX package's own cases (``tests/test_checkpoint.py``) on the
port: the store's atomic commit, integrity, garbage collection and
retention; the async writer; the manager's restore fallback and step
ids; the bit-identical resume (params, the optimizer's slots and
schedule, the RNG, the iterator) under ``kvstore="local"`` and under the
fused step of ``kvstore="tpu"``; ``fit``'s periodic, final and SIGTERM
saves; ``module_checkpoint``; the serving watcher; telemetry and the
profiler's spans.

The momentum defect: under ``kvstore="tpu"`` the JAX package's
``TrainState`` captures its kvstore's updater, which its fused step never
used, so its resume loses SGD's momentum; the port's captures the fused
step's slots.  ``test_fused_step_resume_keeps_momentum_beside_the_jax_package``
holds both: the port's resume equals its uninterrupted run bit for bit,
the JAX package's does not, and the JAX package's resumed weights equal
the port's resume with the momentum dropped.

Bands: host logic and the port's resume against itself bitwise; the port
against the JAX package on trained weights rtol 1e-5 / atol 1e-6 (fp32
rounding of the two packages' kernels over a few steps).
"""
import json
import os
import signal
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import checkpoint as jck
from mxnet_tpu_torch import checkpoint
from mxnet_tpu_torch.checkpoint import (AsyncCheckpointer, CheckpointManager,
                                        CheckpointStore, IntegrityError,
                                        RetentionPolicy, TrainState,
                                        write_checkpoint)

torch.set_num_threads(1)

CPU = tmx.cpu()
RTOL, ATOL = 1e-5, 1e-6


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _payload(val=0.0):
    return {"arg/w": np.full((4, 3), val, np.float32),
            "arg/b": np.arange(3, dtype=np.float32)}


def _params(val=0.0):
    return {"w": np.full((4, 3), val, np.float32),
            "b": np.arange(3, dtype=np.float32)}


def _blob_data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 4).astype(np.float32)
    y = (X.sum(axis=1) > 2.0).astype(np.float32)
    return X, y


def _net(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.FullyConnected(net, num_hidden=2, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _iter(X, y, shuffle=False, batch_size=8):
    with tmx.cpu():
        return tmx.io.NDArrayIter(X, y, batch_size=batch_size,
                                  shuffle=shuffle)


def _fresh_module(it, seed, kvstore="local", scheduler=True):
    """Bind, init and set up SGD with momentum, deterministically from
    ``seed`` (the port's initializers draw from its CPU generator)."""
    tmx.random.seed(seed)
    mod = tmx.mod.Module(_net(tmx), context=CPU)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=True)
    mod.init_params(tmx.init.Xavier())
    params = {"learning_rate": 0.1, "momentum": 0.9}
    if scheduler:
        params["lr_scheduler"] = tmx.lr_scheduler.FactorScheduler(
            step=2, factor=0.5)
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=params)
    return mod


def _train_steps(mod, it, n):
    done = 0
    while done < n:
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
            done += 1
            if done == n:
                return
        it.reset()


def _host_params(mod):
    arg, aux = mod.get_params()
    return {k: v.asnumpy() for k, v in list(arg.items()) + list(aux.items())}


# ---------------------------------------------------------------------------
# the store's format, both ways
# ---------------------------------------------------------------------------
_RNG = np.random.RandomState(81)
ARRAYS = {
    "arg/fp32": _RNG.randn(3, 4).astype(np.float32),
    "arg/fp16": _RNG.randn(5).astype(np.float16),
    "arg/bf16": _RNG.randn(2, 3).astype(ml_dtypes.bfloat16),
    "aux/int32": _RNG.randint(-9, 9, (2, 3)).astype(np.int32),
    "aux/uint8": _RNG.randint(0, 255, (2, 2, 2)).astype(np.uint8),
    "iter/idx": np.arange(7, dtype=np.int64),
    "scalar": np.array(2.5, np.float32),
    "empty": np.zeros((0, 3), np.float32),
    "fc1/weight": np.ones((2,), np.float32),
    "fc1.weight": np.zeros((3,), np.float32),
}
BLOBS = {"optimizer": b"\x00opaque\xff", "symbol": b'{"nodes": []}'}


def _as_port(v):
    """The array as the port writes it: bf16 as a torch tensor."""
    if v.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
    return v


def _words(v):
    """Raw bytes of a value either store returns."""
    if isinstance(v, torch.Tensor):
        return v.contiguous().view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(v).tobytes()


def _tree(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def test_stores_write_the_same_bytes(tmp_path):
    jpath = jck.CheckpointStore(str(tmp_path / "jax")).write(
        4, ARRAYS, blobs=BLOBS, meta={"epoch": 1})
    tpath = CheckpointStore(str(tmp_path / "port")).write(
        4, {k: _as_port(v) for k, v in ARRAYS.items()}, blobs=BLOBS,
        meta={"epoch": 1})
    jt, tt = _tree(jpath), _tree(tpath)
    assert sorted(jt) == sorted(tt)
    for name in jt:
        if name != "manifest.json":
            assert jt[name] == tt[name], name
    jm, tm = json.loads(jt["manifest.json"]), json.loads(tt["manifest.json"])
    assert jm == tm
    assert jm["shards"]["arg/bf16"]["dtype"] == "bfloat16"


def test_a_jax_written_checkpoint_reads_here(tmp_path):
    jck.CheckpointStore(str(tmp_path)).write(2, ARRAYS, blobs=BLOBS,
                                             meta={"k": [1, 2]})
    manifest, arrays, blobs = CheckpointStore(str(tmp_path)).read(2)
    assert manifest["meta"] == {"k": [1, 2]} and blobs == BLOBS
    assert sorted(arrays) == sorted(ARRAYS)
    for k, v in ARRAYS.items():
        got = arrays[k]
        assert _words(got) == _words(v), k
        # both stores write a 0-d array as one element
        assert tuple(got.shape) == np.ascontiguousarray(v).shape, k
    assert arrays["arg/bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(arrays["arg/bf16"].float().numpy(),
                                  ARRAYS["arg/bf16"].astype(np.float32))


def test_a_port_written_checkpoint_reads_in_the_jax_package(tmp_path):
    CheckpointStore(str(tmp_path)).write(
        2, {k: _as_port(v) for k, v in ARRAYS.items()}, blobs=BLOBS)
    _m, arrays, blobs = jck.CheckpointStore(str(tmp_path)).read(2)
    assert blobs == BLOBS
    for k, v in ARRAYS.items():
        assert arrays[k].dtype == v.dtype, k
        assert arrays[k].tobytes() == v.tobytes(), k


def _jax_fit(tmp_path, X, y):
    jit = jmx.io.NDArrayIter(X, y, batch_size=8)
    mod = jmx.mod.Module(_net(jmx), context=jmx.cpu())
    mgr = jck.CheckpointManager(directory=str(tmp_path), async_save=False)
    mod.fit(jit, num_epoch=1, optimizer_params={"learning_rate": 0.05},
            initializer=jmx.init.Xavier(), checkpoint_manager=mgr)
    return mod, mgr


def test_a_jax_managed_module_checkpoint_restores_here(tmp_path):
    X, y = _blob_data()
    jmod, jmgr = _jax_fit(tmp_path, X, y)
    it = _iter(X, y)
    mod = _fresh_module(it, 5)
    state = CheckpointManager(str(tmp_path), async_save=False) \
        .restore_latest(mod, train_data=it)
    assert state.epoch == 1 and state.meta["input_shapes"] == {
        "data": [8, 4]}
    got, want = _host_params(mod), {
        k: v.asnumpy() for k, v in list(jmod.get_params()[0].items())}
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert tmx.sym.load_json(state.symbol_json).list_arguments() == \
        jmod.symbol.list_arguments()


def test_a_port_managed_module_checkpoint_restores_in_the_jax_package(
        tmp_path):
    X, y = _blob_data()
    it = _iter(X, y)
    mod = tmx.mod.Module(_net(tmx), context=CPU)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.05},
            initializer=tmx.init.Xavier(), checkpoint_manager=mgr)
    jit = jmx.io.NDArrayIter(X, y, batch_size=8)
    jmod = jmx.mod.Module(_net(jmx), context=jmx.cpu())
    jmod.bind(data_shapes=jit.provide_data, label_shapes=jit.provide_label)
    jmod.init_params(jmx.init.Xavier())
    state = jck.CheckpointManager(str(tmp_path), async_save=False) \
        .restore_latest(jmod, train_data=jit)
    assert state.meta["rng"] == {"seed": 0, "count": 0}
    want = _host_params(mod)
    for k, v in jmod.get_params()[0].items():
        assert np.array_equal(v.asnumpy(), want[k]), k


def test_a_jax_checkpoints_rng_seeds_the_port(tmp_path):
    """A JAX-written checkpoint has no torch generator state: restoring
    it seeds the port's generators from ``meta["rng"]["seed"]`` (the two
    packages' streams differ by design)."""
    store = jck.CheckpointStore(str(tmp_path))
    store.write(1, {"arg/w": np.ones((2,), np.float32)},
                meta={"rng": {"seed": 17, "count": 5}})
    _m, arrays, blobs = CheckpointStore(str(tmp_path)).read(1)
    TrainState.from_payload(arrays, blobs, _m["meta"]).restore_into(
        tmx.mod.Module(_net(tmx), context=CPU))
    a = tmx.nd.random.uniform(shape=(4,), ctx=CPU).asnumpy()
    tmx.random.seed(17)
    b = tmx.nd.random.uniform(shape=(4,), ctx=CPU).asnumpy()
    assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# store: atomic layout, integrity, retention (the JAX package's cases)
# ---------------------------------------------------------------------------
def test_store_roundtrip(tmp_path):
    store = CheckpointStore(tmp_path)
    store.write(3, _payload(1.5), blobs={"optimizer": b"opaque"},
                meta={"epoch": 2, "nbatch": 7})
    assert store.steps() == [3] and store.latest() == 3
    manifest, arrays, blobs = store.read(3)
    assert manifest["meta"] == {"epoch": 2, "nbatch": 7}
    assert blobs["optimizer"] == b"opaque"
    np.testing.assert_array_equal(arrays["arg/w"], _payload(1.5)["arg/w"])
    assert arrays["arg/b"].dtype == np.float32
    for spec in manifest["shards"].values():
        assert spec["bytes"] > 0 and len(spec["sha256"]) == 64
    assert store.total_bytes(3) == sum(
        s["bytes"] for s in manifest["shards"].values()) + 6


def test_store_rejects_duplicate_step(tmp_path):
    store = CheckpointStore(tmp_path)
    store.write(1, _payload())
    with pytest.raises(checkpoint.CheckpointError):
        store.write(1, _payload())


def test_latest_ignores_partials_and_garbage(tmp_path):
    store = CheckpointStore(tmp_path)
    store.write(5, _payload())
    orphan = tmp_path / ".tmp-ckpt-00000009-999-dead"
    orphan.mkdir()
    (orphan / "arg.w.bin").write_bytes(b"\x00" * 16)
    broken = tmp_path / "ckpt-00000007"
    broken.mkdir()
    (broken / "manifest.json").write_text("{not json")
    assert store.steps() == [5] and store.latest() == 5


def test_corrupt_shard_is_integrity_error(tmp_path):
    store = CheckpointStore(tmp_path)
    path = store.write(1, _payload(2.0))
    shard = os.path.join(path, "arg.w.bin")
    data = bytearray(open(shard, "rb").read())
    data[0] ^= 0xFF
    with open(shard, "wb") as f:
        f.write(data)
    with pytest.raises(IntegrityError):
        store.read(1)
    _, arrays, _ = store.read(1, verify=False)
    assert arrays["arg/w"].shape == (4, 3)


def test_crash_mid_commit_preserves_previous(tmp_path, monkeypatch):
    store = CheckpointStore(tmp_path)
    store.write(1, _payload(1.0))
    from mxnet_tpu_torch.checkpoint import store as store_mod
    real_replace = os.replace

    def _boom(src, dst):
        raise OSError("simulated crash at commit")

    monkeypatch.setattr(store_mod.os, "replace", _boom)
    with pytest.raises(OSError):
        store.write(2, _payload(2.0))
    monkeypatch.setattr(store_mod.os, "replace", real_replace)
    assert store.latest() == 1
    assert len([n for n in os.listdir(tmp_path)
                if n.startswith(".tmp-")]) == 1
    assert len(store.gc_orphans()) == 1
    assert [n for n in os.listdir(tmp_path) if n.startswith(".tmp-")] == []
    store.write(2, _payload(2.0))
    assert store.steps() == [1, 2]


def test_gc_skips_live_writers_and_other_live_processes(tmp_path):
    from mxnet_tpu_torch.checkpoint import store as store_mod
    store = CheckpointStore(tmp_path)
    fake_tmp = str(tmp_path / (".tmp-ckpt-00000003-%d-abcd1234"
                               % os.getpid()))
    os.makedirs(fake_tmp)
    with store_mod._ACTIVE_LOCK:
        store_mod._ACTIVE_TMP.add(fake_tmp)
    try:
        assert CheckpointStore(tmp_path).gc_orphans() == []
        assert os.path.isdir(fake_tmp)
    finally:
        with store_mod._ACTIVE_LOCK:
            store_mod._ACTIVE_TMP.discard(fake_tmp)
    assert store.gc_orphans() == [fake_tmp]
    live = tmp_path / ".tmp-ckpt-00000001-1-aaaaaaaa"       # pid 1: init
    live.mkdir()
    dead = tmp_path / ".tmp-ckpt-00000002-999999-bbbbbbbb"
    dead.mkdir()
    assert str(dead) in store.gc_orphans()
    assert os.path.isdir(live)


@pytest.mark.parametrize("steps, keep_last, keep_every", [
    ([1, 2, 3, 4, 5, 6, 7, 8], 2, 4), ([], 2, 4), ([1, 2, 3], 0, 0),
    ([3, 9], 1, 0), ([3, 9], 1, 2), ([2, 4, 6, 7], 3, 3)])
def test_retention_victims_equal_the_jax_packages(steps, keep_last,
                                                  keep_every):
    got = RetentionPolicy(keep_last, keep_every).victims(steps)
    assert got == jck.RetentionPolicy(keep_last, keep_every).victims(steps)
    if steps and keep_last > 0:
        assert steps[-1] not in got


def test_retention_prunes_the_store(tmp_path):
    store = CheckpointStore(tmp_path)
    for step in range(1, 9):
        store.write(step, _payload(step))
    assert RetentionPolicy(2, 4).apply(store) == [1, 2, 3, 5, 6]
    assert store.steps() == [4, 7, 8]


# ---------------------------------------------------------------------------
# async checkpointer
# ---------------------------------------------------------------------------
def test_async_save_does_not_block_caller(tmp_path, monkeypatch):
    store = CheckpointStore(tmp_path)
    real_write = CheckpointStore.write

    def slow_write(self, step, arrays, blobs=None, meta=None):
        time.sleep(0.25)
        return real_write(self, step, arrays, blobs=blobs, meta=meta)

    monkeypatch.setattr(CheckpointStore, "write", slow_write)
    ckpt = AsyncCheckpointer(store)
    t0 = time.perf_counter()
    assert ckpt.save(1, _payload()) is True
    assert time.perf_counter() - t0 < 0.15
    assert ckpt.wait(timeout=10.0) and store.latest() == 1
    t0 = time.perf_counter()
    write_checkpoint(store, 2, _payload())
    assert time.perf_counter() - t0 >= 0.25


def test_async_at_most_one_in_flight(tmp_path, monkeypatch):
    store = CheckpointStore(tmp_path)
    gate = threading.Event()
    real_write = CheckpointStore.write

    def gated_write(self, step, arrays, blobs=None, meta=None):
        gate.wait(10.0)
        return real_write(self, step, arrays, blobs=blobs, meta=meta)

    monkeypatch.setattr(CheckpointStore, "write", gated_write)
    ckpt = AsyncCheckpointer(store)
    assert ckpt.save(1, _payload()) is True and ckpt.in_flight
    assert ckpt.save(2, _payload()) is False
    gate.set()
    assert ckpt.wait(timeout=10.0) and store.steps() == [1]
    assert ckpt.save(3, _payload()) is True
    assert ckpt.wait(timeout=10.0) and store.steps() == [1, 3]


def test_async_failure_is_contained(tmp_path, monkeypatch):
    from mxnet_tpu_torch import engine
    store = CheckpointStore(tmp_path)

    def bad_write(self, *a, **k):
        raise OSError("disk on fire")

    monkeypatch.setattr(CheckpointStore, "write", bad_write)
    ckpt = AsyncCheckpointer(store)
    assert ckpt.save(1, _payload()) is True
    assert ckpt.wait(timeout=10.0)
    assert isinstance(ckpt.last_error(), OSError)
    engine.check_raise()
    tmx.nd.array([1.0], ctx=CPU).asnumpy()
    ckpt.clear_error()
    assert ckpt.last_error() is None


# ---------------------------------------------------------------------------
# manager: restore fallback, step ids
# ---------------------------------------------------------------------------
def test_manager_restore_falls_back_past_corruption(tmp_path):
    mgr = CheckpointManager(directory=str(tmp_path), async_save=False)
    assert mgr.save_state(TrainState(_params(1.0), {}, {"epoch": 1}))
    assert mgr.save_state(TrainState(_params(9.0), {}, {"epoch": 2}))
    with open(os.path.join(mgr.store.path(2), "arg.w.bin"), "r+b") as f:
        f.write(b"\xde\xad")
    restored = mgr.restore_latest()
    assert restored is not None and restored.epoch == 1
    np.testing.assert_array_equal(restored.arg_params["w"],
                                  _params(1.0)["w"])


def test_manager_step_ids_equal_the_jax_packages(tmp_path):
    """Retention, a restart over the same directory and a second manager
    on it assign the same step ids in both packages."""
    def run(pkg, root):
        mgr = pkg.CheckpointManager(directory=str(root), async_save=False,
                                    keep_last=1)
        for epoch in range(3):
            mgr.save_state(pkg.TrainState(_params(epoch), {},
                                          {"epoch": epoch}))
        first = mgr.steps()
        mgr2 = pkg.CheckpointManager(directory=str(root), async_save=False,
                                     keep_last=0)
        mgr2.save_state(pkg.TrainState(_params(7), {}, {"epoch": 7}))
        mgr.save_state(pkg.TrainState(_params(8), {}, {"epoch": 8}))
        return first, mgr2.latest_step(), mgr.steps()

    got = run(checkpoint, tmp_path / "port")
    assert got == run(jck, tmp_path / "jax")
    # the first manager's next id skips the second's step 4
    assert got == ([3], 5, [5])


# ---------------------------------------------------------------------------
# full-state resume
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kvstore", ["local", "tpu"])
def test_resume_is_bit_identical(kvstore, monkeypatch):
    """6 steps straight against 3 steps, capture, restore into a module
    with another init, 3 steps: params, optimizer slots, the schedule's
    position and the next random draw are identical.  ``tpu`` runs the
    fused sweep (knob 1)."""
    monkeypatch.setenv("MXNET_PALLAS_FUSED_OPT", "1")
    X, y = _blob_data()

    def slots(mod):
        if mod._fused_exec_update:
            exe = mod._exec_group.execs[0]
            return {n: [s.clone() for s in v]
                    for n, v in exe.optimizer_slots().items()}
        return {i: st._data.clone() for i, st in mod._updater.states.items()}

    it_a = _iter(X, y)
    mod_a = _fresh_module(it_a, 11, kvstore)
    assert mod_a._fused_exec_update == (kvstore == "tpu")
    _train_steps(mod_a, it_a, 6)
    want, slots_a = _host_params(mod_a), slots(mod_a)
    lr_a = mod_a._optimizer._get_lr(0)
    draw_a = tmx.nd.random.uniform(shape=(5,), ctx=CPU).asnumpy()

    it_b = _iter(X, y)
    mod_b = _fresh_module(it_b, 11, kvstore)
    _train_steps(mod_b, it_b, 3)
    state = TrainState.capture(mod_b, epoch=0, nbatch=3, train_data=it_b)
    it_c = _iter(X, y)
    mod_c = _fresh_module(it_c, 77, kvstore)
    state.restore_into(mod_c, train_data=it_c)
    assert it_c.cursor == it_b.cursor
    _train_steps(mod_c, it_c, 3)
    got, slots_c = _host_params(mod_c), slots(mod_c)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert sorted(slots_a) == sorted(slots_c)
    for k in slots_a:
        for a, c in zip(slots_a[k], slots_c[k]):
            assert torch.equal(a, c), k
    assert mod_c._optimizer.num_update == mod_a._optimizer.num_update
    assert mod_c._optimizer._get_lr(0) == lr_a
    assert np.array_equal(
        tmx.nd.random.uniform(shape=(5,), ctx=CPU).asnumpy(), draw_a)


def test_a_fused_step_state_restores_into_the_local_updater(monkeypatch):
    """The fused step's payload (numpy slots under the local path's
    indices, the optimizer's update counts keyed by weight name) restores
    into a ``kvstore="local"`` module's ``Updater`` (counts keyed by
    index), which then continues bitwise as the fused run does, the
    schedule's position included (the two paths agree bit for bit on the
    CPU)."""
    monkeypatch.setenv("MXNET_PALLAS_FUSED_OPT", "1")
    X, y = _blob_data()
    it_a = _iter(X, y)
    mod_a = _fresh_module(it_a, 11, "tpu")
    _train_steps(mod_a, it_a, 3)
    state = TrainState.capture(mod_a, nbatch=3, train_data=it_a)
    _train_steps(mod_a, it_a, 3)
    it_b = _iter(X, y)
    mod_b = _fresh_module(it_b, 77, "local")
    state.restore_into(mod_b, train_data=it_b)
    assert sorted(mod_b._updater.states) == list(range(4))
    _train_steps(mod_b, it_b, 3)
    want, got = _host_params(mod_a), _host_params(mod_b)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_a_busy_writer_refuses_before_capturing(tmp_path, monkeypatch):
    X, y = _blob_data()
    it = _iter(X, y)
    mod = _fresh_module(it, 3)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    gate = threading.Event()
    real_write = CheckpointStore.write

    def gated_write(self, *a, **k):
        gate.wait(10.0)
        return real_write(self, *a, **k)

    captures = []
    real_capture = TrainState.capture.__func__

    def counting_capture(cls, *a, **k):
        captures.append(1)
        return real_capture(cls, *a, **k)

    monkeypatch.setattr(CheckpointStore, "write", gated_write)
    monkeypatch.setattr(TrainState, "capture", classmethod(counting_capture))
    assert mgr.save_module(mod, epoch=1) is True
    assert mgr.save_module(mod, epoch=2) is False
    assert len(captures) == 1
    gate.set()
    assert mgr.wait(10.0) and mgr.steps() == [1]


def test_resume_bit_identical_across_shuffled_epoch_boundary():
    """The port's NDArrayIter reshuffles from its CPU generator at every
    reset, so the resume restores the torch generator state too."""
    X, y = _blob_data()

    def start(seed, steps):
        tmx.random.seed(seed)
        it = _iter(X, y, shuffle=True)
        mod = _fresh_module(it, seed)
        _train_steps(mod, it, steps)
        return mod, it

    mod_a, _ = start(21, 12)             # crosses the reshuffle at step 8
    mod_b, it_b = start(21, 5)
    state = TrainState.capture(mod_b, nbatch=5, train_data=it_b)
    tmx.random.seed(777)
    it_c = _iter(X, y, shuffle=True)
    mod_c = _fresh_module(it_c, 55)
    state.restore_into(mod_c, train_data=it_c)
    _train_steps(mod_c, it_c, 7)
    want, got = _host_params(mod_a), _host_params(mod_c)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def _numpy_params(seed=3):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": (rng.randn(8, 4) * 0.5).astype(np.float32),
            "fc1_bias": (rng.randn(8) * 0.1).astype(np.float32),
            "fc2_weight": (rng.randn(2, 8) * 0.5).astype(np.float32),
            "fc2_bias": (rng.randn(2) * 0.1).astype(np.float32)}


def _run_pkg(mx, X, y, steps, arg, resume_at=None, drop_optimizer=False,
             other_init=None):
    """``steps`` fused-SGD-momentum steps under ``kvstore="tpu"`` from
    ``arg``; with ``resume_at``, a capture there and a restore into a
    module initialised from ``other_init``."""
    ctx = CPU if mx is tmx else mx.cpu()

    def module(init):
        if mx is tmx:
            it = _iter(X, y)
            args = {k: tmx.nd.array(v, ctx=CPU) for k, v in init.items()}
        else:
            it = mx.io.NDArrayIter(X, y, batch_size=8)
            args = {k: mx.nd.array(v) for k, v in init.items()}
        mod = mx.mod.Module(_net(mx), context=ctx)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params=args, aux_params={})
        mod.init_optimizer(kvstore="tpu", optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9})
        return mod, it

    mod, it = module(arg)
    if resume_at is None:
        _train_steps(mod, it, steps)
        return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    _train_steps(mod, it, resume_at)
    pkg = checkpoint if mx is tmx else jck
    state = pkg.TrainState.capture(mod, nbatch=resume_at, train_data=it)
    if drop_optimizer:
        state.optimizer_state = None
    mod2, it2 = module(other_init)
    state.restore_into(mod2, train_data=it2)
    _train_steps(mod2, it2, steps - resume_at)
    return {k: v.asnumpy() for k, v in mod2.get_params()[0].items()}


def test_fused_step_resume_keeps_momentum_beside_the_jax_package(
        monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS_FUSED_OPT", "1")
    X, y = _blob_data()
    arg, other = _numpy_params(3), _numpy_params(4)
    full = _run_pkg(tmx, X, y, 6, arg)
    resumed = _run_pkg(tmx, X, y, 6, arg, 3, other_init=other)
    cold = _run_pkg(tmx, X, y, 6, arg, 3, drop_optimizer=True,
                    other_init=other)
    jfull = _run_pkg(jmx, X, y, 6, arg)
    jresumed = _run_pkg(jmx, X, y, 6, arg, 3, other_init=other)
    for k in full:
        assert np.array_equal(resumed[k], full[k]), k
        np.testing.assert_allclose(full[k], jfull[k], rtol=RTOL, atol=ATOL)
        # the JAX package's resume lost the momentum: it equals the
        # port's resume with the optimizer state dropped
        np.testing.assert_allclose(jresumed[k], cold[k], rtol=RTOL,
                                   atol=ATOL)
    assert max(np.abs(jresumed[k] - jfull[k]).max() for k in full) > 1e-3
    assert max(np.abs(cold[k] - full[k]).max() for k in full) > 1e-3


# ---------------------------------------------------------------------------
# fit() integration + SIGTERM
# ---------------------------------------------------------------------------
def _fit(mod, it, **kw):
    kw.setdefault("optimizer_params", {"learning_rate": 0.05})
    kw.setdefault("initializer", tmx.init.Xavier())
    mod.fit(it, **kw)


def test_fit_periodic_and_final_saves_match_the_jax_package(tmp_path):
    X, y = _blob_data()
    it = _iter(X, y)
    mod = tmx.mod.Module(_net(tmx), context=CPU)
    mgr = CheckpointManager(directory=str(tmp_path / "port"),
                            async_save=False, period_steps=3,
                            period_epochs=1, keep_last=0)
    _fit(mod, it, num_epoch=2, checkpoint_manager=mgr)
    jit = jmx.io.NDArrayIter(X, y, batch_size=8)
    jmod = jmx.mod.Module(_net(jmx), context=jmx.cpu())
    jmgr = jck.CheckpointManager(directory=str(tmp_path / "jax"),
                                 async_save=False, period_steps=3,
                                 period_epochs=1, keep_last=0)
    jmod.fit(jit, num_epoch=2, optimizer_params={"learning_rate": 0.05},
             checkpoint_manager=jmgr)

    def positions(m):
        out = []
        for s in m.steps():
            meta = m.store.manifest(s)["meta"]
            out.append((s, meta["epoch"], meta["nbatch"],
                        meta.get("iter", {}).get("cursor")))
        return out

    assert positions(mgr) == positions(jmgr)
    # 8 batches an epoch: saves after batches 3 and 6, cursor at the
    # last trained batch, then the epoch's end
    assert positions(mgr)[:3] == [(1, 0, 3, 16), (2, 0, 6, 40), (3, 1, 0,
                                                                None)]
    final = mgr.restore_latest()
    assert final.epoch == 2 and final.meta["input_shapes"] == {
        "data": [8, 4]}


def test_fit_crash_restore_continue_matches_uninterrupted(tmp_path):
    X, y = _blob_data()

    def run(it, mgr=None, crash_at=None):
        def cb(param):
            if crash_at is not None and param.nbatch == crash_at:
                raise RuntimeError("simulated crash")
        mod = tmx.mod.Module(_net(tmx), context=CPU)
        kw = dict(optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                  num_epoch=1, batch_end_callback=cb)
        if mgr is not None:
            kw["checkpoint_manager"] = mgr
        tmx.random.seed(13)
        _fit(mod, it, **kw)
        return mod

    want = _host_params(run(_iter(X, y)))
    mgr = CheckpointManager(directory=str(tmp_path), async_save=False,
                            period_steps=4, period_epochs=0)
    with pytest.raises(RuntimeError):
        run(_iter(X, y), mgr=mgr, crash_at=3)
    it_c = _iter(X, y)
    mod_c = _fresh_module(it_c, 99, scheduler=False)
    state = mgr.restore_latest(mod_c, train_data=it_c)
    assert state.nbatch == 4
    _train_steps(mod_c, it_c, 4)
    got = _host_params(mod_c)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_fit_env_knob_builds_default_manager(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_CKPT_ASYNC", "0")
    X, y = _blob_data()
    _fit(tmx.mod.Module(_net(tmx), context=CPU), _iter(X, y), num_epoch=1)
    mgr = checkpoint.default_manager()
    assert mgr is not None and mgr.latest_step() is not None
    assert checkpoint.default_manager() is mgr


def test_sigterm_triggers_final_save(tmp_path):
    X, y = _blob_data()
    mgr = CheckpointManager(directory=str(tmp_path), async_save=False,
                            period_steps=0, period_epochs=0)

    def preempt(param):
        if param.epoch == 0 and param.nbatch == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    prev = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as exc_info:
        _fit(tmx.mod.Module(_net(tmx), context=CPU), _iter(X, y),
             num_epoch=2, batch_end_callback=preempt,
             checkpoint_manager=mgr)
    assert exc_info.value.code == 143
    assert signal.getsignal(signal.SIGTERM) == prev
    state = mgr.restore_latest()
    assert (state.epoch, state.nbatch) == (0, 3)
    assert state.meta["iter"]["cursor"] == 16


def test_sigterm_flag_scope_sets_flag_off_main_thread_noop():
    prev = signal.getsignal(signal.SIGTERM)
    with checkpoint.sigterm_flag_scope() as flag:
        assert flag["signaled"] is False
        os.kill(os.getpid(), signal.SIGTERM)
        assert flag["signaled"] is True
    assert signal.getsignal(signal.SIGTERM) == prev
    flags = []

    def run():
        with checkpoint.sigterm_flag_scope() as f:
            flags.append(f)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert flags == [{"signaled": False}]


# ---------------------------------------------------------------------------
# callback.module_checkpoint and save_checkpoint routing
# ---------------------------------------------------------------------------
class _FlakyModule:
    def __init__(self, fail_times=1):
        self.fail_times = fail_times
        self.saves = []

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        manager=None):
        if self.fail_times > 0:
            self.fail_times -= 1
            raise OSError("transient save failure")
        self.saves.append(epoch)


def test_module_checkpoint_retries_after_failure():
    mod = _FlakyModule(fail_times=1)
    cb = tmx.callback.module_checkpoint(mod, "prefix", period=2)
    for epoch, want in ((1, []), (2, [3]), (3, [3]), (4, [3, 5])):
        cb(epoch)
        assert mod.saves == want
    with pytest.raises(ValueError):
        tmx.callback.module_checkpoint(_FlakyModule())


def test_module_checkpoint_with_manager(tmp_path):
    X, y = _blob_data()
    mod = tmx.mod.Module(_net(tmx), context=CPU)
    mgr = CheckpointManager(directory=str(tmp_path), async_save=False)
    _fit(mod, _iter(X, y), num_epoch=2,
         epoch_end_callback=tmx.callback.module_checkpoint(
             mod, period=1, manager=mgr))
    assert len(mgr.steps()) == 2


def test_save_checkpoint_mirrors_to_manager(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_CKPT_DIR", str(tmp_path / "managed"))
    monkeypatch.setenv("MXNET_CKPT_ASYNC", "0")
    X, y = _blob_data()
    it = _iter(X, y)
    mod = _fresh_module(it, 3)
    prefix = str(tmp_path / "legacy")
    mod.save_checkpoint(prefix, 1)
    assert os.path.exists(prefix + "-symbol.json")
    assert os.path.exists(prefix + "-0001.params")
    mgr = checkpoint.default_manager()
    assert mgr.restore_latest().optimizer_state is not None
    before = mgr.steps()
    mod.save_checkpoint(prefix, 2, manager=False)
    assert mgr.steps() == before


# ---------------------------------------------------------------------------
# serving hot swap
# ---------------------------------------------------------------------------
def test_watch_checkpoints_hot_swap(tmp_path):
    X, y = _blob_data()
    it = _iter(X, y)
    mod = _fresh_module(it, 3)
    _train_steps(mod, it, 2)
    mgr = CheckpointManager(directory=str(tmp_path), async_save=False)
    mgr.save_module(mod, epoch=0, nbatch=2)
    registry = tmx.serving.ModelRegistry()
    with registry.watch_checkpoints(str(tmp_path), "clf", start=False,
                                    ctx=CPU) as watcher:
        assert watcher.poll_once() == 1
        assert registry.describe() == {"clf": {"versions": [1],
                                               "default": 1}}
        assert watcher.poll_once() is None
        _train_steps(mod, it, 2)
        mgr.save_module(mod, epoch=0, nbatch=4)
        assert watcher.poll_once() == 2
        entry = registry.get("clf")
        assert entry.version == 2 and entry.sample_shapes == {"data": (4,)}
        assert np.array_equal(entry.arg_params["fc1_weight"].asnumpy(),
                              mod.get_params()[0]["fc1_weight"].asnumpy())


def test_watch_retries_after_transient_read_error(tmp_path, monkeypatch):
    X, y = _blob_data()
    mod = _fresh_module(_iter(X, y), 3)
    mgr = CheckpointManager(directory=str(tmp_path), async_save=False)
    mgr.save_module(mod, epoch=0)
    registry = tmx.serving.ModelRegistry()
    watcher = registry.watch_checkpoints(str(tmp_path), "clf", start=False,
                                         ctx=CPU)
    real_read = CheckpointStore.read
    calls = {"n": 0, "fail_until": 5}

    def flaky_read(self, step, verify=True):
        calls["n"] += 1
        if calls["n"] <= calls["fail_until"]:
            raise OSError("transient NFS hiccup")
        return real_read(self, step, verify=verify)

    monkeypatch.setattr(CheckpointStore, "read", flaky_read)
    assert watcher.poll_once() is None and calls["n"] == 3
    assert watcher.poll_once() == 1
    mgr.save_module(mod, epoch=1)
    calls.update(n=0, fail_until=1)
    assert watcher.poll_once() == 2 and registry.get("clf").version == 2


def test_watch_skips_unservable_checkpoint(tmp_path):
    mgr = CheckpointManager(directory=str(tmp_path), async_save=False)
    mgr.save_state(TrainState(_params(), {}, {"epoch": 0}))
    registry = tmx.serving.ModelRegistry()
    watcher = registry.watch_checkpoints(str(tmp_path), "clf", start=False,
                                         ctx=CPU)
    assert watcher.poll_once() is None and registry.describe() == {}


# ---------------------------------------------------------------------------
# telemetry and the profiler
# ---------------------------------------------------------------------------
def test_checkpoint_telemetry_and_profiler_spans(tmp_path):
    from mxnet_tpu_torch import profiler, telemetry
    mgr = CheckpointManager(directory=str(tmp_path), async_save=False)
    profiler.set_state("run")
    try:
        mgr.save_state(TrainState(_params(), {}, {"epoch": 0}))
        mgr.restore_latest()
        events = json.loads(profiler.dumps(reset=True))["traceEvents"]
    finally:
        profiler.set_state("stop")
    assert {"checkpoint:save", "checkpoint:restore"} <= {
        e["name"] for e in events}
    snap = telemetry.snapshot()
    for fam in ("mxnet_checkpoint_saves_total", "mxnet_checkpoint_bytes",
                "mxnet_checkpoint_save_seconds",
                "mxnet_checkpoint_restores_total",
                "mxnet_checkpoint_restore_seconds",
                "mxnet_checkpoint_failures_total"):
        assert fam in snap, fam
    assert snap["mxnet_checkpoint_bytes"]["values"][0]["value"] > 0
    samples = telemetry.validate_exposition(telemetry.prometheus_text())
    assert "mxnet_checkpoint_save_seconds_bucket" in samples


# ---------------------------------------------------------------------------
# rehearsal of chip_smoke.py's phase 20 on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_train_serve_phase_rehearses_on_the_cpu(tmp_path,
                                                          monkeypatch):
    """chip_smoke's phase 20 with ctx=cpu() at ResNet-8 size (3x32x32,
    batch 4, 10 classes, buckets 1..4): the manager's cost, the
    checkpointed fit with the server beside it, the canaries, the NaN
    rollback, the burst, the faults, the warm restart (in this process)
    and the resume, each checked by the phase itself; knobs at 1, the
    counting wrappers patched over the kernel wrappers see the phase's
    launches: K1b once a bucket and K2 once a fit step, K3 at each site
    and K2 once a served forward."""
    import sys
    import chip_smoke
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "example", "image-classification",
        "symbols"))
    import resnet as jax_resnet
    for knob in ("MXNET_PALLAS_FUSED_OPT", "MXNET_PALLAS_SOFTMAX",
                 "MXNET_PALLAS_BN_RELU"):
        monkeypatch.setenv(knob, "1")
    seen = {}

    def counting(name, fn):
        def wrapper(*a, **kw):
            if a[0].device.type != "meta":
                seen[name] = seen.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    for name in ("sgd_mom_sweep", "softmax_lastaxis", "scale_bias_relu"):
        monkeypatch.setattr(ck, name, counting(name, getattr(ck, name)))

    def counts(reset=False):
        if reset:
            seen.clear()
        return dict(seen)

    image, batch = (3, 32, 32), 4
    sym = tmx.sym.load_json(jax_resnet.get_symbol(10, 8, "3,32,32").tojson())
    # the p99 gate made inert: on a loaded CPU one slow canary batch among
    # eight would roll a healthy version back; the gate's verdicts are
    # held in tests/test_torch_serving_multitenant.py
    res = chip_smoke.train_serve(
        tmx, CPU, sym, image, batch, str(tmp_path), epochs=3, steps=3,
        timed=(1, 3, 1), clients=2, live=4, spawn=False, classes=10,
        counts=counts,
        knob_values={"MXNET_SERVING_CANARY_P99_FACTOR": "1000"})
    loop = res["loop"]
    sites = len(chip_smoke.k3_sites(tmx, sym, batch, image))
    assert loop["fused"] and loop["buckets"] >= 1
    assert loop["versions"] == [1, 2, 3] and loop["retained"] == [2, 3]
    assert loop["launches"] == {
        "sgd_mom_sweep": loop["buckets"] * loop["fit_steps"],
        "softmax_lastaxis": loop["fit_steps"] + loop["forwards"],
        "scale_bias_relu": sites * loop["forwards"]}
    assert [v["canary"]["decision"] for v in loop["verdicts"][1:]] == \
        ["promoted", "promoted"]
    assert res["promoted"]["bitwise"] and res["after_rollback"]["bitwise"]
    assert res["poison"]["verdict"]["reason"] == "nonfinite_outputs"
    assert res["burst"]["entered"] >= 1 and res["burst"]["left"]
    assert res["restart"]["manifest"]["warmed"] == [1, 2, 4]
    assert res["resume"]["bitwise"]
    assert res["timing"]["committed"] == res["timing"]["accepted"]
