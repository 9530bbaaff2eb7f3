"""The port's checkpoint files against the JAX package's, on the CPU.

``nd.save`` containers, ``-symbol.json`` files, the ``save_checkpoint``
pair and gluon parameter files must be the same bytes in both packages
for the same values, and each package must read the other's.  The
``.states`` files pickle each package's own classes, so they are held by
content: unpickled and compared as numpy.  Module and Trainer resumes
must equal the uninterrupted run (bit for bit on the CPU), and match the
JAX package's resumed run within the fp32 band of the training tests.

Inputs are made with numpy from fixed seeds.  Bands: Predictor outputs
rtol 1e-5 / atol 1e-6 (``tests/test_torch_serving.py``'s), Module.fit
weights rtol 1e-4 / atol 1e-5 and the transformer's logits rtol 1e-5 /
atol 1e-5 (``tests/test_torch_train.py``'s and
``tests/test_torch_transformer.py``'s), gluon weights after a step
within 1e-4 of each one's largest magnitude
(``tests/test_torch_lm_train.py``'s).
"""
import os
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.gluon.contrib import transformer as jtr
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.contrib import transformer as ttr
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.symbols import resnet as tresnet
from test_torch_train import (BATCH as FIT_BATCH, SHAPE as FIT_SHAPE,  # noqa: F401
                              small)

torch.set_num_threads(1)

CPU = tmx.cpu()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# the nd.save container
# ---------------------------------------------------------------------------
_RNG = np.random.RandomState(80)
CONTAINERS = {
    "fp32": {"w": _RNG.randn(3, 4).astype(np.float32)},
    "fp16": {"w": _RNG.randn(5).astype(np.float16)},
    "bf16": {"w": (_RNG.randn(2, 3).astype(np.float32), "bfloat16")},
    "int32": {"i": _RNG.randint(-9, 9, (2, 3)).astype(np.int32)},
    "int8": {"i": _RNG.randint(-9, 9, (7,)).astype(np.int8)},
    "uint8": {"u": _RNG.randint(0, 255, (2, 2, 2)).astype(np.uint8)},
    "0-d": {"s": np.array(3.5, np.float32)},
    "empty": {"e": np.zeros((0,), np.float32)},
    "arg-aux-names": {"arg:fc_weight": _RNG.randn(4, 3).astype(np.float32),
                      "aux:bn_moving_var": _RNG.rand(4).astype(np.float32),
                      "arg:größe_é": _RNG.randn(2).astype(np.float32)},
    "nameless-list": [_RNG.randn(3).astype(np.float32),
                      _RNG.randint(0, 9, (2,)).astype(np.int32)],
}


def _arrays(mx, case, ctx=None):
    """The case's arrays as ``mx`` NDArrays, in the container's form."""
    def one(v):
        a, dt = v if isinstance(v, tuple) else (v, None)
        arr = mx.nd.array(a) if ctx is None else mx.nd.array(a, ctx=ctx)
        return arr.astype(dt) if dt else arr

    spec = CONTAINERS[case]
    if isinstance(spec, dict):
        return {k: one(v) for k, v in spec.items()}
    return [one(v) for v in spec]


def _host(arr):
    """(dtype name, float64 values) of either package's NDArray."""
    return str(arr.dtype), np.asarray(arr.asnumpy(), np.float64)


def _same_contents(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        got, want = list(got.values()), list(want.values())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        gd, gv = _host(g)
        wd, wv = _host(w)
        assert gd == wd
        assert np.array_equal(gv, wv)


@pytest.mark.parametrize("case", list(CONTAINERS))
def test_container_bytes_and_loads_match_the_jax_package(case, tmp_path):
    jf, tf = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jarr, tarr = _arrays(jmx, case), _arrays(tmx, case, CPU)
    jmx.nd.save(jf, jarr)
    tmx.nd.save(tf, tarr)
    assert _bytes(tf) == _bytes(jf)
    # each package reads the other's file, by path and from its bytes
    for got in (tmx.nd.load(jf, ctx=CPU), tmx.nd.load_buffer(_bytes(jf),
                                                               ctx=CPU)):
        _same_contents(got, tarr)
        assert all(a.context == CPU for a in (
            got.values() if isinstance(got, dict) else got))
    for got in (jmx.nd.load(tf), jmx.nd.load_buffer(_bytes(tf))):
        _same_contents(got, jarr)


@pytest.mark.parametrize("offset", [0, 24], ids=["list-magic", "v2-magic"])
def test_container_wrong_magic_raises_in_both_packages(offset, tmp_path):
    path = str(tmp_path / "x.params")
    tmx.nd.save(path, [tmx.nd.array(np.ones(2, np.float32), ctx=CPU)])
    raw = bytearray(_bytes(path))
    raw[offset] ^= 0xFF
    with pytest.raises(MXNetError, match="magic"):
        tmx.nd.load_buffer(bytes(raw), ctx=CPU)
    with pytest.raises(JaxMXNetError, match="magic"):
        jmx.nd.load_buffer(bytes(raw))


@pytest.mark.parametrize("kind", ["nd.save", "Symbol.save", "atomic_write"])
def test_a_write_that_raises_leaves_the_earlier_file(kind, tmp_path,
                                                     monkeypatch):
    """The first array is written, the second raises (a dtype the
    container has no id for); the file at the target keeps its earlier
    bytes and no temp file is left behind."""
    path = str(tmp_path / "f")
    good = tmx.nd.array(np.arange(4, dtype=np.float32), ctx=CPU)
    tmx.nd.save(path, {"a": good})
    before = _bytes(path)
    if kind == "nd.save":
        bad = tmx.nd.NDArray(torch.ones(3, dtype=torch.bool))
        with pytest.raises(MXNetError):
            tmx.nd.save(path, {"a": good, "b": bad})
    else:
        from mxnet_tpu_torch import _atomic_io

        class Torn(Exception):
            pass

        def torn(*a, **kw):
            raise Torn()
        monkeypatch.setattr(os, "fsync", torn)
        with pytest.raises(Torn):
            if kind == "Symbol.save":
                tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=2,
                                       name="fc").save(path)
            else:
                _atomic_io.atomic_write(path, pickle.dumps({0: good}))
    assert _bytes(path) == before
    assert os.listdir(str(tmp_path)) == ["f"]


def test_golden_container_loads_and_saves_back_the_same_bytes(tmp_path):
    path = os.path.join(FIX, "golden_ndarray_v2.params")
    loaded = tmx.nd.load(path, ctx=CPU)
    expect = np.load(os.path.join(FIX, "golden_ndarray_v2_expect.npz"))
    assert list(loaded) == list(expect.files)
    for k in expect.files:
        got = loaded[k].asnumpy()
        assert got.dtype == expect[k].dtype and np.array_equal(got,
                                                               expect[k]), k
    out = str(tmp_path / "again.params")
    tmx.nd.save(out, loaded)
    assert _bytes(out) == _bytes(path)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16", "int32",
                                   "uint8"])
def test_ndarray_pickles_through_host_memory(dtype):
    src = tmx.nd.array(np.arange(-3, 3, dtype=np.float32).reshape(2, 3),
                       ctx=CPU).astype(dtype)
    _, args = src.__reduce__()
    assert all(isinstance(a, (np.ndarray, str)) for a in args)
    back = pickle.loads(pickle.dumps(src))
    assert back.dtype == dtype and back.context == CPU
    assert torch.equal(back._data, src._data)


def test_load_without_a_gpu_raises_naming_the_gpu(tmp_path, monkeypatch):
    path = str(tmp_path / "x.params")
    tmx.nd.save(path, {"arg:w": tmx.nd.array(np.ones(2), ctx=CPU)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="GPU"):
        tmx.nd.load(path)
    with pytest.raises(MXNetError, match="GPU"):
        tmx.nd.load_buffer(_bytes(path))


# ---------------------------------------------------------------------------
# symbol files and the checkpoint pair
# ---------------------------------------------------------------------------
IMAGE = (3, 64, 64)


@pytest.fixture(scope="module")
def resnet18():
    """The port's small ImageNet-style ResNet-18 (10 classes, 64x64),
    its JAX twin from the JSON, He-scaled weights and random moving stats
    from a seed, and a batch of two."""
    tsym = tresnet.get_symbol(10, 18, ",".join(map(str, IMAGE)))
    jsym = jmx.sym.load_json(tsym.tojson())
    arg_shapes, _, aux_shapes = tsym.infer_shape(data=(2,) + IMAGE)
    rng = np.random.RandomState(81)
    arg = {n: (rng.randn(*s) * np.sqrt(2.0 / max(1, np.prod(s[1:]))))
           .astype(np.float32)
           for n, s in zip(tsym.list_arguments(), arg_shapes)
           if n not in ("data", "softmax_label")}
    aux = {n: ((rng.rand(*s) + 0.5) if n.endswith("_var")
               else rng.randn(*s) * 0.1).astype(np.float32)
           for n, s in zip(tsym.list_auxiliary_states(), aux_shapes)}
    x = rng.randn(2, *IMAGE).astype(np.float32)
    return tsym, jsym, arg, aux, x


def _save_pair(mx, sym, arg, aux, prefix, epoch=1, ctx=None):
    kw = {} if ctx is None else {"ctx": ctx}
    args = {k: mx.nd.array(v, **kw) for k, v in arg.items()}
    auxs = {k: mx.nd.array(v, **kw) for k, v in aux.items()}
    mx.model.save_checkpoint(prefix, epoch, sym, args, auxs)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_symbol_file_moves_between_the_packages(resnet18, writer, tmp_path):
    tsym, jsym = resnet18[:2]
    path = str(tmp_path / "x-symbol.json")
    if writer == "jax":
        jsym.save(path)
        back = tmx.sym.load(path)
    else:
        tsym.save(path)
        back = jmx.sym.load(path)
    assert back.tojson() == tsym.tojson() == jsym.tojson()
    assert back.list_arguments() == tsym.list_arguments()


def _jax_predict(symbol_file, param_file, x, output_names=None):
    p = jmx.predictor.Predictor(symbol_file, param_file, {"data": x.shape},
                                output_names=output_names)
    p.forward(data=x)
    return [p.get_output(i).asnumpy() for i in range(p.num_outputs)]


def _port_predict(symbol_file, param_file, x, output_names=None):
    p = tmx.Predictor(symbol_file, param_file, {"data": x.shape},
                      dev_type="cpu", output_names=output_names)
    p.forward(data=x)
    return [p.get_output(i).asnumpy() for i in range(p.num_outputs)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_pair_is_the_same_bytes_and_loads_across(resnet18,
                                                            writer,
                                                            tmp_path):
    """One package's ``save_checkpoint`` -> the other's
    ``load_checkpoint`` and ``Predictor(files)``: the same parameters, and
    outputs within rtol 1e-5 / atol 1e-6 of the writer's ``Predictor``."""
    tsym, jsym, arg, aux, x = resnet18
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    _save_pair(jmx, jsym, arg, aux, jp)
    _save_pair(tmx, tsym, arg, aux, tp, ctx=CPU)
    for suffix in ("-symbol.json", "-0001.params"):
        assert _bytes(tp + suffix) == _bytes(jp + suffix), suffix
    src = jp if writer == "jax" else tp
    if writer == "jax":
        sym, args, auxs = tmx.model.load_checkpoint(src, 1, ctx=CPU)
    else:
        sym, args, auxs = jmx.model.load_checkpoint(src, 1)
    assert sym.tojson() == tsym.tojson()
    assert sorted(args) == sorted(arg) and sorted(auxs) == sorted(aux)
    for got, want in ((args, arg), (auxs, aux)):
        for k in want:
            assert np.array_equal(got[k].asnumpy(), want[k]), k
    sf, pf = src + "-symbol.json", src + "-0001.params"
    (jo,), (to,) = _jax_predict(sf, pf, x), _port_predict(sf, pf, x)
    assert to.shape == (2, 10) and np.isfinite(to).all()
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("form", ["files", "contents"])
def test_model_server_loads_a_checkpoint(resnet18, form, tmp_path):
    """``ModelServer.load_model`` from the JAX package's files, or from
    the JSON text and the container's bytes, answers as the port's
    ``Predictor`` of the same files."""
    tsym, jsym, arg, aux, x = resnet18
    prefix = str(tmp_path / "j")
    _save_pair(jmx, jsym, arg, aux, prefix, epoch=3)
    sf, pf = prefix + "-symbol.json", prefix + "-0003.params"
    want = _port_predict(sf, pf, x)[0]
    src = (sf, pf) if form == "files" else (
        _bytes(sf).decode(), _bytes(pf))
    srv = tmx.serving.ModelServer(max_batch=2, ctx=CPU)
    assert srv.load_model("r18", *src, {"data": (1,) + IMAGE}) == 1
    srv.start()
    try:
        got = srv.infer("r18", {"data": x}, timeout_ms=60000.0)[0]
    finally:
        srv.stop()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("heads", [["flatten0_output"],
                                   ["pool_final_output", "fc1_output"]],
                         ids=["one", "two"])
def test_output_names_pick_internal_heads_in_both(resnet18, heads, tmp_path):
    """The internal heads reach ~1e3 with these weights, and the two
    packages sum each convolution in another order: each output is held
    within 1e-5 of its largest magnitude."""
    tsym, jsym, arg, aux, x = resnet18
    prefix = str(tmp_path / "j")
    _save_pair(jmx, jsym, arg, aux, prefix)
    sf, pf = prefix + "-symbol.json", prefix + "-0001.params"
    want = _jax_predict(sf, pf, x, heads)
    got = _port_predict(sf, pf, x, heads)
    assert len(got) == len(want) == len(heads)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    with pytest.raises(MXNetError, match="not in graph"):
        _port_predict(sf, pf, x, ["no_such_output"])


def test_predictor_bytes_io_and_create(resnet18, tmp_path):
    tsym, jsym, arg, aux, x = resnet18
    prefix = str(tmp_path / "t")
    _save_pair(tmx, tsym, arg, aux, prefix, ctx=CPU)
    sf, pf = prefix + "-symbol.json", prefix + "-0001.params"
    p = tmx.predictor.create(sf, pf, {"data": x.shape}, dev_type="cpu")
    p.set_input_bytes("data", x.tobytes())
    got = np.frombuffer(p.forward().get_output_bytes(0), np.float32)
    np.testing.assert_array_equal(got.reshape(2, 10),
                                  _port_predict(sf, pf, x)[0])


def test_predictor_without_a_gpu_raises_naming_the_gpu(resnet18, tmp_path,
                                                       monkeypatch):
    tsym, jsym, arg, aux, x = resnet18
    prefix = str(tmp_path / "t")
    _save_pair(tmx, tsym, arg, aux, prefix, ctx=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="GPU"):
        tmx.Predictor(prefix + "-symbol.json", prefix + "-0001.params",
                      {"data": x.shape})
    with pytest.raises(MXNetError, match="GPU"):
        tmx.mod.Module.load(prefix, 1)


# ---------------------------------------------------------------------------
# Module resume
# ---------------------------------------------------------------------------
SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
# (kvstore, MXNET_PALLAS_FUSED_OPT): the sweep, the per-array fused step,
# and the module's own Updater
PATHS = {"tpu-1": ("tpu", "1"), "tpu-0": ("tpu", "0"),
         "local": ("local", None)}


def _take_path(monkeypatch, path):
    kvstore, knob = PATHS[path]
    if knob is None:
        monkeypatch.delenv("MXNET_PALLAS_FUSED_OPT", raising=False)
    else:
        monkeypatch.setenv("MXNET_PALLAS_FUSED_OPT", knob)
    return kvstore


def _iter(mx, small):
    x, y = small[4], small[5]
    return mx.io.NDArrayIter(x, y, batch_size=FIT_BATCH)


def _fit_port(small, path, monkeypatch, prefix, epochs=2):
    """``epochs`` epochs of Module.fit on the port from the fixture's
    parameters, checkpointed every epoch with the optimizer states."""
    kvstore = _take_path(monkeypatch, path)
    _, tsym, arg, aux = small[:4]
    args, auxs = tmx.convert.params_from_numpy(arg, aux, CPU)
    mod = tmx.mod.Module(tsym, context=CPU)
    mod.fit(_iter(tmx, small), num_epoch=epochs, kvstore=kvstore,
            optimizer="sgd", optimizer_params=SGD, arg_params=args,
            aux_params=auxs,
            epoch_end_callback=tmx.callback.module_checkpoint(
                mod, prefix, save_optimizer_states=True))
    return mod


def _resume_port(small, path, monkeypatch, prefix, states=True):
    kvstore = _take_path(monkeypatch, path)
    mod = tmx.mod.Module.load(prefix, 1, load_optimizer_states=states,
                              context=CPU)
    mod.fit(_iter(tmx, small), begin_epoch=1, num_epoch=2, kvstore=kvstore,
            optimizer="sgd", optimizer_params=SGD)
    return mod


def _states(path):
    with open(path, "rb") as f:
        return {k: v.asnumpy() for k, v in pickle.load(f).items()}


@pytest.mark.parametrize("writer,reader", [
    ("tpu-1", "tpu-1"), ("tpu-0", "tpu-0"), ("local", "local"),
    ("tpu-1", "local"), ("local", "tpu-0"), ("tpu-0", "tpu-1")])
def test_module_resume_equals_the_uninterrupted_run(small, writer, reader,
                                                    tmp_path, monkeypatch):
    """2 epochs uninterrupted against 1 epoch, ``Module.load(...,
    load_optimizer_states=True)`` and 1 more: weights, moving stats and
    the momentum bit for bit, whichever path wrote and read the files."""
    prefix = str(tmp_path / "m")
    full = _fit_port(small, writer, monkeypatch, prefix)
    resumed = _resume_port(small, reader, monkeypatch, prefix)
    assert resumed._fused_exec_update == (reader != "local")
    for want, got in zip(full.get_params(), resumed.get_params()):
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k]._data, want[k]._data), k
    resumed.save_optimizer_states(prefix + "-resumed.states")
    want, got = _states(prefix + "-0002.states"), \
        _states(prefix + "-resumed.states")
    assert sorted(got) == sorted(want) and len(want) == len(small[2])
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_module_resume_without_the_states_differs(small, tmp_path,
                                                  monkeypatch):
    """Dropping the momentum at the resume moves the weights: the
    comparison above can fail."""
    prefix = str(tmp_path / "m")
    full = _fit_port(small, "tpu-1", monkeypatch, prefix)
    cold = _resume_port(small, "tpu-1", monkeypatch, prefix, states=False)
    want, got = full.get_params()[0], cold.get_params()[0]
    assert not all(torch.equal(got[k]._data, want[k]._data) for k in want)


def _fit_jax(small, kvstore, prefix, epochs):
    jsym, _, arg, aux = small[:4]
    mod = jmx.mod.Module(jsym, context=jmx.cpu())
    mod.fit(_iter(jmx, small), num_epoch=epochs, kvstore=kvstore,
            optimizer="sgd", optimizer_params=SGD,
            arg_params={k: jmx.nd.array(v) for k, v in arg.items()},
            aux_params={k: jmx.nd.array(v) for k, v in aux.items()},
            epoch_end_callback=jmx.callback.module_checkpoint(
                mod, prefix, save_optimizer_states=True))
    return mod


def test_module_resume_matches_the_jax_package(small, tmp_path, monkeypatch):
    """Under ``kvstore="local"`` both packages resume from their own
    epoch-1 files; the weights after the resumed epoch agree within rtol
    1e-4 / atol 1e-5, and so do the momentum files."""
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    _fit_jax(small, "local", jp, 1)
    jmod = jmx.mod.Module.load(jp, 1, load_optimizer_states=True,
                               context=jmx.cpu())
    jmod.fit(_iter(jmx, small), begin_epoch=1, num_epoch=2, kvstore="local",
             optimizer="sgd", optimizer_params=SGD)
    _fit_port(small, "local", monkeypatch, tp, epochs=1)
    tmod = _resume_port(small, "local", monkeypatch, tp)
    for got, want in zip(tmod.get_params(), jmod.get_params()):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].asnumpy(), want[k].asnumpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    jmod.save_optimizer_states(jp + "-r.states")
    tmod.save_optimizer_states(tp + "-r.states")
    want, got = _states(jp + "-r.states"), _states(tp + "-r.states")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5)


def test_tpu_states_hold_the_momentum_the_jax_package_loses(small, tmp_path,
                                                            monkeypatch):
    """With ``kvstore="tpu"`` the JAX package folds the optimizer into the
    executor but writes its kvstore's updater, which never ran: ``{}``.
    The port writes the executor's momentum: equal bit for bit to its
    ``local`` path's, and within the fp32 band of the JAX package's
    ``local`` file."""
    jt, jl = str(tmp_path / "jt"), str(tmp_path / "jl")
    _fit_jax(small, "tpu", jt, 1)
    _fit_jax(small, "local", jl, 1)
    assert _states(jt + "-0001.states") == {}
    reference = _states(jl + "-0001.states")
    got = {}
    for path in ("tpu-1", "tpu-0", "local"):
        prefix = str(tmp_path / path)
        _fit_port(small, path, monkeypatch, prefix, epochs=1)
        got[path] = _states(prefix + "-0001.states")
    assert sorted(got["tpu-1"]) == sorted(reference)
    for k in reference:
        assert np.array_equal(got["tpu-1"][k], got["local"][k]), k
        assert np.array_equal(got["tpu-0"][k], got["local"][k]), k
        assert np.abs(got["tpu-1"][k]).max() > 0, k
        np.testing.assert_allclose(got["tpu-1"][k], reference[k], rtol=1e-4,
                                   atol=1e-5, err_msg=str(k))


def test_save_and_load_params_round_trip(small, tmp_path, monkeypatch):
    prefix = str(tmp_path / "m")
    mod = _fit_port(small, "tpu-1", monkeypatch, prefix, epochs=1)
    mod.save_params(prefix + ".params")
    assert _bytes(prefix + ".params") == _bytes(prefix + "-0001.params")
    other = tmx.mod.Module(small[1], context=CPU)
    other.bind(mod.data_shapes, mod.label_shapes)
    other.init_params()
    other.load_params(prefix + ".params")
    for want, got in zip(mod.get_params(), other.get_params()):
        for k in want:
            assert torch.equal(got[k]._data, want[k]._data), k


def test_kvstore_tpu_writes_its_fused_slots(tmp_path):
    """A bare ``tpu`` kvstore keeps SGD's momentum as its updater's
    states, so its file holds them and a fresh store continues from it
    as the ``local`` store does."""
    w = np.random.RandomState(82).randn(6).astype(np.float32)
    grads = [np.random.RandomState(83 + i).randn(6).astype(np.float32)
             for i in range(3)]
    out = {}
    for kind in ("tpu", "local"):
        kv = tmx.kv.create(kind)
        kv.set_optimizer(tmx.optimizer.create("sgd", **SGD))
        kv.init("w", tmx.nd.array(w, ctx=CPU))
        res = tmx.nd.zeros((6,), ctx=CPU)
        for step, g in enumerate(grads):
            if step == 2:
                kv.save_optimizer_states(str(tmp_path / kind))
                weight = res.copy()
                kv = tmx.kv.create(kind)
                kv.set_optimizer(tmx.optimizer.create("sgd", **SGD))
                kv.init("w", weight)
                kv.load_optimizer_states(str(tmp_path / kind))
            kv.push("w", tmx.nd.array(g, ctx=CPU))
            kv.pull("w", out=res)
        out[kind] = res.asnumpy()
    tpu, local = _states(str(tmp_path / "tpu")), _states(
        str(tmp_path / "local"))
    assert list(tpu) == list(local) == ["w"]
    assert np.array_equal(tpu["w"], local["w"]) and np.abs(tpu["w"]).any()
    assert np.array_equal(out["tpu"], out["local"])


# ---------------------------------------------------------------------------
# gluon
# ---------------------------------------------------------------------------
VOCAB = 32
LM = dict(units=32, hidden_size=64, num_layers=2, num_heads=4, max_len=32)
T = 16


def _tokens(seed=84):
    ids = np.random.RandomState(seed).randint(0, VOCAB, (2, T + 1))
    return ids[:, :-1].astype(np.float32), ids[:, 1:].astype(np.float32)


@pytest.fixture(scope="module")
def jax_lm():
    """A JAX ``TransformerLM`` with Xavier weights from a seed, its
    LayerNorm and bias values moved off 1 and 0, after one forward."""
    jmx.random.seed(6)
    lm = jtr.TransformerLM(VOCAB, **LM)
    lm.initialize(jmx.init.Xavier())
    lm(jmx.nd.zeros((1, 4)))
    rng = np.random.RandomState(85)
    for k, p in lm.collect_params().items():
        if k.endswith(("gamma", "beta", "bias")):
            v = p.data().asnumpy()
            p.set_data(jmx.nd.array(v + 0.2 * rng.randn(*v.shape)))
    return lm


def _logits(mx, lm, x, ctx=None):
    kw = {} if ctx is None else {"ctx": ctx}
    return lm(mx.nd.array(x, **kw)).asnumpy()


@pytest.mark.parametrize("reader", ["port-deferred", "port-fresh", "jax"])
def test_gluon_parameters_move_between_the_packages(jax_lm, reader,
                                                    tmp_path):
    """The JAX package's ``save_parameters`` -> the port's
    ``load_parameters``, into a model initialized with deferred shapes or
    never initialized, and the port's file (the same bytes) -> the JAX
    package's: the logits within rtol 1e-5 / atol 1e-5."""
    x, _ = _tokens()
    jf, tf = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jax_lm.save_parameters(jf)
    want = _logits(jmx, jax_lm, x)
    lm = ttr.TransformerLM(VOCAB, **LM)
    if reader == "port-deferred":
        lm.initialize(tmx.init.Xavier(), ctx=CPU)
        assert lm.ln_f.gamma.shape == (0,)
    lm.load_parameters(jf, ctx=CPU)
    assert lm.ln_f.gamma.shape == (LM["units"],)
    assert all(p.data().context == CPU
               for p in lm.collect_params().values())
    lm.save_parameters(tf)
    assert _bytes(tf) == _bytes(jf)
    if reader == "jax":
        other = jtr.TransformerLM(VOCAB, **LM)
        other.initialize(jmx.init.Xavier())
        other.load_parameters(tf)
        got = _logits(jmx, other, x)
    else:
        got = _logits(tmx, lm, x, CPU)
    assert got.shape == (2, T, VOCAB)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_gluon_load_checks_names_and_shapes(jax_lm, tmp_path):
    jf = str(tmp_path / "j.params")
    jax_lm.save_parameters(jf)
    lm = ttr.TransformerLM(VOCAB, **dict(LM, units=16))
    with pytest.raises(MXNetError, match="incompatible"):
        lm.load_parameters(jf, ctx=CPU)
    lm = ttr.TransformerLM(VOCAB, **dict(LM, num_layers=1))
    with pytest.raises(MXNetError, match="not present"):
        lm.load_parameters(jf, ctx=CPU)
    lm = ttr.TransformerLM(VOCAB, **dict(LM, num_layers=1))
    lm.load_parameters(jf, ctx=CPU, ignore_extra=True)
    lm = ttr.TransformerLM(VOCAB, **dict(LM, num_layers=3))
    with pytest.raises(MXNetError, match="missing"):
        lm.load_parameters(jf, ctx=CPU)


def _step(mx, lm, trainer, x, y):
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(lm(x).reshape((-1, VOCAB)), y.reshape((-1,))).mean()
    loss.backward()
    trainer.step(1)
    return float(loss.asnumpy())


def _weights(lm):
    return {n[len(lm.prefix):]: p.data().asnumpy()
            for n, p in lm.collect_params().items()}


def _run(mx, jax_lm, optimizer, params, tmp_path, ctx=None):
    """Two steps from the JAX model's weights; the model and trainer
    saved after the first, loaded into fresh ones that take the second.
    Returns (uninterrupted weights, resumed weights, the states file's
    contents as numpy)."""
    kw = {} if ctx is None else {"ctx": ctx}
    x, y = (mx.nd.array(a, **kw) for a in _tokens())
    tag = "j" if mx is jmx else "t"
    pf, sf = str(tmp_path / (tag + ".params")), str(tmp_path / (tag + ".st"))
    jf = str(tmp_path / "init.params")
    jax_lm.save_parameters(jf)
    mod = jtr if mx is jmx else ttr
    lm = mod.TransformerLM(VOCAB, **LM)
    lm.load_parameters(jf, **kw)
    trainer = mx.gluon.Trainer(lm.collect_params(), optimizer, dict(params))
    _step(mx, lm, trainer, x, y)
    lm.save_parameters(pf)
    trainer.save_states(sf)
    _step(mx, lm, trainer, x, y)
    lm2 = mod.TransformerLM(VOCAB, **LM)
    lm2.load_parameters(pf, **kw)
    trainer2 = mx.gluon.Trainer(lm2.collect_params(), optimizer,
                                dict(params))
    trainer2.load_states(sf)
    _step(mx, lm2, trainer2, x, y)
    with open(sf, "rb") as f:
        states = pickle.load(f)
    flat = {k: [s.asnumpy() for s in (v if isinstance(v, tuple) else (v,))]
            for k, v in states.items()}
    return _weights(lm), _weights(lm2), flat


def _close(got, want, tol=1e-4):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("adam", {"learning_rate": 1e-2, "epsilon": 1e-3})])
def test_trainer_states_resume(jax_lm, optimizer, params, tmp_path):
    """SGD with momentum: the resumed step equals the uninterrupted one
    bit for bit.  Adam: both packages pickle the updater without the
    optimizer, so the resumed step restarts the update count; the port's
    resumed weights match the JAX package's within 1e-4 of each one's
    largest magnitude, and the states files hold the same m and v."""
    full, resumed, states = _run(tmx, jax_lm, optimizer, params, tmp_path,
                                 CPU)
    jfull, jresumed, jstates = _run(jmx, jax_lm, optimizer, params,
                                    tmp_path)
    assert sorted(states) == sorted(jstates) == list(range(len(full)))
    for k in jstates:
        for got, want in zip(states[k], jstates[k]):
            assert _close(got, want), k
    for n in jresumed:
        assert _close(resumed[n], jresumed[n]), n
        assert _close(full[n], jfull[n]), n
    if optimizer == "sgd":
        assert all(np.array_equal(resumed[n], full[n]) for n in full)
    else:
        assert not all(np.array_equal(resumed[n], full[n]) for n in full)


# ---------------------------------------------------------------------------
# the checkpoint manager's routes, read back by the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("how", ["manager-save", "manager-callback",
                                 "env-save", "env-callback"])
def test_checkpoint_manager_routes_write_what_the_jax_package_reads(
        small, how, tmp_path, monkeypatch):
    """``Module.save_checkpoint(manager=)``, ``module_checkpoint(manager=)``
    and the same two under ``MXNET_CKPT_DIR`` each commit one managed
    checkpoint beside the prefix files; the JAX package's store reads its
    arrays back equal to the module's parameters."""
    jsym, tsym, arg, aux, _x, _y = small
    mod = tmx.mod.Module(tsym, context=CPU)
    mod.bind(data_shapes=[("data", (FIT_BATCH,) + FIT_SHAPE)],
             label_shapes=[("softmax_label", (FIT_BATCH,))])
    args, auxs = tmx.convert.params_from_numpy(arg, aux, CPU, symbol=tsym)
    mod.init_params(arg_params=args, aux_params=auxs)
    ckdir = str(tmp_path / "managed")
    kw = {}
    if how.startswith("manager"):
        kw["manager"] = tmx.checkpoint.CheckpointManager(ckdir,
                                                         async_save=False)
    else:
        monkeypatch.setenv("MXNET_CKPT_DIR", ckdir)
        monkeypatch.setenv("MXNET_CKPT_ASYNC", "0")
    prefix = str(tmp_path / "m")
    if how.endswith("save"):
        mod.save_checkpoint(prefix, 1, **kw)
        assert os.path.exists(prefix + "-0001.params")
    else:
        tmx.callback.module_checkpoint(mod, prefix, **kw)(0)
        assert os.path.exists(prefix + "-0001.params")
    store = jmx.checkpoint.CheckpointStore(ckdir)
    assert store.steps() == [1]
    manifest, arrays, blobs = store.read(1)
    assert manifest["meta"]["epoch"] == 1
    assert jmx.sym.load_json(blobs["symbol"].decode()).tojson() == \
        jsym.tojson()
    want = dict(("arg/" + k, v) for k, v in arg.items())
    want.update(("aux/" + k, v) for k, v in aux.items())
    assert sorted(arrays) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(arrays[k], v), k


def test_do_checkpoint_writes_every_period(resnet18, tmp_path):
    tsym, jsym, arg, aux, x = resnet18
    args, auxs = tmx.convert.params_from_numpy(arg, aux, CPU)
    cb = tmx.callback.do_checkpoint(str(tmp_path / "c"), period=2)
    for epoch in range(4):
        cb(epoch, tsym, args, auxs)
    assert sorted(os.listdir(str(tmp_path))) == [
        "c-0002.params", "c-0004.params", "c-symbol.json"]


# ---------------------------------------------------------------------------
# rehearsal of chip_smoke.py's checkpoint phase on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_checkpoint_phase_rehearses_on_the_cpu(small, tmp_path,
                                                         monkeypatch):
    """chip_smoke's phase 13 with ctx=cpu(): a ResNet-20 at 28x28 fitted 2
    epochs of 2 steps and checkpointed, served from the files, resumed
    with and without its momentum, and a small TransformerLM saved and
    resumed; knobs at 1, the counting wrappers patched over the kernel
    wrappers see each path's kernels, and no kernel launches."""
    import chip_smoke
    for knob in ("MXNET_PALLAS_FUSED_OPT", "MXNET_PALLAS_SOFTMAX",
                 "MXNET_PALLAS_BN_RELU", "MXNET_PALLAS_NORM"):
        monkeypatch.setenv(knob, "1")
    seen = {}

    def counting(name, fn):
        def wrapper(*a, **kw):
            if a[0].device.type != "meta":
                seen[name] = seen.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    for name in ("sgd_mom_sweep", "softmax_lastaxis", "scale_bias_relu",
                 "layernorm_fwd", "layernorm_bwd", "bias_softmax",
                 "softmax_bwd"):
        monkeypatch.setattr(ck, name, counting(name, getattr(ck, name)))
    tsym, prefix = small[1], str(tmp_path / "r")
    mod, ref, a = chip_smoke.ckpt_fit(tmx, CPU, tsym, FIT_SHAPE, FIT_BATCH,
                                      2, prefix, classes=10)
    assert a["fused"] and a["kernel"] == "sgd_mom_sweep"
    assert a["params_mb"] > 0 and a["states_mb"] > 0
    assert len(a["save_ms"]) == 2 and a["load_params_ms"] > 0
    seen.clear()
    b = chip_smoke.ckpt_serve(tmx, ck, CPU, mod, prefix, 2, FIT_SHAPE,
                              FIT_BATCH)
    sites = len(chip_smoke.k3_sites(tmx, tsym, FIT_BATCH, FIT_SHAPE))
    assert b["bitwise"] and b["shape"] == (FIT_BATCH, 10)
    # the served forward and the module's
    assert seen == {"scale_bias_relu": 2 * sites, "softmax_lastaxis": 2}
    seen.clear()
    state, calls = chip_smoke.ckpt_resume(tmx, ck, CPU, prefix, FIT_SHAPE,
                                          FIT_BATCH, 2, classes=10)
    assert seen == {"sgd_mom_sweep": 4, "softmax_lastaxis": 2}
    res = chip_smoke.compare_states(state, ref)
    assert res["bitwise"] and res["tensors"] > 0
    cold, _ = chip_smoke.ckpt_resume(tmx, ck, CPU, prefix, FIT_SHAPE,
                                     FIT_BATCH, 2, states=False, classes=10)
    assert chip_smoke.compare_states(cold, ref)["max_rel"] \
        > chip_smoke.CKPT_TOL
    config = dict(LM, vocab_size=VOCAB)
    lm = chip_smoke.transformer_lm(tmx, CPU, config)
    x, y = chip_smoke.lm_batch(tmx, CPU, VOCAB, 2, T)
    trainer = tmx.gluon.Trainer(lm.collect_params(), "adam",
                                dict(chip_smoke.LM_ADAM))
    chip_smoke.lm_loss(tmx, lm, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), x,
                       y)
    trainer.step(1)
    seen.clear()
    d = chip_smoke.ckpt_lm(tmx, ck, lm, trainer, x, y, config, str(tmp_path))
    assert d["logits_bitwise"] and d["adam_loaded_bitwise"]
    assert d["sgd_step_bitwise"] and d["adam_mv_bitwise"]
    assert d["losses"][0] == d["losses"][1]
    assert d["params_mb"] > 0 and d["adam_states_mb"] > d["sgd_states_mb"]
    assert seen["layernorm_fwd"] > 0 and seen["layernorm_bwd"] > 0
    assert seen["bias_softmax"] > 0 and seen["softmax_bwd"] > 0
    assert not any(calls.values()) and not any(d["calls"].values())
