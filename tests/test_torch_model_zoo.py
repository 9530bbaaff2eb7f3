"""The port's ``gluon.model_zoo.vision`` against the JAX package's, on the
CPU: all 34 ``get_model`` names build with the JAX package's parameter
names (so ``.params`` files move between the two); five networks
(ResNet-18 v1 and v2, MobileNet 0.25, MobileNetV2 0.25, SqueezeNet 1.1)
run a forward at a small input from the JAX network's parameters, held
within 1e-5 of the largest logit; one ``Trainer`` step of ResNet-18 v1
moves every parameter and running statistic as the JAX package's step
does, within 1e-5 of each array's largest magnitude; ``pretrained=True``
loads a file staged under ``MXNET_GLUON_REPO``; and ``export`` and
``SymbolBlock.imports`` round-trip.
"""
import hashlib
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu.gluon.model_zoo import vision as jvision

from test_torch_gluon_layers import build, carry, init, nd, rel

NET_TOL = 1e-5      # of the largest logit or array magnitude (a network)
CPU = tmx.cpu()
NAMES = sorted(jvision._models)


def test_get_model_knows_the_34_names_of_the_jax_package():
    assert sorted(tvision._models) == NAMES and len(NAMES) == 34
    for mx in (jmx, tmx):
        with pytest.raises(ValueError, match="not supported"):
            mx.gluon.model_zoo.vision.get_model("resnet19_v1")


def _names(mx, name):
    with tmx.cpu():
        net = build(mx, lambda m: m.gluon.model_zoo.vision.get_model(
            name, classes=7))
        return [(k, p.shape) for k, p in net.collect_params().items()]


@pytest.mark.parametrize("name", NAMES)
def test_parameter_names_and_declared_shapes_equal_the_jax_packages(name):
    assert _names(tmx, name) == _names(jmx, name)


FORWARD = {
    "resnet18_v1": (2, 3, 32, 32),
    "resnet18_v2": (2, 3, 32, 32),
    "mobilenet0.25": (2, 3, 32, 32),
    "mobilenetv2_0.25": (2, 3, 32, 32),
    "squeezenet1.1": (2, 3, 64, 64),
}


def _pair(name, shape, classes=10):
    """The JAX network, initialized and run once, and the port's with its
    parameters."""
    x = np.random.RandomState(3).rand(*shape).astype(np.float32)

    def make(m):
        return m.gluon.model_zoo.vision.get_model(name, classes=classes)

    jnet = build(jmx, make)
    init(jmx, jnet, x)
    with tmx.cpu():
        tnet = build(tmx, make)
        init(tmx, tnet, x)
        carry(jnet, tnet)
    return jnet, tnet, x


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_forward_matches_the_jax_package(name):
    jnet, tnet, x = _pair(name, FORWARD[name])
    want = jnet(nd(jmx, x)).asnumpy()
    with tmx.cpu():
        tnet.hybridize()
        got = tnet(nd(tmx, x)).asnumpy()
    assert got.shape == want.shape == (2, 10)
    assert rel(got, want) <= NET_TOL


def _train_step(mx, net, x, y):
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(net(nd(mx, x)), nd(mx, y))
    loss.backward()
    trainer.step(x.shape[0])
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def test_one_trainer_step_of_resnet18_matches_the_jax_package():
    jnet, tnet, x = _pair("resnet18_v1", (4, 3, 64, 64))
    y = np.array([1, 5, 0, 9], np.float32)
    before = {k: p.data().asnumpy().copy()
              for k, p in jnet.collect_params().items()}
    want = _train_step(jmx, jnet, x, y)
    with tmx.cpu():
        got = _train_step(tmx, tnet, x, y)
    assert sorted(got) == sorted(want)
    for k in want:
        assert rel(got[k], want[k]) <= NET_TOL, k
    moved = [k for k in want if not np.array_equal(want[k], before[k])]
    assert "resnetv10_dense0_weight" in moved
    assert "resnetv10_batchnorm0_running_mean" in moved


def test_pretrained_loads_a_file_staged_under_mxnet_gluon_repo(
        tmp_path, monkeypatch):
    """``pretrained=True`` finds ``<name>.params`` in the directory (or
    ``file://`` url) that ``MXNET_GLUON_REPO`` names, copies it into the
    cache root and loads it, in both packages; a ``<name>-<sha1[:8]>``
    file with other contents fails its check; with nothing staged both
    raise MXNetError."""
    repo = tmp_path / "repo"
    repo.mkdir()
    src = build(jmx, lambda m: m.gluon.model_zoo.vision.squeezenet1_1())
    init(jmx, src, np.zeros((1, 3, 64, 64), np.float32))
    src.save_parameters(str(repo / "squeezenet1.1.params"))
    want = {k[len(src.prefix):]: p.data().asnumpy()
            for k, p in src.collect_params().items()}
    for i, url in enumerate((str(repo), "file://" + str(repo))):
        monkeypatch.setenv("MXNET_GLUON_REPO", url)
        for mx in (jmx, tmx):
            root = tmp_path / ("cache%d_%s" % (i, mx.__name__))
            with tmx.cpu():
                net = mx.gluon.model_zoo.vision.squeezenet1_1(
                    pretrained=True, root=str(root), ctx=mx.cpu())
            got = {k[len(net.prefix):]: p.data().asnumpy()
                   for k, p in net.collect_params().items()}
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
            assert os.listdir(root) == ["squeezenet1.1.params"]
    bad = tmp_path / "bad"
    bad.mkdir()
    sha = tmx.gluon.model_zoo.model_store.short_hash("squeezenet1.1")
    (bad / ("squeezenet1.1-%s.params" % sha)).write_bytes(b"not weights")
    assert hashlib.sha1(b"not weights").hexdigest()[:8] != sha
    monkeypatch.setenv("MXNET_GLUON_REPO", str(bad))
    for mx in (jmx, tmx):
        with pytest.raises(mx.base.MXNetError, match="sha1"):
            mx.gluon.model_zoo.model_store.get_model_file(
                "squeezenet1.1", root=str(tmp_path / "c3"))
    monkeypatch.setenv("MXNET_GLUON_REPO", str(tmp_path / "empty"))
    for mx in (jmx, tmx):
        with pytest.raises(mx.base.MXNetError):
            mx.gluon.model_zoo.model_store.get_model_file(
                "alexnet", root=str(tmp_path / "c4"))


def _mlp(mx):
    net = mx.gluon.nn.HybridSequential(prefix="net_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(6, activation="relu"),
                mx.gluon.nn.Dense(3))
    return net


def _mlp_symbol(mx):
    x = mx.sym.var("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(
        x, num_hidden=6, name="net_dense0"), act_type="relu")
    return mx.sym.FullyConnected(h, num_hidden=3, name="net_dense1")


def test_export_then_symbol_block_imports_round_trips(tmp_path):
    """``export`` writes ``arg:``-keyed parameters only, as the JAX
    package's does; ``SymbolBlock.imports`` of a symbol with the same
    names and that file answers as the block did.  The files of one
    package load in the other."""
    x = np.random.RandomState(4).randn(5, 4).astype(np.float32)
    out = {}
    for mx in (jmx, tmx):
        with tmx.cpu():
            net = build(mx, _mlp)
            init(mx, net, x)
            if mx is tmx:
                carry(jnet, net)
            else:
                jnet = net
            prefix = str(tmp_path / mx.__name__)
            net.export(prefix, epoch=3)
            _mlp_symbol(mx).save(prefix + "-symbol.json")
            keys = sorted(mx.nd.load(prefix + "-0003.params"))
            block = mx.gluon.SymbolBlock.imports(
                prefix + "-symbol.json", ["data"], prefix + "-0003.params",
                ctx=mx.cpu())
            out[mx] = (keys, net(nd(mx, x)).asnumpy(),
                       block(nd(mx, x)).asnumpy())
    assert out[tmx][0] == out[jmx][0] == [
        "arg:net_dense0_bias", "arg:net_dense0_weight", "arg:net_dense1_bias",
        "arg:net_dense1_weight"]
    for mx in (jmx, tmx):
        assert rel(out[mx][2], out[mx][1]) <= 1e-6
    assert rel(out[tmx][2], out[jmx][2]) <= 1e-6
    with tmx.cpu():
        cross = tmx.gluon.SymbolBlock.imports(
            str(tmp_path / "mxnet_tpu-symbol.json"), "data",
            str(tmp_path / "mxnet_tpu-0003.params"), ctx=CPU)
        assert rel(cross(nd(tmx, x)).asnumpy(), out[jmx][2]) <= 1e-6


def test_symbol_block_serves_a_resnet_checkpoint_as_the_jax_package(
        tmp_path):
    """A ``model.save_checkpoint`` of the port's ResNet symbol (aux states
    included), imported through ``SymbolBlock.imports`` in both packages:
    the answers agree within the network band, and the port's equal its
    ``Predictor``'s at the same batch bitwise."""
    from mxnet_tpu_torch.symbols import resnet
    sym = resnet.get_symbol(10, 8, "3,16,16")
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(2, 3, 16, 16))
    r = np.random.RandomState(5)
    args = {n: (r.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    auxs = {n: (r.rand(*s) + 0.5).astype(np.float32)
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    prefix = str(tmp_path / "r8")
    with tmx.cpu():
        tmx.model.save_checkpoint(
            prefix, 1, sym, {k: tmx.nd.array(v) for k, v in args.items()},
            {k: tmx.nd.array(v) for k, v in auxs.items()})
    x = r.rand(2, 3, 16, 16).astype(np.float32)
    out = {}
    for mx in (jmx, tmx):
        with tmx.cpu():
            block = mx.gluon.SymbolBlock.imports(
                prefix + "-symbol.json", ["data", "softmax_label"],
                prefix + "-0001.params", ctx=mx.cpu())
            out[mx] = block(nd(mx, x), nd(mx, np.zeros(2))).asnumpy()
    assert out[tmx].shape == (2, 10)
    assert rel(out[tmx], out[jmx]) <= NET_TOL
    with tmx.cpu():
        pred = tmx.Predictor(prefix + "-symbol.json", prefix + "-0001.params",
                             {"data": (2, 3, 16, 16)}, dev_type="cpu")
        np.testing.assert_array_equal(
            pred.forward(data=x).get_output(0).asnumpy(), out[tmx])


def test_chip_smoke_gluon_phase_rehearses_on_the_cpu(tmp_path):
    """Phase 18's functions at a small size on the CPU: the loop from a
    ``.rec`` through the DataLoader (2 threads), the first step's replay
    (the same device: exact), the eval forward against a second network
    carried across by name, and the SymbolBlock against a Predictor."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.symbols import resnet
    path, _, _ = cs.write_rec(tmx, str(tmp_path / "train"), n=16,
                              classes=10, short=40, long_range=(40, 48))
    net, trainer, loss_fn, (x, y), rec = cs.gluon_train(
        tmx, ck, CPU, path, (3, 32, 32), 4, layers=18, classes=10,
        warmup=2, steps=1, workers=2)
    first = rec["first_step"]
    assert (first["weights"], first["batchnorms"]) == (62, 20)
    assert first["weights_max_rel"] == first["running_stats_max_rel"] == 0
    assert rec["eval_logits_max_rel"] == 0 and rec["eval_shape"] == [4, 10]
    assert np.isfinite([rec["ce_first"], rec["ce_last"]]).all()
    assert rec["data_on"] == "cpu" and x.shape == (4, 3, 32, 32)
    sb = cs.gluon_symbol_block(tmx, ck, CPU, resnet.get_symbol(
        10, 8, "3,16,16"), (3, 16, 16), 2, str(tmp_path), n=2)
    assert sb["bitwise"] == 2 and sb["launches"] == {}
