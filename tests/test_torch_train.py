"""The port's training path against the JAX package, on the CPU.

Small sizes (a ResNet-20 at 28x28, batch 4), inputs made with numpy from
fixed seeds and handed to both packages.  The JAX side runs its Pallas
kernels in interpret mode, as tests/test_pallas.py runs them; the port's
kernel wrappers take their plain versions on CPU tensors.  Tolerances:
fp32 elementwise code within 1e-6 (abs) or 1e-5 (relative); the
executor and Module.fit within rtol 1e-4 / atol 1e-5, because the two
packages sum convolutions in different orders.  The two port paths
(sweep and per-array) must agree bit for bit.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import loss as jloss
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.parallel import collectives as jcoll
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops import loss as tloss
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.parallel import collectives as tcoll

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "example", "image-classification",
                                "symbols"))
sys.path.insert(0, REPO)
import resnet as jax_resnet  # noqa: E402

SHAPE = (3, 28, 28)
BATCH = 4


@pytest.fixture(scope="module")
def small():
    """A ResNet-20 (10 classes, 28x28) built by the JAX package and moved
    across as JSON, with He-scaled weights and non-trivial moving stats
    from a seed, and 16 samples with labels.

    Every BatchNorm gets gamma near 0.2 and beta near +1 or -1 by
    channel index, the same sign in every BatchNorm: a channel is either
    alive everywhere (each ReLU input about 0.2 or more above zero, the
    residual sums too) or dead everywhere (below zero).  So the packages'
    rounding differences (~1e-5 in the forward) cannot flip a ReLU, which
    would pass a gradient the other side blocks.  With random betas near
    0 a pre-activation 4e-6 from zero flipped in one BatchNorm of this
    network and moved that BatchNorm's beta gradient by 2.7%, and eight
    training steps later a first-layer weight by 1e-2."""
    jsym = jax_resnet.get_symbol(10, 20, "3,28,28")
    arg_shapes, _, aux_shapes = jsym.infer_shape(data=(BATCH,) + SHAPE)
    rng = np.random.RandomState(50)
    sign = rng.choice([-1.0, 1.0], 64)
    arg = {}
    for n, shp in zip(jsym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        std = np.sqrt(2.0 / np.prod(shp[1:])) if len(shp) > 1 else 0.1
        arg[n] = (rng.randn(*shp) * std).astype(np.float32)
        if n.endswith("_gamma"):
            arg[n] = (0.2 + 0.05 * rng.rand(*shp)).astype(np.float32)
        elif n.endswith("_beta"):
            arg[n] = (sign[:shp[0]] + 0.05 * rng.randn(*shp)).astype(
                np.float32)
    aux = {n: ((rng.rand(*shp) + 0.5) if n.endswith("_var")
               else rng.randn(*shp) * 0.1).astype(np.float32)
           for n, shp in zip(jsym.list_auxiliary_states(), aux_shapes)}
    x = rng.randn(16, *SHAPE).astype(np.float32)
    y = rng.randint(0, 10, 16).astype(np.float32)
    return jsym, tmx.sym.load_json(jsym.tojson()), arg, aux, x, y


def _close(got, ref, rtol=1e-4, atol=1e-5, what=""):
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# nd.array keeps the numpy dtype as the JAX package does
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("src", [
    np.arange(6, dtype=np.int32), np.arange(6, dtype=np.int64),
    np.arange(6, dtype=np.float16), np.arange(6, dtype=np.float64),
    [1, 2, 3], torch.arange(6, dtype=torch.int32)],
    ids=["int32", "int64", "float16", "float64", "list", "torch-int32"])
def test_nd_array_dtype_matches_the_jax_package(src):
    got = tmx.nd.array(src, ctx=tmx.cpu())
    ref = jmx.nd.array(src)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got.asnumpy(), ref.asnumpy())
    assert tmx.nd.array(src, ctx=tmx.cpu(), dtype="float64").dtype \
        == "float64"


def test_ndarray_surface_for_the_training_path():
    a = tmx.nd.ones((2, 3), ctx=tmx.cpu())
    big = tmx.nd.zeros((4, 3), ctx=tmx.cpu())
    a.copyto(big[1:3])                 # into a view of a larger buffer
    assert big.asnumpy().sum() == 6 and big.asnumpy()[0].sum() == 0
    big[:] = 2.5
    assert (big.asnumpy() == 2.5).all()
    big[:] = np.arange(12, dtype=np.float32).reshape(4, 3)
    assert big.asnumpy()[3, 2] == 11
    b = big.astype("float16")
    assert b.dtype == "float16" and b._data.data_ptr() != big._data.data_ptr()
    assert tmx.nd.empty((5,), ctx=tmx.cpu()).shape == (5,)
    big.wait_to_read()


# ---------------------------------------------------------------------------
# SoftmaxOutput backward and training BatchNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("normalization,use_ignore", [
    ("null", False), ("batch", False), ("valid", False), ("valid", True),
    ("null", True)])
def test_softmax_output_backward_matches_jax_grad(normalization, use_ignore):
    rng = np.random.RandomState(51)
    x = rng.randn(6, 10).astype(np.float32)
    lab = rng.randint(0, 10, 6).astype(np.float32)
    lab[1] = 3.0
    kw = dict(grad_scale=0.7, ignore_label=3.0, use_ignore=use_ignore,
              normalization=normalization)
    out, vjp = jax.vjp(lambda d: jloss._softmax_output(
        d, jnp.asarray(lab), **kw), jnp.asarray(x))
    (ref,) = vjp(jnp.ones_like(out))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(lab).requires_grad_()
    got = tloss._softmax_output(xt, yt, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-6)
    # the head gradient is ignored: a random one gives the same result
    got.backward(torch.from_numpy(rng.randn(6, 10).astype(np.float32)))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)
    assert torch.equal(yt.grad, torch.zeros(6))


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_training_batchnorm_matches_jax(fix_gamma):
    rng = np.random.RandomState(52)
    x = (rng.randn(4, 5, 6, 7) * 2 + 0.5).astype(np.float32)
    gamma = (rng.rand(5) + 0.5).astype(np.float32)
    beta = rng.randn(5).astype(np.float32)
    mm = (rng.randn(5) * 0.1).astype(np.float32)
    mv = (rng.rand(5) + 0.5).astype(np.float32)
    head = rng.randn(4, 5, 6, 7).astype(np.float32)
    kw = dict(eps=2e-5, momentum=0.9, fix_gamma=fix_gamma,
              __is_train__=True)

    def jfn(d, g, b):
        return jnn._batch_norm(d, g, b, jnp.asarray(mm), jnp.asarray(mv),
                               **kw)

    (jout, jmean, jvar), vjp = jax.vjp(jfn, jnp.asarray(x),
                                       jnp.asarray(gamma), jnp.asarray(beta))
    jdx, jdg, jdb = vjp((jnp.asarray(head), jnp.zeros(5), jnp.zeros(5)))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (x, gamma, beta))
    out, nmean, nvar = tnn._batch_norm(tx, tg, tb, torch.from_numpy(mm),
                                       torch.from_numpy(mv), **kw)
    assert not nmean.requires_grad and not nvar.requires_grad
    out.backward(torch.from_numpy(head))
    for got, ref in ((out.detach(), jout), (nmean, jmean), (nvar, jvar),
                     (tx.grad, jdx), (tb.grad, jdb)):
        _close(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    if fix_gamma:
        assert tg.grad is None or torch.equal(tg.grad, torch.zeros(5))
    else:
        _close(tg.grad.numpy(), np.asarray(jdg), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# bucket plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cap,first", [(0, None), (4096, None),
                                       (4096, 1024), (1 << 20, 256)])
def test_bucket_plan_and_round_trip_match_the_jax_helpers(cap, first):
    rng = np.random.RandomState(53)
    names = ["p%d" % i for i in range(9)]
    shapes = [(3, 5, 7), (64,), (1,), (), (33, 2), (128, 9), (5,), (2, 2),
              (300,)]
    tplan = tcoll.build_bucket_plan(names, shapes, cap, first)
    jplan = jcoll.build_bucket_plan(names, shapes, cap, first)
    assert [(b.names, b.shapes, b.offsets, b.n) for b in tplan] == \
        [(b.names, b.shapes, b.offsets, b.n) for b in jplan]
    vals = {n: np.asarray(rng.randn(*s), np.float32)
            for n, s in zip(names, shapes)}
    for tb, jb in zip(tplan, jplan):
        tf = tcoll.flatten_bucket([torch.from_numpy(vals[n]) for n in tb.names],
                                  tb)
        jf = jcoll.flatten_bucket([jnp.asarray(vals[n]) for n in jb.names],
                                  jb)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        views = tcoll.unflatten_bucket(tf, tb)
        for n in tb.names:
            np.testing.assert_array_equal(views[n].numpy(), vals[n])
            assert views[n].data_ptr() >= tf.data_ptr()   # views, no copy


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------
def test_executor_train_forward_backward_matches_jax(small):
    jsym, tsym, arg, aux, x, y = small
    shapes = dict(data=(BATCH,) + SHAPE, softmax_label=(BATCH,))
    jexe = jsym.simple_bind(ctx=jmx.cpu(), grad_req="write", **shapes)
    texe = tsym.simple_bind(ctx=tmx.cpu(), grad_req="write", **shapes)
    assert set(texe.grad_dict) == set(jexe.grad_dict)
    for params, jd, td in ((arg, jexe.arg_dict, texe.arg_dict),
                           (aux, jexe.aux_dict, texe.aux_dict)):
        for k, v in params.items():
            jd[k]._data = jnp.asarray(v)
            td[k]._data = torch.from_numpy(v.copy())
    feeds = dict(data=x[:BATCH], softmax_label=y[:BATCH])
    jout = jexe.forward(is_train=True, **feeds)[0].asnumpy()
    jexe.backward()
    tout = texe.forward(is_train=True, **feeds)[0].asnumpy()
    texe.backward()
    _close(tout, jout, what="outputs")
    for k in jexe.grad_dict:
        _close(texe.grad_dict[k].asnumpy(), jexe.grad_dict[k].asnumpy(),
               what="grad " + k)
    for k in jexe.aux_dict:
        _close(texe.aux_dict[k].asnumpy(), jexe.aux_dict[k].asnumpy(),
               what="aux " + k)
    # grad_req add accumulates: a second forward/backward doubles
    texe2 = tsym.simple_bind(ctx=tmx.cpu(), grad_req="add", **shapes)
    texe2.copy_params_from({k: texe.arg_dict[k] for k in arg},
                           {k: tmx.nd.array(v, ctx=tmx.cpu())
                            for k, v in aux.items()})
    for _ in range(2):
        texe2.forward(is_train=True, **feeds)
        texe2.backward()
    g1 = texe.grad_dict["fc1_weight"].asnumpy()
    _close(texe2.grad_dict["fc1_weight"].asnumpy(), 2 * g1, rtol=1e-3,
           atol=1e-5)


def test_fix_gamma_gamma_gets_an_exact_zero_gradient():
    """A fix_gamma BatchNorm's gamma is unused; autograd materialises its
    gradient as an exact zero, as jax.vjp gives."""
    data = jmx.sym.var("data")
    net = jmx.sym.BatchNorm(data, fix_gamma=True, name="bn")
    net = jmx.sym.FullyConnected(net, num_hidden=3, name="fc")
    jsym = jmx.sym.SoftmaxOutput(net, name="softmax")
    tsym = tmx.sym.load_json(jsym.tojson())
    rng = np.random.RandomState(57)
    x = rng.randn(5, 4).astype(np.float32)
    y = rng.randint(0, 3, 5).astype(np.float32)
    grads = []
    for sym, ctx in ((jsym, jmx.cpu()), (tsym, tmx.cpu())):
        exe = sym.simple_bind(ctx=ctx, grad_req="write", data=(5, 4))
        exe.arg_dict["fc_weight"][:] = rng.randn(3, 4).astype(np.float32)
        exe.arg_dict["bn_gamma"][:] = 3.0
        exe.aux_dict["bn_moving_var"][:] = 1.0
        exe.forward(is_train=True, data=x, softmax_label=y)
        exe.backward()
        grads.append(exe.grad_dict["bn_gamma"].asnumpy())
        assert np.abs(exe.grad_dict["fc_weight"].asnumpy()).max() > 0
    assert np.array_equal(grads[1], np.zeros(4, np.float32))
    assert np.array_equal(grads[0], grads[1])


def test_feature_graph_backward_with_out_grads_matches_jax():
    """A graph without a loss head: a training forward runs the forward
    only (BatchNorm writes its moving stats back), and backward(out_grads)
    runs the graph again seeded with the given head gradients."""
    data = jmx.sym.var("data")
    net = jmx.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                              name="conv")
    net = jmx.sym.BatchNorm(net, fix_gamma=False, name="bn")
    net = jmx.sym.Activation(net, act_type="relu", name="relu")
    jsym = jmx.sym.FullyConnected(net, num_hidden=3, name="fc")
    tsym = tmx.sym.load_json(jsym.tojson())
    rng = np.random.RandomState(59)
    x = rng.randn(2, 2, 5, 5).astype(np.float32)
    head = rng.randn(2, 3).astype(np.float32)
    params = {"conv_weight": rng.randn(4, 2, 3, 3) * 0.3,
              "conv_bias": rng.randn(4) * 0.1, "bn_gamma": rng.rand(4) + 0.5,
              "bn_beta": np.array([1.0, -1.0, 1.0, 1.0]),
              "fc_weight": rng.randn(3, 100) * 0.1, "fc_bias": rng.randn(3)}
    res = []
    for sym, ctx, nd in ((jsym, jmx.cpu(), jmx.nd), (tsym, tmx.cpu(),
                                                     tmx.nd)):
        exe = sym.simple_bind(ctx=ctx, grad_req="write", data=x.shape)
        for k, v in params.items():
            exe.arg_dict[k][:] = v.astype(np.float32)
        exe.aux_dict["bn_moving_var"][:] = 1.0
        out = exe.forward(is_train=True, data=x)[0].asnumpy()
        exe.backward(out_grads=[nd.array(head)] if sym is jsym
                     else [tmx.nd.array(head, ctx=ctx)])
        res.append((out, {k: g.asnumpy() for k, g in exe.grad_dict.items()},
                    exe.aux_dict["bn_moving_mean"].asnumpy()))
    _close(res[1][0], res[0][0])
    _close(res[1][2], res[0][2])
    for k in res[0][1]:
        _close(res[1][1][k], res[0][1][k], what=k)


def test_executor_backward_needs_a_training_forward(small):
    _, tsym, *_ = small
    exe = tsym.simple_bind(ctx=tmx.cpu(), grad_req="write",
                           data=(2,) + SHAPE, softmax_label=(2,))
    with pytest.raises(MXNetError, match="forward"):
        exe.backward()
    with pytest.raises(MXNetError, match="grad_req"):
        tsym.simple_bind(ctx=tmx.cpu(), grad_req="bogus", data=(2,) + SHAPE)


# ---------------------------------------------------------------------------
# the slice as a whole: Module.fit
# ---------------------------------------------------------------------------
def _fit_jax(small, kvstore, optimizer, params):
    jsym, _, arg, aux, x, y = small
    mod = jmx.mod.Module(jsym, context=jmx.cpu())
    met = jmx.metric.create("acc")
    mod.fit(jmx.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=2,
            kvstore=kvstore, optimizer=optimizer, optimizer_params=params,
            arg_params={k: jmx.nd.array(v) for k, v in arg.items()},
            aux_params={k: jmx.nd.array(v) for k, v in aux.items()},
            eval_metric=met)
    a, b = mod.get_params()
    return ({k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in b.items()}, met.get()[1])


def _fit_port(small, kvstore, optimizer, params):
    _, tsym, arg, aux, x, y = small
    args, auxs = tmx.convert.params_from_numpy(arg, aux, tmx.cpu())
    mod = tmx.mod.Module(tsym, context=tmx.cpu())
    met = tmx.metric.create("acc")
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=2,
            kvstore=kvstore, optimizer=optimizer, optimizer_params=params,
            arg_params=args, aux_params=auxs, eval_metric=met)
    a, b = mod.get_params()
    exe = mod._exec_group.execs[0]
    return ({k: v.asnumpy() for k, v in a.items()},
            {k: v.asnumpy() for k, v in b.items()}, met.get()[1],
            mod._fused_exec_update, exe._sweep)


# Adam's epsilon is 1e-3 here: with 1e-8 each step moves a weight by about
# lr * sign(g), so a gradient within rounding of zero can take opposite
# signs in the two packages and move the weight 2 * lr apart
@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 0.001, "wd": 1e-4, "epsilon": 1e-3,
              "clip_gradient": 0.05})],
    ids=["sgd-momentum", "adam-clip"])
def test_module_fit_matches_the_jax_package(small, monkeypatch, optimizer,
                                            params):
    monkeypatch.setenv("MXNET_PALLAS_FUSED_OPT", "1")
    ck.reset_kernel_calls()
    ja, jx, jacc = _fit_jax(small, "tpu", optimizer, params)
    sweep = _fit_port(small, "tpu", optimizer, params)
    local = _fit_port(small, "local", optimizer, params)
    assert sweep[3] and sweep[4] is not None        # the fused sweep ran
    assert not local[3]
    assert len(sweep[4]["plan"]) == 2               # wd_mult 1 and 0
    for k in ja:
        _close(sweep[0][k], ja[k], what=k)
    for k in jx:
        _close(sweep[1][k], jx[k], what=k)
    assert abs(sweep[2] - jacc) <= 1e-6
    # the port's two paths agree bit for bit
    for got, ref in ((sweep[0], local[0]), (sweep[1], local[1])):
        for k in ref:
            assert np.array_equal(got[k].view(np.int32),
                                  ref[k].view(np.int32)), k
    assert sweep[2] == local[2]
    assert set(ck.kernel_calls().values()) == {0}   # plain versions on CPU


def test_module_fused_knob_zero_takes_the_per_array_path(small, monkeypatch):
    params = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
    monkeypatch.setenv("MXNET_PALLAS_FUSED_OPT", "1")
    sweep = _fit_port(small, "tpu", "sgd", params)
    monkeypatch.setenv("MXNET_PALLAS_FUSED_OPT", "0")
    per_array = _fit_port(small, "tpu", "sgd", params)
    assert per_array[3] and per_array[4] is None
    for k in sweep[0]:
        assert np.array_equal(sweep[0][k].view(np.int32),
                              per_array[0][k].view(np.int32)), k
    monkeypatch.delenv("MXNET_PALLAS_FUSED_OPT")
    auto = _fit_port(small, "device", "sgd", params)   # auto: off on CPU
    assert not auto[3]
    for k in sweep[0]:
        assert np.array_equal(sweep[0][k], auto[0][k]), k


def test_runtime_mult_change_demotes_with_slots_carried_over(small,
                                                            monkeypatch):
    """set_wd_mult after install: the bucket no longer shares one wd, so
    the executor demotes to the per-array path; the slots move across
    bit for bit and the next step equals a per-array run's."""
    _, tsym, arg, aux, x, y = small
    monkeypatch.setenv("MXNET_PALLAS_FUSED_OPT", "1")
    batch = tmx.io.DataBatch([tmx.nd.array(x[:BATCH], ctx=tmx.cpu())],
                             [tmx.nd.array(y[:BATCH], ctx=tmx.cpu())])
    mods = []
    for knob in ("1", "0"):
        monkeypatch.setenv("MXNET_PALLAS_FUSED_OPT", knob)
        args, auxs = tmx.convert.params_from_numpy(arg, aux, tmx.cpu())
        mod = tmx.mod.Module(tsym, context=tmx.cpu())
        mod.bind([("data", (BATCH,) + SHAPE)], [("softmax_label", (BATCH,))])
        mod.init_params(arg_params=args, aux_params=auxs)
        mod.init_optimizer(kvstore="tpu", optimizer="sgd", optimizer_params={
            "learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4})
        mods.append(mod)
    for step in range(3):
        if step == 1:
            for mod in mods:
                mod._optimizer.set_wd_mult({"fc1_weight": 0.5})
        for mod in mods:
            mod.forward_backward(batch)
            mod.update()
        if step == 1:
            assert mods[0]._exec_group.execs[0]._sweep is None
    a, b = (m._exec_group.execs[0] for m in mods)
    for n in a.arg_dict:
        assert torch.equal(a.arg_dict[n]._data, b.arg_dict[n]._data), n
    for sa, sb in zip(a._fused_state, b._fused_state):
        assert all(torch.equal(p, q) for p, q in zip(sa, sb))


def test_lr_schedule_step_rewrites_the_device_hyperparameters(small,
                                                             monkeypatch):
    _, tsym, arg, aux, x, y = small
    monkeypatch.setenv("MXNET_PALLAS_FUSED_OPT", "1")
    args, auxs = tmx.convert.params_from_numpy(arg, aux, tmx.cpu())
    mod = tmx.mod.Module(tsym, context=tmx.cpu())
    sched = tmx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    mod.fit(tmx.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
            kvstore="tpu", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "lr_scheduler": sched},
            arg_params=args, aux_params=auxs)
    exe = mod._exec_group.execs[0]
    host, dev = exe._hyper
    # 4 updates with a decay every 2: lr 0.1, 0.1, 0.05, 0.05
    assert host[:, 0].tolist() == [np.float32(0.05)] * 2
    assert torch.equal(dev, torch.from_numpy(host))


# ---------------------------------------------------------------------------
# pieces of the training path
# ---------------------------------------------------------------------------
def test_initializer_name_rules_and_xavier_scale():
    tmx.random.seed(3)
    init = tmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                           magnitude=2)
    arrs = {n: tmx.nd.zeros(s, ctx=tmx.cpu()) for n, s in (
        ("c_weight", (256, 64, 3, 3)), ("c_bias", (5,)), ("bn_gamma", (5,)),
        ("bn_beta", (5,)), ("bn_moving_mean", (5,)), ("bn_moving_var", (5,)))}
    for n, a in arrs.items():
        a[:] = 7.0
        init(tmx.init.InitDesc(n), a)
    w = arrs["c_weight"].asnumpy()
    assert abs(w.std() - np.sqrt(2.0 / (64 * 9))) < 0.01 * np.sqrt(2.0 / 576)\
        * 10
    for n, v in (("c_bias", 0), ("bn_gamma", 1), ("bn_beta", 0),
                 ("bn_moving_mean", 0), ("bn_moving_var", 1)):
        assert (arrs[n].asnumpy() == v).all(), n
    tmx.random.seed(3)
    again = tmx.nd.zeros((256, 64, 3, 3), ctx=tmx.cpu())
    init(tmx.init.InitDesc("c_weight"), again)
    np.testing.assert_array_equal(again.asnumpy(), w)     # seeded
    with pytest.raises(ValueError, match="Unknown initialization"):
        init(tmx.init.InitDesc("mystery"), tmx.nd.zeros((2,), ctx=tmx.cpu()))


def test_schedulers_and_metrics_match_the_jax_package():
    for kind, kw in (("FactorScheduler", {"step": 3, "factor": 0.5}),
                     ("MultiFactorScheduler", {"step": [2, 5],
                                               "factor": 0.1})):
        js = getattr(jmx.lr_scheduler, kind)(**kw)
        ts = getattr(tmx.lr_scheduler, kind)(**kw)
        js.base_lr = ts.base_lr = 0.2
        assert [ts(n) for n in range(1, 9)] == [js(n) for n in range(1, 9)]
    rng = np.random.RandomState(54)
    p = rng.rand(8, 5).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    lab = rng.randint(0, 5, 8).astype(np.float32)
    for name, kw in (("acc", {}), ("ce", {}), ("top_k_accuracy",
                                                {"top_k": 2})):
        jm, tm = jmx.metric.create(name, **kw), tmx.metric.create(name, **kw)
        jm.update([jmx.nd.array(lab)], [jmx.nd.array(p)])
        tm.update([tmx.nd.array(lab, ctx=tmx.cpu())],
                  [tmx.nd.array(p, ctx=tmx.cpu())])
        assert tm.get()[0] == jm.get()[0]
        assert abs(tm.get()[1] - jm.get()[1]) <= 1e-6
    comp = tmx.metric.create(["acc", "ce"])
    comp.update([tmx.nd.array(lab, ctx=tmx.cpu())],
                [tmx.nd.array(p, ctx=tmx.cpu())])
    assert comp.get()[0] == ["accuracy", "cross-entropy"]


def test_ndarray_iter_pads_discards_and_shuffles_from_the_seed():
    x = np.arange(10, dtype=np.float32).reshape(10, 1)
    it = tmx.io.NDArrayIter(x, x[:, 0], batch_size=4)
    batches = list(it)
    assert [b.pad for b in batches] == [0, 0, 2]
    assert batches[2].data[0].asnumpy()[:, 0].tolist() == [8, 9, 0, 1]
    assert batches[0].data[0].context == tmx.cpu()
    it = tmx.io.NDArrayIter(x, batch_size=4, last_batch_handle="discard")
    assert len(list(it)) == 2
    orders = []
    for _ in range(2):
        tmx.random.seed(7)
        it = tmx.io.NDArrayIter(x, batch_size=5, shuffle=True)
        orders.append(np.concatenate([b.data[0].asnumpy()[:, 0]
                                      for b in it]))
    assert orders[0].tolist() == orders[1].tolist()
    assert sorted(orders[0].tolist()) == list(range(10))


def test_kvstore_paths_update_like_the_optimizer():
    w0 = np.random.RandomState(55).randn(3, 4).astype(np.float32)
    g = np.random.RandomState(56).randn(3, 4).astype(np.float32)
    finals = []
    for kind in ("device", "tpu"):
        kv = tmx.kv.create(kind)
        assert kv.type == kind and kv.rank == 0 and kv.num_workers == 1
        kv.set_optimizer(tmx.optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9, wd=1e-3,
            param_idx2name={0: "a_weight"}))
        kv.init("a_weight", tmx.nd.array(w0, ctx=tmx.cpu()))
        out = tmx.nd.zeros((3, 4), ctx=tmx.cpu())
        for _ in range(2):
            kv.push("a_weight", tmx.nd.array(g, ctx=tmx.cpu()))
            kv.pull("a_weight", out=out)
        finals.append(out.asnumpy())
    upd = tmx.optimizer.get_updater(tmx.optimizer.create(
        "sgd", learning_rate=0.1, momentum=0.9, wd=1e-3,
        param_idx2name={0: "a_weight"}))
    w = tmx.nd.array(w0, ctx=tmx.cpu())
    for _ in range(2):
        upd("a_weight", tmx.nd.array(g, ctx=tmx.cpu()), w)
    for f in finals:
        np.testing.assert_array_equal(f, w.asnumpy())
    # dist_sync is ported (a world of one in a lone process); dist_async
    # comes with the next multi-GPU slice
    assert type(tmx.kv.create("dist_sync")).__name__ == "KVStoreDist"
    with pytest.raises(MXNetError, match="next multi-GPU slice"):
        tmx.kv.create("dist_async")


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------
def test_module_without_gpu_raises_naming_the_gpu(small, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="GPU"):
        tmx.mod.Module(small[1])


def test_new_modules_import_neither_jax_nor_the_jax_package():
    import subprocess
    mods = ("mxnet_tpu_torch.module", "mxnet_tpu_torch.optimizer",
            "mxnet_tpu_torch.kvstore", "mxnet_tpu_torch.metric",
            "mxnet_tpu_torch.initializer", "mxnet_tpu_torch.io",
            "mxnet_tpu_torch.random", "mxnet_tpu_torch.lr_scheduler",
            "mxnet_tpu_torch.callback", "mxnet_tpu_torch.model",
            "mxnet_tpu_torch.parallel.collectives",
            "mxnet_tpu_torch.ops.optimizer_ops")
    code = ("import sys, importlib\n"
            "for m in %r: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')))" % (mods,))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# rehearsal of chip_smoke.py's training phases on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_training_phases_rehearse_on_the_cpu(small, monkeypatch):
    """chip_smoke's train() and parity() with ctx=cpu(), a ResNet-20 and
    2 steps, knobs at 1: the counting wrappers patched over the kernel
    wrappers see buckets x steps sweeps and one softmax per step."""
    import chip_smoke
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

    for name in ("sgd_mom_sweep", "sgd_sweep", "adam_sweep",
                 "softmax_lastaxis"):
        monkeypatch.setattr(ck, name, counting(name, getattr(ck, name)))
    tsym = small[1]
    mod, tr = chip_smoke.train(tmx, ck, tmx.cpu(), tsym, SHAPE, BATCH, 2,
                               warmup=1, classes=10)
    assert tr["fused"] and tr["kernel"] == "sgd_mom_sweep"
    assert len(tr["buckets"]) == 2 and tr["steps"] == 3
    assert seen == {"sgd_mom_sweep": 6, "softmax_lastaxis": 3}
    assert set(tr["calls"].values()) == {0}
    assert np.isfinite(tr["ce_first"]) and np.isfinite(tr["ce_last"])
    assert tr["step_ms"] > 0
    arg, aux = mod.get_params()
    par = chip_smoke.parity(tmx, ck, tmx.cpu(), tsym, SHAPE, BATCH,
                            {k: v.copy() for k, v in arg.items()},
                            {k: v.copy() for k, v in aux.items()},
                            classes=10, on="1")
    assert par["bitwise"] and par["tensors"] > 0
    _, adam = chip_smoke.train(tmx, ck, tmx.cpu(), tsym, SHAPE, BATCH, 1,
                               optimizer="adam",
                               optimizer_params={"learning_rate": 1e-3},
                               arg_params=arg, aux_params=aux, classes=10)
    assert adam["kernel"] == "adam_sweep" and seen["adam_sweep"] == 2
