"""The port's autograd, backward kernels' plain versions, losses and
Trainer against the JAX package, on the CPU.

The same numpy inputs (fixed seeds) go through the JAX function and its
counterpart in ``mxnet_tpu_torch``.  The JAX package's Pallas kernels
run under ``jax.vjp``, which is interpret mode off the TPU, as
tests/test_pallas.py runs them; the port's wrappers take their plain
versions on CPU tensors.  The CUDA kernels themselves are held against
those plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.parallel import attention as jatt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.parallel import attention as tatt

torch.set_num_threads(1)

CPU = tmx.cpu()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want):
    """max |got - want| over want's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _nd(pkg, a):
    return pkg.nd.array(a) if pkg is jmx else pkg.nd.array(a, ctx=CPU)


# ---------------------------------------------------------------------------
# K6b: the LayerNorm backward, through the op's autograd Function
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c", [37, 128, 1000, 1025])
def test_k6b_plain_matches_jax_fused_layernorm_vjp(c, monkeypatch):
    """dx, dgamma and dbeta within 1e-5 of their largest magnitude: the
    port's LayerNorm op under ``record()`` (K6a's plain version forward,
    K6b's backward) against ``jax.vjp`` of ``fused_layernorm``."""
    monkeypatch.setenv("MXNET_PALLAS_NORM", "1")
    rng = np.random.RandomState(80)
    x = (rng.randn(3, 5, c) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    do = rng.randn(3, 5, c).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: pk.fused_layernorm(*a, 1e-5),
                     jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    want = vjp(jnp.asarray(do))
    calls = []
    real = ck.layernorm_bwd
    monkeypatch.setattr(ck, "layernorm_bwd",
                        lambda *a: calls.append(a) or real(*a))
    arrays = [_nd(tmx, a) for a in (x, g, b)]
    for a in arrays:
        a.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.LayerNorm(*arrays)
    y.backward(_nd(tmx, do))
    assert len(calls) == 1
    for a, w in zip(arrays, want):
        assert _rel(a.grad.asnumpy(), w) <= 1e-5
    # the wrapper's plain version alone, from K6a's plain mu and rstd
    _, mu, rstd = ck.layernorm_fwd(_t(x), _t(g), _t(b), 1e-5)
    dx = ck.layernorm_bwd(_t(x), _t(do), _t(g), mu, rstd)
    assert _rel(dx.numpy(), want[0]) <= 1e-5


def test_k6b_reads_one_mu_and_rstd_per_row():
    x = torch.zeros(4, 6)
    with pytest.raises(MXNetError, match="one per row"):
        ck.layernorm_bwd(x, x, torch.ones(6), torch.zeros(4, 128),
                         torch.ones(4, 128))


# ---------------------------------------------------------------------------
# K7b / K7c: the flash-attention backward
# ---------------------------------------------------------------------------
def _flash_case(seed, bh, tq, tk, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(bh, t, d).astype(np.float32)
            for t in (tq, tk, tk, tq)]


@pytest.mark.parametrize("d", [16, 32, 72])
@pytest.mark.parametrize("t", [16, 72])
@pytest.mark.parametrize("causal", [True, False])
def test_k7b_k7c_plain_match_jax_flash_attention_vjp(causal, t, d):
    """dq, dk and dv within 1e-5 against ``jax.vjp`` of the JAX package's
    ``flash_attention`` (its three Pallas kernels in interpret mode); D
    72 is a width the CUDA kernels pad to 80."""
    q, k, v, do = _flash_case(81 + t + d, 4, t, t, d)
    _flash_bwd_against_jax(q, k, v, do, causal)


@pytest.mark.parametrize("tq,tk", [(16, 40), (40, 16)])
def test_k7b_k7c_plain_match_jax_when_tq_differs_from_tk(tq, tk):
    q, k, v, do = _flash_case(82, 4, tq, tk, 32)
    _flash_bwd_against_jax(q, k, v, do, False)


def _flash_bwd_against_jax(q, k, v, do, causal):
    _, vjp = jax.vjp(lambda *a: pk.flash_attention(*a, causal),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(_t, (q, k, v, do))
    o, lse = ck.flash_attention_fwd(tq, tk, tv, causal)
    delta = (tdo * o).sum(-1)
    dq = ck.flash_attention_bwd_dq(tq, tk, tv, tdo, lse, delta, causal)
    dk, dv = ck.flash_attention_bwd_dkv(tq, tk, tv, tdo, lse, delta, causal)
    for got, w in zip((dq, dk, dv), want):
        assert got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_local_attention_flash_differentiates_like_jax(causal):
    """``local_attention(impl="flash")`` end to end, GQA heads included:
    the outputs' vjp against the JAX package's."""
    rng = np.random.RandomState(83)
    q = rng.randn(2, 24, 4, 16).astype(np.float32)
    k, v = (rng.randn(2, 24, 2, 16).astype(np.float32) for _ in range(2))
    do = rng.randn(2, 24, 4, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jatt.local_attention(*a, causal=causal,
                                                     impl="flash"),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    ins = [_t(a).requires_grad_() for a in (q, k, v)]
    o = tatt.local_attention(*ins, causal=causal, impl="flash")
    got = torch.autograd.grad(o, ins, _t(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# K5b: the softmax backward, with and without the bias
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_bias,masked", [(False, False), (True, False),
                                              (True, True)])
def test_k5b_plain_matches_jax_fused_bias_softmax_vjp(with_bias, masked):
    """dx within 1e-6 against ``jax.vjp`` of ``fused_bias_softmax``, and
    dbias (the sum of dx over the leading dim) where a bias needs one."""
    rng = np.random.RandomState(84)
    x = (rng.randn(6, 12, 20) * 3).astype(np.float32)
    do = rng.randn(6, 12, 20).astype(np.float32)
    bias = (rng.randn(12, 20) * 0.5).astype(np.float32)
    if masked:
        bias = np.where(np.tril(np.ones((12, 20), bool)), 0.0,
                        pk.NEG_INF).astype(np.float32)
    xs = [x] + ([bias] if with_bias else [])
    _, vjp = jax.vjp(pk.fused_bias_softmax, *map(jnp.asarray, xs))
    want = vjp(jnp.asarray(do))
    ins = [_t(a).requires_grad_() for a in xs]
    p = tatt._FusedSoftmax.apply(ins[0], ins[1] if with_bias else None)
    got = torch.autograd.grad(p, ins, _t(do))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    if with_bias:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("knob", ["1", "0"])
def test_local_attention_einsum_route_differentiates_like_jax(knob,
                                                              monkeypatch):
    """The causal einsum route, through K5a/K5b's plain versions (knob 1,
    the mask a bias that needs no gradient) or torch's softmax (knob 0),
    against the JAX package's route with the same knob."""
    monkeypatch.setenv("MXNET_PALLAS_SOFTMAX", knob)
    rng = np.random.RandomState(85)
    q, k, v, do = (rng.randn(2, 12, 2, 8).astype(np.float32)
                   for _ in range(4))
    _, vjp = jax.vjp(lambda *a: jatt.local_attention(*a, causal=True),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    calls = []
    real = ck.softmax_bwd
    monkeypatch.setattr(ck, "softmax_bwd",
                        lambda *a: calls.append(a) or real(*a))
    ins = [_t(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(tatt.local_attention(*ins, causal=True), ins,
                              _t(do))
    assert len(calls) == (1 if knob == "1" else 0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# autograd on small expressions
# ---------------------------------------------------------------------------
X = np.array([[0.5, -1.0, 2.0], [1.5, 0.25, -0.75]], np.float32)
HG = np.array([[1.0, -2.0, 0.5], [3.0, 1.0, -1.0]], np.float32)


def _expr(pkg, x):
    return (x * x * x + 2 * x).exp() / 10 + (x * 3 - 1) ** 2


@pytest.mark.parametrize("req", ["write", "add"])
def test_attach_grad_write_and_add_match_jax(req):
    """Two backward passes: ``write`` keeps the last gradient, ``add``
    sums both, as in the JAX package."""
    out = {}
    for pkg in (jmx, tmx):
        x = _nd(pkg, X)
        x.attach_grad(req)
        for _ in range(2):
            with pkg.autograd.record():
                y = _expr(pkg, x).sum()
            y.backward()
        out[pkg] = x.grad.asnumpy()
    np.testing.assert_allclose(out[tmx], out[jmx], rtol=1e-6)


def test_attach_grad_null_takes_no_gradient():
    """``null`` keeps a zero buffer that no backward writes (MXNet's
    kNullOp); a ``write`` variable in the same expression gets its
    gradient, as in the JAX package."""
    out = {}
    for pkg in (jmx, tmx):
        x, z = _nd(pkg, X), _nd(pkg, HG)
        x.attach_grad("null")
        z.attach_grad()
        with pkg.autograd.record():
            y = (x * z * z).sum()
        y.backward()
        out[pkg] = z.grad.asnumpy()
        if pkg is tmx:
            assert not x.grad.asnumpy().any()
    np.testing.assert_allclose(out[tmx], out[jmx], rtol=1e-6)


def test_backward_with_head_gradients_matches_jax():
    """One head with its gradient, then two heads at once (one with a
    gradient, one with the default ones)."""
    out = {}
    for pkg in (jmx, tmx):
        x = _nd(pkg, X)
        x.attach_grad()
        with pkg.autograd.record():
            y = _expr(pkg, x)
        y.backward(_nd(pkg, HG))
        one = x.grad.asnumpy()
        with pkg.autograd.record():
            y1, y2 = x * x, (x + 1).exp()
        pkg.autograd.backward([y1, y2], [_nd(pkg, HG), None])
        out[pkg] = (one, x.grad.asnumpy())
    for a, b in zip(out[tmx], out[jmx]):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_grad_and_second_derivative_match_jax():
    """``grad`` returns new arrays and leaves the buffer alone; with
    ``create_graph`` its result records, so a second backward gives
    d/dx sum((dy/dx)^2)."""
    out = {}
    for pkg in (jmx, tmx):
        x = _nd(pkg, X)
        x.attach_grad()
        with pkg.autograd.record():
            y = (x * x * x).sum()
        dx = pkg.autograd.grad(y, [x])[0]
        assert not x.grad.asnumpy().any()
        with pkg.autograd.record():
            y = (x * x * x + x.exp()).sum()
            dx2 = pkg.autograd.grad(y, [x], create_graph=True)[0]
            z = (dx2 * dx2).sum()
        z.backward()
        out[pkg] = (dx.asnumpy(), dx2.asnumpy(), x.grad.asnumpy())
    for a, b in zip(out[tmx], out[jmx]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    np.testing.assert_allclose(out[tmx][0], 3 * X * X, rtol=1e-6)


def test_retain_graph_pause_and_mark_variables_match_jax():
    """``retain_graph`` keeps the graph for a second backward (added into
    an ``add`` buffer); ``pause`` keeps its ops out of the graph;
    ``mark_variables`` attaches a given buffer."""
    out = {}
    for pkg in (jmx, tmx):
        x = _nd(pkg, X)
        x.attach_grad("add")
        with pkg.autograd.record():
            y = _expr(pkg, x).sum()
        y.backward(retain_graph=True)
        y.backward()
        retained = x.grad.asnumpy()
        z, buf = _nd(pkg, X), _nd(pkg, np.zeros_like(X))
        pkg.autograd.mark_variables([z], [buf])
        with pkg.autograd.record():
            a = z * 2
            with pkg.autograd.pause():
                c = z * 3
                assert not pkg.autograd.is_recording()
            w = (a * c).sum()
        w.backward()
        out[pkg] = (retained, buf.asnumpy())
    for a, b in zip(out[tmx], out[jmx]):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    np.testing.assert_allclose(out[tmx][1], 6 * X, rtol=1e-6)


def test_backward_twice_without_retain_graph_raises():
    """The graph is freed by the first backward; the port raises on a
    second one (the JAX package returns without writing anything)."""
    x = _nd(tmx, X)
    x.attach_grad()
    with tmx.autograd.record():
        y = (x * x).sum()
    y.backward()
    with pytest.raises(MXNetError, match="retain_graph"):
        y.backward()


def test_unconnected_heads_and_unmarked_variables_raise():
    x, w = _nd(tmx, X), _nd(tmx, X)
    with tmx.autograd.record():
        y = (w * 2).sum()
    with pytest.raises(MXNetError, match="not connected"):
        y.backward()
    x.attach_grad()
    with tmx.autograd.record():
        y = (x * w).sum()
    with pytest.raises(MXNetError, match="not marked"):
        tmx.autograd.grad(y, [w])
    y2 = (x * 2).sum()        # outside record(): nothing records
    with pytest.raises(MXNetError, match="not connected"):
        y2.backward()


def _custom_sigmoid(pkg):
    class Sigmoid(pkg.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + (-x).exp())
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)
    return Sigmoid()


def test_custom_function_matches_jax():
    out = {}
    for pkg in (jmx, tmx):
        x = _nd(pkg, X)
        x.attach_grad()
        with pkg.autograd.record():
            y = _custom_sigmoid(pkg)(x * 2)
            z = (y * y).sum()
        z.backward()
        out[pkg] = (y.asnumpy(), x.grad.asnumpy())
    for a, b in zip(out[tmx], out[jmx]):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_setitem_records_and_refuses_marked_variables():
    """Under ``record()`` a write of a recorded value into a plain array
    records (the gradient flows through the written region); a write
    into a marked variable raises MXNetError, not a torch error; outside
    ``record()`` it writes."""
    out = {}
    for pkg in (jmx, tmx):
        x = _nd(pkg, X)
        x.attach_grad()
        with pkg.autograd.record():
            buf = _nd(pkg, np.zeros((2, 3), np.float32))
            buf[0:1] = x[0:1] * 3
            y = (buf * buf).sum()
        y.backward()
        out[pkg] = x.grad.asnumpy()
    np.testing.assert_allclose(out[tmx], out[jmx], rtol=1e-6)
    x = _nd(tmx, X)
    x.attach_grad()
    with tmx.autograd.record():
        with pytest.raises(MXNetError, match="in-place write"):
            x[:] = 1.0
    x[:] = 1.0
    assert (x.asnumpy() == 1).all() and x._data.requires_grad


def test_detach_and_training_flags():
    x = _nd(tmx, X)
    x.attach_grad()
    assert not tmx.autograd.is_recording() and not tmx.autograd.is_training()
    with tmx.autograd.record():
        assert tmx.autograd.is_recording() and tmx.autograd.is_training()
        y = (x.detach() * 2 + x).sum()
        with tmx.autograd.predict_mode():
            assert not tmx.autograd.is_training()
    y.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), np.ones_like(X))
    with tmx.autograd.train_mode():
        assert tmx.autograd.is_training() and not tmx.autograd.is_recording()


# ---------------------------------------------------------------------------
# Dropout in training mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keeps_one_minus_p_scaled(p):
    """Over 1e5 elements the kept share is 1 - p within 5 standard
    deviations, kept values are scaled by 1 / (1 - p), the gradient is
    the mask scaled alike, and predict mode is the identity.  The JAX
    package draws from threefry and the port from Philox, so the masks
    themselves are not compared."""
    tmx.random.seed(7)
    x = _nd(tmx, np.full((100, 1000), 2.0, np.float32))
    x.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.Dropout(x, p=p)
    y.backward()
    out = y.asnumpy()
    kept = out != 0
    share = kept.mean()
    assert abs(share - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / out.size)
    np.testing.assert_allclose(out[kept], 2.0 / (1 - p), rtol=1e-6)
    np.testing.assert_array_equal(x.grad.asnumpy() != 0, kept)
    np.testing.assert_allclose(x.grad.asnumpy()[kept], 1 / (1 - p),
                               rtol=1e-6)
    np.testing.assert_array_equal(tmx.nd.Dropout(x, p=p).asnumpy(),
                                  x.asnumpy())
    with tmx.autograd.train_mode():
        row = tmx.nd.Dropout(x, p=p, axes=(1,)).asnumpy()
    assert ((row == 0) | (row == 2.0 / (1 - p))).all()
    assert (row == row[:, :1]).all()      # one decision per row


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------
def _loss_case(name):
    rng = np.random.RandomState(86)
    pred = (rng.randn(6, 10) * 2).astype(np.float32)
    if name == "SoftmaxCrossEntropyLoss":
        label = rng.randint(0, 10, (6,)).astype(np.float32)
    else:
        label = rng.randn(6, 10).astype(np.float32)
    return pred, label, rng.rand(6, 1).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["SoftmaxCrossEntropyLoss", "L2Loss",
                                  "L1Loss"])
def test_losses_and_their_gradients_match_jax(name, weighted):
    pred, label, sw = _loss_case(name)
    out = {}
    for pkg in (jmx, tmx):
        kw = {"weight": 0.5} if weighted else {}
        loss_fn = getattr(pkg.gluon.loss, name)(**kw)
        p = _nd(pkg, pred)
        p.attach_grad()
        args = [p, _nd(pkg, label)] + ([_nd(pkg, sw)] if weighted else [])
        with pkg.autograd.record():
            loss = loss_fn(*args)
        loss.backward()
        out[pkg] = (loss.asnumpy(), p.grad.asnumpy())
    assert out[tmx][0].shape == (6,)
    for a, b in zip(out[tmx], out[jmx]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------
W0 = np.random.RandomState(87).randn(4, 5).astype(np.float32)
C = np.random.RandomState(88).randn(4, 5).astype(np.float32)


def _trainer_steps(pkg, optimizer, params, steps=2):
    p = pkg.gluon.Parameter("w", shape=W0.shape)
    if pkg is jmx:
        p.initialize()
    else:
        p.initialize(ctx=CPU)
    p.set_data(_nd(pkg, W0))
    trainer = pkg.gluon.Trainer([p], optimizer, dict(params))
    c = _nd(pkg, C)
    for _ in range(steps):
        with pkg.autograd.record():
            loss = (p.data() * p.data() * c).sum()
        loss.backward()
        trainer.step(4)
    return p.data().asnumpy(), trainer


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("adam", {"learning_rate": 0.01, "epsilon": 1e-3})])
def test_trainer_steps_match_jax(optimizer, params):
    """Two steps from the same weights, the gradients 2 w c scaled by 1 /
    batch: the weights agree within 1e-6 of their largest magnitude."""
    got, trainer = _trainer_steps(tmx, optimizer, params)
    want, _ = _trainer_steps(jmx, optimizer, params)
    assert _rel(got, want) <= 1e-6
    assert _rel(got, W0) > 1e-3
    assert trainer.learning_rate == params["learning_rate"]
    trainer.set_learning_rate(0.5)
    assert trainer.learning_rate == 0.5


def test_trainer_stale_gradient_check_raises_as_in_jax():
    """A parameter with no value (its deferred initialization never
    finished) raises the JAX package's UserWarning in ``step``, unless
    ``ignore_stale_grad``."""
    for pkg in (jmx, tmx):
        p = pkg.gluon.Parameter("w", shape=(0, 3), allow_deferred_init=True)
        if pkg is jmx:
            p.initialize()
        else:
            p.initialize(ctx=CPU)
        trainer = pkg.gluon.Trainer([p], "sgd", {"learning_rate": 0.1})
        with pytest.raises(UserWarning, match="has not been updated"):
            trainer.step(1)
        trainer.step(1, ignore_stale_grad=True)


def test_parameter_grad_zero_grad_and_null():
    net = tmx.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=CPU)
    params = net.collect_params()
    x = _nd(tmx, np.ones((2, 4), np.float32))
    with tmx.autograd.record():
        y = net(x).sum()
    y.backward()
    assert net.weight.grad().asnumpy().any()
    params.zero_grad()
    assert not net.weight.grad().asnumpy().any()
    net.bias.grad_req = "null"
    with pytest.raises(MXNetError, match="grad_req='null'"):
        net.bias.grad()
    with tmx.autograd.record():
        y = net(x).sum()
    y.backward()
    assert net.weight.grad().asnumpy().any()
