"""The port's transformer path against the JAX package, on the CPU.

The same numpy inputs (fixed seeds) go through the JAX function and its
counterpart in ``mxnet_tpu_torch``.  Where the JAX function reaches a
Pallas kernel it runs in interpret mode, as tests/test_pallas.py runs
it; the port's wrappers take their plain versions on CPU tensors.  The
CUDA kernels themselves are held against those plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.contrib import transformer as jtr
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu.parallel import attention as jatt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.contrib import transformer as ttr
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.parallel import attention as tatt

torch.set_num_threads(1)

CPU = tmx.cpu()
KNOBS = ("MXNET_PALLAS_NORM", "MXNET_PALLAS_SOFTMAX")
SMALL = dict(units=128, hidden_size=256, num_layers=2, num_heads=4,
             max_len=32)
VOCAB = 64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _set_knobs(monkeypatch, value):
    for k in KNOBS:
        monkeypatch.setenv(k, value)


# ---------------------------------------------------------------------------
# K6a: LayerNorm forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c", [37, 128])
def test_k6a_plain_matches_jax_fused_layernorm(c, monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS_NORM", "1")
    rng = np.random.RandomState(50)
    x = (rng.randn(3, 7, c) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    jo, (_, _, jmu, jrs) = pk._layernorm_fwd(jnp.asarray(x), jnp.asarray(g),
                                             jnp.asarray(b), 1e-5)
    o, mu, rstd = ck.layernorm_fwd(_t(x), _t(g), _t(b), 1e-5)
    assert o.shape == x.shape and mu.shape == rstd.shape == (3, 7)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(mu.numpy().ravel(), np.asarray(jmu)[:, 0],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy().ravel(), np.asarray(jrs)[:, 0],
                               rtol=1e-5)
    # the op, knob on (the wrapper's plain version) and off (the plain
    # chain), against the JAX op with the same knob
    for knob in ("1", "0"):
        monkeypatch.setenv("MXNET_PALLAS_NORM", knob)
        want = np.asarray(jget_op("LayerNorm").fn(
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
        got = tmx.nd.LayerNorm(tmx.nd.array(x, ctx=CPU),
                               tmx.nd.array(g, ctx=CPU),
                               tmx.nd.array(b, ctx=CPU)).asnumpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_layernorm_op_other_axis_takes_the_plain_chain(monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS_NORM", "1")
    rng = np.random.RandomState(51)
    x = rng.randn(4, 6, 5).astype(np.float32)
    g, b = rng.rand(6).astype(np.float32) + 0.5, rng.randn(6).astype(
        np.float32)
    want = np.asarray(jget_op("LayerNorm").fn(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), axis=1))
    calls = []
    monkeypatch.setattr(ck, "layernorm_fwd",
                        lambda *a: calls.append(a) or (None,))
    got = tmx.nd.LayerNorm(tmx.nd.array(x, ctx=CPU), tmx.nd.array(g, ctx=CPU),
                           tmx.nd.array(b, ctx=CPU), axis=1).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not calls


# ---------------------------------------------------------------------------
# K5a: softmax(x + bias)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [True, False])
def test_k5a_plain_matches_jax_fused_bias_softmax(masked):
    rng = np.random.RandomState(52)
    x = (rng.randn(6, 12, 20) * 3).astype(np.float32)
    if masked:
        bias = np.where(np.tril(np.ones((12, 20), bool)), 0.0,
                        pk.NEG_INF).astype(np.float32)
    else:
        bias = (rng.randn(12, 20) * 0.5).astype(np.float32)
    want = np.asarray(pk.fused_bias_softmax(jnp.asarray(x),
                                            jnp.asarray(bias)))
    got = ck.bias_softmax(_t(x), _t(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if masked:
        assert (got[:, ~np.tril(np.ones((12, 20), bool))] == 0).all()


def test_k5a_bias_rows_must_match():
    with pytest.raises(MXNetError, match="bias rows"):
        ck.bias_softmax(torch.zeros(4, 10, 17), torch.zeros(20, 17))
    with pytest.raises(MXNetError, match="float32"):
        ck.bias_softmax(torch.zeros(4, 10, 17),
                        torch.zeros(10, 17, dtype=torch.float64))


# ---------------------------------------------------------------------------
# K7a through local_attention, and the routes
# ---------------------------------------------------------------------------
def _qkv(seed, b=2, t=32, h=4, hkv=4, d=32):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, h, d).astype(np.float32),
            rng.randn(b, t, hkv, d).astype(np.float32),
            rng.randn(b, t, hkv, d).astype(np.float32))


@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_local_attention_flash_matches_jax(causal, hkv):
    q, k, v = _qkv(53, hkv=hkv)
    want = np.asarray(jatt.local_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        impl="flash"))
    got = tatt.local_attention(_t(q), _t(k), _t(v), causal=causal,
                               impl="flash")
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_flash_attention_lse_matches_jax():
    rng = np.random.RandomState(54)
    q, k, v = (rng.randn(3, 40, 16).astype(np.float32) for _ in range(3))
    jo, (_, _, _, _, jlse) = pk._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), True, None, 128,
                                           128)
    o, lse = ck.flash_attention_fwd(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("knob", ["1", "0"])
@pytest.mark.parametrize("causal,q_offset,kv_offset",
                         [(True, 0, 0), (False, 0, 0), (True, 4, 0)])
def test_local_attention_einsum_routes_match_jax(knob, causal, q_offset,
                                                 kv_offset, monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS_SOFTMAX", knob)
    q, k, v = _qkv(55, t=12, hkv=2)
    want = np.asarray(jatt.local_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_offset, kv_offset=kv_offset))
    got = tatt.local_attention(_t(q), _t(k), _t(v), causal=causal,
                               q_offset=q_offset, kv_offset=kv_offset)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_local_attention_empty_causal_rows_keep_loud_path(monkeypatch):
    """q_offset < kv_offset under a causal mask leaves query rows with no
    visible key: the fused softmax's finite NEG_INF would return uniform
    attention there, so the gate keeps the einsum route, whose NaN
    surfaces the misuse; knob on and off agree, as in the JAX package."""
    rng = np.random.RandomState(13)
    q, k, v = (rng.randn(1, 8, 2, 4).astype(np.float32) for _ in range(3))
    want = np.asarray(jatt.local_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=0, kv_offset=4, impl="einsum"))
    outs = {}
    for knob in ("1", "0"):
        monkeypatch.setenv("MXNET_PALLAS_SOFTMAX", knob)
        outs[knob] = tatt.local_attention(
            _t(q), _t(k), _t(v), causal=True, q_offset=0, kv_offset=4,
            impl="einsum").numpy()
        np.testing.assert_array_equal(np.isnan(outs[knob]), np.isnan(want))
    assert np.isnan(outs["1"]).any()
    m = ~np.isnan(want)
    np.testing.assert_allclose(outs["1"][m], want[m], rtol=1e-5, atol=1e-5)


def test_local_attention_wide_heads_under_auto_match_jax():
    """D 320 is past the widest instance of the flash kernels (256):
    ``impl="auto"`` returns the JAX package's result (on the card it takes
    the flash route, whose kernels split D into chunks of 64 columns, held
    by tests/test_torch_cuda.py)."""
    q, k, v = _qkv(57, t=16, h=2, hkv=2, d=320)
    assert q.shape[-1] == 320
    want = np.asarray(jatt.local_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    got = tatt.local_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_flash_route_needs_cuda_under_auto(monkeypatch):
    """On the CPU ``impl="auto"`` never takes the flash kernel, as the JAX
    package never does off the TPU; ``impl="flash"`` forces it."""
    monkeypatch.setenv("MXNET_PALLAS_SOFTMAX", "0")
    calls = []
    real = ck.flash_attention_fwd
    monkeypatch.setattr(ck, "flash_attention_fwd",
                        lambda *a: calls.append(a) or real(*a))
    q, k, v = _qkv(56, t=16)
    tatt.local_attention(_t(q), _t(k), _t(v), causal=True)
    assert not calls
    tatt.local_attention(_t(q), _t(k), _t(v), causal=True, impl="flash")
    assert len(calls) == 1 and calls[0][0].shape == (8, 16, 32)
    assert not tatt._flash_eligible(_t(q), _t(k), True, 0, 0)


# ---------------------------------------------------------------------------
# the ops of the path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,reverse", [
    ((0, 0, 4, 8), False), ((0, 0, -1), False), ((-3, 0), False),
    ((-4, 2, -1, -2), False), ((0, -2), False), ((-1, 8), True)])
def test_reshape_matches_jax(shape, reverse):
    x = np.arange(2 * 5 * 32, dtype=np.float32).reshape(2, 5, 32)
    want = np.asarray(jget_op("Reshape").fn(jnp.asarray(x), shape=shape,
                                            reverse=reverse))
    got = tmx.nd.array(x, ctx=CPU).reshape(shape, reverse=reverse)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.asnumpy(), want)


def test_slice_like_embedding_arange_match_jax():
    rng = np.random.RandomState(57)
    x = rng.randn(1, 10, 3).astype(np.float32)
    like = np.zeros((2, 4, 3), np.float32)
    want = np.asarray(jget_op("slice_like").fn(jnp.asarray(x),
                                               jnp.asarray(like), axes=(1,)))
    got = tmx.nd.slice_like(tmx.nd.array(x, ctx=CPU),
                            tmx.nd.array(like, ctx=CPU), axes=(1,))
    np.testing.assert_array_equal(got.asnumpy(), want)
    w = rng.randn(9, 5).astype(np.float32)
    ids = np.array([[0, 8, 3], [2, 2, 7]], np.float32)
    want = np.asarray(jget_op("Embedding").fn(
        jnp.asarray(ids), jnp.asarray(w), input_dim=9, output_dim=5))
    got = tmx.nd.Embedding(tmx.nd.array(ids, ctx=CPU),
                           tmx.nd.array(w, ctx=CPU), input_dim=9,
                           output_dim=5)
    np.testing.assert_array_equal(got.asnumpy(), want)
    for args in ((0, 7), (2, 11, 3), (5,)):
        want = np.asarray(jget_op("_arange").fn(*args))
        got = tmx.nd.arange(*args, ctx=CPU)
        assert got.dtype == "float32"
        np.testing.assert_array_equal(got.asnumpy(), want)
    np.testing.assert_array_equal(
        tmx.nd.arange(0, 3, repeat=2, ctx=CPU).asnumpy(),
        np.asarray(jget_op("_arange").fn(0, 3, repeat=2)))


def test_ndarray_arithmetic_and_reductions():
    rng = np.random.RandomState(58)
    a, b = rng.rand(3, 4).astype(np.float32) + 0.5, \
        rng.rand(1, 4).astype(np.float32) + 0.5
    x, y = tmx.nd.array(a, ctx=CPU), tmx.nd.array(b, ctx=CPU)
    cases = [(x + y, a + b), (x - y, a - b), (x * y, a * b), (x / y, a / b),
             (x ** y, a ** b), (x + 2, a + 2), (2 + x, 2 + a), (x - 2, a - 2),
             (2 - x, 2 - a), (x * 3, a * 3), (3 * x, 3 * a), (x / 4, a / 4),
             (4 / x, 4 / a), (x ** 2, a ** 2), (2 ** x, 2 ** a),
             (x.sum(), a.sum()), (x.mean(axis=1), a.mean(axis=1)),
             (x.sum(axis=0, keepdims=True), a.sum(axis=0, keepdims=True)),
             (x.expand_dims(1), a[:, None])]
    for got, want in cases:
        assert got.shape == np.shape(want)
        np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-6)
    ints = tmx.nd.array(np.array([1, 2, 3], np.int32), ctx=CPU)
    assert (ints + 1).dtype == "int32"


# ---------------------------------------------------------------------------
# the model against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_lm():
    """The JAX TransformerLM at small width, initialized from a seed, and
    its parameters as numpy arrays."""
    jmx.random.seed(3)
    lm = jtr.TransformerLM(VOCAB, **SMALL)
    lm.initialize(jmx.init.Xavier())
    lm(jmx.nd.zeros((1, 4)))       # finishes the deferred shapes
    arrays = {k: v.data().asnumpy() for k, v in lm.collect_params().items()}
    # LayerNorm's gamma and beta start at 1 and 0: move them so a mix-up
    # of the two, or of one layer's with another's, shows
    rng = np.random.RandomState(59)
    for k, v in arrays.items():
        if k.endswith(("gamma", "beta", "bias")):
            arrays[k] = (v + 0.2 * rng.randn(*v.shape)).astype(np.float32)
            lm.collect_params()[k].set_data(jmx.nd.array(arrays[k]))
    return lm, arrays, {}


def _tokens(t):
    return np.random.RandomState(60 + t).randint(0, VOCAB, (2, t)).astype(
        np.float32)


def _jax_logits(jax_lm, t, knob, monkeypatch):
    lm, _, cache = jax_lm
    if (t, knob) not in cache:
        _set_knobs(monkeypatch, knob)
        cache[t, knob] = lm(jmx.nd.array(_tokens(t))).asnumpy()
    return cache[t, knob]


def _port_lm(arrays, hybridize=False):
    lm = ttr.TransformerLM(VOCAB, **SMALL)
    lm.initialize(tmx.init.Xavier(), ctx=CPU)
    tmx.convert.block_params_from_numpy(lm, arrays, ctx=CPU)
    if hybridize:
        lm.hybridize()
    return lm


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("knob", ["1", "0"])
@pytest.mark.parametrize("t", [16, 12])
def test_transformer_lm_logits_match_jax(jax_lm, t, knob, hybridize,
                                         monkeypatch):
    want = _jax_logits(jax_lm, t, knob, monkeypatch)
    lm = _port_lm(jax_lm[1], hybridize)
    _set_knobs(monkeypatch, knob)
    got = lm(tmx.nd.array(_tokens(t), ctx=CPU))
    assert got.shape == (2, t, VOCAB) and got.dtype == "float32"
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-5, atol=1e-5)


def test_transformer_lm_parameter_names_match_jax(jax_lm):
    lm, arrays, _ = jax_lm
    port = ttr.TransformerLM(VOCAB, **SMALL)
    strip = lambda names, p: [n[len(p):] for n in names]   # noqa: E731
    assert strip(port.collect_params().keys(), port.prefix) == \
        strip(arrays.keys(), lm.prefix)
    assert port.prefix.startswith("transformerlm")
    assert "blocks_transformerencodercell1_ffn_dense0_weight" in \
        strip(port.collect_params().keys(), port.prefix)


def test_transformer_lm_routes_on_the_cpu(jax_lm, monkeypatch):
    """Knobs 1: every LayerNorm goes through ``layernorm_fwd`` and every
    attention through ``bias_softmax`` (the flash route needs CUDA), each
    taking its plain version, so no kernel launches; knobs 0: none of
    the wrappers is called."""
    lm = _port_lm(jax_lm[1])
    names = ("layernorm_fwd", "bias_softmax", "softmax_lastaxis",
             "flash_attention_fwd")
    for knob, want in (("1", {"layernorm_fwd": 5, "bias_softmax": 2}),
                       ("0", {})):
        _set_knobs(monkeypatch, knob)
        taken = dict.fromkeys(names, 0)
        for n in names:
            real = getattr(ck, n)

            def counting(*a, _n=n, _real=real, **kw):
                taken[_n] += 1
                return _real(*a, **kw)
            monkeypatch.setattr(ck, n, counting)
        ck.reset_kernel_calls()
        lm(tmx.nd.array(_tokens(16), ctx=CPU))
        assert {k: v for k, v in taken.items() if v} == want
        assert not any(ck.kernel_calls().values())
        monkeypatch.undo()


def test_block_params_from_numpy_raises_on_mismatch(jax_lm):
    arrays = dict(jax_lm[1])
    lm = ttr.TransformerLM(VOCAB, **SMALL)
    lm.initialize(ctx=CPU)
    gone = next(iter(arrays))
    with pytest.raises(MXNetError, match="missing.*embedding0_weight"):
        tmx.convert.block_params_from_numpy(
            lm, {k: v for k, v in arrays.items() if k != gone}, ctx=CPU)
    # the stray name takes the JAX block's root prefix, whose count
    # depends on how many blocks this process named before it
    stray = gone.split("_", 1)[0] + "_stray"
    with pytest.raises(MXNetError, match="lacks.*stray"):
        tmx.convert.block_params_from_numpy(
            lm, dict(arrays, **{stray: np.zeros(3)}), ctx=CPU)
    bad = dict(arrays)
    bad[gone] = np.zeros((VOCAB + 1, SMALL["units"]), np.float32)
    with pytest.raises(MXNetError, match="embedding0_weight"):
        tmx.convert.block_params_from_numpy(lm, bad, ctx=CPU)


def test_initialize_defaults_to_the_gpu_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lm = ttr.TransformerLM(VOCAB, **SMALL)
    with pytest.raises(MXNetError, match="GPU"):
        lm.initialize(tmx.init.Xavier())
    with pytest.raises(MXNetError, match="GPU"):
        tmx.nd.arange(0, 4)


def test_deferred_shapes_finish_at_the_first_forward():
    lm = ttr.TransformerLM(VOCAB, **SMALL)
    lm.initialize(tmx.init.Xavier(), ctx=CPU)
    w = lm.blocks[0].ffn[0].weight
    assert w.shape == (SMALL["hidden_size"], 0)
    with pytest.raises(tmx.gluon.DeferredInitializationError):
        w.data()
    lm(tmx.nd.array(_tokens(4), ctx=CPU))
    assert w.shape == (SMALL["hidden_size"], SMALL["units"])
    assert w.data().shape == w.shape and w.data().context == CPU
    assert lm.embed.weight.data().shape == (VOCAB, SMALL["units"])
    assert lm.ln_f.gamma.data().asnumpy().tolist() == [1.0] * SMALL["units"]
    assert not lm.head.bias.data().asnumpy().any()
    # set_data keeps the device and dtype; a deferred parameter takes the
    # shape it is given
    lm.ln_f.beta.set_data(np.full(SMALL["units"], 0.5))
    assert lm.ln_f.beta.data().dtype == "float32"
    assert (lm.ln_f.beta.data().asnumpy() == 0.5).all()
    fresh = ttr.TransformerLM(VOCAB, **SMALL)
    fresh.initialize(ctx=CPU)
    fresh.ln_f.gamma.set_data(np.ones(SMALL["units"], np.float32))
    assert fresh.ln_f.gamma.shape == (SMALL["units"],)
    assert fresh.ln_f.gamma.data().context == CPU
    with pytest.raises(MXNetError, match="incompatible"):
        lm.ln_f.beta.set_data(np.zeros(SMALL["units"] + 1))


def test_record_backward_and_training_mode_dropout_work():
    """Under ``record()`` the model records and ``backward`` fills every
    parameter's gradient; ``attach_grad`` and ``autograd.grad`` work on
    the inputs of the path; training-mode Dropout drops units, and
    predict mode is unchanged, the identity."""
    lm = ttr.TransformerLM(VOCAB, dropout=0.1, **SMALL)
    lm.initialize(tmx.init.Xavier(), ctx=CPU)
    x = tmx.nd.array(_tokens(8), ctx=CPU)
    out = lm(x)       # predict mode: Dropout is the identity
    assert out.shape == (2, 8, VOCAB)
    assert not tmx.autograd.is_recording() and not tmx.autograd.is_training()
    with tmx.autograd.record():
        assert tmx.autograd.is_recording() and tmx.autograd.is_training()
        trained = lm(x)
        loss = (trained * trained).mean()
    loss.backward()
    assert not np.allclose(trained.asnumpy(), out.asnumpy())
    for p in lm.collect_params().values():
        assert p.grad().shape == p.shape and p.grad().asnumpy().any(), p.name
    with tmx.autograd.train_mode():
        assert not np.allclose(lm(x).asnumpy(), out.asnumpy())
    with tmx.autograd.predict_mode():
        np.testing.assert_array_equal(lm(x).asnumpy(), out.asnumpy())
    np.testing.assert_array_equal(lm(x).asnumpy(), out.asnumpy())
    h = tmx.nd.array(np.random.RandomState(61).randn(2, 8, SMALL["units"])
                     .astype(np.float32), ctx=CPU)
    h.attach_grad()
    with tmx.autograd.record():
        y = lm.ln_f(h).sum()
    (dh,) = tmx.autograd.grad(y, [h], retain_graph=True)
    y.backward()
    np.testing.assert_allclose(h.grad.asnumpy(), dh.asnumpy(), rtol=1e-6)
    y = tmx.nd.array(np.ones((2, 3), np.float32), ctx=CPU)
    with tmx.autograd.train_mode():
        np.testing.assert_array_equal(tmx.nd.Dropout(y, p=0.0).asnumpy(), 1)


# ---------------------------------------------------------------------------
# rehearsal of chip_smoke.py's transformer phase on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_transformer_phase_rehearses_on_the_cpu(jax_lm,
                                                          monkeypatch):
    """chip_smoke's transformer path with ctx=cpu() at small width, knobs
    at 1: counting wrappers over the kernel wrappers see 5 LayerNorms and
    2 masked softmaxes per forward (the CPU never takes the flash route
    under ``auto``), no kernel launches, and the plain forward it holds
    the logits against agrees with the JAX package."""
    import chip_smoke
    _set_knobs(monkeypatch, "1")
    seen = {}
    for name in ("layernorm_fwd", "bias_softmax", "flash_attention_fwd"):
        def counting(*a, _n=name, _fn=getattr(ck, name), **kw):
            seen[_n] = seen.get(_n, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ck, name, counting)
    config = dict(SMALL, vocab_size=VOCAB)
    lm = chip_smoke.transformer_lm(tmx, CPU, config)
    tmx.convert.block_params_from_numpy(lm, jax_lm[1], ctx=CPU)
    tokens = chip_smoke.lm_tokens(tmx, CPU, VOCAB, 2, 16)
    logits, r = chip_smoke.lm_forward(ck, lm, tokens, reps=1)
    assert seen == {"layernorm_fwd": 10, "bias_softmax": 4}
    assert not any(r["calls"].values())
    assert r["shape"] == (2, 16, VOCAB) and r["finite"] and r["fwd_ms"] > 0
    dev, mag = chip_smoke.logits_deviation(ck, lm, tokens, logits)
    assert dev <= chip_smoke.LOGIT_TOL and mag > 0
    _set_knobs(monkeypatch, "0")
    want = jax_lm[0](jmx.nd.array(tokens.asnumpy())).asnumpy()
    np.testing.assert_allclose(
        chip_smoke.plain_forward(ck, lm, tokens._data).numpy(), want,
        rtol=1e-5, atol=1e-5)
