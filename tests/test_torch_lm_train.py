"""The port's transformer training path against the JAX package, on the CPU.

A small ``TransformerLM`` is built and initialized by the JAX package,
its weights carried to the port by ``convert.block_params_from_numpy``,
and both take the canonical training step three times on one fixed
batch: ``autograd.record()`` -> ``SoftmaxCrossEntropyLoss`` -> ``.mean()``
-> ``backward()`` -> ``gluon.Trainer("adam").step(1)``.  With the kernel
knobs at 1 the JAX package runs its Pallas LayerNorm and masked softmax
in interpret mode and the port the plain versions of K6a/K6b and
K5a/K5b; at 0 both run plain reductions.  On the CPU neither takes the
flash route under ``impl="auto"``; K7b and K7c are held at the op level
(tests/test_torch_autograd.py) and on the card.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.contrib import transformer as jtr
from mxnet_tpu_torch.gluon.contrib import transformer as ttr
from mxnet_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

CPU = tmx.cpu()
KNOBS = ("MXNET_PALLAS_NORM", "MXNET_PALLAS_SOFTMAX")
VOCAB = 32
SMALL = dict(units=64, hidden_size=128, num_layers=2, num_heads=4,
             max_len=32)
# Adam with a larger eps than 1e-8, so that an update is not ~lr*sign(g)
# for every gradient, which would hide a wrong magnitude
ADAM = {"learning_rate": 1e-2, "epsilon": 1e-3}
STEPS = 3


def _set_knobs(monkeypatch, value):
    for k in KNOBS:
        monkeypatch.setenv(k, value)


def _batch(t):
    ids = np.random.RandomState(70 + t).randint(0, VOCAB, (2, t + 1))
    return ids[:, :-1].astype(np.float32), ids[:, 1:].astype(np.float32)


def _strip(params, prefix):
    return {n[len(prefix):]: p for n, p in params.items()}


def _train(mx, lm, x, y, steps=STEPS):
    """``steps`` canonical steps of ``lm`` on ``(x, y)``; per step the
    loss, every gradient after ``backward`` and every weight after
    ``Trainer.step``, as numpy, by name with the root prefix stripped."""
    params = lm.collect_params()
    trainer = mx.gluon.Trainer(params, "adam", dict(ADAM))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    named = _strip(params, lm.prefix)
    out = []
    for _ in range(steps):
        with mx.autograd.record():
            logits = lm(x)
            loss = loss_fn(logits.reshape((-1, VOCAB)),
                           y.reshape((-1,))).mean()
        loss.backward()
        grads = {n: p.grad().asnumpy() for n, p in named.items()}
        trainer.step(1)
        out.append((float(loss.asnumpy()), grads,
                    {n: p.data().asnumpy() for n, p in named.items()}))
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The JAX LM's initial weights, and its three steps per (T, knob),
    computed once each."""
    jmx.random.seed(5)
    lm = jtr.TransformerLM(VOCAB, **SMALL)
    lm.initialize(jmx.init.Xavier())
    lm(jmx.nd.zeros((1, 4)))       # finishes the deferred shapes
    arrays = {k: v.data().asnumpy() for k, v in lm.collect_params().items()}
    # LayerNorm's gamma and beta and the biases start at 1 or 0: move them
    # so a mix-up of one parameter with another shows
    rng = np.random.RandomState(71)
    for k, v in arrays.items():
        if k.endswith(("gamma", "beta", "bias")):
            arrays[k] = (v + 0.2 * rng.randn(*v.shape)).astype(np.float32)
    cache = {}

    def run(t, knob, monkeypatch):
        if (t, knob) not in cache:
            _set_knobs(monkeypatch, knob)
            jlm = jtr.TransformerLM(VOCAB, **SMALL)
            jlm.initialize(jmx.init.Xavier())
            jlm(jmx.nd.zeros((1, 4)))
            for k, p in _strip(jlm.collect_params(), jlm.prefix).items():
                p.set_data(jmx.nd.array(arrays[lm.prefix + k]))
            x, y = _batch(t)
            cache[t, knob] = _train(jmx, jlm, jmx.nd.array(x),
                                    jmx.nd.array(y))
        return cache[t, knob]
    return arrays, run


def _port_lm(arrays):
    lm = ttr.TransformerLM(VOCAB, **SMALL)
    lm.initialize(tmx.init.Xavier(), ctx=CPU)
    tmx.convert.block_params_from_numpy(lm, arrays, ctx=CPU)
    lm.hybridize()
    return lm


def _close(got, want, tol):
    """``max |got - want|`` within ``tol`` of ``want``'s largest
    magnitude."""
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("knob", ["1", "0"])
@pytest.mark.parametrize("t", [16, 12])
def test_three_training_steps_match_jax(jax_run, t, knob, monkeypatch):
    """Per step: the loss within 1e-5 relative, every parameter's
    gradient and updated weight within 1e-4 of its largest magnitude;
    every parameter gets a nonzero gradient, as many as in the JAX
    package.  Steps 2 and 3 start from weights ``Trainer.step`` rebound,
    so they hold the parameters' autograd marking across the update."""
    arrays, run = jax_run
    want = run(t, knob, monkeypatch)
    _set_knobs(monkeypatch, knob)
    lm = _port_lm(arrays)
    x, y = _batch(t)
    got = _train(tmx, lm, tmx.nd.array(x, ctx=CPU), tmx.nd.array(y, ctx=CPU))
    for step, ((gl, gg, gw), (wl, wg, ww)) in enumerate(zip(got, want)):
        assert abs(gl - wl) <= 1e-5 * abs(wl), (step, gl, wl)
        assert set(gg) == set(wg) and len(gg) == len(arrays)
        for n in wg:
            assert np.abs(gg[n]).max() > 0, (step, n)
            assert _close(gg[n], wg[n], 1e-4), (step, n)
            assert _close(gw[n], ww[n], 1e-4), (step, n)
    assert got[-1][0] < got[0][0]


def test_training_step_routes_through_the_backward_wrappers(jax_run,
                                                            monkeypatch):
    """Knobs 1 on the CPU: each LayerNorm's backward goes through
    ``layernorm_bwd`` and each masked softmax's through ``softmax_bwd``
    (their plain versions: no kernel launches); knobs 0 call neither."""
    arrays, _ = jax_run
    x, y = _batch(12)
    for knob, want in (("1", {"layernorm_fwd": 5, "layernorm_bwd": 5,
                              "bias_softmax": 2, "softmax_bwd": 2}),
                       ("0", {})):
        _set_knobs(monkeypatch, knob)
        taken = {}
        for name in ("layernorm_fwd", "layernorm_bwd", "bias_softmax",
                     "softmax_bwd", "softmax_lastaxis",
                     "flash_attention_fwd", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            def counting(*a, _n=name, _fn=getattr(ck, name), **kw):
                taken[_n] = taken.get(_n, 0) + 1
                return _fn(*a, **kw)
            monkeypatch.setattr(ck, name, counting)
        ck.reset_kernel_calls()
        _train(tmx, _port_lm(arrays), tmx.nd.array(x, ctx=CPU),
               tmx.nd.array(y, ctx=CPU), steps=1)
        assert taken == want
        assert not any(ck.kernel_calls().values())
        monkeypatch.undo()


def test_parameters_stay_the_leaves_that_record():
    """Deferred initialization finishing inside a forward under
    ``record()`` leaves each parameter a variable that records, and
    ``Trainer.step`` keeps it one."""
    lm = ttr.TransformerLM(VOCAB, **SMALL)
    lm.initialize(tmx.init.Xavier(), ctx=CPU)
    x, y = (tmx.nd.array(a, ctx=CPU) for a in _batch(8))
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = tmx.gluon.Trainer(lm.collect_params(), "sgd",
                                {"learning_rate": 0.1})
    for step in range(2):
        with tmx.autograd.record():
            loss = loss_fn(lm(x).reshape((-1, VOCAB)), y.reshape((-1,)))
        loss.backward()
        for p in lm.collect_params().values():
            w = p.data()._data
            assert w.is_leaf and w.requires_grad, (step, p.name)
            assert p.grad().asnumpy().any(), (step, p.name)
        trainer.step(x.shape[0])


# ---------------------------------------------------------------------------
# rehearsal of chip_smoke.py's training phase on the CPU
# ---------------------------------------------------------------------------
def test_chip_smoke_training_phase_rehearses_on_the_cpu(jax_run,
                                                        monkeypatch):
    """chip_smoke's transformer training path with ctx=cpu() at small
    width, knobs at 1: the four-way gradient check (kernel path, plain
    path with and without the kernel forward's ReLU decisions, float64),
    no kernel launches, and a falling loss."""
    import chip_smoke
    _set_knobs(monkeypatch, "1")
    lm = chip_smoke.transformer_lm(tmx, CPU, dict(SMALL, vocab_size=VOCAB))
    tmx.convert.block_params_from_numpy(lm, jax_run[0], ctx=CPU)
    x, y = chip_smoke.lm_batch(tmx, CPU, VOCAB, 2, 16)
    _, _, r = chip_smoke.lm_train(tmx, ck, lm, x, y, warmup=2, steps=2)
    assert not any(r["calls"].values())
    assert r["grad_dev"] <= chip_smoke.GRAD_TOL and not r["zero_grads"]
    assert r["relu_inputs"] == 2 * 16 * SMALL["hidden_size"] * 2
    assert r["kernel_vs_f64"] <= chip_smoke.GRAD_TOL
    assert r["plain_vs_f64"] <= chip_smoke.GRAD_TOL
    assert len(r["losses"]) == 4 and r["losses"][-1] < r["losses"][0]
    assert r["n_params"] == len(jax_run[0]) and r["step_ms"] > 0
