"""The port's ``gluon.rnn`` and ``gluon.contrib.rnn`` against the JAX
package's, on the CPU: the fused layers (``RNN``, ``LSTM``, ``GRU``) at
1 and 2 layers, both directions and both layouts, and every cell's
``unroll`` with ``merge_outputs`` True and False, run on the same numpy
input with the JAX block's parameters carried across by name
(``convert.block_params_from_numpy``).  Outputs, the input's gradient and
every parameter's gradient must lie within 1e-6 of the largest magnitude
of each (the fp32 band).  Then what holds in the port alone: the LSTM
layer against an unrolled ``SequentialRNNCell`` of two ``LSTMCell``s,
``VariationalDropoutCell``'s one mask a sequence, ``begin_state`` on the
current context, and ``chip_smoke.py`` phase 19's CPU rehearsal.
"""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

SEED = 0
TOL = 1e-6          # of the largest magnitude, per array (fp32)
T, N, C, H = 4, 2, 3, 5


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _x(*shape, seed=SEED):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def build(mx, make):
    """``make(mx)`` under a fresh NameManager, so both packages count
    prefixes alike."""
    with mx.name.NameManager():
        return make(mx)


def _flat(y):
    """An output, a list of step outputs, or (outputs, states) as one
    list of arrays."""
    if isinstance(y, (list, tuple)):
        return [a for part in y for a in _flat(part)]
    return [y]


def forward_backward(mx, net, x, fn):
    """The outputs of ``fn(mx, net, x)``, the input's gradient and each
    parameter's gradient of ``sum_i sum(out_i * w_i)``, ``w_i`` fixed by
    the seed, recorded in predict mode (a dropout or zoneout mask is all
    ones: the packages draw different random streams)."""
    xa = mx.nd.array(x)
    xa.attach_grad()
    with mx.autograd.record(train_mode=False):
        outs = _flat(fn(mx, net, xa))
        rng = np.random.RandomState(SEED + 1)
        loss = None
        for o in outs:
            term = (o * mx.nd.array(rng.randn(*o.shape).astype(
                np.float32))).sum()
            loss = term if loss is None else loss + term
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    return [o.asnumpy() for o in outs], xa.grad.asnumpy(), grads


def hold(make, x, fn, first=None):
    """Build ``make`` in both packages, run ``first`` (default ``fn``)
    once in the JAX one to finish its deferred shapes, carry its
    parameters into the port's and compare ``fn``'s outputs and
    gradients."""
    first = first or fn
    jnet = build(jmx, make)
    jnet.initialize(jmx.init.Xavier())
    first(jmx, jnet, jmx.nd.array(x))
    with tmx.cpu():
        tnet = build(tmx, make)
        # a modifier cell's parameters are its base cell's, named by it
        tmx.convert.block_params_from_numpy(
            getattr(tnet, "base_cell", tnet), {k: v.data().asnumpy()
                   for k, v in jnet.collect_params().items()},
            ctx=tmx.cpu())
        assert list(tnet.collect_params().keys()) == \
            list(jnet.collect_params().keys())
        got = forward_backward(tmx, tnet, x, fn)
    want = forward_backward(jmx, jnet, x, fn)
    assert [a.shape for a in got[0]] == [a.shape for a in want[0]]
    for g, w in zip(got[0], want[0]):
        assert rel(g, w) <= TOL
    assert rel(got[1], want[1]) <= TOL
    assert sorted(got[2]) == sorted(want[2])
    for k in want[2]:
        assert rel(got[2][k], want[2][k]) <= TOL, k
    return jnet, tnet


# -- the fused layers ------------------------------------------------------
# each mode at 1 and 2 layers, in both directions and both layouts
LAYER_CASES = [("LSTM", 1, False, "TNC"), ("LSTM", 2, True, "NTC"),
               ("GRU", 1, True, "TNC"), ("GRU", 2, False, "NTC"),
               ("RNN", 2, True, "TNC"), ("RNN", 1, False, "NTC")]


@pytest.mark.parametrize("mode,layers,bi,layout", LAYER_CASES,
                         ids=["%s-%dl-%s-%s" % (m, n, "bi" if b else "uni", l)
                              for m, n, b, l in LAYER_CASES])
def test_layer_matches_the_jax_package(mode, layers, bi, layout):
    """Output, handed-back states, input gradient and parameter
    gradients from given states; the parameters keep the JAX package's
    names and order; without states the forward starts from zeros and
    returns the output alone."""
    kw = {"activation": "tanh"} if mode == "RNN" else {}
    shape = (T, N, C) if layout == "TNC" else (N, T, C)
    d = 2 if bi else 1
    n_states = 2 if mode == "LSTM" else 1
    states = [_x(layers * d, N, H, seed=SEED + 2 + i)
              for i in range(n_states)]

    def make(mx):
        return getattr(mx.gluon.rnn, mode)(
            H, num_layers=layers, layout=layout, bidirectional=bi,
            prefix="r_", **kw)

    def with_states(mx, net, xa):
        out, new = net(xa, [mx.nd.array(s) for s in states])
        return [out] + list(new)

    _jnet, tnet = hold(make, _x(*shape), with_states)
    names = list(tnet.collect_params().keys())
    assert names[:4] == ["r_l0_i2h_weight", "r_l0_h2h_weight",
                         "r_l0_i2h_bias", "r_l0_h2h_bias"]
    with tmx.cpu():
        x = tmx.nd.array(_x(*shape))
        out = tnet(x)
        zero, _ = tnet(x, [tmx.nd.zeros(s.shape) for s in states])
    np.testing.assert_array_equal(out.asnumpy(), zero.asnumpy())


# -- the cells --------------------------------------------------------------
def _lstm(mx, prefix):
    return mx.gluon.rnn.LSTMCell(H, prefix=prefix)


def _sequential(mx):
    seq = mx.gluon.rnn.SequentialRNNCell(prefix="s_")
    with seq.name_scope():
        seq.add(mx.gluon.rnn.LSTMCell(H, prefix="a_"))
        seq.add(mx.gluon.rnn.DropoutCell(0.0, prefix="d_"))
        seq.add(mx.gluon.rnn.GRUCell(H, prefix="b_"))
    return seq


CELLS = {
    "rnn_tanh": lambda mx: mx.gluon.rnn.RNNCell(H, prefix="c_"),
    "rnn_relu": lambda mx: mx.gluon.rnn.RNNCell(H, activation="relu",
                                                prefix="c_"),
    "lstm": lambda mx: _lstm(mx, "c_"),
    "gru": lambda mx: mx.gluon.rnn.GRUCell(H, prefix="c_"),
    "sequential": _sequential,
    "dropout": lambda mx: mx.gluon.rnn.DropoutCell(0.0, prefix="c_"),
    "zoneout": lambda mx: mx.gluon.rnn.ZoneoutCell(
        _lstm(mx, "c_"), zoneout_outputs=0.3, zoneout_states=0.2),
    "residual": lambda mx: mx.gluon.rnn.ResidualCell(
        mx.gluon.rnn.GRUCell(C, prefix="c_")),
    "bidirectional": lambda mx: mx.gluon.rnn.BidirectionalCell(
        _lstm(mx, "bi_l_"), mx.gluon.rnn.GRUCell(H, prefix="bi_r_")),
    "variational_dropout": lambda mx: mx.gluon.contrib.rnn
    .VariationalDropoutCell(_lstm(mx, "c_"), drop_inputs=0.0,
                            drop_states=0.0, drop_outputs=0.0),
}
CELL_CASES = [(c, merge, layout) for c in CELLS
              for merge in (True, False) for layout in ("NTC", "TNC")]


@pytest.mark.parametrize("cell,merge,layout", CELL_CASES,
                         ids=["%s-%s-%s" % (c, "merged" if m else "steps", l)
                              for c, m, l in CELL_CASES])
def test_cell_unroll_matches_the_jax_package(cell, merge, layout):
    """``unroll`` from its own zero begin state (predict mode: zoneout's
    masks are all ones), outputs and final states, and their
    gradients."""
    shape = (N, T, C) if layout == "NTC" else (T, N, C)

    def fn(mx, net, xa):
        outs, states = net.unroll(T, xa, layout=layout,
                                  merge_outputs=merge)
        if merge:
            assert not isinstance(outs, list)
        else:
            assert isinstance(outs, list) and len(outs) == T
        return [outs, states]

    hold(CELLS[cell], _x(*shape), fn)


def test_cell_unroll_with_valid_length_and_a_list_input():
    """``valid_length`` masks the steps past each row's length, and a
    list of steps is taken as the sequence."""
    vl = np.array([2, 4], np.float32)

    def fn(mx, net, xa):
        outs, states = net.unroll(T, xa, layout="NTC", merge_outputs=True,
                                  valid_length=mx.nd.array(vl))
        return [outs, states]

    hold(CELLS["lstm"], _x(N, T, C), fn)

    def steps(mx, net, xa):
        seq = [xa[:, t, :] for t in range(T)]
        return list(net.unroll(T, seq, layout="NTC", merge_outputs=False))

    hold(CELLS["gru"], _x(N, T, C), steps)


def test_conv2d_lstm_cell_matches_the_jax_package():
    """Conv2DLSTMCell over (N, C, H, W) steps, unrolled both ways."""
    def make(mx):
        return mx.gluon.contrib.rnn.Conv2DLSTMCell(
            (2, 5, 4), 3, i2h_kernel=(3, 3), h2h_kernel=(1, 3),
            prefix="cv_")

    for merge in (True, False):
        def fn(mx, net, xa, merge=merge):
            return list(net.unroll(3, xa, layout="NTC",
                                   merge_outputs=merge))
        hold(make, _x(N, 3, 2, 5, 4), fn)


# -- the port alone ---------------------------------------------------------
def test_variational_dropout_keeps_one_mask_across_steps():
    """At rate 0.5 in training the same units are dropped at every step
    of a sequence (a step's output over the base cell's is the mask), a
    new sequence draws a new mask, and predict mode drops nothing."""
    with tmx.cpu():
        base = tmx.gluon.rnn.RNNCell(H, prefix="b_")
        cell = tmx.gluon.contrib.rnn.VariationalDropoutCell(
            base, drop_outputs=0.5)
        cell.initialize(tmx.init.Uniform(1.0))
        x = tmx.nd.array(np.abs(_x(N, T, C)) + 0.1)
        tmx.random.seed(SEED)
        with tmx.autograd.record(train_mode=True):
            outs, _ = cell.unroll(T, x, layout="NTC", merge_outputs=False)
            mask0 = cell._output_mask.asnumpy()
            outs2, _ = cell.unroll(T, x, layout="NTC", merge_outputs=False)
            mask1 = cell._output_mask.asnumpy()
        kept = [(o.asnumpy() != 0) for o in outs]
        drop = mask0 == 0
        assert set(np.unique(mask0)) <= {0.0, 2.0}
        assert 0 < drop.sum() < drop.size
        base._modified = False
        ref, _ = base.unroll(T, x, layout="NTC", merge_outputs=False)
        base._modified = True
        for o, r in zip(outs, ref):
            np.testing.assert_array_equal(o.asnumpy(), r.asnumpy() * mask0)
        assert all(np.array_equal(k, kept[0]) for k in kept)
        assert not np.array_equal(mask0, mask1)
        del outs2
        plain, _ = cell.unroll(T, x, layout="NTC", merge_outputs=True)
        np.testing.assert_array_equal(plain.asnumpy(), tmx.nd.stack(
            *ref, axis=1).asnumpy())


def test_begin_state_on_the_current_context():
    """``begin_state`` makes its arrays on the current context (the card
    outside a ``with`` block: raising without one), a forward without
    states makes them on its input's."""
    with tmx.cpu():
        lstm = tmx.gluon.rnn.LSTM(H, num_layers=2)
        lstm.initialize()
        states = lstm.begin_state(N)
        assert [s.shape for s in states] == [(2, N, H)] * 2
        assert all(s.context == tmx.cpu() for s in states)
        out = lstm(tmx.nd.array(_x(T, N, C)))
        assert out.shape == (T, N, H) and out.context == tmx.cpu()
        cell = tmx.gluon.rnn.GRUCell(H)
        assert cell.begin_state(3)[0].context == tmx.cpu()


def test_lstm_layer_against_unrolled_cells():
    """The fused two-layer LSTM and a SequentialRNNCell of two LSTMCells
    with the same weights give the same outputs and states (phase 19
    holds the same on the card, through cuDNN)."""
    got = chip_smoke.lstm_vs_cells(tmx, tmx.cpu(), hidden=H, embed=C,
                                   batch=N, steps=T)
    assert got["output"] <= TOL and got["states"] <= TOL


def test_phase19_rehearsal(tmp_path):
    """``chip_smoke.py`` phase 19 at a tiny size on the CPU: (a)
    telemetry on fit, on and off bitwise equal, one step line a batch,
    no compile past the first step, the exposition valid and the dump's
    spans and counters; (b) serving's mirrors; (c) the medium LSTM LM's
    layout (embedding, 2-layer LSTM, dropout, decoder) trained by
    gluon.Trainer with clipping, its first step held to a second CPU
    replay and its loss on the fixed batch falling."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.symbols import resnet
    sym = resnet.get_symbol(10, 8, "3,16,16")
    fit = chip_smoke.telemetry_fit(tmx, ck, tmx.cpu(), sym, (3, 16, 16),
                                   batch=4, warmup=1, steps=2, classes=10,
                                   workdir=str(tmp_path))
    assert fit["weights_bitwise"] and fit["step_lines"] == 3
    assert fit["compiles_after_first"] == 0
    assert fit["exposition_valid"] and fit["dump"]["fit.step"] == 3
    assert fit["dump"]["counters"] > 0
    srv = chip_smoke.telemetry_serve(tmx, ck, tmx.cpu(), sym, (3, 16, 16),
                                     n_sites=0, max_batch=4, n_requests=6,
                                     n_clients=2, classes=10,
                                     workdir=str(tmp_path))
    assert srv["stats_agree"] and srv["misses"] == srv["compiles"]
    assert srv["finite"]
    assert srv["dump"]["serving:batch"] == srv["batches"]
    assert srv["dump"]["serving.request"] == 6 + srv["warmup"]
    lm = chip_smoke.lstm_lm(tmx, ck, tmx.cpu(), vocab=50, hidden=8,
                            batch=3, steps=5, warmup=1, timed=3)
    assert lm["first_step"]["loss_rel"] <= chip_smoke.LSTM_LM_TOL
    assert lm["first_step"]["grad_max_rel"] <= chip_smoke.LSTM_LM_TOL
    assert lm["fixed_last"] < lm["fixed_first"]
    assert np.isfinite(lm["losses"]).all()
