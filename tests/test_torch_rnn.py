"""The port's RNN family against the JAX package's, on the CPU: the ``RNN``
op in its four modes (1-2 layers, bidirectional, ``state_outputs``,
forward and backward) against the JAX op, every cell's ``unroll`` (the
same graph JSON, outputs and gradients from the same numpy parameters),
``FusedRNNCell`` against its ``unfuse()``, ``pack_weights`` and
``unpack_weights``, ``BucketSentenceIter``, the rnn checkpoint files
byte for byte, a fused cell's packed vector carried across by
``convert``, ``SoftmaxOutput`` with the iterator's -1 padding labels, and
a small rehearsal of ``chip_smoke.py`` phase 17 (a) and (b).  Inputs are
numpy arrays from a seed; fp32 results are held within 1e-6 of the
largest magnitude, gradients through unrolled recurrences within 1e-5.
"""
import os
import random
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.registry import get_op as jget_op
from mxnet_tpu_torch.ops.nn import rnn_param_size
from mxnet_tpu_torch.ops.registry import get_op as tget_op

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

SEED = 0
TOL = 1e-6
GRAD_TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# -- the RNN op ---------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("layers,bi", [(1, False), (2, True)])
def test_rnn_op_matches_the_jax_op(mode, layers, bi):
    rng = np.random.RandomState(SEED)
    d = 2 if bi else 1
    t, n, i, h = 6, 3, 5, 7
    size = rnn_param_size(mode, layers, i, h, d)
    ins = [rng.uniform(-1, 1, (t, n, i)).astype(np.float32),
           rng.uniform(-0.4, 0.4, size).astype(np.float32),
           rng.uniform(-0.5, 0.5, (layers * d, n, h)).astype(np.float32)]
    if mode == "lstm":
        ins.append(rng.uniform(-0.5, 0.5, (layers * d, n, h))
                   .astype(np.float32))
    kw = dict(mode=mode, state_size=h, num_layers=layers, bidirectional=bi,
              state_outputs=True)
    jout, vjp = jax.vjp(lambda *a: jget_op("RNN").fn(*a, **kw),
                        *[jnp.asarray(a) for a in ins])
    tin = [torch.tensor(a, requires_grad=True) for a in ins]
    tout = tget_op("RNN").fn(*tin, **kw)
    assert len(tout) == len(jout) == (3 if mode == "lstm" else 2)
    for a, b in zip(tout, jout):
        assert tuple(a.shape) == b.shape
        assert _rel(a.detach().numpy(), b) <= TOL
    seeds = [rng.uniform(-1, 1, np.shape(o)).astype(np.float32)
             for o in jout]
    jg = vjp(tuple(jnp.asarray(s) for s in seeds))
    tg = torch.autograd.grad(tout, tin, [torch.tensor(s) for s in seeds])
    for a, b in zip(tg, jg):
        assert _rel(a.numpy(), b) <= GRAD_TOL


def test_rnn_op_dropout_acts_only_in_training_between_layers():
    rng = np.random.RandomState(SEED)
    size = rnn_param_size("lstm", 2, 4, 6, 1)
    with tmx.cpu():
        x = tmx.nd.array(rng.uniform(-1, 1, (5, 3, 4)).astype(np.float32))
        w = tmx.nd.array(rng.uniform(-0.4, 0.4, size).astype(np.float32))
        s = tmx.nd.zeros((2, 3, 6))
        kw = dict(state_size=6, num_layers=2, mode="lstm")
        plain = tmx.nd.RNN(x, w, s, s, p=0.0, **kw).asnumpy()
        assert np.array_equal(tmx.nd.RNN(x, w, s, s, p=0.5, **kw).asnumpy(),
                              plain)
        tmx.random.seed(3)
        with tmx.autograd.record():
            a = tmx.nd.RNN(x, w, s, s, p=0.5, **kw).asnumpy()
        tmx.random.seed(3)
        with tmx.autograd.record():
            b = tmx.nd.RNN(x, w, s, s, p=0.5, **kw).asnumpy()
    assert np.array_equal(a, b) and not np.allclose(a, plain)


# -- the cells ----------------------------------------------------------------------
def _cells(mx, name):
    r = mx.rnn
    return {
        "rnn_tanh": lambda: r.RNNCell(6, prefix="rt_"),
        "rnn_relu": lambda: r.RNNCell(6, activation="relu", prefix="rr_"),
        "lstm": lambda: r.LSTMCell(6, prefix="l_"),
        "gru": lambda: r.GRUCell(6, prefix="g_"),
        "sequential": lambda: _stack(r, [r.LSTMCell(6, prefix="s0_"),
                                         r.DropoutCell(0.0, prefix="d_"),
                                         r.GRUCell(5, prefix="s1_")]),
        "bidirectional": lambda: r.BidirectionalCell(
            r.LSTMCell(4, prefix="bl_"), r.GRUCell(4, prefix="br_")),
        "residual": lambda: r.ResidualCell(r.GRUCell(3, prefix="res_")),
        "zoneout": lambda: r.ZoneoutCell(r.LSTMCell(6, prefix="z_"), 0.3,
                                         0.2),
        "fused_lstm": lambda: r.FusedRNNCell(6, num_layers=2, mode="lstm",
                                             bidirectional=True,
                                             prefix="fl_"),
        "fused_gru": lambda: r.FusedRNNCell(5, num_layers=1, mode="gru",
                                            prefix="fg_"),
    }[name]()


def _stack(r, cells):
    s = r.SequentialRNNCell()
    for c in cells:
        s.add(c)
    return s


CELLS = ("rnn_tanh", "rnn_relu", "lstm", "gru", "sequential",
         "bidirectional", "residual", "zoneout", "fused_lstm", "fused_gru")


def _unrolled(mx, name, t, layout):
    cell = _cells(mx, name)
    outs, states = cell.unroll(t, mx.sym.var("data"), layout=layout,
                               merge_outputs=True)
    return mx.sym.Group([outs] + list(states)), cell


@pytest.mark.parametrize("name,layout", [(n, "NTC") for n in CELLS] + [
    (n, "TNC") for n in ("lstm", "bidirectional", "fused_lstm")])
def test_cell_unroll_matches_the_jax_package(name, layout):
    t, n, c = 4, 3, 3
    dshape = (n, t, c) if layout == "NTC" else (t, n, c)
    with jmx.name.NameManager():        # auto-names count from 0
        jsym, _ = _unrolled(jmx, name, t, layout)
    with tmx.name.NameManager():
        tsym, _ = _unrolled(tmx, name, t, layout)
    assert tsym.tojson() == jsym.tojson()
    assert tsym.list_arguments() == jsym.list_arguments()
    rng = np.random.RandomState(SEED)
    arg_shapes, out_shapes, _ = tsym.infer_shape(data=dshape)
    assert [tuple(s) for s in jsym.infer_shape(data=dshape)[1]] == \
        [tuple(s) for s in out_shapes]
    vals = {n_: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for n_, s in zip(tsym.list_arguments(), arg_shapes)}
    seeds = [rng.uniform(-1, 1, s).astype(np.float32) for s in out_shapes]
    train = not name.startswith("zoneout")    # its masks are random
    res = []
    for mx, sym in ((jmx, jsym), (tmx, tsym)):
        exe = sym.simple_bind(ctx=mx.cpu(), grad_req="write", data=dshape)
        for k, v in vals.items():
            exe.arg_dict[k][:] = mx.nd.array(v, ctx=mx.cpu())
        outs = [o.asnumpy() for o in exe.forward(is_train=False)]
        grads = None
        if train:
            exe.forward(is_train=True)
            exe.backward([mx.nd.array(s, ctx=mx.cpu()) for s in seeds])
            grads = {k: exe.grad_dict[k].asnumpy() for k in vals}
        res.append((outs, grads))
    for a, b in zip(res[1][0], res[0][0]):
        assert _rel(a, b) <= TOL
    if train:
        for k in vals:
            assert _rel(res[1][1][k], res[0][1][k]) <= GRAD_TOL, k


@pytest.mark.parametrize("name", CELLS)
def test_begin_state_pack_and_unpack_match(name):
    jcell, tcell = _cells(jmx, name), _cells(tmx, name)
    assert tcell.state_info == jcell.state_info
    if not name.startswith("fused") and name != "bidirectional":
        jb, tb = jcell.begin_state(), tcell.begin_state()
        assert [s.name for s in tb] == [s.name for s in jb]
    args = {"%sx" % name: np.ones(3, np.float32)}
    assert tcell.unpack_weights(args).keys() == \
        jcell.unpack_weights(args).keys()
    assert tcell.pack_weights(args).keys() == jcell.pack_weights(args).keys()


@pytest.mark.parametrize("mode,bi,layers", [("lstm", False, 2),
                                            ("gru", False, 2),
                                            ("lstm", True, 2),
                                            ("rnn_tanh", True, 1),
                                            ("rnn_relu", False, 1)])
def test_fused_cell_matches_its_unfused_cells(mode, bi, layers):
    got = chip_smoke.fused_vs_unrolled(tmx, tmx.cpu(), mode, bi, layers, 8, 6,
                                       3, 5)
    assert max(got["output"], got["data_grad"], got["param_grad"]) <= TOL


def test_fused_cell_unfuse_names_match():
    for mx in (jmx, tmx):
        cell = mx.rnn.FusedRNNCell(4, num_layers=2, mode="gru",
                                   bidirectional=True, dropout=0.2,
                                   prefix="f_")
        out, _ = cell.unfuse().unroll(3, mx.sym.var("data"),
                                      merge_outputs=True)
        if mx is jmx:
            jargs = out.list_arguments()
    assert out.list_arguments() == jargs
    with pytest.raises(tmx.MXNetError, match="unroll"):
        tmx.rnn.FusedRNNCell(4)(tmx.sym.var("x"), [])


# -- BucketSentenceIter -----------------------------------------------------------
def _sentences(seed=SEED):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, 20, rng.randint(1, 14))) for _ in range(60)]


@pytest.mark.parametrize("layout,buckets,invalid", [
    ("NT", [4, 8, 12], -1), ("TN", [5, 10], 0), ("NT", None, -1)])
def test_bucket_sentence_iter_matches(layout, buckets, invalid):
    got = []
    for mx in (jmx, tmx):
        random.seed(SEED)
        np.random.seed(SEED)
        with mx.cpu():
            it = mx.rnn.BucketSentenceIter(
                _sentences(), 4, buckets=list(buckets) if buckets else None,
                invalid_label=invalid, layout=layout)
            batches = []
            for e in range(2):
                if e:
                    it.reset()
                for b in it:
                    batches.append((b.bucket_key, b.data[0].asnumpy(),
                                    b.label[0].asnumpy(),
                                    [(d.name, d.shape, d.layout)
                                     for d in b.provide_data]))
            got.append((it.default_bucket_key, it.provide_data, batches))
    (jk, jd, jb), (tk, td, tb) = got
    assert tk == jk and [(d.name, d.shape) for d in td] == \
        [(d.name, d.shape) for d in jd]
    assert len(tb) == len(jb) > 4
    for (ka, da, la, pa), (kb, db, lb, pb) in zip(tb, jb):
        assert ka == kb and pa == pb
        assert np.array_equal(da, db) and np.array_equal(la, lb)
    if invalid == -1:
        assert (np.concatenate([b[2].ravel() for b in tb]) == -1).any()


def test_padding_labels_get_no_one_in_softmax_output():
    """The iterator pads labels with -1; SoftmaxOutput without
    ``use_ignore`` builds its one-hot by comparing with arange, so a -1
    row's gradient is its probabilities, with no one subtracted, as in
    the JAX package."""
    rng = np.random.RandomState(SEED)
    x = rng.uniform(-2, 2, (6, 5)).astype(np.float32)
    lab = np.array([1, -1, 4, 0, -1, 2], np.float32)
    grads = []
    for mx in (jmx, tmx):
        sym = mx.sym.SoftmaxOutput(mx.sym.var("data"), name="softmax")
        exe = sym.simple_bind(ctx=mx.cpu(), grad_req="write", data=(6, 5),
                              softmax_label=(6,))
        exe.forward(is_train=True, data=mx.nd.array(x, ctx=mx.cpu()),
                    softmax_label=mx.nd.array(lab, ctx=mx.cpu()))
        exe.backward()
        grads.append((exe.outputs[0].asnumpy(),
                      exe.grad_dict["data"].asnumpy()))
    assert _rel(grads[1][1], grads[0][1]) <= TOL
    prob, g = grads[1]
    assert np.allclose(g[[1, 4]], prob[[1, 4]], atol=1e-7)
    assert np.allclose(g[0, 1], prob[0, 1] - 1, atol=1e-7)


# -- checkpoints and convert -----------------------------------------------------
def test_rnn_checkpoint_files_are_byte_for_byte(tmp_path):
    rng = np.random.RandomState(SEED)
    files = {}
    for name, mx in (("jax", jmx), ("port", tmx)):
        cells = [mx.rnn.LSTMCell(4, prefix="l0_"),
                 mx.rnn.FusedRNNCell(3, mode="gru", prefix="f_")]
        with mx.name.NameManager():     # auto-names count from 0
            sym, _ = cells[0].unroll(2, mx.sym.var("data"),
                                     merge_outputs=True)
        rng = np.random.RandomState(SEED)
        arg = {k: mx.nd.array(rng.uniform(-1, 1, (3, 4)).astype(np.float32),
                              ctx=mx.cpu())
               for k in ("l0_i2h_weight", "l0_h2h_weight", "f_parameters")}
        prefix = str(tmp_path / name)
        mx.rnn.save_rnn_checkpoint(cells, prefix, 3, sym, arg, {})
        cb = mx.rnn.do_rnn_checkpoint(cells, prefix + "_cb", period=2)
        cb(0, sym, arg, {})
        cb(1, sym, arg, {})
        files[name] = prefix
    for suffix in ("-symbol.json", "-0003.params", "_cb-0002.params"):
        assert open(files["port"] + suffix, "rb").read() == \
            open(files["jax"] + suffix, "rb").read()
    assert not os.path.exists(files["port"] + "_cb-0001.params")
    with tmx.cpu():
        sym, arg, aux = tmx.rnn.load_rnn_checkpoint(
            [tmx.rnn.LSTMCell(4, prefix="l0_")], files["jax"], 3)
    jsym, jarg, _ = jmx.rnn.load_rnn_checkpoint(
        [jmx.rnn.LSTMCell(4, prefix="l0_")], files["jax"], 3)
    assert sym.tojson() == jsym.tojson() and aux == {}
    for k in jarg:
        assert np.array_equal(arg[k].asnumpy(), jarg[k].asnumpy())


def test_convert_carries_a_fused_cells_packed_vector_unchanged():
    """A FusedRNNCell's packed parameter vector has the same layout in
    both packages, so ``convert.params_from_numpy`` carries the JAX
    package's trained vector across as it is."""
    t, n, c = 5, 2, 3
    outs = []
    rng = np.random.RandomState(SEED)
    vec = None
    for mx in (jmx, tmx):
        cell = mx.rnn.FusedRNNCell(4, num_layers=2, mode="lstm",
                                   bidirectional=True, prefix="f_")
        out, _ = cell.unroll(t, mx.sym.var("data"), merge_outputs=True)
        shapes = dict(zip(out.list_arguments(),
                          out.infer_shape(data=(n, t, c))[0]))
        if vec is None:
            vec = rng.uniform(-0.5, 0.5, shapes["f_parameters"]) \
                .astype(np.float32)
            x = rng.uniform(-1, 1, (n, t, c)).astype(np.float32)
            jexe = out.simple_bind(ctx=mx.cpu(), data=(n, t, c))
            jexe.arg_dict["f_parameters"][:] = mx.nd.array(vec)
            outs.append(jexe.forward(data=mx.nd.array(x))[0].asnumpy())
            carried = jexe.arg_dict["f_parameters"].asnumpy()
        else:
            args, _ = tmx.convert.params_from_numpy(
                {"f_parameters": carried}, {}, tmx.cpu(), symbol=out)
            assert np.array_equal(args["f_parameters"].asnumpy(), vec)
            texe = out.bind(tmx.cpu(), {"data": tmx.nd.array(
                x, ctx=tmx.cpu()), **args})
            outs.append(texe.forward()[0].asnumpy())
    assert _rel(outs[1], outs[0]) <= TOL


# -- rehearsal of chip_smoke.py phase 17 ------------------------------------------
def test_phase17a_records_rehearsal(tmp_path):
    """(a) at a tiny size: the records written, the reader timed, a fit
    from them (kvstore="tpu"), every batch the model received bitwise
    equal to the host replay, the wrappers' batches too, the loss
    falling."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.symbols import resnet
    sym = resnet.get_symbol(10, 8, "3,16,16")
    _mod, batch, rec = chip_smoke.rec_pipeline(
        tmx, ck, tmx.cpu(), sym, str(tmp_path), image=(3, 16, 16), batch=4,
        n_images=40, classes=4, short=20, long_range=(20, 28))
    assert rec["batches"] == rec["replay_batches"] == 10
    assert rec["bitwise_batches"] == 10 and rec["max_abs_vs_replay"] == 0
    assert rec["wrappers"] == {"batches": 3, "bitwise": 3, "max_abs": 0.0}
    assert rec["fused"] and rec["data_on"] == "cpu"
    assert all(v == 0 for v in rec["calls"].values())   # plain versions
    assert rec["ce_last"] < rec["ce_first"]
    assert batch.data[0].shape == (4, 3, 16, 16)


def test_phase17b_bucketed_lm_rehearsal():
    """(b) at a tiny size: each bucket's first-step gradients held to the
    JAX package's from the same numpy parameters (the card's run holds
    them to this CPU path), the fit through BucketingModule with Adam
    and kvstore="tpu", the loss falling, and a step in the largest
    bucket read bitwise through the smallest one's executor."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    keys, vocab = (4, 8), 50
    params = None
    grads = []
    for mx in (jmx, tmx):
        sym_gen = chip_smoke.lm_sym_gen(mx, vocab=vocab, num_hidden=8,
                                        num_embed=8, num_layers=2)
        if params is None:
            params = chip_smoke.lm_params(sym_gen, 8, 4)
        random.seed(SEED)
        np.random.seed(SEED)
        with mx.cpu():
            it = mx.rnn.BucketSentenceIter(
                chip_smoke.lm_corpus(vocab, keys, 4, 2), 4,
                buckets=list(keys), invalid_label=0)
        by_bucket = {}
        for key in keys:
            b = chip_smoke._bucket_batch(mx, mx.cpu(), it, key)
            sym = sym_gen(key)[0]
            mod = mx.mod.Module(sym, context=mx.cpu())
            mod.bind(data_shapes=[("data", (4, key))],
                     label_shapes=[("softmax_label", (4, key))])
            with mx.cpu():
                mod.init_params(arg_params={k: mx.nd.array(v) for k, v in
                                            params.items()},
                                aux_params={})
                mod.forward_backward(b)
            by_bucket[key] = {n: g[0].asnumpy() for n, g in zip(
                mod._exec_group.param_names, mod._exec_group.grad_arrays)}
        grads.append(by_bucket)
    for key in keys:
        for n in grads[0][key]:
            assert _rel(grads[1][key][n], grads[0][key][n]) <= GRAD_TOL, n
    bm, lm = chip_smoke.bucket_fit(tmx, ck, tmx.cpu(), sym_gen, it)
    assert lm["batches"] == 8 and lm["buckets_bound"] == list(keys)
    assert not lm["fused_exec"] and lm["ce_last"] < lm["ce_first"]
    shared = chip_smoke.bucket_shared(tmx, tmx.cpu(), bm, it, 8, 4)
    assert shared["same_arrays"] and shared["bitwise"]
    assert shared["moved"] == shared["params"]
