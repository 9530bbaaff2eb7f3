"""The port's module family against the JAX package's, on the CPU:
``BucketingModule`` (mirroring ``tests/test_module.py``'s bucketing tests:
training across buckets, the executor's fused step off under bucketing,
one optimizer and shared arrays for all buckets), ``SequentialModule``,
``PythonModule``/``PythonLossModule``, ``model.FeedForward`` (fit,
predict, score, save, load, create), ``Module``'s ``predict``,
``iter_predict``, ``get_input_grads`` and rebinding for a new batch
shape, and ``executor_manager``.  Every run starts from the same numpy
parameters (``set_params``), made from a seed; results are held within
1e-6 of each array's largest magnitude (the fp32 band).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

SEED = 0
TOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _numpy_params(sym, seed=SEED, **shapes):
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}
    auxs = {n: np.ones(s, np.float32)
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def _nd(mx, params):
    return {k: mx.nd.array(v) for k, v in params.items()}


def _params_close(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert _rel(a[k].asnumpy(), b[k].asnumpy()) <= TOL, k


def _blobs(n=40, seed=SEED):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 4, n)
    x = rng.normal(0, 1, (n, 8)) + y[:, None] * 0.7
    return x.astype(np.float32), y.astype(np.float32)


# -- BucketingModule -------------------------------------------------------------
def _pool_sym_gen(mx):
    def sym_gen(seq_len):
        data = mx.sym.var("data")
        pooled = mx.sym.mean(data, axis=1, keepdims=True)
        fc = mx.sym.FullyConnected(pooled, name="fc", num_hidden=4)
        return (mx.sym.SoftmaxOutput(fc, name="softmax"), ["data"],
                ["softmax_label"])
    return sym_gen


def _bucket_batch(mx, seq_len, batch=8, seed=SEED):
    rng = np.random.RandomState(seed + seq_len)
    return mx.io.DataBatch(
        data=[mx.nd.array(rng.uniform(-1, 1, (batch, seq_len))
                          .astype(np.float32))],
        label=[mx.nd.array((np.arange(batch) % 4).astype(np.float32))],
        bucket_key=seq_len, provide_data=[("data", (batch, seq_len))],
        provide_label=[("softmax_label", (batch,))])


def _bucketing(mx, kvstore, optimizer, keys=(10, 5, 7), prebind=True,
               steps=(10, 5, 10, 7)):
    sym_gen = _pool_sym_gen(mx)
    args, _ = _numpy_params(sym_gen(10)[0], data=(8, 10),
                            softmax_label=(8,))
    mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=10,
                                 context=mx.cpu())
    mod.bind(data_shapes=[("data", (8, 10))],
             label_shapes=[("softmax_label", (8,))])
    with mx.cpu():
        mod.init_params(arg_params=_nd(mx, args), aux_params={})
    if prebind:
        # bind every bucket before the first step (the JAX package resets
        # the shared weights when a bucket binds after one: see below)
        for k in keys:
            mod.switch_bucket(k, [("data", (8, k))],
                              [("softmax_label", (8,))])
        mod.switch_bucket(10, None, None)
    mod.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                       optimizer_params={"learning_rate": 0.1})
    for k in steps:
        with mx.cpu():
            mod.forward_backward(_bucket_batch(mx, k))
        mod.update()
    return mod


@pytest.mark.parametrize("kvstore,optimizer", [("local", "sgd"),
                                               ("tpu", "adam"),
                                               ("tpu", "sgd")])
def test_bucketing_module_trains_as_the_jax_package(kvstore, optimizer):
    j = _bucketing(jmx, kvstore, optimizer)
    t = _bucketing(tmx, kvstore, optimizer)
    assert set(t._buckets) == set(j._buckets) == {10, 5, 7}
    _params_close(t.get_params()[0], j.get_params()[0])
    # the same arrays in every bucket's executor
    w = {k: m._exec_group.execs[0].arg_dict["fc_weight"]
         for k, m in t._buckets.items()}
    assert w[5] is w[10] and w[7] is w[10]
    with tmx.cpu():
        t.forward(_bucket_batch(tmx, 5), is_train=False)
    with jmx.cpu():
        j.forward(_bucket_batch(jmx, 5), is_train=False)
    assert _rel(t.get_outputs()[0].asnumpy(),
                j.get_outputs()[0].asnumpy()) <= TOL


def test_a_bucket_bound_after_a_step_keeps_the_trained_weights():
    """A bucket bound after a step shares the trained arrays.  The JAX
    package copies the default module's master copies, stale since the
    step, into them as it binds and so undoes the step (the reference's
    bind skips that copy under ``shared_module``); the port does not."""
    moved = {}
    for name, mx in (("jax", jmx), ("port", tmx)):
        mod = _bucketing(mx, "local", "sgd", prebind=False, steps=(10,))
        exe = mod._buckets[10]._exec_group.execs[0]
        trained = exe.arg_dict["fc_weight"].asnumpy().copy()
        with mx.cpu():
            mod.forward(_bucket_batch(mx, 5), is_train=False)
        moved[name] = np.array_equal(
            exe.arg_dict["fc_weight"].asnumpy(), trained)
    assert moved == {"jax": False, "port": True}


def test_bucketing_disables_exec_fusion():
    """(tests/test_module.py:247) The buckets' executors share the weight
    arrays, so no one executor may fold the optimizer into its step under
    BucketingModule; a plain Module with the same kvstore does."""
    def sym_gen(seq_len):
        data = tmx.sym.Variable("data")
        label = tmx.sym.Variable("softmax_label")
        fc = tmx.sym.FullyConnected(tmx.sym.Flatten(data), num_hidden=4,
                                    name="fc")
        return (tmx.sym.SoftmaxOutput(fc, label, name="softmax"),
                ("data",), ("softmax_label",))

    with tmx.cpu():
        mod = tmx.mod.BucketingModule(sym_gen, default_bucket_key=8)
        mod.bind(data_shapes=[tmx.io.DataDesc("data", (2, 8))],
                 label_shapes=[tmx.io.DataDesc("softmax_label", (2,))],
                 for_training=True)
        mod.init_params(tmx.init.Xavier())
        mod.init_optimizer(kvstore="tpu", optimizer="sgd")
        assert mod._curr_module._fused_exec_update is False
        plain = tmx.mod.Module(sym_gen(8)[0])
        plain.bind(data_shapes=[tmx.io.DataDesc("data", (2, 8))],
                   label_shapes=[tmx.io.DataDesc("softmax_label", (2,))])
        plain.init_params(tmx.init.Xavier())
        plain.init_optimizer(kvstore="tpu", optimizer="sgd")
        assert plain._fused_exec_update is True


def test_bucketing_shared_executor_state_no_cross_eviction():
    """(tests/test_module.py:276) One optimizer and updater for all
    buckets (borrow_optimizer); each bucket keeps its own executor, which
    revisiting reuses; an update through one bucket is read by the
    other."""
    mod = _bucketing(tmx, "local", "sgd", keys=(8, 4), prebind=False,
                     steps=(10, 4, 10, 4))
    mods = mod._buckets
    assert set(mods) == {10, 4}
    assert mods[4]._optimizer is mods[10]._optimizer
    assert mods[4]._updater is mods[10]._updater
    execs = {k: m._exec_group.execs[0] for k, m in mods.items()}
    assert execs[4] is not execs[10]
    before = execs[4].arg_dict["fc_weight"].asnumpy().copy()
    for k in (10, 4, 10):
        with tmx.cpu():
            mod.forward_backward(_bucket_batch(tmx, k))
        mod.update()
    assert {k: m._exec_group.execs[0] for k, m in mods.items()} == execs
    after = execs[4].arg_dict["fc_weight"].asnumpy()
    assert not np.array_equal(before, after)
    assert np.array_equal(after, execs[10].arg_dict["fc_weight"].asnumpy())


def test_bucketing_fit_with_a_sentence_iterator_matches():
    """``fit`` over ``BucketSentenceIter`` with ``kvstore="tpu"`` and
    Adam: prepare() binds each upcoming bucket; every bucket is bound
    before the first update, as the iterator's first epoch visits them
    all."""
    got = []
    for mx in (jmx, tmx):
        sents = [[1 + (i * 7 + j) % 9 for j in range(2 + i % 6)]
                 for i in range(24)]
        np.random.seed(SEED)
        import random
        random.seed(SEED)
        with mx.cpu():
            it = mx.rnn.BucketSentenceIter(sents, 4, buckets=[4, 7],
                                           invalid_label=0)

            def sym_gen(seq_len, mx=mx):
                data = mx.sym.var("data")
                emb = mx.sym.Embedding(data, input_dim=10, output_dim=3,
                                       name="emb")
                pred = mx.sym.FullyConnected(
                    mx.sym.Reshape(emb, shape=(-1, 3)), num_hidden=10,
                    name="pred")
                label = mx.sym.Reshape(mx.sym.var("softmax_label"),
                                       shape=(-1,))
                return (mx.sym.SoftmaxOutput(pred, label, name="softmax"),
                        ("data",), ("softmax_label",))

            args, _ = _numpy_params(sym_gen(7)[0], data=(4, 7),
                                    softmax_label=(4, 7))
            mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=7,
                                         context=mx.cpu())
            mod.bind(it.provide_data, it.provide_label)
            mod.init_params(arg_params=_nd(mx, args), aux_params={})
            for k in (4, 7):
                mod.switch_bucket(k, [("data", (4, k))],
                                  [("softmax_label", (4, k))])
            mod.fit(it, num_epoch=2, kvstore="tpu", optimizer="adam",
                    optimizer_params={"learning_rate": 0.05},
                    eval_metric=mx.metric.Perplexity(0))
            got.append(mod.get_params()[0])
    _params_close(got[1], got[0])


# -- SequentialModule, PythonLossModule --------------------------------------------
def _xent_grad(scores, labels):
    """d/ds of -log softmax(s)[label], in numpy, a row at a time summed
    over the batch (what SoftmaxOutput hands back)."""
    s = scores.asnumpy()
    e = np.exp(s - s.max(1, keepdims=True))
    return e / e.sum(1, keepdims=True) \
        - np.eye(s.shape[1])[labels.asnumpy().astype(int)]


def _seq(mx, loss_module=False):
    net1 = mx.sym.Activation(mx.sym.FullyConnected(
        mx.sym.var("data"), name="fc1", num_hidden=6), act_type="relu")
    fc2 = mx.sym.FullyConnected(mx.sym.var("data"), name="fc2",
                                num_hidden=4)
    a1, _ = _numpy_params(net1, data=(10, 8))
    a2, _ = _numpy_params(fc2, seed=1, data=(10, 6))
    smod = mx.mod.SequentialModule()
    smod.add(mx.mod.Module(net1, label_names=None, context=mx.cpu()))
    if loss_module:
        smod.add(mx.mod.Module(fc2, label_names=None, context=mx.cpu()),
                 auto_wiring=True)
        smod.add(mx.mod.PythonLossModule(grad_func=_xent_grad),
                 take_labels=True, auto_wiring=True)
    else:
        smod.add(mx.mod.Module(mx.sym.SoftmaxOutput(fc2, name="softmax"),
                               context=mx.cpu()),
                 take_labels=True, auto_wiring=True)
    return smod, dict(a1, **a2)


@pytest.mark.parametrize("loss_module", [False, True],
                         ids=["softmax_output", "python_loss"])
def test_sequential_module_fits_as_the_jax_package(loss_module):
    x, y = _blobs()
    got = []
    for mx in (jmx, tmx):
        smod, params = _seq(mx, loss_module)
        with mx.cpu():
            train = mx.io.NDArrayIter(x, y, batch_size=10)
            smod.fit(train, num_epoch=2, arg_params=_nd(mx, params),
                     aux_params={},
                     optimizer_params={"learning_rate": 0.05})
            score = smod.score(mx.io.NDArrayIter(x, y, batch_size=10), "acc")
        got.append((smod.get_params()[0], score))
        assert smod.output_shapes[0][1] == (10, 4)
    _params_close(got[1][0], got[0][0])
    assert got[1][1] == got[0][1]


def _pyloss_grad(mx, x, y, grad_func):
    with mx.cpu():
        m = mx.mod.PythonLossModule(grad_func=grad_func)
        m.bind(data_shapes=[("data", (10, 8))],
               label_shapes=[("softmax_label", (10,))])
        m.init_params()
        m.forward(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]),
                  is_train=True)
        m.backward()
        assert m.get_outputs()[0].shape == (10, 8)
        assert m.output_shapes == [("pyloss_output", (10, 8))]
        return m.get_input_grads()[0].asnumpy()


def test_python_loss_module_gradient_and_grad_func():
    """With ``grad_func`` both packages hand back its gradient.  The
    default gradient, softmax(scores) - one_hot(label): the JAX package
    passes one_hot's depth by position, which one_hot refuses, so its
    default backward raises; the port's matches numpy's formula."""
    x, y = _blobs(n=10)
    half = [_pyloss_grad(mx, x, y, lambda s, lab: s.asnumpy() * 0.5)
            for mx in (jmx, tmx)]
    assert _rel(half[1], half[0]) <= TOL
    with pytest.raises(jmx.MXNetError, match="depth"):
        _pyloss_grad(jmx, x, y, None)
    e = np.exp(x - x.max(1, keepdims=True))
    want = e / e.sum(1, keepdims=True) - np.eye(8)[y.astype(int)]
    assert _rel(_pyloss_grad(tmx, x, y, None), want) <= TOL


# -- FeedForward ----------------------------------------------------------------------
def _mlp(mx):
    fc1 = mx.sym.FullyConnected(mx.sym.var("data"), name="fc1", num_hidden=8)
    fc2 = mx.sym.FullyConnected(mx.sym.Activation(fc1, act_type="tanh"),
                                name="fc2", num_hidden=4)
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def test_feedforward_fit_predict_score_save_load(tmp_path):
    x, y = _blobs()
    args, _ = _numpy_params(_mlp(tmx), data=(10, 8), softmax_label=(10,))
    res = {}
    for name, mx in (("jax", jmx), ("port", tmx)):
        with mx.cpu():
            ff = mx.model.FeedForward(_mlp(mx), ctx=mx.cpu(), num_epoch=6,
                                      numpy_batch_size=10,
                                      learning_rate=0.1,
                                      arg_params=_nd(mx, args),
                                      aux_params={})
            ff.fit(x, y)
            pred = ff.predict(mx.io.NDArrayIter(x, y, batch_size=10))
            prefix = str(tmp_path / name)
            ff.save(prefix)
            loaded = mx.model.FeedForward.load(prefix, 6, ctx=mx.cpu(),
                                               numpy_batch_size=10)
            if mx is jmx:
                # on arrays, with no label: the JAX package takes the
                # label for a parameter the file lacks
                with pytest.raises(RuntimeError, match="softmax_label"):
                    loaded.predict(x)
                res[name] = (ff.arg_params, pred)
            else:
                res[name] = (ff.arg_params, pred, loaded.predict(x))
    _params_close(res["port"][0], res["jax"][0])
    assert _rel(res["port"][1], res["jax"][1]) <= TOL
    assert np.array_equal(res["port"][2], res["port"][1])
    assert (res["port"][1].argmax(1) == y).mean() > 0.5
    with tmx.cpu():
        # the JAX package's files load into the port's FeedForward
        cross = tmx.model.FeedForward.load(str(tmp_path / "jax"), 6,
                                           ctx=tmx.cpu(),
                                           numpy_batch_size=10)
        assert _rel(cross.predict(x), res["jax"][1]) <= TOL
        acc = cross.score(tmx.io.NDArrayIter(x, y, batch_size=10))
    assert acc == (res["jax"][1].argmax(1) == y).mean()


def test_feedforward_create_fits():
    x, y = _blobs()
    args, _ = _numpy_params(_mlp(tmx), data=(10, 8), softmax_label=(10,))
    with tmx.cpu():
        ff = tmx.model.FeedForward.create(
            _mlp(tmx), x, y, ctx=tmx.cpu(), num_epoch=2, numpy_batch_size=10,
            learning_rate=0.1, arg_params=_nd(tmx, args), aux_params={})
        ref = tmx.model.FeedForward(_mlp(tmx), ctx=tmx.cpu(), num_epoch=2,
                                    numpy_batch_size=10, learning_rate=0.1,
                                    arg_params=_nd(tmx, args), aux_params={})
        ref.fit(x, y)
    _params_close(ff.arg_params, ref.arg_params)


# -- Module surface, executor_manager ------------------------------------------------
def test_module_predict_iter_predict_input_grads_and_reshape():
    x, y = _blobs(n=25)
    args, _ = _numpy_params(_mlp(tmx), data=(10, 8), softmax_label=(10,))
    res = []
    for mx in (jmx, tmx):
        with mx.cpu():
            mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
            mod.bind(data_shapes=[("data", (10, 8))],
                     label_shapes=[("softmax_label", (10,))],
                     inputs_need_grad=True)
            mod.set_params(_nd(mx, args), {})
            it = mx.io.NDArrayIter(x, y, batch_size=10)
            pred = mod.predict(it).asnumpy()
            chunks = [o[0].asnumpy() for o, _n, _b in mod.iter_predict(it)]
            batch = mx.io.DataBatch([mx.nd.array(x[:10])],
                                    [mx.nd.array(y[:10])])
            mod.forward(batch, is_train=True)
            mod.backward()
            igrad = mod.get_input_grads()[0].asnumpy()
            # a batch of 5 rows rebinds the executor, sharing parameters
            mod.forward(mx.io.DataBatch([mx.nd.array(x[:5])],
                                        [mx.nd.array(y[:5])]),
                        is_train=False)
            small = mod.get_outputs()[0].asnumpy()
        res.append((pred, chunks, igrad, small))
    for a, b in zip(res[1], res[0]):
        if isinstance(a, list):
            for c, d in zip(a, b):
                assert _rel(c, d) <= TOL
        else:
            assert a.shape == b.shape and _rel(a, b) <= TOL
    assert res[1][0].shape == (25, 4) and res[1][3].shape == (5, 4)
    assert [c.shape[0] for c in res[1][1]] == [10, 10, 5]


def test_executor_manager_helpers():
    for batch, loads in ((10, [1, 2, 2]), (7, [1, 1]), (4, [3])):
        assert tmx.executor_manager._split_input_slice(batch, loads) == \
            jmx.executor_manager._split_input_slice(batch, loads)
    with pytest.raises(ValueError):
        tmx.executor_manager._split_input_slice(2, [1, 1, 1])
    x, y = _blobs(n=6)
    with tmx.cpu():
        batch = tmx.io.DataBatch([tmx.nd.array(x)], [tmx.nd.array(y)])
        data_t, label_t = tmx.nd.zeros((6, 8)), tmx.nd.zeros((6,))
        tmx.executor_manager._load_data(batch, [data_t])
        tmx.executor_manager._load_label(batch, [[(slice(0, 6), label_t)]])
    assert np.array_equal(data_t.asnumpy(), x)
    assert np.array_equal(label_t.asnumpy(), y)


def test_executor_group_takes_the_reference_positional_arguments():
    """Queue 3 item 3: ``DataParallelExecutorGroup(symbol, contexts,
    workload, data_shapes, label_shapes, param_names, for_training,
    inputs_need_grad)`` as the JAX package takes it, and ``bind_exec``
    with ``reshape``; both packages' groups give the same outputs and
    parameter gradients from the same parameters."""
    x, y = _blobs(n=6)
    out = {}
    for mx in (jmx, tmx):
        with tmx.cpu():
            data = mx.sym.var("data")
            fc = mx.sym.FullyConnected(data, name="fc", num_hidden=4)
            sym = mx.sym.SoftmaxOutput(fc, name="softmax")
            args, _ = _numpy_params(sym, data=(6, 8))
            group = mx.module.DataParallelExecutorGroup(
                sym, [mx.cpu()], [1], [mx.io.DataDesc("data", (6, 8))],
                [mx.io.DataDesc("softmax_label", (6,))],
                ["fc_weight", "fc_bias"], True, False)
            assert group.workload == [1]
            group.set_params(_nd(mx, args), {})
            batch = mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)])
            group.forward(batch, is_train=True)
            group.backward()
            outs = [group.get_outputs()[0].asnumpy()] + \
                [g[0].asnumpy() for g in group.grad_arrays]
            group.bind_exec([mx.io.DataDesc("data", (3, 8))],
                            [mx.io.DataDesc("softmax_label", (3,))],
                            shared_group=group, reshape=True)
            group.forward(mx.io.DataBatch([mx.nd.array(x[:3])],
                                          [mx.nd.array(y[:3])]),
                          is_train=False)
            out[mx] = outs + [group.get_outputs()[0].asnumpy()]
    for got, want in zip(out[tmx], out[jmx]):
        assert _rel(got, want) <= TOL
    assert out[tmx][-1].shape == (3, 4)
    with pytest.raises(tmx.base.MXNetError, match="workload"):
        with tmx.cpu():
            tmx.module.DataParallelExecutorGroup(
                sym, [tmx.cpu()], [1, 1], [tmx.io.DataDesc("data", (6, 8))],
                None, ["fc_weight", "fc_bias"], False, False)
