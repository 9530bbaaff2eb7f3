"""The port's generative serving (``serving/generate/``, ``ModelServer``'s
``add_generative_model`` / ``infer_stream`` / ``set_slot_quota`` /
``warmup_generative``) against the JAX package's, on the CPU.

Parity, at a small size (vocab 50, 16 units, 32 hidden, 2 layers, 4 heads
over 2 KV heads, 16 positions) with the same weights carried across
(``convert.spec_from_numpy``): the bucketing ladders; the decode
attention at every fill level; ``generative_spec`` key for key; a prefill
(first tokens equal, K/V histories within 1e-6); 12 decode steps over a
window of 8, so the ring wraps (tokens equal, caches within 1e-6); the
ring bookkeeping.  The JAX side runs its own module-level functions
eagerly (its ``ModelServer`` would compile every grid cell).

Then the JAX package's behaviour cases (``tests/test_serving_generate.py``)
on the port: streaming, no convoy, the warmup grid and a free second
warmup, typed rejections, deadlines, stop, slot quotas, priorities,
brownout, the telemetry families, the knobs, greedy parity with the
block's own forward, and the decode fault poisoning only its slot; and
the reference's warmup defect (a warmup while slot 0 holds a live
generation overwrites its K/V and frees it under the scheduler) shown on
both packages.
"""
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon.contrib.transformer import (
    TransformerLM as JTransformerLM,
    cached_attention_step as j_cached_attention_step)
from mxnet_tpu.serving import bucketing as jbucketing
from mxnet_tpu.serving import generate as jgen
from mxnet_tpu_torch import fault
from mxnet_tpu_torch.convert import block_params_from_numpy, spec_from_numpy
from mxnet_tpu_torch.gluon.contrib.transformer import (
    TransformerLM, cached_attention_step)
from mxnet_tpu_torch.serving import (BadRequest, DeadlineExceeded,
                                     DecodeScheduler, DecodeState,
                                     ExecutorCache, GenerativeModel,
                                     ModelNotFound, ModelServer, QueueFull,
                                     ServerClosed, bucketing)

torch.set_num_threads(1)

CPU = tmx.cpu()
VOCAB = 50
MAXLEN = 16
SMALL = dict(vocab_size=VOCAB, units=16, hidden_size=32, num_layers=2,
             num_heads=4, num_kv_heads=2)
TOL = 1e-6      # fp32 attention, histories and caches against the JAX side


@pytest.fixture(autouse=True)
def _disarm():
    yield
    fault.uninstall()


def _jax_block(max_len=MAXLEN, seed=0):
    """The JAX package's block, initialized and run once (its deferred
    shapes), with its weights drawn from numpy so they are not all alike."""
    with jmx.name.NameManager():
        blk = JTransformerLM(max_len=max_len, **SMALL)
    blk.initialize()
    blk(jmx.nd.array(np.zeros((1, 2), np.int32)))
    rng = np.random.RandomState(seed)
    for p in blk.collect_params().values():
        shape = p.data().shape
        p.set_data(jmx.nd.array(
            (rng.randn(*shape) * 0.5).astype(np.float32)))
    return blk


def _jax_arrays(jblk):
    return {k: v.data().asnumpy() for k, v in jblk.collect_params().items()}


def _block(max_len=MAXLEN, seed=0):
    """The port's block on the CPU with the JAX block's weights."""
    jblk = _jax_block(max_len, seed)
    with tmx.name.NameManager():
        blk = TransformerLM(max_len=max_len, **SMALL)
    with tmx.cpu():
        blk.initialize()
    block_params_from_numpy(blk, _jax_arrays(jblk), ctx=CPU)
    return blk


def _server(slots=4, max_len=MAXLEN, prefill_batch=2, warm=True, **kw):
    srv = ModelServer(cache_size=64, ctx=CPU)
    srv.add_generative_model("lm", _block(max_len), slots=slots,
                             max_len=max_len, prefill_batch=prefill_batch,
                             **kw)
    if warm:
        srv.warmup_generative()
    return srv


def _scheduler(slots=1, prefill_batch=2, **kw):
    """A scheduler whose decode loop is parked (a stand-in thread object
    keeps ``submit`` from starting it), so admission is observable."""
    gm = GenerativeModel("lm", _block(), max_len=MAXLEN,
                         prefill_batch=prefill_batch, ctx=CPU)
    sched = DecodeScheduler(gm, ExecutorCache(capacity=8, ctx=CPU),
                            slots=slots, **kw)
    sched._thread = types.SimpleNamespace(join=lambda timeout=None: None)
    return sched


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(
        1, VOCAB - 1, size=n).astype(np.int32)


def _ref_greedy(blk, prompt, n_new):
    """The oracle: the block's full forward over the growing sequence,
    greedy argmax of the last position (valid while it fits the table)."""
    toks = [int(t) for t in prompt]
    out = []
    for _ in range(n_new):
        logits = blk(tmx.nd.array(np.array([toks], np.float32),
                                  ctx=CPU)).asnumpy()
        nxt = int(logits[0, -1].argmax())
        out.append(nxt)
        toks.append(nxt)
    return out


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= TOL * scale, (what, err)


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------
LADDERS = [("seq", (512,)), ("seq", (48,)), ("seq", (16, 4)), ("seq", (1,)),
           ("seq", (5, 5)), ("seq", (4, 8)), ("seq", (0,)),
           ("grid", ([1, 4], [8, 16])), ("grid", ([1, 2, 4], [1, 2, 4])),
           ("pick", (3, 9, [1, 4], [8, 16])), ("pick", (5, 8, [1, 4], [8, 16])),
           ("pick", (1, 17, [1, 4], [8, 16])), ("pick", (4, 16, [1, 4], [8, 16]))]
LADDER_FNS = {"seq": "seq_buckets", "grid": "prefill_grid",
              "pick": "pick_grid_bucket"}


@pytest.mark.parametrize("kind,args", LADDERS,
                         ids=["%s%s" % (k, a) for k, a in LADDERS])
def test_bucketing_matches_the_jax_package(kind, args):
    name = LADDER_FNS[kind]
    outcomes = []
    for mod in (bucketing, jbucketing):
        try:
            outcomes.append(("ok", getattr(mod, name)(*args)))
        except ValueError as exc:
            outcomes.append(("ValueError", str(exc)))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("m", [1, 5, 8])
def test_cached_attention_step_matches_the_jax_package(m):
    rng = np.random.RandomState(m)
    s, h, hkv, d = 4, 4, 2, 3
    q = rng.randn(s, h, d).astype(np.float32)
    kc = rng.randn(s, hkv, m, d).astype(np.float32)
    vc = rng.randn(s, hkv, m, d).astype(np.float32)
    n_valid = np.array([1, m, max(1, m // 2), max(1, m - 1)], np.int32)
    got = cached_attention_step(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc), n_valid)
    want = j_cached_attention_step(jnp.array(q), jnp.array(kc),
                                   jnp.array(vc), jnp.array(n_valid))
    _close(got.numpy(), np.asarray(want), "attention")
    # a slot at n_valid 1 attends to its first position alone
    np.testing.assert_allclose(got.numpy()[0].reshape(hkv, h // hkv, d),
                               np.repeat(vc[0, :, :1], h // hkv, 1),
                               rtol=1e-6, atol=1e-6)


def test_cached_attention_step_matches_the_full_causal_forward():
    from mxnet_tpu_torch.gluon.contrib.transformer import causal_attention
    rng = np.random.RandomState(3)
    b, t, h, hkv, d, m = 1, 6, 4, 2, 3, 8
    q = torch.from_numpy(rng.randn(b, t, h, d).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, t, hkv, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, t, hkv, d).astype(np.float32))
    full = causal_attention(q, k, v)
    kc = torch.zeros(b, hkv, m, d)
    vc = torch.zeros(b, hkv, m, d)
    kc[:, :, :t] = k.transpose(1, 2)
    vc[:, :, :t] = v.transpose(1, 2)
    step = cached_attention_step(q[:, -1], kc, vc, torch.full((b,), t))
    torch.testing.assert_close(step, full[:, -1], rtol=1e-5, atol=1e-5)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_generative_spec_matches_the_jax_package_key_for_key():
    jblk = _jax_block()
    jspec = jblk.generative_spec()
    with tmx.name.NameManager():
        blk = TransformerLM(max_len=MAXLEN, **SMALL)
    with tmx.cpu():
        blk.initialize()        # deferred: generative_spec runs a forward
    block_params_from_numpy(blk, _jax_arrays(jblk), ctx=CPU)
    spec = blk.generative_spec()
    assert spec["config"] == jspec["config"]
    got, want = list(_leaves(spec["params"])), list(_leaves(jspec["params"]))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, a) in zip(got, want):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(a),
                                      err_msg=str(path))
    # the spec holds the block's own tensors: no copy
    assert spec["params"]["embed"] is blk.embed.weight.data()._data
    carried = spec_from_numpy({"config": jspec["config"], "params": {
        k: v for k, v in jspec["params"].items()}}, ctx=CPU)
    for (path, t), (_, a) in zip(_leaves(carried["params"]), want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a),
                                      err_msg=str(path))


def test_a_deferred_block_exports_by_one_dummy_forward():
    with tmx.name.NameManager():
        blk = TransformerLM(max_len=MAXLEN, **SMALL)
    with tmx.cpu():
        blk.initialize(tmx.init.Xavier())
    spec = blk.generative_spec()
    assert tuple(spec["params"]["layers"][0]["wq"].shape) == (16, 16)
    assert tuple(spec["params"]["layers"][0]["wk"].shape) == (8, 16)


def _models(max_len=MAXLEN, prefill_batch=2):
    """The same weights as a JAX ``GenerativeModel`` and the port's."""
    jblk = _jax_block(MAXLEN)
    jspec = jblk.generative_spec()
    jgm = jgen.GenerativeModel("lm", jspec, max_len=max_len,
                               prefill_batch=prefill_batch)
    host = {"config": jspec["config"],
            "params": jax_to_numpy(jspec["params"])}
    gm = GenerativeModel("lm", spec_from_numpy(host, ctx=CPU),
                         max_len=max_len, prefill_batch=prefill_batch,
                         ctx=CPU)
    return jgm, gm


def jax_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_to_numpy(v) for v in tree]
    return np.asarray(tree)


def test_prefill_matches_the_jax_package():
    jgm, gm = _models()
    tokens = np.zeros((4, 8), np.int32)
    lengths = np.array([5, 8, 1, 3], np.int32)
    for row, n in enumerate(lengths):
        tokens[row, :n] = _prompt(int(n), seed=row)
    cache = ExecutorCache(capacity=4, ctx=CPU)
    first, kh, vh = gm.prefill(cache, (4, 8), tokens, lengths)
    jfirst, jkh, jvh = jgm._prefill_impl(jgm.params, jnp.array(tokens),
                                         jnp.array(lengths))
    np.testing.assert_array_equal(first.numpy(), np.asarray(jfirst))
    assert first.dtype == torch.int32
    assert tuple(kh.shape) == (2, 4, 2, 8, 4)
    _close(kh.numpy(), np.asarray(jkh), "k history")
    _close(vh.numpy(), np.asarray(jvh), "v history")
    # the cell is one executor-cache entry; a second prefill hits it
    gm.prefill(cache, (4, 8), tokens, lengths)
    assert (cache.misses, cache.hits) == (1, 1)
    with pytest.raises(ValueError, match="cell"):
        gm.prefill(cache, (4, 8), tokens[:, :4], lengths)


def test_decode_past_the_window_matches_the_jax_package():
    """12 decode steps over a window of 8 (the ring wraps) from prompts
    of 5 and 3 tokens in slots 0 and 2, slot 1 free: tokens equal at
    every step, caches within 1e-6."""
    window = 8
    jgm, gm = _models(max_len=window)
    state = gm.make_state(3)
    jstate = jgen.DecodeState(3, 2, 2, window, 4)
    for slot, n in ((0, 5), (2, 3)):
        toks = _prompt(n, seed=slot)[None]
        lens = np.array([n], np.int32)
        cache = ExecutorCache(capacity=4, ctx=CPU)
        first, kh, vh = gm.prefill(cache, (1, n), toks, lens)
        jfirst, jkh, jvh = jgm._prefill_impl(jgm.params, jnp.array(toks),
                                             jnp.array(lens))
        assert int(first[0]) == int(jfirst[0])
        gm.admit(state, slot, kh[:, 0], vh[:, 0])
        jstate.k, jstate.v = jgm._admit_impl(jstate.k, jstate.v,
                                             jkh[:, 0], jvh[:, 0],
                                             np.int32(slot))
        state.occupy(slot, n, int(first[0]))
        jstate.occupy(slot, n, int(jfirst[0]))
    _close(state.k.numpy(), np.asarray(jstate.k), "admitted k")
    for step in range(12):
        nxt = gm.decode_step(state)
        jnxt, jstate.k, jstate.v = jgm._decode_impl(
            jgm.params, jstate.k, jstate.v, jstate.tokens, jstate.cursor)
        jnxt = np.asarray(jnxt)
        assert nxt.dtype == np.int32 and nxt.shape == (3,)
        for slot in (0, 2):
            assert nxt[slot] == jnxt[slot], (step, slot, nxt, jnxt)
            state.advance(slot, nxt[slot])
            jstate.advance(slot, jnxt[slot])
        _close(state.k.numpy(), np.asarray(jstate.k), "k step %d" % step)
        _close(state.v.numpy(), np.asarray(jstate.v), "v step %d" % step)
    assert int(state.cursor[0]) == 17 and int(state.cursor[0]) % window == 1
    assert gm.compile_stats() == {"decode_compiles": 1,
                                  "admit_compiles": 2, "admit_programs": 2}


def test_decode_state_ring_semantics_match_the_jax_package():
    def drive(cls, **kw):
        st = cls(slots=2, num_layers=1, num_kv_heads=2, max_len=4,
                 head_dim=2, **kw)
        log = [st.free_slots(), st.busy()]
        st.occupy(0, prompt_len=3, first_token=7)
        log += [st.busy(), st.free_slots(), int(st.cursor[0]),
                int(st.tokens[0])]
        for tok in (1, 2, 3):
            st.advance(0, tok)
            log.append(int(st.cursor[0]))
        log += [int(st.cursor[0]) % 4, st.n_generated(0, prompt_len=3)]
        for args, exc in (((0, 1, 0), RuntimeError), ((1, 5, 0), ValueError)):
            with pytest.raises(exc):
                st.occupy(*args)
        st.release(0)
        log += [st.free_slots(), tuple(st.k.shape), str(st.k.dtype)[-7:]]
        return log

    assert drive(DecodeState, ctx=CPU) == drive(jgen.DecodeState)
    for kw in ({}, {"slots": 3}, {"dtype_size": 2, "slots": 5}):
        args = dict(num_layers=2, num_kv_heads=2, max_len=8, head_dim=4)
        assert DecodeState.kv_bytes(**args, **kw) == \
            jgen.DecodeState.kv_bytes(**args, **kw)
    assert DecodeState.kv_bytes(num_layers=2, num_kv_heads=2, max_len=8,
                                head_dim=4, slots=3) == 2 * 2 * 3 * 2 * 8 * 4 * 4
    st = DecodeState(1, 1, 1, 4, 2, ctx=CPU)
    assert st.k.device.type == "cpu" and st.device == torch.device("cpu")


def test_the_model_takes_the_current_context():
    spec = _block().generative_spec()
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError, match="GPU"):
            GenerativeModel("lm", spec)         # gpu(0) outside a block
        with pytest.raises(tmx.MXNetError, match="GPU"):
            DecodeState(1, 1, 1, 4, 2)
    with tmx.cpu():
        gm = GenerativeModel("lm", spec)
    assert gm.device == torch.device("cpu")
    assert gm.make_state(2).k.device.type == "cpu"
    assert gm.symbol_sha == jgen.GenerativeModel(
        "lm", _jax_block().generative_spec()).symbol_sha
    assert gm.param_bytes() == 4 * sum(
        t.numel() for _, t in _leaves(spec["params"]))


# ---------------------------------------------------------------------------
# the reference's warmup defect, on both packages
# ---------------------------------------------------------------------------
def _seat_and_warm(gen, sched):
    """Seat one generation in slot 0 (the parked loop's own admission
    and prefill), then warm one grid cell while it is live; returns the
    stream and slot 0's K rows before and after the warmup."""
    stream = sched.submit(_prompt(3, seed=5), max_new_tokens=8,
                          tenant="live")
    with sched._cv:
        adm = sched._pick_admissions_locked()
    sched._do_prefill(adm)
    assert adm["slots"] == [0] and sched.state.active[0]
    before = np.array(sched.state.k[:, 0])
    sched.warmup(grid=[(1, 4)])
    after = np.array(sched.state.k[:, 0])
    return stream, before, after


def test_warmup_beside_a_live_slot_leaves_it_alone_unlike_the_jax_package():
    # the JAX package: the warmup admits a dummy prompt into slot 0 of the
    # live state and releases it while the scheduler still holds its meta
    jgm = jgen.GenerativeModel("lm", _jax_block(), max_len=MAXLEN,
                               prefill_batch=1)
    jsched = jgen.DecodeScheduler(jgm, jmx.serving.ExecutorCache(capacity=8),
                                  slots=2)
    jsched._thread = types.SimpleNamespace(join=lambda timeout=None: None)
    jstream, before, after = _seat_and_warm(jgen, jsched)
    assert 0 in jsched._slot_meta and not jsched.state.active[0]
    assert not np.array_equal(before, after)     # its K rows overwritten
    n = jstream.n_tokens
    jsched._do_step()
    assert jstream.n_tokens == n                 # the stream never advances
    jsched.stop(drain=False)

    # the port: the warmup runs on a scratch state of the same geometry
    gm = GenerativeModel("lm", _block(), max_len=MAXLEN, prefill_batch=1,
                         ctx=CPU)
    sched = DecodeScheduler(gm, ExecutorCache(capacity=8, ctx=CPU), slots=2)
    sched._thread = types.SimpleNamespace(join=lambda timeout=None: None)
    stream, before, after = _seat_and_warm(None, sched)
    assert 0 in sched._slot_meta and sched.state.active[0]
    np.testing.assert_array_equal(before, after)
    assert int(sched.state.cursor[0]) == 3
    n = stream.n_tokens
    sched._do_step()
    assert stream.n_tokens == n + 1
    sched.stop(drain=False)
    assert sched.ledgers()["live"]["failed"] == 1


# ---------------------------------------------------------------------------
# behaviour on the port (the JAX package's cases)
# ---------------------------------------------------------------------------
def test_greedy_parity_with_the_blocks_own_forward():
    blk = _block()
    srv = ModelServer(cache_size=64, ctx=CPU)
    srv.add_generative_model("lm", blk, slots=2, max_len=MAXLEN,
                             prefill_batch=2)
    try:
        for seed, (n, new) in enumerate(((5, 8), (1, 6), (9, 7))):
            prompt = _prompt(n, seed=11 + seed)
            got = srv.infer_stream("lm", prompt, max_new_tokens=new).result(
                timeout=120)
            assert got == _ref_greedy(blk, prompt, new), (n, got)
    finally:
        srv.stop(drain=False)


def test_streaming_iteration_yields_incrementally():
    srv = _server(slots=2, warm=False)
    try:
        st = srv.infer_stream("lm", _prompt(3), max_new_tokens=5)
        toks = list(st)
        assert len(toks) == 5
        assert st.state == "served" and st.done()
        assert st.ttft_s is not None and st.ttft_s > 0
        assert len(st.token_latencies_s) == 4
        assert st.result(timeout=1) == toks
    finally:
        srv.stop(drain=False)


def test_no_convoy_shorts_finish_while_long_generation_in_flight():
    srv = _server(slots=4, prefill_batch=2)
    sched = srv._gen_sched("lm")
    miss0 = srv.cache.misses
    jit0 = sched.model.compile_stats()
    try:
        long_st = srv.infer_stream("lm", _prompt(4), max_new_tokens=48,
                                   tenant="long")
        shorts = [srv.infer_stream("lm", _prompt(3, seed=s),
                                   max_new_tokens=4, tenant="short")
                  for s in range(6)]
        for s in shorts:
            assert len(s.result(timeout=120)) == 4
        assert not long_st.done()
        assert len(long_st.result(timeout=120)) == 48
        # steady state bound nothing new: the warmed grid, admit rungs
        # and decode step served every request above
        assert srv.cache.misses == miss0
        assert sched.model.compile_stats() == jit0
        led = sched.ledgers()
        for counts in led.values():
            assert counts["submitted"] == (
                counts["served"] + counts["failed"]
                + counts["expired"] + counts["shed"]), led
        assert led["short"]["served"] == 6
        assert led["long"]["served"] == 1
    finally:
        srv.stop(drain=False)


def test_warmup_covers_grid_and_second_warmup_is_free(tmp_path):
    srv = ModelServer(cache_size=64, ctx=CPU,
                      manifest_path=str(tmp_path / "manifest.json"))
    srv.add_generative_model("lm", _block(), slots=4, max_len=MAXLEN,
                             prefill_batch=2)
    sched = srv._gen_sched("lm")
    warmed = srv.warmup_generative()["lm"]
    assert warmed == len(sched.model.grid()) == 2 * 5
    assert sched.model.compile_stats() == {
        "decode_compiles": 1, "admit_compiles": 5, "admit_programs": 5}
    miss0 = srv.cache.misses
    assert srv.warmup_generative()["lm"] == warmed
    assert srv.cache.misses == miss0
    assert sched.state.busy() == 0 and not sched.state.k.any()
    # a restarted server warms the manifest's grid cells
    assert srv.manifest.grid_for("lm", sched.model.symbol_sha) == \
        sorted(sched.model.grid())
    srv.stop(drain=False)
    srv2 = ModelServer(cache_size=64, ctx=CPU,
                       manifest_path=str(tmp_path / "manifest.json"))
    srv2.add_generative_model("lm", _block(), slots=4, max_len=MAXLEN,
                              prefill_batch=2)
    assert srv2.warmup_generative(from_manifest=True) == {"lm": warmed}
    with pytest.raises(ModelNotFound):
        srv2.warmup_generative("nope")
    srv2.stop(drain=False)


def test_bad_request_rejections():
    srv = _server(slots=1, warm=False)
    try:
        with pytest.raises(BadRequest):
            srv.infer_stream("lm", np.zeros(0, np.int32))
        with pytest.raises(BadRequest):
            srv.infer_stream("lm", _prompt(MAXLEN + 1))
        with pytest.raises(BadRequest):
            srv.infer_stream("lm", _prompt(2), max_new_tokens=0)
        with pytest.raises(ModelNotFound):
            srv.infer_stream("nope", _prompt(2))
        with pytest.raises(ValueError, match="already registered"):
            srv.add_generative_model("lm", _block())
    finally:
        srv.stop(drain=False)


def test_queue_full_rejection_carries_retry_hint():
    sched = _scheduler(slots=1, queue_depth=2)
    sched.submit(_prompt(2), max_new_tokens=4)
    sched.submit(_prompt(2), max_new_tokens=4)
    with pytest.raises(QueueFull) as ei:
        sched.submit(_prompt(2), max_new_tokens=4)
    assert ei.value.retry_after_s > 0
    sched.stop(drain=False)
    led = sched.ledgers()["default"]
    assert led == {"submitted": 2, "served": 0, "failed": 2,
                   "expired": 0, "shed": 0}
    assert sched.stats()["rejected_queue_full"] == 1


def test_deadline_expired_in_queue_is_typed_and_ledgered():
    sched = _scheduler(slots=1)
    st = sched.submit(_prompt(2), max_new_tokens=4, tenant="impatient",
                      timeout_ms=10.0)
    time.sleep(0.05)
    with sched._cv:
        sched._expire_locked(time.monotonic())
    with pytest.raises(DeadlineExceeded):
        st.result(timeout=5)
    assert st.state == "expired"
    assert sched.ledgers()["impatient"] == {
        "submitted": 1, "served": 0, "failed": 0, "expired": 1, "shed": 0}
    sched.stop(drain=False)


def test_deadline_mid_generation_frees_the_slot():
    srv = _server(slots=1)
    try:
        st = srv.infer_stream("lm", _prompt(2), max_new_tokens=100000,
                              tenant="slow", timeout_ms=150.0)
        with pytest.raises(DeadlineExceeded):
            st.result(timeout=30)
        assert st.state == "expired" and st.n_tokens > 1
        after = srv.infer_stream("lm", _prompt(2), max_new_tokens=3)
        assert len(after.result(timeout=30)) == 3
        assert srv._gen_sched("lm").ledgers()["slow"]["expired"] == 1
    finally:
        srv.stop(drain=False)


def test_stop_fails_pending_and_running_with_server_closed():
    srv = _server(slots=1)
    hog = srv.infer_stream("lm", _prompt(2), max_new_tokens=100000,
                           tenant="hog")
    queued = srv.infer_stream("lm", _prompt(2), max_new_tokens=4)
    srv.stop(drain=False)
    for st in (hog, queued):
        with pytest.raises(ServerClosed):
            st.result(timeout=30)
    with pytest.raises(ServerClosed):
        srv._gen_sched("lm").submit(_prompt(2))
    led = srv._gen_sched("lm").ledgers()
    assert sum(c["failed"] for c in led.values()) == 2
    with pytest.raises(ServerClosed):
        srv.add_generative_model("lm2", _block())


def test_slot_quota_admits_one_slot_per_tenant_per_round():
    sched = _scheduler(slots=4, prefill_batch=4)
    sched.set_slot_quota("a", 1)
    for i in range(3):
        sched.submit(_prompt(2, seed=i), max_new_tokens=4, tenant="a")
    sched.submit(_prompt(2, seed=9), max_new_tokens=4, tenant="b")
    with sched._cv:
        adm = sched._pick_admissions_locked()
        assert [s.tenant for s, _ in adm["batch"]] == ["a", "b"]
        assert len(sched._pending) == 2
        assert all(s.tenant == "a" for s, _ in sched._pending)
    sched.set_slot_quota("a", None)
    with sched._cv:
        assert "a" not in sched._slot_quotas
    sched.stop(drain=False)


def test_server_slot_quota_reaches_the_scheduler():
    srv = _server(slots=2, warm=False)
    try:
        srv.set_slot_quota("lm", "a", 1)
        assert srv._gen_sched("lm")._slot_quotas == {"a": 1}
        with pytest.raises(ModelNotFound):
            srv.set_slot_quota("nope", "a", 1)
    finally:
        srv.stop(drain=False)


def test_priority_orders_admission_within_a_rung():
    sched = _scheduler(slots=4)
    sched.submit(_prompt(2, seed=0), max_new_tokens=4, priority=1,
                 tenant="batchy")
    sched.submit(_prompt(2, seed=1), max_new_tokens=4, priority=0,
                 tenant="interactive")
    with sched._cv:
        adm = sched._pick_admissions_locked()
        assert [s.tenant for s, _ in adm["batch"]] == ["interactive",
                                                       "batchy"]
    sched.stop(drain=False)


def test_brownout_sheds_low_class_at_the_door():
    srv = _server(slots=2, warm=False)
    sched = srv._gen_sched("lm")
    with sched._cv:
        sched._brownout = True     # brownout_ms=0 -> never recomputed
    try:
        shed = srv.infer_stream("lm", _prompt(2), max_new_tokens=4,
                                priority=2, tenant="batchy")
        assert shed.state == "shed"
        with pytest.raises(QueueFull) as ei:
            shed.result(timeout=1)
        assert ei.value.retry_after_s > 0
        kept = srv.infer_stream("lm", _prompt(2), max_new_tokens=4,
                                priority=0, tenant="interactive")
        assert len(kept.result(timeout=120)) == 4
        led = sched.ledgers()
        assert led["batchy"]["shed"] == 1
        assert led["interactive"]["served"] == 1
    finally:
        srv.stop(drain=False)


def test_token_priced_brownout_sheds_queued_low_classes():
    sched = _scheduler(slots=1, brownout_ms=1.0)
    sched._token_costs.extend([0.01] * 8)      # 10 ms a token
    low = sched.submit(_prompt(2), max_new_tokens=50, priority=2,
                       tenant="low")
    high = sched.submit(_prompt(2), max_new_tokens=50, priority=0,
                        tenant="high")
    with sched._cv:
        sched._update_brownout_locked()
        assert sched._brownout
    assert low.state == "shed" and high.state == "pending"
    assert sched.stats()["sheds"] == 1
    sched.stop(drain=False)


def test_generative_telemetry_round_trips_exposition():
    from mxnet_tpu_torch import telemetry
    srv = _server(slots=2, warm=False)
    try:
        srv.infer_stream("lm", _prompt(3), max_new_tokens=4).result(
            timeout=120)
        gen = srv.stats()["generative"]["lm"]
        assert gen["steps"] >= 3 and gen["ledgers"]["default"]["served"] == 1
    finally:
        srv.stop(drain=False)
    text = telemetry.prometheus_text()
    telemetry.validate_exposition(text)
    snap = telemetry.snapshot()
    for fam in ("mxnet_serving_ttft_seconds",
                "mxnet_serving_per_token_seconds"):
        vals = snap[fam]["values"]
        assert any(v["labels"].get("model") == "lm" for v in vals), fam
    states = {(v["labels"]["model"], v["labels"]["state"])
              for v in snap["mxnet_serving_decode_slots"]["values"]}
    assert {("lm", "busy"), ("lm", "free")} <= states


def test_tracing_spans_cover_a_generation():
    from mxnet_tpu_torch.telemetry import tracing
    tracing.reset()
    tracing.enable(sample=1.0, p99_factor=1e9)
    srv = _server(slots=2, warm=False)
    try:
        srv.infer_stream("lm", _prompt(3), max_new_tokens=3).result(
            timeout=120)
    finally:
        srv.stop(drain=False)
        names = {s["name"] for s in tracing.snapshot()}
        tracing.disable()
        tracing.reset()
    assert {"gen.request", "gen.occupy", "gen.decode_step"} <= names


GEN_KNOBS = ("MXNET_SERVING_GEN_SLOTS", "MXNET_SERVING_GEN_MAX_LEN",
             "MXNET_SERVING_GEN_MAX_NEW_TOKENS",
             "MXNET_SERVING_GEN_PREFILL_BATCH",
             "MXNET_SERVING_GEN_QUEUE_DEPTH", "MXNET_SERVING_GEN_SLOT_QUOTA",
             "MXNET_SERVING_GEN_BROWNOUT_MS")


@pytest.mark.parametrize("name", GEN_KNOBS)
def test_generative_knobs_registered_with_the_jax_defaults(name,
                                                           monkeypatch):
    monkeypatch.delenv(name, raising=False)
    from mxnet_tpu import config as jconfig
    from mxnet_tpu_torch import config
    assert config.get(name) == jconfig.get(name)
    assert config._REGISTRY[name].typ is jconfig._REGISTRY[name].typ
    assert config._REGISTRY[name].description


def test_knobs_set_the_scheduler_defaults(monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_GEN_SLOTS", "3")
    monkeypatch.setenv("MXNET_SERVING_GEN_QUEUE_DEPTH", "5")
    monkeypatch.setenv("MXNET_SERVING_GEN_MAX_NEW_TOKENS", "2")
    monkeypatch.setenv("MXNET_SERVING_GEN_MAX_LEN", "8")
    monkeypatch.setenv("MXNET_SERVING_GEN_PREFILL_BATCH", "3")
    monkeypatch.setenv("MXNET_SERVING_GEN_SLOT_QUOTA", "1")
    srv = ModelServer(cache_size=64, ctx=CPU)
    sched = srv.add_generative_model("lm", _block())
    try:
        assert (sched.slots, sched.queue_depth, sched.default_new_tokens,
                sched._default_slot_quota) == (3, 5, 2, 1)
        assert sched.model.max_len == 8 and sched.state.k.shape[3] == 8
        assert sched.model.batch_ladder == [1, 2, 3]
        assert len(srv.infer_stream("lm", _prompt(2)).result(
            timeout=60)) == 2
    finally:
        srv.stop(drain=False)


def test_decode_fault_poisons_only_the_victim_slot():
    plan = fault.FaultPlan({"rules": [
        {"site": "serving.decode.step", "kind": "raise", "times": 1,
         "where": {"tenant": "victim"}}]})
    srv = _server(slots=4, prefill_batch=2)
    want = {s: srv.infer_stream("lm", _prompt(3, seed=s),
                                max_new_tokens=8).result(timeout=120)
            for s in range(3)}
    fault.install(plan)
    try:
        victim = srv.infer_stream("lm", _prompt(3), max_new_tokens=32,
                                  tenant="victim")
        healthy = {s: srv.infer_stream("lm", _prompt(3, seed=s),
                                       max_new_tokens=8, tenant="t%d" % s)
                   for s in range(3)}
        with pytest.raises(fault.FaultInjected):
            victim.result(timeout=120)
        for s, st in healthy.items():
            assert st.result(timeout=120) == want[s]
        fault.uninstall()
        again = srv.infer_stream("lm", _prompt(2), max_new_tokens=4,
                                 tenant="victim")
        assert len(again.result(timeout=120)) == 4
        led = srv._gen_sched("lm").ledgers()
        assert led["victim"] == {"submitted": 2, "served": 1,
                                 "failed": 1, "expired": 0, "shed": 0}
        for s in range(3):
            assert led["t%d" % s]["served"] == 1
            assert led["t%d" % s]["failed"] == 0
        assert plan.injected_count() == 1
    finally:
        fault.uninstall()
        srv.stop(drain=False)


def test_chip_smoke_generative_phase_rehearses_on_the_cpu():
    """chip_smoke's phase 21 (a) and (b) with ctx=cpu() at the small
    width: the warmed grid, solo / mixed / steady traffic, the decode and
    prefill timings, the tokens against the block's own forward, the
    prefill and decode against a second model on the CPU, and the decode
    fault isolated to its tenant, each checked by the phase itself (the
    convoy bound among them)."""
    import chip_smoke
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    config = dict(SMALL, max_len=MAXLEN)
    res = chip_smoke.generative_phase(
        tmx, ck, CPU, config=config, slots=4, max_len=MAXLEN,
        prefill_batch=2,
        solo={"waves": 3, "requests": 2, "prompt": 3, "new": 4},
        long={"prompt": 4, "new": 40},
        steady={"prompt": 3, "new": 12, "steps": 30},
        check={"prompts": (2, 5, 9), "new": 5},
        cpu={"prompts": (2, 5), "steps": 4, "slots": 2}, timed=3,
        cell=(2, 4))
    assert res["cells_warmed"] == res["grid_cells"] == 2 * 5
    assert res["traffic"]["steady_steps"] >= 30
    assert res["traffic"]["steady_misses"] == 0
    assert res["tokens"]["matched"] == [5, 5, 5]
    assert res["cpu"]["first_equal"] and res["cpu"]["worst"] == 0.0
    assert res["faults"]["victim_failed"]
    assert res["kv_bytes"] == 4 * DecodeState.kv_bytes(2, 2, MAXLEN, 4)
