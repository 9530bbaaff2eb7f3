"""The port's model-axis sharding (``mxnet_tpu_torch.parallel``: the mesh's
model axes, ring and Ulysses attention, ``pipeline_apply`` and
``switch_moe``) against the JAX package's.

The multi-rank runs are real processes: one world of four ranks over gloo
on the CPU (``chip_smoke.run_ranks``, rendezvous through a ``file://``
store under the test's temporary directory, every process gone when it
returns) runs every case of ``CASES``; the JAX package runs the same case
in this process on its virtual 8-device CPU mesh (each function and its
gradient under one ``jax.jit``, as a training step runs it).  Inputs are
numpy from
seeds (``chip_smoke.mp_inputs``).  Each function takes and returns global
arrays on every rank, as the JAX one does; each rank's loss
``sum(out * w)`` is divided by the world and its gradients are summed
over the world, which is the JAX package's gradient of ``sum(out * w)``
(the exact-transpose rule of ``collectives``).  The forward and the
gradients must lie within 1e-6 of the JAX package's (relative to the
largest value held).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

import chip_smoke as cs

torch.set_num_threads(1)

WORLD = 4
TOL = 1e-6


def _attn(fn, sp, causal, t=8, h=4, hkv=None, b=2, d=8, seed=0):
    return {"kind": "attn", "fn": fn, "sp": sp, "causal": causal, "b": b,
            "t": t, "h": h, "hkv": hkv or h, "d": d, "seed": seed}


ATTN = [_attn(fn, sp, causal) for fn in ("ring", "ulysses")
        for sp in (2, 4) for causal in (False, True)]
ATTN += [
    # grouped-query attention: two K/V heads for four query heads
    _attn("ring", 2, True, hkv=2, seed=1),
    _attn("ulysses", 4, True, hkv=2, seed=1),
    # a length the axis does not divide: padded, the padded keys masked
    _attn("ring", 4, False, t=10, seed=2),
    _attn("ring", 4, True, t=11, seed=2),
    _attn("ulysses", 2, True, t=9, seed=2),
    _attn("ulysses", 4, False, t=10, seed=2),
]
PIPE = [{"kind": "pipe", "pp": pp, "m": m, "b": 8, "d": 6, "seed": 3}
        for pp, m in ((2, 2), (2, 4), (4, 4), (4, 2))]
# capacity factors: 4 keeps every token, 0.5 drops some
MOE = [{"kind": "moe", "ep": ep, "e": e, "t": 16, "d": 6, "f": 10,
        "cf": cf, "seed": 4} for ep, e in ((2, 4), (4, 8), (4, 4))
       for cf in (4.0, 0.5)]
MESHES = [{"dp": 4}, {"tp": 2}, {"dp": 2, "fsdp": 2}, {"sp": 4},
          {"pp": 2, "ep": 2}, {"fsdp": 2, "tp": 2}, {"dp": 1, "ep": 4}]
# meshes four ranks cannot hold: the JAX package's error, not a shrink
MESHES += [{"tp": 3}, {"dp": 3, "tp": 2}, {"sp": 2, "ep": 4}]
MESH = [{"kind": "mesh", "mesh": m} for m in MESHES]
SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}
# the first Dense's bias feeds the BatchNorm, which takes its mean back
# out: its gradient is rounding noise, which Adam with eps 1e-8 turns
# into +-lr a step in either package; a larger eps keeps it small
ADAM = {"learning_rate": 0.05, "epsilon": 1e-3}
LM_ADAM = {"learning_rate": 0.01}


def _trainer(mesh, net, opt, zero):
    params = {"sgd": SGD, "adam": LM_ADAM if net == "lm" else ADAM}[opt]
    return {"kind": "trainer", "mesh": mesh, "net": net, "opt": opt,
            "opt_params": params, "zero": zero, "steps": 3}


# every model-axis mesh at zero 0 and 2, each optimizer on each; the
# Dense chain with its BatchNorm under tp and fsdp, the LM under sp (its
# attention through the ring) and under tp
TRAINER = [_trainer({"dp": 2, "tp": 2}, "bn", "sgd", 0),
           _trainer({"dp": 2, "tp": 2}, "bn", "adam", 2),
           _trainer({"dp": 2, "fsdp": 2}, "bn", "adam", 0),
           _trainer({"dp": 2, "fsdp": 2}, "bn", "sgd", 2),
           _trainer({"dp": 1, "fsdp": 4}, "bn", "adam", 2),
           _trainer({"dp": 1, "fsdp": 4}, "bn", "sgd", 0),
           _trainer({"dp": 2, "sp": 2}, "lm", "adam", 2),
           _trainer({"dp": 2, "sp": 2}, "lm", "sgd", 0),
           _trainer({"dp": 1, "tp": 4}, "lm", "adam", 0)]
# a state saved at dp=1 x fsdp=4, zero=2 restores at dp=2 x fsdp=2,
# zero=1 and at dp=4, zero=0 (the JAX package's state too)
RESUME = dict(_trainer(None, "bn", "adam", 2), kind="resume",
              save=({"dp": 1, "fsdp": 4}, 2),
              loads=[({"dp": 2, "fsdp": 2}, 1), ({"dp": 4}, 0)])
# a Dropout under tp, each rank seeded with its rank: the ranks of a
# replica group must still draw the same masks
DROPOUT = {"kind": "dropout", "mesh": {"dp": 2, "tp": 2}, "steps": 2}
# phase 23 of chip_smoke.py at small width (its four-card meshes)
CHIP = {"kind": "chip", "cfg": dict(
    cs.MP_CFG, config=cs.MP_SMALL_LM, meshes=cs.MP_MESHES, batch=4, t=8,
    sp_t=32, ulysses=(2, 16, 4, 8), ring_t=13,
    pipe={"batch": 4, "t": 8, "m": 4},
    moe={"e": 8, "tokens": 64, "f": 16, "cf": (4.0, 0.5)})}
CASES = MESH + ATTN + PIPE + MOE + TRAINER + [RESUME, DROPOUT, CHIP]


def _index(kind):
    return [i for i, c in enumerate(CASES) if c["kind"] == kind]


def _jax_resume():
    """The JAX package's trainer on the resume case's saved mesh: its
    state after the steps, and its losses over two more."""
    (kw, zero), case = RESUME["save"], RESUME
    tr = cs.mp_trainer(jmx, dict(case, zero=zero), _jmesh4(**kw))
    res = cs.mp_trainer_run(jmx, tr, case)
    state = tr.state_dict()
    x, y = cs.mp_data(case["net"])
    more = [float(tr.step(jmx.nd.array(x), jmx.nd.array(y)).asnumpy())
            for _ in range(2)]
    return state, res["losses"], more


@pytest.fixture(scope="module")
def jax_resume():
    return _jax_resume()


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_resume):
    """Every rank's results of every case, from one world of four."""
    cases = [dict(c, jax_state=jax_resume[0]) if c["kind"] == "resume"
             else c for c in CASES]
    return cs.run_ranks("chip_smoke:mp_cases_rank", WORLD, (cases,),
                        workdir=str(tmp_path_factory.mktemp("ranks")),
                        threads=1, timeout=300)


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    dev = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert dev <= TOL * scale, (what, dev, scale)


def _jmesh(**kw):
    n = 1
    for v in kw.values():
        n *= v
    return jmx.parallel.make_mesh(devices=jax.devices()[:n], **kw)


def _jmesh4(**kw):
    return jmx.parallel.make_mesh(devices=jax.devices()[:WORLD], **kw)


# -- the mesh -----------------------------------------------------------------

@pytest.mark.parametrize("i", _index("mesh"),
                         ids=["-".join("%s%d" % kv for kv in
                                       CASES[i]["mesh"].items())
                              for i in _index("mesh")])
def test_mesh_shape_and_rank_coordinates_are_the_jax_packages(world, i):
    """Rank r takes the coordinates of JAX device r in the row-major
    (dp, fsdp, tp, pp, sp, ep) layout; each axis's group holds the ranks
    along that axis."""
    try:
        jm = jmx.parallel.make_mesh(devices=jax.devices()[:WORLD],
                                    **CASES[i]["mesh"])
    except jmx.MXNetError as e:
        for r in range(WORLD):
            assert world[r][i] == {"error": str(e)}
        return
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(WORLD):
        got = world[r][i]
        assert got["shape"] == dict(jm.shape)
        assert got["devices"] == ids.tolist()
        where = np.argwhere(ids == r)[0]
        assert got["coords"] == {a: int(c) for a, c in
                                 zip(jm.axis_names, where)}
        for a in jm.axis_names:
            assert got["groups"][a] == jm.shape[a]
        assert got["groups"]["('dp', 'fsdp')"] == jm.shape["dp"] \
            * jm.shape["fsdp"]
        assert got["groups"]["None"] == WORLD


@pytest.mark.parametrize("kw", [{"dp": 2}, {"pp": 2}, {"tp": 3, "sp": 1},
                                {"dp": 1, "fsdp": 1}, {}])
def test_lone_process_make_mesh_is_the_jax_packages(kw):
    """A lone process is a world of one: the JAX package's one device."""
    try:
        want = jmx.parallel.make_mesh(devices=jax.devices()[:1], **kw)
        jerr = None
    except jmx.MXNetError as e:
        want, jerr = None, str(e)
    with tmx.cpu():
        if jerr is not None:
            with pytest.raises(tmx.MXNetError) as e:
                tmx.parallel.make_mesh(**kw)
            assert str(e.value) == jerr
        else:
            assert tmx.parallel.make_mesh(**kw).shape == dict(want.shape)


def test_model_axes_need_ranks_in_order_and_sharding_divides():
    with tmx.cpu():
        mesh = tmx.parallel.make_mesh()
    spec = tmx.parallel.mesh.Sharding(mesh, (("dp", "fsdp"), None))
    assert spec.shard_shape((6, 2)) == (6, 2)
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(spec.local(x), x)
    assert mesh.coords == dict.fromkeys(mesh.axis_names, 0)
    assert mesh.axis_index(("dp", "tp")) == 0


# -- attention ----------------------------------------------------------------

def _jattn(case):
    a = cs.mp_inputs(case)
    mesh = _jmesh(sp=case["sp"])
    fn = getattr(jmx.parallel, case["fn"] + "_attention")

    def loss(q, k, v):
        out = fn(q, k, v, mesh=mesh, causal=case["causal"])
        return jnp.sum(out * a["w"]), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                 has_aux=True))(
        jnp.asarray(a["q"]), jnp.asarray(a["k"]), jnp.asarray(a["v"]))
    return {"out": np.asarray(out), "dq": np.asarray(grads[0]),
            "dk": np.asarray(grads[1]), "dv": np.asarray(grads[2])}


def _attn_id(c):
    return "%s-sp%d-%s-t%d%s" % (c["fn"], c["sp"],
                                 "causal" if c["causal"] else "full", c["t"],
                                 "-gqa" if c["hkv"] != c["h"] else "")


@pytest.mark.parametrize("i", _index("attn"),
                         ids=[_attn_id(CASES[i]) for i in _index("attn")])
def test_sequence_parallel_attention_matches_the_jax_package(world, i):
    want = _jattn(CASES[i])
    for r in range(WORLD):
        got = world[r][i]
        for k in ("out", "dq", "dk", "dv"):
            _close(got[k], want[k], (r, k))


def test_one_rank_attention_is_local_attention():
    """Without a mesh (or with sp of one) both forms are
    ``local_attention``, whose ``kv_len`` mask zeroes the padded queries'
    rows, as the JAX package's does."""
    case = _attn("ring", 1, True, t=6)
    a = cs.mp_inputs(case)
    t = {k: torch.tensor(v) for k, v in a.items()}
    for name in ("ring_attention", "ulysses_attention"):
        got = getattr(tmx.parallel, name)(t["q"], t["k"], t["v"],
                                          causal=True)
        want = tmx.parallel.local_attention(t["q"], t["k"], t["v"],
                                            causal=True)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for causal in (False, True):
        got = tmx.parallel.local_attention(t["q"], t["k"], t["v"],
                                           causal=causal, kv_len=4)
        want = jmx.parallel.local_attention(
            jnp.asarray(a["q"]), jnp.asarray(a["k"]), jnp.asarray(a["v"]),
            causal=causal, kv_len=4)
        _close(got.numpy(), np.asarray(want), causal)


# -- pipeline -----------------------------------------------------------------

def _jpipe(case):
    a = cs.mp_inputs(case)
    mesh = _jmesh(pp=case["pp"])

    def loss(w, b, x):
        out = jmx.parallel.pipeline_apply(
            cs.mp_stage(jnp), {"w": w, "b": b}, x, mesh,
            num_microbatches=case["m"])
        return jnp.sum(out * a["g"]), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True))(
        jnp.asarray(a["w"]), jnp.asarray(a["b"]), jnp.asarray(a["x"]))
    return {"out": np.asarray(out), "dw": np.asarray(g[0]),
            "db": np.asarray(g[1]), "dx": np.asarray(g[2])}


@pytest.mark.parametrize("i", _index("pipe"), ids=[
    "pp%d-m%d" % (CASES[i]["pp"], CASES[i]["m"]) for i in _index("pipe")])
def test_pipeline_apply_matches_the_jax_package(world, i):
    """The outputs and the gradients of the stacked parameters and of x
    are the JAX package's, which are the sequential apply's."""
    case = CASES[i]
    want = _jpipe(case)
    a = cs.mp_inputs(case)
    seq = a["x"].astype(np.float64)
    for s in range(case["pp"]):
        seq = np.tanh(seq @ a["w"][s] + a["b"][s])
    _close(want["out"], seq, "jax vs sequential")
    for r in range(WORLD):
        for k in ("out", "dw", "db", "dx"):
            _close(world[r][i][k], want[k], (r, k))


# -- experts ------------------------------------------------------------------

def _jmoe(case):
    a = cs.mp_inputs(case)
    mesh = _jmesh(ep=case["ep"])

    def loss(x, gate, w1, w2):
        out = jmx.parallel.switch_moe(
            x, gate, {"w1": w1, "w2": w2}, cs.mp_expert(jnp), mesh,
            capacity_factor=case["cf"])
        return jnp.sum(out * a["g"]), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                             has_aux=True))(
        *(jnp.asarray(a[n]) for n in ("x", "gate", "w1", "w2")))
    res = {"out": np.asarray(out)}
    res.update(zip(("dx", "dgate", "dw1", "dw2"),
                   (np.asarray(v) for v in g)))
    return res


@pytest.mark.parametrize("i", _index("moe"), ids=[
    "ep%d-e%d-cf%g" % (CASES[i]["ep"], CASES[i]["e"], CASES[i]["cf"])
    for i in _index("moe")])
def test_switch_moe_matches_the_jax_package(world, i):
    """Top-1 routing with capacity: the outputs (dropped tokens zero) and
    the gradients of the tokens, the gate and the experts."""
    case = CASES[i]
    want = _jmoe(case)
    dropped = int((np.abs(want["out"]).sum(-1) == 0).sum())
    # the small capacity really drops tokens, the large one none
    assert (dropped > 0) == (case["cf"] < 1), dropped
    for r in range(WORLD):
        got = world[r][i]
        assert got["dropped"] == dropped
        for k in ("out", "dx", "dgate", "dw1", "dw2"):
            _close(got[k], want[k], (r, k))


# -- ParallelTrainer ----------------------------------------------------------

def _largest(params):
    return max(float(np.abs(v).max()) for v in params.values())


def _moving(name):
    # the JAX package's step never writes BatchNorm's moving statistics
    # back (ROADMAP queue 3); the port's does
    return name.endswith(("running_mean", "running_var"))


def _trainer_id(c):
    return "%s-%s-%s-z%d" % ("".join("%s%d" % kv for kv in c["mesh"].items()),
                             c["net"], c["opt"], c["zero"])


@pytest.mark.parametrize("i", _index("trainer"),
                         ids=[_trainer_id(CASES[i])
                              for i in _index("trainer")])
def test_model_axis_trainer_matches_the_jax_package(world, i):
    """Three steps on each mesh: the parameters and losses within 1e-6
    of the largest |parameter| of the JAX trainer on the same mesh shape,
    and ``comm_stats``, ``optimizer_state_bytes`` and ``plan_spec``
    (the per-parameter specs among it) equal to the JAX package's.  (The
    nets have no dropout.)"""
    case = CASES[i]
    jt = cs.mp_trainer(jmx, case, _jmesh4(**case["mesh"]))
    want = cs.mp_trainer_run(jmx, jt, case)
    big = _largest(want["params"])
    # Adam with eps 1e-8 turns rounding noise in a gradient into +-lr a
    # step: where the JAX package's own dp-only and model-axis trainers
    # lie further apart than 1e-6, the band is twice their distance
    dp = cs.mp_trainer_run(jmx, cs.mp_trainer(jmx, case, _jmesh4(dp=WORLD)),
                           case)
    own = max(float(np.abs(dp["params"][n] - v).max())
              for n, v in want["params"].items() if not _moving(n))
    tol = max(TOL * big, 2 * own)
    for r in range(WORLD):
        got = world[r][i]
        for n, v in want["params"].items():
            if not _moving(n):
                dev = float(np.abs(got["params"][n] - v).max())
                assert dev <= tol, (r, n, dev, tol)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                                   atol=tol)
        assert got["comm"] == want["comm"]
        assert got["plan"] == want["plan"]
    # the bytes each rank holds: the JAX package's per device
    assert world[0][i]["bytes"] == want["bytes"]
    specs = [p["spec"] for p in want["plan"]["params"]]
    assert any(s and any(e for e in s) for s in specs) \
        or case["mesh"].get("sp")


@pytest.mark.parametrize("i", _index("trainer"),
                         ids=[_trainer_id(CASES[i])
                              for i in _index("trainer")])
def test_model_axis_trainer_issues_the_collectives_of_its_plan(world, i):
    """A step's calls: the wire model's (one per bucket and kind, one
    all-reduce per sharded parameter over its copies), the global loss's
    all-reduce and BatchNorm's four where the batch is split, for each
    sharded parameter one all-gather per split dim in the forward and,
    for a trainable one, one reduce-scatter per split dim in the
    backward, and under sp each ring's gather on exit and its
    reduce-scatter in the backward; at construction one broadcast a
    replicated parameter or bucket, and on a mesh with model axes one
    more, of the dropout seed."""
    case, got = CASES[i], world[0][i]
    kinds = got["comm"]["kinds"]
    split = {p["name"]: sum(1 for e in (p["spec"] or ()) if e)
             for p in got["plan"]["params"]}
    train = {p["name"]: p["trainable"] for p in got["plan"]["params"]}
    rings = cs.MP_SMALL_LM["num_layers"] if case["mesh"].get("sp") else 0
    gathers = sum(split.values()) + rings
    scatters = sum(v for n, v in split.items() if train[n]) + rings
    batch = case["mesh"].get("dp", 1) * case["mesh"].get("fsdp", 1) > 1
    bn = 4 if case["net"] == "bn" else 0
    replicas = int(np.prod(list(case["mesh"].values()))) \
        > case["mesh"].get("dp", 1) * case["mesh"].get("fsdp", 1)
    steps = case["steps"]
    assert got["calls"] == {
        "all_reduce": (kinds["all_reduce"]["ops"] + batch * (1 + bn))
        * steps,
        "reduce_scatter": (kinds["reduce_scatter"]["ops"] + scatters)
        * steps,
        "all_gather": (kinds["all_gather"]["ops"] + gathers) * steps,
        "broadcast": len(got["params"])
        - sum(len(b["names"]) for b in got["plan"]["buckets"])
        + len(got["plan"]["buckets"]) + replicas}


def _bitwise(a, b):
    for k in ("params", "residuals"):
        assert sorted(a[k]) == sorted(b[k]), k
        for n in a[k]:
            np.testing.assert_array_equal(a[k][n], b[k][n], err_msg=n)
    assert sorted(a["slots"]) == sorted(b["slots"])
    for s in a["slots"]:
        for n in a["slots"][s]:
            np.testing.assert_array_equal(a["slots"][s][n], b["slots"][s][n],
                                          err_msg="%s/%s" % (s, n))
    for s in a["scalars"]:
        np.testing.assert_array_equal(np.asarray(a["scalars"][s]).reshape(-1),
                                      np.asarray(b["scalars"][s]).reshape(-1))


def test_resume_across_fsdp_width_and_zero_stage_both_ways(world,
                                                           jax_resume):
    """A state saved at dp=1 x fsdp=4, zero=2 restores bit for bit at
    dp=2 x fsdp=2, zero=1 and at dp=4, zero=0 in the port, from the
    port's state and from the JAX package's; the JAX package restores the
    port's the same; and the trajectories go on together."""
    jstate, jlosses, jmore = jax_resume
    got = world[0][CASES.index(RESUME)]
    tol = TOL * _largest(jstate["params"])
    np.testing.assert_allclose(got["saved_losses"], jlosses, rtol=0,
                               atol=tol)
    np.testing.assert_allclose(got["continued"], jmore, rtol=0, atol=tol)
    for i, (kw, zero) in enumerate(RESUME["loads"]):
        for src, state in (("port", got["saved"]), ("jax", jstate)):
            load = got["load%d_%s" % (i, src)]
            assert load["compat"]["compatible"], load["compat"]
            _bitwise(load["state"], state)
            np.testing.assert_allclose(load["losses"], jmore, rtol=0,
                                       atol=tol)
        # the other direction: the JAX package restores the port's state
        jt = cs.mp_trainer(jmx, dict(RESUME, zero=zero), _jmesh4(**kw))
        jt.load_state_dict(got["saved"])
        _bitwise(jt.state_dict(), got["saved"])


def test_replica_group_draws_the_same_dropout_masks(world):
    """On dp=2 x tp=2 with rank r seeded r, the ranks that hold the same
    rows (0 and 1, 2 and 3) drop the same units in each step, the two
    row blocks and the two steps drop others, and every rank's generator
    comes back to its own state after a step."""
    got = [world[r][CASES.index(DROPOUT)] for r in range(WORLD)]
    for r in got:
        assert r["restored"] == [True] * DROPOUT["steps"]
        assert len(r["masks"]) == DROPOUT["steps"]
    for step in range(DROPOUT["steps"]):
        m = [r["masks"][step] for r in got]
        np.testing.assert_array_equal(m[0], m[1])
        np.testing.assert_array_equal(m[2], m[3])
        assert not np.array_equal(m[0], m[2])
    assert not np.array_equal(got[0]["masks"][0], got[0]["masks"][1])


# -- phase 23's rehearsal -----------------------------------------------------

def test_chip_smoke_model_parallel_phase_rehearses_on_the_cpu(world):
    """Phase 23 (a)-(d) at small width over the world of four gloo ranks,
    on the meshes four cards take: each mesh's first SGD update against
    the dp-only trainer's, the falling loss, the LM under sp against its dense
    forward, Ulysses, the ring, the pipeline and the experts against their
    one-rank forms; the launch counts hold only on the card."""
    rec = world[0][CASES.index(CHIP)]
    assert rec["world"] == WORLD
    assert sorted(rec["trainers"]) == ["dp1xfsdp4", "dp2xsp2", "dp2xtp2"]
    assert all("vs_dp" in r and "losses_vs_dp" in r
               for r in rec["trainers"].values())
    assert cs.mp_checks(rec, on_card=False) == []
    assert rec["moe"][0.5]["dropped"] > 0
