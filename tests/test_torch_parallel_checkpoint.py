"""The data-parallel trainer's checkpoints in the port against the JAX
package's: ``ParallelTrainerState`` written by either package restores in
the other (the store's files are the same bytes), a restore across mesh
width and ZeRO stage, ``check_restore_compat``'s verdicts,
``load_state_dict``'s refusals, and ``run_elastic`` widening from two
ranks to four (sub-meshes of one world of four gloo ranks on the CPU)
against the JAX package's uninterrupted oracle, as
``tests/test_fault.py::test_run_elastic_width_change_loss_curve_exact``
holds the JAX package to its own.
"""
import hashlib
import os

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.checkpoint import (CheckpointManager as JManager,
                                  ParallelTrainerState as JState,
                                  check_restore_compat as jcompat)
from mxnet_tpu.fault.backoff import BackoffPolicy as JBackoff
from mxnet_tpu.fault.elastic import (ElasticSupervisor as JSupervisor,
                                     run_elastic as jrun_elastic)
from mxnet_tpu_torch.checkpoint import (CheckpointManager as TManager,
                                        ParallelTrainerState as TState,
                                        check_restore_compat as tcompat)
from mxnet_tpu_torch.fault.backoff import BackoffPolicy as TBackoff
from mxnet_tpu_torch.fault.elastic import (ElasticError,
                                           ElasticSupervisor as TSupervisor,
                                           run_elastic as trun_elastic)

import chip_smoke as cs

torch.set_num_threads(1)

TOL = 1e-6
ADAM = {"learning_rate": 0.05}


def _jtrainer(case):
    """``chip_smoke.par_case_trainer`` in the JAX package, on its first
    ``width`` devices."""
    return cs.par_case_trainer(jmx, case,
                               devices=jax.devices()[:case["width"]])


def _case(opt="adam", zero=2, width=1, **kw):
    return dict({"net": "mlp", "opt": opt,
                 "opt_params": ADAM if opt == "adam" else
                 {"learning_rate": 0.05, "momentum": 0.9},
                 "zero": zero, "width": width, "steps": 2}, **kw)


def _jax(case):
    tr = _jtrainer(case)
    cs.par_case_run(jmx, tr, case)
    return tr


def _port(case):
    with tmx.cpu():
        tr = cs.par_case_trainer(tmx, case)
        cs.par_case_run(tmx, tr, case)
    return tr


def _equal_states(a, b):
    """Two ``state_dict``s equal bit for bit (a scalar read back from a
    store comes back with shape (1,), as in the JAX package)."""
    for k in ("params", "residuals"):
        assert sorted(a[k]) == sorted(b[k]), k
        for n in a[k]:
            np.testing.assert_array_equal(np.asarray(a[k][n]),
                                          np.asarray(b[k][n]), err_msg=n)
    assert sorted(a["slots"]) == sorted(b["slots"])
    for s in a["slots"]:
        for n in a["slots"][s]:
            np.testing.assert_array_equal(a["slots"][s][n],
                                          b["slots"][s][n], err_msg=n)
    assert sorted(a["scalars"]) == sorted(b["scalars"])
    for s in a["scalars"]:
        np.testing.assert_array_equal(np.asarray(a["scalars"][s]).reshape(-1),
                                      np.asarray(b["scalars"][s]).reshape(-1))


@pytest.mark.parametrize("case", [
    _case("adam", 2, 2), _case("sgd", 0, 2),
    _case("sgd", 1, 4, compression="2bit",
          compression_params={"threshold": 0.01})],
    ids=["adam-z2-w2", "sgd-z0-w2", "sgd-z1-w4-2bit"])
def test_a_jax_checkpoint_restores_in_the_port(tmp_path, case):
    jt = _jax(case)
    assert jt.save_checkpoint(str(tmp_path), step=5, block=True)
    with tmx.cpu():
        tt = cs.par_case_trainer(tmx, dict(case, width=1, zero=0))
        assert tt.restore_checkpoint(str(tmp_path)) == 5
    _equal_states(tt.state_dict(), jt.state_dict())


@pytest.mark.parametrize("case", [
    _case("adam", 2), _case("sgd", 0, compression="bf16")],
    ids=["adam-z2", "sgd-z0-bf16"])
def test_a_port_checkpoint_restores_in_the_jax_package(tmp_path, case):
    tt = _port(case)
    assert tt.save_checkpoint(str(tmp_path), step=3, block=True)
    jt = _jtrainer(dict(case, width=2, zero=1))
    assert jt.restore_checkpoint(str(tmp_path)) == 3
    _equal_states(jt.state_dict(), tt.state_dict())


def _files(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dirpath, f), root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def test_both_packages_write_the_same_bytes(tmp_path):
    """One state written by each package's store: the same files, the
    same bytes, manifest and all."""
    jt = _jax(_case("adam", 2, 2))
    state = jt.state_dict()
    with tmx.cpu():
        tt = cs.par_case_trainer(tmx, _case("adam", 2))
        tt.load_state_dict(state)
    JManager(str(tmp_path / "j")).save_state(JState.capture(jt), step=1,
                                             block=True)
    TManager(str(tmp_path / "t"), async_save=False).save_state(
        TState.capture(tt), step=1, block=True)
    assert _files(tmp_path / "j") == _files(tmp_path / "t")


def test_load_state_dict_rejects_mismatches():
    tt = _port(_case("adam", 2))
    sd = tt.state_dict()
    first = next(iter(sd["params"]))
    with pytest.raises(tmx.MXNetError, match="missing param"):
        tt.load_state_dict(dict(sd, params={
            k: v for k, v in sd["params"].items() if k != first}))
    with pytest.raises(tmx.MXNetError, match="shape"):
        tt.load_state_dict(dict(sd, params=dict(
            sd["params"], **{first: np.zeros((3, 3), np.float32)})))
    sgd = _port(_case("sgd", 2))
    with pytest.raises(tmx.MXNetError, match="optimizer slots"):
        sgd.load_state_dict(sd)


def _verdict_cases():
    return {"same-adam-z0": _case("adam", 0),
            "sgd": _case("sgd", 2),
            "bn-net": _case("adam", 1, net="bn"),
            "adam-2bit": _case("adam", 2, compression="2bit")}


@pytest.mark.parametrize("saved", [
    _case("adam", 2, 2), _case("adam", 1, 2, compression="bf16")],
    ids=["adam", "adam-bf16"])
def test_check_restore_compat_verdicts_are_the_jax_packages(saved):
    state = JState.capture(_jax(saved))
    for name, target in _verdict_cases().items():
        want = jcompat(state, _jtrainer(target))
        with tmx.cpu():
            got = tcompat(state, cs.par_case_trainer(tmx, target))
        assert got == want, name
    # the port's own snapshot gives the same verdicts
    tstate = TState.capture(_port(dict(saved, width=1)))
    with tmx.cpu():
        t = cs.par_case_trainer(tmx, _case("sgd", 2))
    assert tcompat(tstate, t) == jcompat(state, _jtrainer(_case("sgd", 2)))


def test_resume_across_width_and_zero_stage(tmp_path):
    """In one world of four ranks: Adam at width 4 zero=2, its state
    loaded at width 2 zero=1 bit for bit, both trajectories on within
    1e-6; the JAX package does the same on its devices; the restore
    verdicts against other trainers are the JAX package's."""
    got = cs.run_ranks("chip_smoke:reshard_rank", 4, (3, 2),
                       workdir=str(tmp_path), threads=1, timeout=300)[0]
    _equal_states(got["back"], got["state"])
    np.testing.assert_allclose(got["losses_b"], got["losses_a"], rtol=0,
                               atol=TOL)
    ja = _jtrainer({"opt": "adam", "opt_params": ADAM,
                                   "zero": 2, "width": 4})
    x, y = cs.par_data()
    for _ in range(3):
        ja.step(jmx.nd.array(x), jmx.nd.array(y))
    want = ja.state_dict()
    big = max(float(np.abs(v).max()) for v in want["params"].values())
    for n, v in want["params"].items():
        assert float(np.abs(got["state"]["params"][n] - v).max()) \
            <= TOL * big
    state = JState.capture(ja)
    for key, case in (
            ("w2-z1-adam", {"opt": "adam", "opt_params": {}, "zero": 1,
                            "width": 2}),
            ("w4-z0-sgd", {"opt": "sgd", "opt_params": {"momentum": 0.9},
                           "zero": 0, "width": 4}),
            ("w2-z2-adam-bn", {"net": "bn", "opt": "adam", "opt_params": {},
                               "zero": 2, "width": 2})):
        assert got["verdicts"][key] == jcompat(
            state, _jtrainer(case)), key


def _jax_oracle(tmp_path, steps=6):
    from mxnet_tpu.fault.drill import _build_trainer, _drill_data_fn
    return jrun_elastic(lambda r: _build_trainer(2), _drill_data_fn(), steps,
                        str(tmp_path / "ck-oracle"),
                        supervisor=JSupervisor(retries=0, backoff=JBackoff(
                            retries=8, base_s=0.001, max_s=0.002,
                            jitter=0.0, sleep=lambda s: None)))


def test_run_elastic_widens_from_two_ranks_to_four(tmp_path):
    """An error at step 3 of a width-2 run; the retry resumes at step 3
    on all four ranks (a note says the mesh reshards), and the loss
    curve stays within atol 1e-5 of the JAX package's uninterrupted
    width-2 oracle (the first three steps within its 1e-6)."""
    oracle = _jax_oracle(tmp_path)
    out = cs.run_ranks("chip_smoke:elastic_width_rank", 4,
                       (str(tmp_path / "ck"), [2, 4], 3, 6),
                       workdir=str(tmp_path), threads=1, timeout=300)
    got = out[0]
    steps, verdict = got["restores"][-1]
    assert steps == 3
    assert any("reshard" in n for n in verdict["notes"])
    np.testing.assert_allclose(got["curve"][:3], oracle[:3], rtol=0,
                               atol=TOL * max(map(abs, oracle)))
    np.testing.assert_allclose(got["curve"], oracle, rtol=0, atol=1e-5)
    # ranks 2 and 3 sat out the width-2 steps and ran the rest
    for r in (2, 3):
        assert out[r]["curve"][:3] == [None] * 3
        np.testing.assert_array_equal(out[r]["curve"][3:],
                                      got["curve"][3:])


def test_run_elastic_incompatible_topology_is_loud(tmp_path):
    """A checkpoint that cannot land on the new trainer (another
    parameter set) refuses through check_restore_compat: never a silent
    re-init."""
    sup = TSupervisor(retries=0, backoff=TBackoff(
        retries=2, base_s=0.001, max_s=0.002, jitter=0.0))
    with tmx.cpu():
        trun_elastic(lambda r: cs.drill_trainer(tmx, 1),
                     cs.drill_data(tmx), 2, str(tmp_path / "ck"),
                     supervisor=sup)

        def other(restart):
            tmx.random.seed(0)
            net = tmx.gluon.nn.HybridSequential(prefix="other_")
            with net.name_scope():
                net.add(tmx.gluon.nn.Dense(4, in_units=16))
            net.initialize(tmx.init.Zero())
            return tmx.parallel.ParallelTrainer(
                net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                {"learning_rate": 0.1})

        with pytest.raises(ElasticError, match="topology"):
            trun_elastic(other, cs.drill_data(tmx), 4, str(tmp_path / "ck"),
                         supervisor=TSupervisor(retries=1, backoff=TBackoff(
                             retries=2, base_s=0.001, max_s=0.002,
                             jitter=0.0)))
