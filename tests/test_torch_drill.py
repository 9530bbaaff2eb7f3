"""The port's fault drills (``mxnet_tpu_torch/fault/drill.py``) as the
JAX package tests its own (``tests/test_fault.py`` and
``tests/test_serving_multitenant.py``): the multi-process drills and the
soaks are marked slow, as the JAX ones are.  Each runs on the CPU
(``ctx=cpu()``; the drills' rank processes join gloo worlds and their
children are told ``--ctx cpu``).  A world of two ranks of the fused-sweep
parity drill stays in tier 1."""
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.fault import drill


def test_fused_sweep_parity_on_a_world_of_two(tmp_path):
    """Each rank's shard of the flat buckets through the sweep path
    equals the per-array update bitwise (on the CPU both are the plain
    mirrors: nothing launches, so the record's launch count is zero), and
    rank 0's shard after the four steps is the JAX package's
    ``PureSGD``/``PureAdam`` tree_map update of the same numpy buckets,
    within 1e-6."""
    record = drill.fused_sweep_parity_drill(tmpdir=str(tmp_path), world=2,
                                            ctx=tmx.cpu(), timeout=120)
    assert record["mesh"] == "dp2"
    assert record["bitwise_equal_vs_per_array"]
    assert record["launches"] == {}
    shard = np.load(record["shard_arrays"])
    buckets = ("b0", "b1")
    # rank 0 of two keeps the first half of each bucket that every rank
    # draws whole (the parameters, then four gradients, an optimizer)
    rng = np.random.RandomState(5)
    for j in range(len(drill.PARITY_OPTIMIZERS)):
        for name in ["params"] + ["grad%d" % t for t in range(4)]:
            for b, n in zip(buckets, (8 * 2048, 8192)):
                np.testing.assert_array_equal(
                    shard["o%d/%s/%s" % (j, name, b)],
                    rng.randn(n).astype(np.float32)[:n // 2])
    for j, (cls, kw) in enumerate(drill.PARITY_OPTIMIZERS):
        opt = getattr(jmx.parallel.optimizer, cls)(**kw)
        p = {b: jnp.asarray(shard["o%d/params/%s" % (j, b)])
             for b in buckets}
        state = opt.init(p)
        for t in range(4):
            g = {b: jnp.asarray(shard["o%d/grad%d/%s" % (j, t, b)])
                 for b in buckets}
            p, state = opt.apply(p, g, state)
        for b in buckets:
            np.testing.assert_allclose(shard["o%d/out/%s" % (j, b)],
                                       np.asarray(p[b]), rtol=1e-6,
                                       atol=1e-6, err_msg="%s %s" % (cls, b))


@pytest.mark.slow
def test_elastic_multiproc_kill_drill(tmp_path):
    """SIGKILL mid-run + shrink + SIGKILL + grow over gloo worlds: the
    stitched loss curve equals the uninterrupted oracle."""
    report = drill.elastic_kill_drill(steps=10, kill_at=(3, 6),
                                      widths=(4, 2, 8), tmpdir=str(tmp_path),
                                      atol=1e-5, ctx=tmx.cpu())
    assert report["loss_curve_matches_oracle"]
    assert report["legs"][0]["killed"] and report["legs"][1]["killed"]
    assert not report["legs"][2]["killed"]
    assert report["max_loss_dev_vs_oracle"] <= 1e-5


@pytest.mark.slow
def test_fused_sweep_parity_drill(tmp_path):
    record = drill.fused_sweep_parity_drill(tmpdir=str(tmp_path),
                                            ctx=tmx.cpu())
    assert record["mesh"] == "dp8"
    assert record["bitwise_equal_vs_per_array"]


@pytest.mark.slow
def test_chaos_soak_zero_lost_zero_incomplete():
    report = drill.chaos_soak(duration_s=6.0, clients=4, ctx=tmx.cpu())
    assert report["zero_lost_requests"]
    assert report["zero_duplicated_requests"]
    assert report["zero_incomplete_checkpoint_reads"]
    assert report["faults_injected"]["total"] > 0
    assert report["checkpoints"]["versions_hot_swapped"] >= 1


@pytest.mark.slow
def test_multitenant_chaos_soak():
    report = drill.multitenant_soak(duration_s=6.0, ctx=tmx.cpu())
    assert report["canary"]["verdict"]["reason"] == "nonfinite_outputs"
    assert report["canary"]["rollback_wall_s"] < 5.0
    assert report["zero_cross_tenant_evictions"]
    assert report["per_tenant"]["tenantB"]["requests"]["lost"] == 0
    assert report["faults_injected"]["total"] > 0
    assert report["tracing"]["incident_dump"]
    assert report["tracing"]["flight_events"] >= 1


@pytest.mark.slow
def test_fleet_network_soak_bars(tmp_path):
    report = drill.fleet_network_soak(duration_s=6.0, clients=3, replicas=2,
                                      kv_pushes=16, min_faults=80,
                                      tmpdir=str(tmp_path), ctx=tmx.cpu())
    assert report["zero_lost_requests"]
    assert report["zero_duplicated_requests"]
    assert report["zero_incomplete_checkpoint_reads"]
    assert report["gradients_applied_exactly_once"]
    assert report["replay_identical"]
    fi = report["faults_injected"]
    assert fi["total"] >= 80
    assert set(fi["by_kind"]) >= {"partition", "slow_link", "lost_ack",
                                  "reorder", "sigkill"}
    assert report["serving"]["fleet_ledger"]["ejections"] >= 1
