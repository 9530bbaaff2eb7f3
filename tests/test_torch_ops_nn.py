"""The port's neural-network, loss, creation, contrib, misc and optimizer
operators against the JAX package, on the CPU.

Every ``chip_smoke.OP_CASES`` entry whose op lives in ``ops/nn.py``,
``loss.py``, ``misc.py``, ``contrib.py``, ``init_ops.py`` or
``optimizer_ops.py`` (Activation and LeakyReLU in every form, the
Pooling variants, Deconvolution, LRN, InstanceNorm, UpSampling, the
softmax family, the regression and SVM outputs with their own
gradients, MakeLoss, Crop, the FFT pair, count_sketch, fused_bn_relu,
and the eleven update ops, whose states come back through their inputs)
runs through ``mxnet_tpu.nd`` and ``mxnet_tpu_torch.nd`` (``ctx=cpu()``)
on the same numpy inputs, with the case table's bands; gradients within
1e-5 of the largest.
"""
import os
import sys

import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

MODULES = ("nn", "loss", "misc", "contrib", "init_ops", "optimizer_ops")


@pytest.mark.parametrize("i", chip_smoke.case_indices(MODULES),
                         ids=chip_smoke.case_id)
def test_op_matches_the_jax_package(i):
    case = chip_smoke.OP_CASES[i]
    assert [(what, err, lim) for what, err, lim in chip_smoke.case_checks(
        case, tmx, tmx.cpu(), jmx, jmx.cpu()) if not err <= lim] == []


def test_mp_sgd_updates_keep_fp16_weights_with_an_fp32_master():
    import numpy as np
    c = tmx.cpu()
    rng = np.random.RandomState(0)
    w32 = rng.randn(5).astype(np.float32)
    w = tmx.nd.array(w32.astype(np.float16), ctx=c)
    g = tmx.nd.array(rng.randn(5).astype(np.float16), ctx=c)
    mom = tmx.nd.zeros((5,), ctx=c)
    master = tmx.nd.array(w32, ctx=c)
    out = tmx.nd.mp_sgd_mom_update(w, g, mom, master, lr=0.1, momentum=0.9)
    assert out.dtype == "float16" and master.dtype == "float32"
    want_mom = np.float32(0.0) - np.float32(0.1) * g.asnumpy().astype(
        np.float32)
    want = w32 + want_mom
    np.testing.assert_array_equal(mom.asnumpy(), want_mom)
    np.testing.assert_array_equal(master.asnumpy(), want)
    np.testing.assert_array_equal(out.asnumpy(), want.astype(np.float16))
