"""The port's element-wise operators against the JAX package, on the CPU.

Every ``chip_smoke.OP_CASES`` entry whose op lives in ``ops/elemwise.py``
(the unary maths, rounding, comparisons and logic, the binary ops with
their scalar and broadcast forms, Cast, clip, add_n, BlockGrad...) runs
through ``mxnet_tpu.nd`` and ``mxnet_tpu_torch.nd`` (``ctx=cpu()``) on the
same numpy inputs.  Bands, the case table's: "exact" bitwise (NaN equal
to NaN), "f32" within 1e-6 of the largest |reference|, special functions
within 2e-6 of it (``chip_smoke.OP_BAND_REASONS``); gradients within
1e-5 of the largest.  Phase 14 of ``chip_smoke.py`` runs the same table
on the card against the port's CPU results.
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

MODULES = ("elemwise",)


@pytest.mark.parametrize("i", chip_smoke.case_indices(MODULES),
                         ids=chip_smoke.case_id)
def test_op_matches_the_jax_package(i):
    case = chip_smoke.OP_CASES[i]
    assert [(what, err, lim) for what, err, lim in chip_smoke.case_checks(
        case, tmx, tmx.cpu(), jmx, jmx.cpu()) if not err <= lim] == []


def test_mod_takes_the_sign_of_the_divisor_and_round_goes_to_even():
    x = tmx.nd.array([-5.5, 5.5, -0.5, 2.5], ctx=tmx.cpu())
    assert (x % 2).asnumpy().tolist() == [0.5, 1.5, 1.5, 0.5]
    assert (x % -2).asnumpy().tolist() == [-1.5, -0.5, -0.5, -1.5]
    assert tmx.nd.round(x).asnumpy().tolist() == [-6.0, 6.0, -0.0, 2.0]
    assert (x > 0).dtype == "float32"
    assert (tmx.nd.array([1, 2], ctx=tmx.cpu(), dtype="int32") == 1).dtype \
        == "int32"
