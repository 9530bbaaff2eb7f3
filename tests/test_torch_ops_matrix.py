"""The port's shape, indexing, ordering, reduction and linalg operators
against the JAX package, on the CPU.

Every ``chip_smoke.OP_CASES`` entry whose op lives in ``ops/matrix.py`` or
``ops/reduce.py`` runs through ``mxnet_tpu.nd`` and ``mxnet_tpu_torch.nd``
(``ctx=cpu()``) on the same numpy inputs, with the case table's bands:
data movement, indexing and ordering bitwise (``topk``, ``sort`` and
``argsort`` on inputs with ties, so the tie order is held); arithmetic and
reductions within 1e-6 of the largest |reference|; the ``linalg_*`` ops
within 5e-6 of it (``chip_smoke.OP_BAND_REASONS``), ``gelqf`` and
``syevd`` after fixing the signs their factors are unique up to;
gradients within 1e-5 of the largest.
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

MODULES = ("matrix", "reduce")


@pytest.mark.parametrize("i", chip_smoke.case_indices(MODULES),
                         ids=chip_smoke.case_id)
def test_op_matches_the_jax_package(i):
    case = chip_smoke.OP_CASES[i]
    assert [(what, err, lim) for what, err, lim in chip_smoke.case_checks(
        case, tmx, tmx.cpu(), jmx, jmx.cpu()) if not err <= lim] == []


def test_where_broadcasts_a_1d_condition_along_the_last_axis():
    """As in the JAX package (numpy broadcasting): a 1-D condition lines
    up with the last axis; one of another length is refused."""
    import numpy as np
    c = tmx.cpu()
    cond = tmx.nd.array([1, 0, 1], ctx=c)
    out = tmx.nd.where(cond, tmx.nd.ones((3, 3), ctx=c),
                       tmx.nd.zeros((3, 3), ctx=c)).asnumpy()
    assert out.tolist() == [[1, 0, 1]] * 3
    with pytest.raises(Exception):
        tmx.nd.where(cond, tmx.nd.ones((3, 4), ctx=c),
                     tmx.nd.zeros((3, 4), ctx=c))
    t = tmx.nd.array(np.array([1, 2, 2, 3, 3, 1], np.float32), ctx=c)
    assert t.topk(k=3).asnumpy().tolist() == [3.0, 4.0, 1.0]
    assert t.argsort(is_ascend=False).asnumpy().tolist() == [
        4.0, 3.0, 2.0, 1.0, 5.0, 0.0]
