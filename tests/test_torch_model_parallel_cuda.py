"""Model-axis sharding's kernels on the card: Ulysses's local step, which
runs ``local_attention`` over the whole sequence with H/sp heads, goes
through K7a, K7b and K7c and agrees with the plain route.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``mxnet_tpu_torch/ops/csrc`` at first use); elsewhere they skip.  They
import neither ``jax`` nor the JAX package::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_model_parallel_cuda.py -q
"""
import pytest
import torch

import chip_smoke
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu

# fp32, the same sums in another order, of the largest value
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _attention(q, k, v, w, impl, causal):
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    o = mx.parallel.local_attention(*leaves, causal=causal, impl=impl)
    (o * w).sum().backward()
    return [o] + [a.grad for a in leaves]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [2, 4])
def test_ulysses_local_step_runs_k7_against_the_plain_route(cuda, sp,
                                                            causal):
    b, t, h, d = 2, 256, 12 // sp, 64
    q, k, v, w = chip_smoke._seeded(cuda, [(b, t, h, d)] * 4)
    ck.reset_kernel_calls()
    flash = _attention(q, k, v, w, "auto", causal)
    calls = ck.kernel_calls()
    assert calls["flash_attention_fwd"] == 1
    assert calls["flash_attention_bwd_dq"] == 1
    assert calls["flash_attention_bwd_dkv"] == 1
    plain = _attention(q, k, v, w, "einsum", causal)
    for got, want in zip(flash, plain):
        assert chip_smoke._rel(got, want) <= TOL


def test_one_rank_meshes_run_each_entry_point_on_the_card(cuda):
    """At a mesh of one the sequence-parallel forms are
    ``local_attention`` and the kernels launch."""
    with mx.gpu(0):
        mesh = mx.parallel.make_mesh(sp=1)
    q, k, v, w = chip_smoke._seeded(cuda, [(2, 128, 4, 64)] * 4)
    want = mx.parallel.local_attention(q, k, v, causal=True)
    ck.reset_kernel_calls()
    for fn in (mx.parallel.ring_attention, mx.parallel.ulysses_attention):
        got = fn(q, k, v, mesh=mesh, causal=True)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ck.kernel_calls()["flash_attention_fwd"] == 2
