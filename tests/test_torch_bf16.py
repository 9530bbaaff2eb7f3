"""The port's bf16 plain versions of the transformer kernels against the
JAX package, on the CPU.

The same numpy inputs (fixed seeds), cast to bfloat16, go through the JAX
package's Pallas kernels (interpret mode off the TPU, as
tests/test_pallas.py runs them) and through the port's wrappers, which
take their plain versions on CPU tensors.  The CUDA kernels are held to
these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py), so a plain version that rounds where the TPU kernel does
not would hide the same fault in its kernel.

Every tolerance below is stated in bf16 steps: an output rounds once to
bf16 (8 significant bits), so two computations that agree before that
rounding land within one step, ``2**-7`` of the larger magnitude.  Where
an intermediate is rounded to bf16 inside the kernel (p before ``p v``,
p and ds before the backward's products), the two sides may round it to
the two sides of one step, because their ``exp`` differ in the last bit;
each test says what that adds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.parallel import attention as jatt
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.parallel import attention as tatt

torch.set_num_threads(1)

STEP = 2.0 ** -7     # one bf16 step, relative to the magnitude


def _bf16(a):
    """numpy fp32 -> (jax bf16, torch bf16) holding the same values."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(
        np.ascontiguousarray(a)).to(torch.bfloat16)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _within_one_step(got, want, atol):
    mag = np.maximum(np.abs(got), np.abs(want))
    return np.abs(got - want) <= mag * STEP + atol


# ---------------------------------------------------------------------------
# K7a: p is rounded to v's dtype before p v, as the TPU kernel does
# ---------------------------------------------------------------------------
def _attention_weights(q, k, causal):
    """fp32 softmax weights w (BH, Tq, Tk) of the bf16 inputs, with the
    kernels' finite mask."""
    s = np.einsum("bqd,bkd->bqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        keep = np.arange(q.shape[1])[:, None] >= np.arange(k.shape[1])
        s = np.where(keep, s, pk.NEG_INF)
    w = np.exp(s - s.max(-1, keepdims=True))
    return w / w.sum(-1, keepdims=True)


@pytest.mark.parametrize("t", [128, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_k7a_bf16_plain_matches_jax_flash_attention(causal, t):
    """o within one bf16 step of its magnitude plus one step of the
    largest single term ``w_j |v_j|`` of its row, plus 1e-6.  Both sides
    round ``p_j = exp(s_j - m)`` to bf16 before ``p v`` (the JAX kernel in
    one block of keys at these T, so with the same m); XLA's and torch's
    exp can differ in the last bit and put one p_j on the other side of a
    bf16 step, which moves o by one step of that term.  A plain version
    that keeps p in fp32 misses this by the rounding of every p_j, and
    fails here."""
    rng = np.random.RandomState(90 + t)
    q, k, v = (rng.randn(4, t, 64).astype(np.float32) for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
    want = _f32(pk.flash_attention(jq, jk, jv, causal))
    o, lse = ck.flash_attention_fwd(tq, tk, tv, causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    w = _attention_weights(_f32(tq), _f32(tk), causal)
    term = (w[..., None] * np.abs(_f32(tv))[:, None]).max(axis=2)
    got = _f32(o)
    mag = np.maximum(np.abs(got), np.abs(want))
    assert (np.abs(got - want) <= (mag + term) * STEP + 1e-6).all()


# ---------------------------------------------------------------------------
# K7b, K7c: through local_attention(impl="flash") and torch's autograd
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t", [128, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_k7b_k7c_bf16_plain_match_jax_flash_attention_vjp(causal, t):
    """dq, dk and dv within one bf16 step of each element's magnitude plus
    one step of the largest magnitude: p and ds are rounded to bf16
    before the products on both sides (``pallas_kernels.py`` :226, :261,
    :267), and where the two round one of them to the two sides of a
    step the error is a step of that term, which is bounded by the
    largest gradient rather than by the element's own (often cancelled)
    magnitude."""
    rng = np.random.RandomState(95 + t)
    q = rng.randn(1, t, 4, 64).astype(np.float32)
    k, v, do = (rng.randn(1, t, 4, 64).astype(np.float32) for _ in range(3))
    jins, tins = zip(*map(_bf16, (q, k, v)))
    jdo, tdo = _bf16(do)
    _, vjp = jax.vjp(lambda *a: jatt.local_attention(*a, causal=causal,
                                                     impl="flash"), *jins)
    want = vjp(jdo)
    tins = [a.requires_grad_() for a in tins]
    o = tatt.local_attention(*tins, causal=causal, impl="flash")
    got = torch.autograd.grad(o, tins, tdo)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g, w = _f32(g), _f32(w)
        assert _within_one_step(g, w, np.abs(w).max() * STEP).all()


# ---------------------------------------------------------------------------
# K2, K5a, K6a: fp32 inside, one rounding of the output
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c", [20, 1000])
def test_k2_bf16_plain_matches_jax_softmax(c):
    """Within one bf16 step plus 1e-6: max, exp and sum run in fp32 on
    both sides and the output rounds once."""
    rng = np.random.RandomState(100 + c)
    jx, tx = _bf16((rng.randn(6, 12, c) * 3).astype(np.float32))
    want = _f32(pk.fused_bias_softmax(jx))
    got = ck.softmax_lastaxis(tx)
    assert got.dtype == torch.bfloat16
    assert _within_one_step(_f32(got), want, 1e-6).all()


@pytest.mark.parametrize("masked", [True, False])
def test_k5a_bf16_plain_matches_jax_fused_bias_softmax(masked):
    """Within one bf16 step plus 1e-6, as K2 (the fp32 bias is added in
    fp32 on both sides); a masked column is exactly 0."""
    rng = np.random.RandomState(102)
    jx, tx = _bf16((rng.randn(6, 12, 20) * 3).astype(np.float32))
    keep = np.tril(np.ones((12, 20), bool))
    bias = (np.where(keep, 0.0, pk.NEG_INF) if masked
            else rng.randn(12, 20) * 0.5).astype(np.float32)
    want = _f32(pk.fused_bias_softmax(jx, jnp.asarray(bias)))
    got = ck.bias_softmax(tx, torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    assert _within_one_step(_f32(got), want, 1e-6).all()
    if masked:
        assert (_f32(got)[:, ~keep] == 0).all()


@pytest.mark.parametrize("c", [37, 768])
def test_k6a_bf16_plain_matches_jax_fused_layernorm(c):
    """o within one bf16 step plus 1e-6 (the row statistics in fp32 on
    both sides, one rounding of the output); mu and rstd, kept in fp32,
    within 1e-5."""
    rng = np.random.RandomState(104)
    jx, tx = _bf16((rng.randn(3, 7, c) * 2 + 0.5).astype(np.float32))
    g = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    jo, (_, _, jmu, jrs) = pk._layernorm_fwd(jx, jnp.asarray(g),
                                             jnp.asarray(b), 1e-5)
    o, mu, rstd = ck.layernorm_fwd(tx, torch.from_numpy(g),
                                   torch.from_numpy(b), 1e-5)
    assert o.dtype == torch.bfloat16
    assert _within_one_step(_f32(o), _f32(jo), 1e-6).all()
    np.testing.assert_allclose(mu.numpy().ravel(), np.asarray(jmu)[:, 0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rstd.numpy().ravel(), np.asarray(jrs)[:, 0],
                               rtol=1e-5)
