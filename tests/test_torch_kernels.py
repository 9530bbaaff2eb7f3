"""The port's kernel modules against the JAX package's Pallas kernels.

The same numpy inputs (fixed seeds) go through the JAX kernel, run in
interpret mode on the CPU as tests/test_pallas.py runs it, and through
the port's wrapper on CPU tensors, which routes to the kernel's plain
version.  The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import cuda_kernels as ck
from mxnet_tpu_torch.ops import nn as tnn

torch.set_num_threads(1)

BF16 = np.dtype(ml_dtypes.bfloat16)


def _bf16_ulp_close(a, b):
    """|a - b| <= one bf16 ulp of the larger magnitude (8 mantissa bits
    -> spacing 2**(e - 7))."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    mag = np.maximum(np.abs(a), np.abs(b))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30)))
                                    - 7), 0.0)
    return bool(np.all(np.abs(a - b) <= ulp))


def _assert_k3_close(got, ref, x, s, b):
    """fp32 within 1e-6 relative to the size of the operands, |x*s| +
    |b|.  XLA's CPU backend may contract x*s + b into one FMA (a single
    rounding); the port rounds the product and the sum separately, as
    its CUDA kernel does to stay bitwise equal to the plain version.
    The two differ by at most half an ulp of x*s, which is 6e-8 of the
    operands' size but unbounded relative to a result that cancels to
    near zero."""
    bound = 1e-6 * (np.abs(x * s) + np.abs(b))
    assert np.all(np.abs(got - ref) <= bound), \
        float(np.max(np.abs(got - ref) - bound))


def _to_torch(a, dtype):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _to_jax(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32).astype(
        BF16 if dtype == "bfloat16" else np.float32))


# ---------------------------------------------------------------------------
# K3: scale + bias + relu
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 3), (1030, 64)])
def test_k3_plain_matches_jax_fused_scale_bias_relu(shape, dtype, relu):
    rng = np.random.RandomState(10)
    x = rng.randn(*shape).astype(np.float32) * 3
    s = (rng.rand(shape[1]) + 0.5).astype(np.float32)
    b = rng.randn(shape[1]).astype(np.float32)
    ref = np.asarray(pk.fused_scale_bias_relu(
        _to_jax(x, dtype), jnp.asarray(s), jnp.asarray(b),
        relu=relu)).astype(np.float32)
    got = ck.scale_bias_relu(_to_torch(x, dtype), torch.from_numpy(s),
                             torch.from_numpy(b), relu=relu)
    assert got.dtype == _to_torch(x, dtype).dtype
    got = got.float().numpy()
    if dtype == "float32":
        _assert_k3_close(got, ref, x, s[None], b[None])
    else:
        assert _bf16_ulp_close(got, ref)
    if relu:
        assert got.min() >= 0


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("fix_gamma", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_fused_bn_relu_eval_nchw_matches_jax(dtype, fix_gamma, relu):
    """NCHW (2, 8, 5, 7): the port reads NCHW in place, the JAX path
    transposes to (N*H*W, C) and back."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 8, 5, 7).astype(np.float32)
    gamma = (rng.rand(8) + 0.5).astype(np.float32)
    beta = rng.randn(8).astype(np.float32)
    mean = (rng.randn(8) * 0.1).astype(np.float32)
    var = (rng.rand(8) + 0.5).astype(np.float32)
    ref = np.asarray(jnn.fused_bn_relu_eval(
        _to_jax(x, dtype), *(jnp.asarray(v) for v in (gamma, beta, mean,
                                                       var)),
        eps=2e-5, fix_gamma=fix_gamma, relu=relu)).astype(np.float32)
    got = tnn.fused_bn_relu_eval(
        _to_torch(x, dtype), *(torch.from_numpy(v) for v in (gamma, beta,
                                                            mean, var)),
        eps=2e-5, fix_gamma=fix_gamma, relu=relu).float().numpy()
    if dtype == "float32":
        g = np.ones_like(gamma) if fix_gamma else gamma
        s = (g / np.sqrt(var + 2e-5))[None, :, None, None]
        b = beta[None, :, None, None] - mean[None, :, None, None] * s
        _assert_k3_close(got, ref, x, s, b)
    else:
        assert _bf16_ulp_close(got, ref)


def test_k3_plain_propagates_nan():
    """The JAX server's non-finite sentinel relies on relu passing NaN."""
    x = torch.tensor([[float("nan"), -1.0, 2.0]])
    y = ck.scale_bias_relu(x, torch.ones(3), torch.zeros(3), relu=True)
    assert torch.isnan(y[0, 0]) and y[0, 1] == 0 and y[0, 2] == 2


def test_k3_wrapper_rejects_bad_scale():
    x = torch.zeros(2, 4, 3, 3)
    with pytest.raises(MXNetError, match="scale"):
        ck.scale_bias_relu(x, torch.ones(3), torch.zeros(4))
    with pytest.raises(MXNetError, match="bias"):
        ck.scale_bias_relu(x, torch.ones(4),
                           torch.zeros(4, dtype=torch.float64))


# ---------------------------------------------------------------------------
# K2: last-axis softmax
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,scale", [((4, 1000), 1.0), ((3, 7), 1.0),
                                         ((4, 1000), 1e4), ((7, 1), 1.0),
                                         ((3, 1025), 1.0), ((4, 10000), 3.0),
                                         ((4, 10000), 1e4),
                                         ((3, 10001), 1.0),
                                         ((1, 65537), 1.0)])
def test_k2_plain_matches_jax_fused_bias_softmax(shape, scale):
    rng = np.random.RandomState(12)
    x = (rng.randn(*shape) * scale).astype(np.float32)
    ref = np.asarray(pk.fused_bias_softmax(jnp.asarray(x)))
    got = ck.softmax_lastaxis(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-5)


def test_k2_plain_bf16_keeps_dtype_and_matches_fp32():
    rng = np.random.RandomState(13)
    x = rng.randn(5, 33).astype(np.float32)
    got = ck.softmax_lastaxis(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    ref = ck.softmax_lastaxis_ref(torch.from_numpy(x).to(torch.bfloat16)
                                  .float())
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=1e-2)


# ---------------------------------------------------------------------------
# K5a and K5b at the rows whose meaning the kernels keep (C 128 and 1: no
# padding of the TPU kernel's 128 lanes changes them)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["masked row", "nan row", "one column"])
def test_k5a_k5b_plain_match_jax_at_masked_and_nan_rows(case):
    """A row the bias masks entirely comes out uniform, a NaN makes its
    row NaN (p and dx), one column gives exactly 1: the plain versions
    against ``fused_bias_softmax`` and its ``jax.vjp``, within 1e-6."""
    rng = np.random.RandomState(15)
    c = 1 if case == "one column" else 128
    x = (rng.randn(2, 4, c) * 3).astype(np.float32)
    do = rng.randn(2, 4, c).astype(np.float32)
    bias = np.where(np.tril(np.ones((4, c), bool)), 0.0,
                    pk.NEG_INF).astype(np.float32)
    if case == "masked row":
        bias[1] = pk.NEG_INF
    if case == "nan row":
        x[:, 1, 5] = np.nan
    want_p, vjp = jax.vjp(pk.fused_bias_softmax, jnp.asarray(x),
                          jnp.asarray(bias))
    want_dx = vjp(jnp.asarray(do))[0]
    p = ck.bias_softmax(torch.from_numpy(x), torch.from_numpy(bias))
    dx = ck.softmax_bwd(p, torch.from_numpy(do))
    np.testing.assert_allclose(p.numpy(), np.asarray(want_p), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=1e-6,
                               atol=1e-6)
    if case == "masked row":
        assert (p[:, 1] == p[:, 1, :1]).all()
    if case == "nan row":
        assert torch.isnan(p[:, 1]).all() and torch.isnan(dx[:, 1]).all()
        assert not torch.isnan(p[:, 0]).any()
    if case == "one column":
        assert (p == 1).all()


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain version, knobs, launch counts
# ---------------------------------------------------------------------------
def test_cpu_tensor_routes_to_plain_version_and_counts_nothing():
    ck.reset_kernel_calls()
    rng = np.random.RandomState(14)
    x = torch.from_numpy(rng.randn(2, 3, 4, 4).astype(np.float32))
    s = torch.from_numpy((rng.rand(3) + 0.5).astype(np.float32))
    b = torch.from_numpy(rng.randn(3).astype(np.float32))
    assert torch.equal(ck.scale_bias_relu(x, s, b),
                       ck.scale_bias_relu_ref(x, s, b))
    assert torch.equal(ck.softmax_lastaxis(x), ck.softmax_lastaxis_ref(x))
    for name in ("sgd_sweep", "sgd_mom_sweep", "adam_sweep"):
        w, g = torch.ones(5), torch.ones(5)
        slots = [torch.zeros(5)] * {"sgd_sweep": 0, "sgd_mom_sweep": 1,
                                    "adam_sweep": 2}[name]
        hyper = torch.full((ck.sweep_hyper_len(name, False),), 0.5)
        getattr(ck, name)(w, g, *slots, hyper)
        assert not torch.equal(w, torch.ones(5))
    g, bt = torch.ones(4), torch.zeros(4)
    assert all(torch.equal(a, b) for a, b in zip(
        ck.layernorm_fwd(x, g, bt), ck.layernorm_fwd_ref(x, g, bt, 1e-5)))
    q = x.reshape(6, 4, 4)
    assert all(torch.equal(a, b) for a, b in zip(
        ck.flash_attention_fwd(q, q, q, True),
        ck.flash_attention_fwd_ref(q, q, q, True)))
    bias = torch.zeros(4, 4)
    assert torch.equal(ck.bias_softmax(x, bias), ck.bias_softmax_ref(x, bias))
    _, mu, rstd = ck.layernorm_fwd(x, g, bt)
    assert torch.equal(ck.layernorm_bwd(x, x, g, mu, rstd),
                       ck.layernorm_bwd_ref(x, x, g, mu, rstd))
    o, lse = ck.flash_attention_fwd(q, q, q, True)
    delta = (o * q).sum(-1)
    assert torch.equal(ck.flash_attention_bwd_dq(q, q, q, q, lse, delta),
                       ck.flash_attention_bwd_dq_ref(q, q, q, q, lse, delta))
    assert all(torch.equal(a, b) for a, b in zip(
        ck.flash_attention_bwd_dkv(q, q, q, q, lse, delta, True),
        ck.flash_attention_bwd_dkv_ref(q, q, q, q, lse, delta, True)))
    p = ck.softmax_lastaxis(x)
    assert torch.equal(ck.softmax_bwd(p, x), ck.softmax_bwd_ref(p, x))
    assert ck.kernel_calls() == {"scale_bias_relu": 0, "softmax_lastaxis": 0,
                                 "sgd_sweep": 0, "sgd_mom_sweep": 0,
                                 "adam_sweep": 0, "layernorm_fwd": 0,
                                 "layernorm_bwd": 0, "flash_attention_fwd": 0,
                                 "flash_attention_bwd_dq": 0,
                                 "flash_attention_bwd_dkv": 0,
                                 "bias_softmax": 0, "softmax_bwd": 0}


@pytest.mark.parametrize("value,device,expected", [
    (None, "cpu", False), (None, "cuda", True), ("auto", "cuda", True),
    ("1", "cpu", True), ("0", "cuda", False), ("0", "cpu", False)])
def test_family_knob_resolution(monkeypatch, value, device, expected):
    if value is None:
        monkeypatch.delenv("MXNET_PALLAS_SOFTMAX", raising=False)
    else:
        monkeypatch.setenv("MXNET_PALLAS_SOFTMAX", value)
    assert ck.family_enabled("MXNET_PALLAS_SOFTMAX", device) is expected


def test_kernel_build_is_lazy_and_keyed_by_source_hash():
    """Importing the port builds nothing; each source has its own
    library path and a hash over its text and the nvcc flags."""
    assert set(_build.SOURCES) == {"scale_bias_relu", "softmax",
                                   "optimizer_sweep", "layernorm",
                                   "flash_attention"}
    for name in _build.SOURCES:
        src, so, digest = _build._paths(name)
        assert os.path.exists(src) and src.endswith(".cu")
        assert so.endswith("libmxtt_%s.so" % name)
        assert len(digest) == 64
    assert "arch=compute_90a,code=sm_90a" in _build.FLAGS
    assert not _build._LIBS and not ck._FNS


def test_kernel_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    with pytest.raises(MXNetError, match="nvcc"):
        _build.nvcc_path()


def test_cuda_sources_carry_their_design_note():
    for name, tpu_kernel in (("scale_bias_relu", "_scale_bias_relu_kernel"),
                             ("softmax", "_softmax_fwd_kernel"),
                             ("optimizer_sweep", "_sgd_kernel"),
                             ("optimizer_sweep", "_sgd_mom_kernel"),
                             ("optimizer_sweep", "_adam_kernel"),
                             ("layernorm", "_layernorm_fwd_kernel"),
                             ("flash_attention", "_flash_fwd_kernel"),
                             ("softmax", "_softmax_bias_fwd_kernel"),
                             ("layernorm", "_layernorm_bwd_kernel"),
                             ("flash_attention", "_flash_bwd_dq_kernel"),
                             ("flash_attention", "_flash_bwd_dkv_kernel"),
                             ("softmax", "_softmax_bwd_kernel")):
        with open(_build._paths(name)[0]) as f:
            text = f.read()
        header = text.split("#include")[0]
        assert "Replaces: mxnet_tpu/ops/pallas_kernels.py " in header
        assert " %s (:" % tpu_kernel in header or \
            "pallas_kernels.py %s" % tpu_kernel in header
        assert "Bound on Hopper" in text
        assert 'extern "C" int mxtt_' in text


def test_tf32_is_off_for_the_fp32_reference_forward():
    assert tmx is not None
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


# ---------------------------------------------------------------------------
# K1a / K1b / K4: the optimizer sweeps
# ---------------------------------------------------------------------------
_LR, _MU, _WD, _RESCALE = 0.1, 0.9, 1e-4, 1.0 / 32
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _sweep_inputs(n, seed=15):
    rng = np.random.RandomState(seed)
    w = rng.randn(n).astype(np.float32)
    g = (rng.randn(n) * 40).astype(np.float32)
    m = (rng.randn(n) * 0.1).astype(np.float32)
    v = (rng.rand(n) * 0.01).astype(np.float32)
    return w, g, m, v


def _hyper(name, clip):
    """The executor's hyperparameter vector for ``name`` (``1 - beta`` in
    double, as Executor._sweep_hyper), and the clip the sweep sees: a
    negative clip is off."""
    on = clip is not None and clip >= 0
    h = {"sgd_sweep": [_LR, _WD, _RESCALE],
         "sgd_mom_sweep": [_LR, _MU, _WD, _RESCALE],
         "adam_sweep": [_LR, _B1, _B2, 1.0 - _B1, 1.0 - _B2, _EPS, _WD,
                        _RESCALE]}[name] + ([clip] if on else [])
    return torch.tensor(h, dtype=torch.float32), on


def _run_sweep(name, n, clip):
    w, g, m, v = _sweep_inputs(n)
    hyper, on = _hyper(name, clip)
    tw, tm, tv = (torch.from_numpy(a.copy()) for a in (w, m, v))
    slots = {"sgd_sweep": (), "sgd_mom_sweep": (tm,),
             "adam_sweep": (tm, tv)}[name]
    getattr(ck, name)(tw, torch.from_numpy(g), *slots, hyper, use_clip=on)
    return (w, g, m, v), [tw.numpy()] + [s.numpy() for s in slots]


def _assert_ulp_close(got, ref, mag, ulps=2):
    """|got - ref| <= ``ulps`` fp32 ulps of the operands' magnitude
    ``mag``: XLA's CPU backend may contract a product and a sum into one
    FMA (one rounding), where the port rounds each, as its CUDA kernel
    does to stay bitwise equal to the plain version."""
    bound = ulps * np.float32(2.0 ** -23) * mag
    assert np.all(np.abs(got - ref) <= bound), \
        float(np.max(np.abs(got - ref) - bound))


@pytest.mark.parametrize("clip", [None, 0.5, -1.0])
@pytest.mark.parametrize("n", [1000, 131073])
@pytest.mark.parametrize("name", ["sgd_sweep", "sgd_mom_sweep"])
def test_sgd_sweep_plain_matches_jax_fused_sgd_momentum(name, n, clip):
    (w, g, m, _), got = _run_sweep(name, n, clip)
    mom = jnp.asarray(m) if name == "sgd_mom_sweep" else None
    jw, jm = pk.fused_sgd_momentum(
        jnp.asarray(w), jnp.asarray(g), mom, lr=_LR,
        momentum=_MU if mom is not None else 0.0, wd=_WD, rescale=_RESCALE,
        clip=clip if clip is not None and clip >= 0 else None)
    gp = np.abs(g * _RESCALE)
    if clip is not None and clip >= 0:
        gp = np.minimum(gp, clip)
    step = _LR * (gp + _WD * np.abs(w))
    if mom is None:
        _assert_ulp_close(got[0], np.asarray(jw), np.abs(w) + step)
    else:
        mmag = _MU * np.abs(m) + step
        _assert_ulp_close(got[1], np.asarray(jm), mmag)
        _assert_ulp_close(got[0], np.asarray(jw), np.abs(w) + mmag)


@pytest.mark.parametrize("clip", [None, 0.5, -1.0])
@pytest.mark.parametrize("n", [1000, 131073])
def test_adam_sweep_plain_matches_jax_fused_adam(n, clip):
    (w, g, m, v), got = _run_sweep("adam_sweep", n, clip)
    jw, jm, jv = pk.fused_adam(
        jnp.asarray(w), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
        lr_eff=_LR, beta1=_B1, beta2=_B2, epsilon=_EPS, wd=_WD,
        rescale=_RESCALE, clip=clip if clip is not None and clip >= 0
        else None)
    gp = g * _RESCALE
    if clip is not None and clip >= 0:
        gp = np.clip(gp, -clip, clip)
    gp = np.abs(gp) + _WD * np.abs(w)
    mmag = _B1 * np.abs(m) + (1 - _B1) * gp
    vmag = _B2 * v + (1 - _B2) * gp * gp
    _assert_ulp_close(got[1], np.asarray(jm), mmag)
    _assert_ulp_close(got[2], np.asarray(jv), vmag)
    # the step lr * m' / (sqrt(v') + eps) carries the moments' own
    # difference (each may be one rounding apart): to first order
    # |step| * (|dm'| / |m'| + |dv'| / (2 v')) on top of 2 ulps of
    # |w| + |step|
    jm_, jv_ = np.asarray(jm), np.asarray(jv)
    step = _LR * np.abs(jm_) / (np.sqrt(jv_) + _EPS)
    carried = step * (np.abs(got[1] - jm_) / np.maximum(np.abs(jm_), 1e-30)
                      + np.abs(got[2] - jv_) / np.maximum(2 * jv_, 1e-30))
    bound = 2 * np.float32(2.0 ** -23) * (np.abs(w) + step) + carried
    assert np.all(np.abs(got[0] - np.asarray(jw)) <= bound)


@pytest.mark.parametrize("clip", [None, 0.5, -1.0])
@pytest.mark.parametrize("name", ["sgd_sweep", "sgd_mom_sweep",
                                  "adam_sweep"])
def test_sweep_plain_bitwise_equals_optimizer_ops(name, clip):
    """The sweep's plain version (0-dim fp32 hyperparameters) against the
    port's per-array update (Python floats): the same expressions, so
    the same bits."""
    from mxnet_tpu_torch.ops import optimizer_ops as oo
    (w, g, m, v), got = _run_sweep(name, 4099, clip)
    tw, tg, tm, tv = (torch.from_numpy(a) for a in (w, g, m, v))
    kw = dict(wd=_WD, rescale_grad=_RESCALE,
              clip_gradient=-1.0 if clip is None else clip)
    if name == "sgd_sweep":
        ref = [oo.sgd_update(tw, tg, lr=_LR, **kw)]
    elif name == "sgd_mom_sweep":
        ref = list(oo.sgd_mom_update(tw, tg, tm, lr=_LR, momentum=_MU, **kw))
    else:
        ref = list(oo.adam_update(tw, tg, tm, tv, lr=_LR, beta1=_B1,
                                  beta2=_B2, epsilon=_EPS, **kw))
    for a, b in zip(got, ref):
        assert np.array_equal(a.view(np.int32), b.numpy().view(np.int32))


def test_sweep_clip_lets_nan_through():
    w = torch.zeros(4)
    g = torch.tensor([float("nan"), 100.0, -100.0, 0.5])
    hyper = torch.tensor([1.0, 0.0, 1.0, 1.0])   # lr, wd, rescale, clip
    ck.sgd_sweep(w, g, hyper, use_clip=True)
    assert torch.isnan(w[0]) and w[1:].tolist() == [-1.0, 1.0, -0.5]


def test_sweep_wrapper_rejects_bad_operands():
    w = torch.zeros(6)
    with pytest.raises(MXNetError, match="hyper"):
        ck.sgd_mom_sweep(w, w.clone(), w.clone(), torch.zeros(5))
    with pytest.raises(MXNetError, match="float32"):
        ck.adam_sweep(w, w.clone(), w.clone(), w[:5].clone(), torch.zeros(8))
    with pytest.raises(MXNetError, match="slots"):
        ck._sweep("sgd_mom_sweep", w, w.clone(), (), torch.zeros(4), False)


# ---------------------------------------------------------------------------
# chip_smoke.py's bounds for K7b and K7c (computed from shapes, no card)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_out,n_prod,tensor_ms,cuda_core_ms",
                         [(1, 3, 0.11737, 0.28875), (2, 4, 0.15649, 0.38500)])
def test_chip_smoke_flash_backward_bounds(n_out, n_prod, tensor_ms,
                                          cuda_core_ms):
    """At the training step's (96, 1024, 64) causal shape: ``n_prod``
    products of 2 D operations over the 524,800 visible pairs of each
    slice, over the H100's dense TF32 rate three times (3xTF32) and over
    its fp32 CUDA-core rate; both bound by operations, not bytes."""
    import chip_smoke
    bw, fp32, tf32, _ = chip_smoke.card_rates("NVIDIA H100 80GB HBM3")
    assert (bw, fp32, tf32) == (3.35e12, 67e12, 494.5e12)
    ops, (cms, cby), (tms, tby) = chip_smoke.flash_bwd_bound(
        96, 1024, 1024, 64, True, n_out, n_prod, bw, fp32, tf32)
    assert ops == 2 * 64 * n_prod * 96 * 524800
    assert cby == tby == "operations"
    assert abs(tms - tensor_ms) < 1e-5 and abs(cms - cuda_core_ms) < 1e-5


@pytest.mark.parametrize("kernel,bound_ms,by", [
    ("K7a", 0.015142, "bytes"), ("K7b", 0.019552, "operations"),
    ("K7c", 0.026069, "operations")])
def test_chip_smoke_flash_bf16_bounds(kernel, bound_ms, by):
    """The bf16 instances at the training step's (96, 1024, 64) causal
    shape are bound at the H100's dense bf16 tensor-core rate (989.5
    TFLOP/s), whatever units the kernels compute on: K7a's 4 D operations
    a visible pair fall below its 50.7 MB of 2-byte q, k, v, o (and fp32
    lse) at 3.35 TB/s; K7b's 3 and K7c's 4 products of 2 D a pair stay
    above their bytes."""
    import chip_smoke
    bw, _, _, bf16 = chip_smoke.card_rates("NVIDIA H100 80GB HBM3")
    assert bf16 == 989.5e12
    if kernel == "K7a":
        got = chip_smoke.flash_bound(96, 1024, 1024, 64, True, 2, bw, bf16)
    else:
        n_out, n_prod = (1, 3) if kernel == "K7b" else (2, 4)
        got = chip_smoke.bound_ms(
            chip_smoke.flash_bwd_bytes(96, 1024, 1024, 64, n_out, 2),
            2 * 64 * n_prod * 96 * 524800, bw, bf16)
    assert got[1] == by and abs(got[0] - bound_ms) < 1e-6, got


@pytest.mark.parametrize("causal", [True, False])
def test_chip_smoke_attention_terms(causal):
    """The per-element bf16 bound of K7a's check: the terms ``w_j |v_j|``
    of each output, their largest at most their sum, and the sum equal
    to the weights times ``|v|``."""
    import chip_smoke
    rng = np.random.RandomState(110)
    q, k, v = (torch.from_numpy(rng.randn(2, 9, 8).astype(np.float32))
               for _ in range(3))
    top = chip_smoke.attention_terms(q, k, v, causal, largest=True)
    total = chip_smoke.attention_terms(q, k, v, causal, largest=False)
    s = torch.matmul(q, k.transpose(1, 2)) / 8 ** 0.5
    if causal:
        s = s.masked_fill(~torch.ones(9, 9, dtype=torch.bool).tril(),
                          ck.NEG_INF)
    w = torch.softmax(s, -1)
    assert top.shape == total.shape == q.shape
    assert torch.allclose(total, w @ v.abs(), atol=1e-6)
    assert bool((top <= total + 1e-7).all())
    if causal:   # the first query sees only the first key
        assert torch.allclose(top[:, 0], v[:, 0].abs(), atol=1e-6)


# the kernels of softmax.cu as torch.profiler names them, and the kind each
# must land in
_SOFTMAX_KERNEL_NAMES = [
    ("void (anonymous namespace)::softmax_regs_kernel<float, 32, 4, 1>"
     "(float const*, float*, long, int)", "K2"),
    ("void (anonymous namespace)::softmax_regs_kernel<__nv_bfloat16, 4, 4, 8>"
     "(__nv_bfloat16 const*, __nv_bfloat16*, long, int)", "K2"),
    ("void (anonymous namespace)::softmax_rows_kernel<float>(float const*, "
     "float*, long, long)", "K2"),
    ("void (anonymous namespace)::softmax_rows_onchip_kernel<float, 16, 4>"
     "(float const*, float*, long, int, int)", "K2"),
    ("void (anonymous namespace)::softmax_rows_onchip_kernel<__nv_bfloat16, "
     "32, 1>(__nv_bfloat16 const*, __nv_bfloat16*, long, int, int)", "K2"),
    ("void (anonymous namespace)::softmax_rows_stream_kernel<float, 4>"
     "(float const*, float*, long)", "K2"),
    ("void (anonymous namespace)::bias_softmax_regs_kernel<float, 32, 4, 1>"
     "(float const*, float const*, float*, long, long, int)", "K5a"),
    ("void (anonymous namespace)::bias_softmax_regs_kernel<__nv_bfloat16, 4, "
     "1, 2>(__nv_bfloat16 const*, float const*, __nv_bfloat16*, long, long, "
     "int)", "K5a"),
    ("void (anonymous namespace)::bias_softmax_rows_kernel<float>(float "
     "const*, float const*, float*, long, long, long)", "K5a"),
    ("void (anonymous namespace)::softmax_bwd_regs_kernel<float, 32, 4>"
     "(float const*, float const*, float*, long, int)", "K5b"),
    ("void (anonymous namespace)::softmax_bwd_rows_kernel<__nv_bfloat16>"
     "(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, long, "
     "long)", "K5b"),
]


# the profiler's names of flash_attention.cu's kernels: the bf16
# instances of K7a, K7b and K7c on the bf16 tensor cores
# (flash_fwd_bf16_kernel, flash_bwd_dq_bf16_kernel,
# flash_bwd_dkv_bf16_kernel), the fp32 ones and the WIDE ones
_BF16_FWD_ARGS = ("(__nv_bfloat16 const*, __nv_bfloat16 const*, "
                  "__nv_bfloat16 const*, __nv_bfloat16*, float*, int, int, "
                  "int, float, int, bool)")
_BF16_DQ_ARGS = ("(__nv_bfloat16 const*, __nv_bfloat16 const*, "
                 "__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
                 "float const*, __nv_bfloat16*, int, int, int, float, int, "
                 "bool)")
_BF16_DKV_ARGS = ("(__nv_bfloat16 const*, __nv_bfloat16 const*, "
                  "__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, "
                  "float const*, __nv_bfloat16*, __nv_bfloat16*, int, int, "
                  "int, float, int, bool)")
_FLASH_KERNEL_NAMES = [
    ("void (anonymous namespace)::flash_fwd_bf16_kernel<64>"
     + _BF16_FWD_ARGS, "K7a"),
    ("void (anonymous namespace)::flash_fwd_bf16_kernel<256>"
     + _BF16_FWD_ARGS, "K7a"),
    ("void (anonymous namespace)::flash_bwd_dq_bf16_kernel<64>"
     + _BF16_DQ_ARGS, "K7b"),
    ("void (anonymous namespace)::flash_bwd_dq_bf16_kernel<128>"
     + _BF16_DQ_ARGS, "K7b"),
    ("void (anonymous namespace)::flash_bwd_dkv_bf16_kernel<64>"
     + _BF16_DKV_ARGS, "K7c"),
    ("void (anonymous namespace)::flash_bwd_dkv_bf16_kernel<128>"
     + _BF16_DKV_ARGS, "K7c"),
    ("void (anonymous namespace)::flash_fwd_kernel<float, 64, false>(float "
     "const*, float const*, float const*, float*, float*, int, int, int, "
     "float, int, bool)", "K7a"),
    ("void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, 64, true>"
     + _BF16_FWD_ARGS, "K7a"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<__nv_bfloat16, 64, "
     "true>" + _BF16_DQ_ARGS, "K7b"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<float, 64, false>"
     "(float const*, float const*, float const*, float const*, float "
     "const*, float const*, float*, float*, int, int, int, float, int, "
     "bool)", "K7c"),
]


@pytest.mark.parametrize("table", ["KINDS", "LM_KINDS", "LM_TRAIN_KINDS"])
@pytest.mark.parametrize("name,kind", _FLASH_KERNEL_NAMES)
def test_chip_smoke_profile_kinds_tell_the_flash_kernels_apart(name, kind,
                                                               table):
    """Each kernel of flash_attention.cu, the bf16 tensor-core instances
    of K7a, K7b and K7c among them, lands in its own kind in every profile
    table of chip_smoke.py, and never in another or in "other"."""
    import chip_smoke
    us = chip_smoke.by_kind({name: 1.0}, getattr(chip_smoke, table))
    assert us[kind] == 1.0 and sum(us.values()) == 1.0


@pytest.mark.parametrize("table", ["KINDS", "LM_KINDS", "LM_TRAIN_KINDS"])
@pytest.mark.parametrize("name,kind", _SOFTMAX_KERNEL_NAMES)
def test_chip_smoke_profile_kinds_tell_the_softmax_kernels_apart(name, kind,
                                                                 table):
    """Each kernel of softmax.cu lands in its own kind in every profile
    table of chip_smoke.py, and never in another or in "other"; torch's
    own softmax kernels land in none of the three."""
    import chip_smoke
    kinds = getattr(chip_smoke, table)
    us = chip_smoke.by_kind({name: 1.0}, kinds)
    assert us[kind] == 1.0 and sum(us.values()) == 1.0
    torch_softmax = {
        "void softmax_warp_forward<float, float, float, 10, false, false>"
        "(float*, float const*, int, int, int, bool const*, int, bool)": 1.0,
        "void (anonymous namespace)::cunn_SoftMaxForward<4, float, float, "
        "float, Epilogue>(float*, float const*, int)": 1.0}
    us = chip_smoke.by_kind(torch_softmax, kinds)
    assert us["K2"] == us["K5a"] == us["K5b"] == 0.0


@pytest.mark.parametrize("source,table", [
    ("softmax", "SOFTMAX_VARIANTS"), ("softmax", "K2_WIDE_VARIANTS"),
    ("layernorm", "LAYERNORM_VARIANTS"), ("flash_attention", "FLASH_VARIANTS")])
def test_time_variants_edits_are_found_in_their_sources(source, table):
    """Every variant ``time_variants.py`` times is its source with lines
    replaced that the source holds (``variant_texts`` raises on a text it
    does not find), and each differs from the source and the others."""
    import time_variants
    variants = getattr(time_variants, table)
    runs = time_variants.variant_texts(source, variants)
    names = [name for name, _ in runs]
    assert names[1:-1] == list(variants) and runs[0][1] == runs[-1][1]
    texts = [text for _, text in runs[:-1]]
    assert len(set(texts)) == len(texts)


@pytest.mark.parametrize("dtype,fragment", [
    ("fp32", "softmax_rows_onchip_kernelIfLi16ELi4EE"),
    ("bf16", "softmax_rows_onchip_kernelI13__nv_bfloat16Li16ELi8EE")])
def test_chip_smoke_counts_the_sass_of_each_wide_k2_instance(dtype,
                                                             fragment):
    """Phase 2's ``k2_wide_counts`` reads K2's wide-row instance of 16
    values a thread in 16-byte chunks, a kernel of softmax.cu that
    ``launch_wide`` launches, and ``time_variants.py`` reports its
    registers."""
    import chip_smoke
    import time_variants
    assert (dtype, fragment) in chip_smoke.K2_WIDE_KERNELS
    assert fragment in time_variants.K2_WIDE_MAIN
    kernel = fragment[:fragment.index("I")]
    with open(os.path.join(_build.CSRC, "softmax.cu")) as f:
        text = f.read()
    assert "    %s(" % kernel in text and "%s<T, N, VEC>" % kernel in text
    assert "go(std::integral_constant<int, 16>{});" in text


@pytest.mark.parametrize("knum,fragment", [
    ("K7a", "flash_fwd_bf16_kernelILi64E"),
    ("K7b", "flash_bwd_dq_bf16_kernelILi64E"),
    ("K7c", "flash_bwd_dkv_bf16_kernelILi64E")])
def test_chip_smoke_counts_the_tensor_cores_of_each_bf16_flash_kernel(
        knum, fragment):
    """Phase 2's ``hmma_counts`` reads the D-64 instance of each bf16
    flash kernel, and each is a kernel of flash_attention.cu that
    ``launch_bwd`` or ``launch_fwd`` launches."""
    import chip_smoke
    assert (knum, fragment) in chip_smoke.HMMA_KERNELS
    kernel = fragment[:-len("ILi64E")]
    with open(os.path.join(_build.CSRC, "flash_attention.cu")) as f:
        text = f.read()
    assert "    %s(" % kernel in text and "%s<DP><<<" % kernel in text
