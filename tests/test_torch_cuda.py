"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``mxnet_tpu_torch/ops/csrc`` at first use); elsewhere they skip.  They
import neither ``jax`` nor the JAX package, so on a machine without JAX
run them past ``tests/conftest.py``::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import chip_smoke
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _k3_inputs(shape, dtype, device, seed=40):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 3)
    s = torch.from_numpy((rng.rand(shape[1]) + 0.5).astype(np.float32))
    b = torch.from_numpy(rng.randn(shape[1]).astype(np.float32))
    return x.to(device, dtype), s.to(device), b.to(device)


# (2, 16, 8, 8) takes 16-byte accesses in both dtypes, (2, 8, 14, 14) in
# fp32 only, the others the scalar path
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 8, 8), (2, 8, 14, 14),
                                   (2, 64, 7, 7), (3, 5, 6, 9), (4, 16)])
def test_k3_kernel_bitwise_equals_plain(cuda, shape, dtype, relu):
    x, s, b = _k3_inputs(shape, dtype, cuda)
    before = ck.kernel_calls()["scale_bias_relu"]
    y = ck.scale_bias_relu(x, s, b, relu)
    ref = ck.scale_bias_relu_ref(x, s, b, relu)
    torch.cuda.synchronize()
    assert ck.kernel_calls()["scale_bias_relu"] == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(y.view(bits), ref.view(bits))


def test_k3_kernel_propagates_nan(cuda):
    x = torch.tensor([[float("nan"), -1.0, 2.0]], device=cuda)
    y = ck.scale_bias_relu(x, torch.ones(3, device=cuda),
                           torch.zeros(3, device=cuda), relu=True)
    assert torch.isnan(y[0, 0]) and y[0, 1] == 0 and y[0, 2] == 2


def _bf16_close(got, ref, atol):
    """Within one bf16 rounding of the larger magnitude (the kernel and
    its plain version both compute in fp32 and round once), plus ``atol``
    for the fp32 difference under it."""
    got, ref = got.float(), ref.float()
    mag = torch.maximum(got.abs(), ref.abs())
    return bool(((got - ref).abs() <= mag * 2.0 ** -7 + atol).all())


# Below 1024 rows one row a block of 1, 2, 4 or 8 warps: (1, 1000) and
# (8, 1000) are serving buckets, 1024 the widest row held in registers,
# 999 and 33 take scalar loads.  From 1024 rows one warp a row with 4, 8,
# 16 or 32 values a lane, each with vector loads (C 100, 256, 500 and
# 512, 1000, 1024; bf16 C 500 scalar) and with scalar ones (C 99, 255,
# 511, 999).  Past 1024 columns the row on chip: 1025 (scalar) and 4097
# (scalar, a cluster of 4 for 5 rows), the bucketed LM's (320, 10000)
# and (1920, 10000) (one CTA a row), (32, 10000) (clusters of 4), (1,
# 10000) (a cluster of 8), (7, 10001) (scalar loads), (2, 50257) (scalar,
# a cluster of 8 CTAs of 800 threads), logits x1e4; (2, 300000) is past
# what eight CTAs hold and takes the streaming form.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,scale", [((32, 1000), 1.0), ((7, 1), 1.0),
                                         ((5, 4097), 1.0), ((3, 2, 33), 1.0),
                                         ((4, 1000), 1e4), ((1, 1000), 1.0),
                                         ((8, 1000), 1.0), ((3, 1024), 1.0),
                                         ((3, 1025), 1.0), ((5, 999), 1.0),
                                         ((6, 100), 1.0), ((6, 256), 1.0),
                                         ((6, 500), 1.0), ((1024, 100), 1.0),
                                         ((1024, 99), 1.0),
                                         ((1024, 256), 1.0),
                                         ((1024, 255), 1.0),
                                         ((1500, 500), 1.0),
                                         ((1500, 512), 1.0),
                                         ((1024, 511), 1.0),
                                         ((2048, 1000), 1.0),
                                         ((1024, 999), 1.0),
                                         ((1024, 1024), 1.0),
                                         ((320, 10000), 3.0),
                                         ((1920, 10000), 3.0),
                                         ((32, 10000), 3.0),
                                         ((1, 10000), 3.0),
                                         ((7, 10001), 1.0),
                                         ((2, 50257), 1.0),
                                         ((2, 300000), 1.0),
                                         ((32, 10000), 1e4)])
def test_k2_kernel_matches_plain(cuda, shape, scale, dtype):
    """fp32 within 1e-6, bf16 within one rounding of the magnitude."""
    x = torch.from_numpy((np.random.RandomState(41).randn(*shape) * scale)
                         .astype(np.float32)).to(cuda, dtype)
    y = ck.softmax_lastaxis(x)
    ref = ck.softmax_lastaxis_ref(x)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape
    assert torch.isfinite(y).all()
    if dtype == torch.float32:
        assert (y - ref).abs().max().item() <= 1e-6
    else:
        assert _bf16_close(y, ref, 1e-6)
    assert (y.float().sum(-1) - 1).abs().max().item() <= \
        (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 1000), (320, 10000), (32, 10000),
                                   (2, 50257), (2, 300000)])
def test_k2_kernel_spreads_a_nan_over_its_row_only(cuda, shape, dtype):
    """A NaN anywhere in a row makes that whole row NaN, as the plain
    version's does, on every form (one CTA a row, a cluster a row, the
    streaming form); the other rows stay as the plain version has them."""
    x = torch.from_numpy(np.random.RandomState(43).randn(*shape)
                         .astype(np.float32)).to(cuda, dtype)
    x[1, shape[1] * 2 // 3] = float("nan")
    y = ck.softmax_lastaxis(x)
    ref = ck.softmax_lastaxis_ref(x)
    torch.cuda.synchronize()
    assert torch.isnan(y[1]).all() and torch.isnan(ref[1]).all()
    keep = torch.arange(shape[0], device=cuda) != 1
    assert torch.isfinite(y[keep]).all()
    if dtype == torch.float32:
        assert (y[keep] - ref[keep]).abs().max().item() <= 1e-6
    else:
        assert _bf16_close(y[keep], ref[keep], 1e-6)


def test_kernels_raise_on_what_they_do_not_take(cuda):
    x = torch.zeros(2, 4, 3, 3, device=cuda)
    s, b = torch.ones(4, device=cuda), torch.zeros(4, device=cuda)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        ck.scale_bias_relu(x.half(), s, b)
    with pytest.raises(MXNetError, match="contiguous"):
        ck.scale_bias_relu(x.transpose(2, 3), s, b)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        ck.softmax_lastaxis(x.double())


# ---------------------------------------------------------------------------
# K1a / K1b / K4: the optimizer sweeps, in place, bitwise
# ---------------------------------------------------------------------------
def _sweep_case(name, n, use_clip, device, offset=0, seed=42):
    """Operands of sweep ``name`` over ``n`` elements, each a view at
    ``offset`` elements into its own buffer (offset 1 breaks the 16-byte
    alignment), and its hyperparameter vector."""
    rng = np.random.RandomState(seed)
    n_slots = {"sgd_sweep": 0, "sgd_mom_sweep": 1, "adam_sweep": 2}[name]

    def buf(scale, positive=False):
        a = rng.randn(n + offset).astype(np.float32) * scale
        if positive:
            a = np.abs(a)
        return torch.from_numpy(a).to(device)[offset:]

    w, g = buf(1.0), buf(3.0)
    if n > 7:
        g[::7] = float("nan")       # the clip lets a NaN through
    slots = [buf(0.1)] + ([buf(0.01, positive=True)] if n_slots == 2 else [])
    slots = slots[:n_slots]
    h = {"sgd_sweep": [0.1, 1e-4, 1.0 / 32],
         "sgd_mom_sweep": [0.1, 0.9, 1e-4, 1.0 / 32],
         "adam_sweep": [1e-3, 0.9, 0.999, 1.0 - 0.9, 1.0 - 0.999, 1e-8,
                        1e-4, 1.0 / 32]}[name]
    hyper = torch.tensor(h + ([0.05] if use_clip else []),
                         dtype=torch.float32, device=device)
    return w, g, slots, hyper


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("use_clip", [False, True])
@pytest.mark.parametrize("n", [1, 3, 4097, 131073])
@pytest.mark.parametrize("name", ["sgd_sweep", "sgd_mom_sweep", "adam_sweep"])
def test_sweep_kernel_bitwise_equals_plain(cuda, name, n, use_clip, offset):
    w, g, slots, hyper = _sweep_case(name, n, use_clip, cuda, offset)
    kw, ks = w.clone(), [s.clone() for s in slots]
    pw, ps = w.clone(), [s.clone() for s in slots]
    before = ck.kernel_calls()[name]
    getattr(ck, name)(kw, g, *ks, hyper, use_clip=use_clip)
    getattr(ck, name + "_ref")(pw, g, *ps, hyper, use_clip=use_clip)
    torch.cuda.synchronize()
    assert ck.kernel_calls()[name] == before + 1
    for got, ref in zip([kw] + ks, [pw] + ps):
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert not torch.equal(kw, w)


def test_sweep_kernels_raise_on_what_they_do_not_take(cuda):
    w = torch.zeros(10, device=cuda)
    h = torch.zeros(4, device=cuda)
    with pytest.raises(MXNetError, match="float32"):
        ck.sgd_mom_sweep(w, w.double(), w.clone(), h)
    with pytest.raises(MXNetError, match="hyper"):
        ck.sgd_mom_sweep(w, w.clone(), w.clone(), torch.zeros(3, device=cuda))
    with pytest.raises(MXNetError, match="contiguous"):
        ck.sgd_sweep(torch.zeros(10, 2, device=cuda)[:, 0],
                     torch.zeros(10, device=cuda), torch.zeros(3, device=cuda))


def test_fused_adam_step_does_not_wait_on_the_card(cuda):
    """Adam's bias correction rewrites the executor's hyperparameter table
    every step; the copy goes through pinned memory without blocking, so
    two fused steps run under sync debug mode "error"."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.symbols import resnet
    sym = resnet.get_symbol(10, 8, "3,32,32")
    req = {n: "null" if n in ("data", "softmax_label") else "write"
           for n in sym.list_arguments()}
    exe = sym.simple_bind(ctx=mx.gpu(0), grad_req=req, data=(4, 3, 32, 32))
    rng = np.random.RandomState(45)
    for n, a in exe.arg_dict.items():
        if n != "softmax_label":
            a[:] = (rng.randn(*a.shape) * 0.1).astype(np.float32)
    for n, a in exe.aux_dict.items():
        a[:] = 1.0 if n.endswith("_var") else 0.0
    opt = mx.optimizer.create("adam", learning_rate=1e-3)
    assert exe.install_fused_update(
        opt, [n for n, r in req.items() if r != "null"])
    exe.forward(is_train=True)
    first = exe._hyper[1].clone()
    ck.reset_kernel_calls()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            exe.forward(is_train=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ck.kernel_calls()["adam_sweep"] == 2 * len(exe._sweep["plan"])
    host, dev = exe._hyper
    assert torch.equal(dev.cpu(), torch.from_numpy(host))
    assert not torch.equal(dev, first)


# ---------------------------------------------------------------------------
# K6a / K7a / K5a: the transformer forward's kernels
# ---------------------------------------------------------------------------
# fp32: the row's two sums are taken in another order than torch's mean
# (warp shuffles over lane-strided partial sums) and rsqrtf is within 2
# ulp, so the outputs, O(1) with these gammas, agree within 1e-5.  C up to
# 1024 takes the warp-per-row layout, 1025-8192 the block-per-row one with
# the row in registers, 10000 the one striding over device memory
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 768), (3, 5, 37), (17, 1000),
                                   (2, 1), (9, 1024), (4, 32), (5, 1025),
                                   (6, 1280), (3, 1600), (7, 2048),
                                   (2, 3, 4096), (3, 8192), (4, 10000)])
def test_k6a_kernel_matches_plain(cuda, shape, dtype):
    rng = np.random.RandomState(46)
    c = shape[-1]
    x = torch.from_numpy((rng.randn(*shape) * 2 + 0.5).astype(np.float32))
    g = torch.from_numpy((1 + 0.1 * rng.randn(c)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.randn(c)).astype(np.float32))
    x, g, b = x.to(cuda, dtype), g.to(cuda), b.to(cuda)
    before = ck.kernel_calls()["layernorm_fwd"]
    o, mu, rstd = ck.layernorm_fwd(x, g, b, 1e-5)
    ro, rmu, rrstd = ck.layernorm_fwd_ref(x, g, b, 1e-5)
    torch.cuda.synchronize()
    assert ck.kernel_calls()["layernorm_fwd"] == before + 1
    assert o.dtype == dtype and o.shape == x.shape
    assert mu.shape == rstd.shape == shape[:-1] and mu.dtype == torch.float32
    assert (mu - rmu).abs().max().item() <= 1e-5
    assert ((rstd - rrstd).abs() / rrstd).max().item() <= 1e-5
    if dtype == torch.float32:
        assert (o - ro).abs().max().item() <= 1e-5
    else:
        assert _bf16_close(o, ro, 1e-5)


def _qkv(bh, tq, tk, d, dtype, device, seed=47):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(bh, t, d).astype(np.float32))
            .to(device, dtype) for t in (tq, tk, tk)]


# fp32: the kernel sums the scores and the weighted values in another order
# than cuBLAS (64-key tiles with online rescaling against one-shot
# products over up to 1024 keys), so o and lse agree within 1e-5; D 320
# and 512 take the instances that split D into chunks of 64 columns
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,tq,tk,d", [(3, 8, 8, 32), (2, 64, 64, 64),
                                        (2, 200, 200, 128), (4, 100, 72, 16),
                                        (1, 1024, 1024, 64), (2, 24, 40, 64),
                                        (2, 72, 72, 48), (2, 130, 130, 80),
                                        (2, 128, 128, 96), (2, 64, 96, 112),
                                        (2, 64, 64, 8), (2, 72, 72, 72),
                                        (2, 40, 56, 200), (2, 33, 33, 256),
                                        (2, 1, 1, 64), (2, 127, 127, 64),
                                        (2, 129, 129, 64), (2, 1000, 1000, 64),
                                        (2, 1, 1, 128), (2, 127, 127, 128),
                                        (2, 129, 129, 128),
                                        (2, 1000, 1000, 128),
                                        (2, 200, 200, 320), (2, 65, 90, 320),
                                        (2, 129, 129, 512)])
def test_k7a_kernel_matches_plain(cuda, bh, tq, tk, d, causal):
    q, k, v = _qkv(bh, tq, tk, d, torch.float32, cuda)
    before = ck.kernel_calls()["flash_attention_fwd"]
    o, lse = ck.flash_attention_fwd(q, k, v, causal)
    ro, rlse = ck.flash_attention_fwd_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert ck.kernel_calls()["flash_attention_fwd"] == before + 1
    assert o.shape == q.shape and lse.shape == (bh, tq)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (o - ro).abs().max().item() <= 1e-5
    assert (lse - rlse).abs().max().item() <= 1e-5


def test_k7a_kernel_bf16_and_scale(cuda):
    """Two key tiles: the kernel rounds p = exp(s - m) at its running max
    m, the plain version at the row's, so any p may round to the other
    side of a step: o within one step of the sum of its terms."""
    q, k, v = _qkv(4, 96, 96, 64, torch.bfloat16, cuda)
    o, lse = ck.flash_attention_fwd(q, k, v, True, scale=0.3)
    ro, rlse = ck.flash_attention_fwd_ref(q, k, v, True, scale=0.3)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16
    terms = chip_smoke.attention_terms(q, k, v, True, False, scale=0.3)
    assert chip_smoke.bf16_attention_close(o, ro, terms, 1e-5)
    assert (lse - rlse).abs().max().item() <= 1e-5


@pytest.mark.parametrize("causal", [True, False])
def test_k7a_kernel_rounds_p_to_bf16(cuda, causal):
    """One key tile (T 64): the kernel's running max is the row's, so it
    and the plain version round the same p, and only an exp that differs
    in its last bit can put one p on the other side of a step: o within
    one step of its largest term.  A kernel that kept p in fp32 would
    miss this by the rounding of every p."""
    q, k, v = _qkv(8, 64, 64, 64, torch.bfloat16, cuda, seed=49)
    o, _ = ck.flash_attention_fwd(q, k, v, causal)
    ro, _ = ck.flash_attention_fwd_ref(q, k, v, causal)
    torch.cuda.synchronize()
    terms = chip_smoke.attention_terms(q, k, v, causal, True)
    assert chip_smoke.bf16_attention_close(o, ro, terms, 1e-6)


# C across the register instances (4, 8, 16, 32 values a lane: C <= 128,
# 256, 512, 1024) and past them (1025, the strided loop), below 1024 rows
# (one row a block of 1-8 warps) and from there on (one warp a row, 1029
# and 1025 rows: not a multiple of the four a block; 2400 rows of a 4-D
# x).  Cases: "offset" views x one
# element past an aligned base (scalar loads), "bias offset" the bias
# (scalar loads though x is aligned), "masked row" masks bias row 1
# entirely (the row comes out uniform, 1 / C), "nan row" puts a NaN in
# row 1 of every batch (the row comes out NaN).
_SOFTMAX_EDGE_SHAPES = [
    (2, 3, c) for c in (1, 31, 32, 33, 128, 129, 512, 513, 1000, 1020, 1024,
                        1025)] + [
    (3, 343, c) for c in (31, 32, 33, 128, 129, 512, 513, 1000, 1020, 1024,
                          1025)] + [
    (5, 205, c) for c in (32, 129, 513, 1020)] + [(2, 3, 400, 100)]
_SOFTMAX_CASES = [((6, 40, 40), ""), ((2, 3, 17, 1020), ""), ((5, 1, 7), "")] \
    + [(shape, "") for shape in _SOFTMAX_EDGE_SHAPES] + [
    ((2, 3, 17, 1020), "offset"), ((3, 343, 1020), "offset"),
    ((2, 3, 256), "offset"), ((3, 343, 1020), "bias offset"),
    ((2, 3, 17, 1020), "masked row"), ((3, 343, 1020), "masked row"),
    ((2, 3, 17, 1020), "nan row"), ((3, 343, 1020), "nan row"),
    ((3, 343, 1025), "nan row")]


def _offset(t, offset):
    """A contiguous copy of ``t`` whose data start ``offset`` elements past
    an aligned allocation."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def _softmax_case_inputs(shape, case, causal, dtype, device, seed):
    """x (``shape``, ``dtype``) and its fp32 (R, C) bias for a K5a case:
    causal 0 / NEG_INF, or 0.5 randn; see ``_SOFTMAX_CASES``."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(*shape) * 3).astype(np.float32))
    r, c = shape[-2:]
    bias = torch.from_numpy((rng.randn(r, c) * 0.5).astype(np.float32))
    if causal:
        bias = torch.where(torch.ones(r, c, dtype=torch.bool).tril(),
                           0.0, ck.NEG_INF)
    if case == "masked row":
        bias[min(1, r - 1)] = ck.NEG_INF
    if case == "nan row":
        x[..., min(1, r - 1), c // 2] = float("nan")
    x, bias = x.to(device, dtype), bias.to(device)
    if case == "offset":
        x = _offset(x, 1)
    if case == "bias offset":
        bias = _offset(bias, 1)
    return x, bias


def _close_with_nan(got, ref, f32_tol):
    """NaN exactly where the plain version has it; elsewhere fp32 within
    ``f32_tol`` or bf16 within one rounding of the magnitude."""
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(got), nan):
        return False
    got, ref = got[~nan], ref[~nan]
    if got.dtype == torch.float32:
        return (got - ref).abs().max().item() <= f32_tol
    return _bf16_close(got, ref, f32_tol)


# fp32: the same arithmetic as the plain version with the sum in another
# order, as K2 (1e-6); bf16: both compute in fp32 and round once, so
# within one bf16 rounding of the magnitude (plus 1e-6); a masked column
# comes out exactly 0
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,case", _SOFTMAX_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_k5a_kernel_matches_plain(cuda, shape, case, causal, dtype):
    x, bias = _softmax_case_inputs(shape, case, causal, dtype, cuda, 48)
    r, c = shape[-2:]
    before = ck.kernel_calls()["bias_softmax"]
    y = ck.bias_softmax(x, bias)
    ref = ck.bias_softmax_ref(x, bias)
    torch.cuda.synchronize()
    assert ck.kernel_calls()["bias_softmax"] == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    assert _close_with_nan(y, ref, 1e-6)
    row = min(1, r - 1)
    if case == "nan row":
        assert torch.isnan(y[..., row, :]).all()
        assert not torch.isnan(y[..., :row, :]).any()
    if case == "masked row":
        assert torch.equal(y[..., row, :], ref[..., row, :])
        assert (y[..., row, :] == y[..., row, :1]).all()
    if causal:
        masked = ~torch.ones(r, c, dtype=torch.bool, device=cuda).tril()
        if case in ("masked row", "nan row"):
            masked[row] = False
        assert (y[..., masked] == 0).all()
    if c == 1 and case == "":
        assert (y == 1).all()


def test_transformer_kernels_raise_on_what_they_do_not_take(cuda):
    x = torch.zeros(4, 0, device=cuda)
    g, b = torch.ones(0, device=cuda), torch.zeros(0, device=cuda)
    with pytest.raises(MXNetError, match="C >= 1"):
        ck.layernorm_fwd(x, g, b)
    x, g, b = (torch.zeros(4, 8, device=cuda), torch.ones(8, device=cuda),
               torch.zeros(8, device=cuda))
    with pytest.raises(MXNetError, match="float32"):
        ck.layernorm_fwd(x, g.double(), b)
    q = torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(MXNetError, match="contiguous"):
        ck.flash_attention_fwd(q.transpose(0, 1).contiguous()
                               .transpose(0, 1), q, q)
    with pytest.raises(MXNetError, match="bias rows"):
        ck.bias_softmax(torch.zeros(2, 4, 5, device=cuda),
                        torch.zeros(3, 5, device=cuda))


def test_local_attention_wide_heads_take_the_flash_route(cuda):
    """Under ``impl="auto"`` a head dim past the widest instance (D 320)
    takes the flash route on the card, as the JAX package's condition
    has no D clause, and matches the einsum route; ``impl="flash"`` gives
    the same result."""
    from mxnet_tpu_torch.parallel import attention
    rng = np.random.RandomState(50)
    q, k, v = (torch.from_numpy(rng.randn(2, 16, 2, 320).astype(np.float32))
               .to(cuda) for _ in range(3))
    ck.reset_kernel_calls()
    got = attention.local_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ck.kernel_calls()["flash_attention_fwd"] == 1
    want = attention.local_attention(q, k, v, causal=True, impl="einsum")
    assert got.shape == q.shape
    assert (got - want).abs().max().item() <= 1e-5
    forced = attention.local_attention(q, k, v, causal=True, impl="flash")
    assert torch.equal(forced, got)


@pytest.mark.parametrize("c", [768, 1280, 2048])
def test_layernorm_op_launches_k6a_at_every_width(cuda, c):
    """The LayerNorm op on CUDA tensors goes through K6a at any width, as
    the JAX package's op goes through its kernel at every C it takes."""
    import mxnet_tpu_torch as mx
    rng = np.random.RandomState(49)
    x = mx.nd.array(rng.randn(2, 5, c).astype(np.float32), ctx=mx.gpu(0))
    g = mx.nd.array((1 + 0.1 * rng.randn(c)).astype(np.float32),
                    ctx=mx.gpu(0))
    b = mx.nd.array((0.1 * rng.randn(c)).astype(np.float32), ctx=mx.gpu(0))
    ck.reset_kernel_calls()
    y = mx.nd.LayerNorm(x, g, b, axis=-1, eps=1e-5)
    torch.cuda.synchronize()
    assert ck.kernel_calls()["layernorm_fwd"] == 1
    ro = ck.layernorm_fwd_ref(x._data, g._data, b._data, 1e-5)[0]
    assert (y._data - ro).abs().max().item() <= 1e-5


# ---------------------------------------------------------------------------
# K6b / K7b / K7c / K5b: the transformer backward's kernels
# ---------------------------------------------------------------------------
def _rel_err(got, ref):
    """max |got - ref| over the largest |ref|."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def _bf16_bwd_close(got, ref):
    """bf16 backward: within one bf16 rounding of each element's
    magnitude, plus one rounding of the largest magnitude for the p and
    ds that round to the other side of a bf16 step inside the kernel
    (both round the same fp32 values, which agree only within 1e-6)."""
    got, ref = got.float(), ref.float()
    mag = torch.maximum(got.abs(), ref.abs())
    top = ref.abs().max().item()
    return bool(((got - ref).abs() <= mag * 2.0 ** -7
                 + top * 2.0 ** -7).all())


# fp32: the kernel's two row means run in another order than torch's, so
# dx agrees within 1e-5 of its largest magnitude; (8192, 768) is one
# LayerNorm of the GPT-2-small training step; C 768, 1000 and 1024 take
# the vector layout (persistent warps, 16-byte loads), C 1 and 37 the
# scalar warp-per-row one, 1025-8192 the block-per-row one, 9000 and 10000
# the striding one
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8192, 768), (3, 5, 37), (17, 1000),
                                   (2, 1), (9, 1024), (5, 1025),
                                   (3, 2048), (3, 8192), (2, 9000),
                                   (4, 10000)])
def test_k6b_kernel_matches_plain(cuda, shape, dtype):
    rng = np.random.RandomState(60)
    c = shape[-1]
    x = torch.from_numpy((rng.randn(*shape) * 2 + 0.5).astype(np.float32))
    do = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    g = torch.from_numpy((1 + 0.1 * rng.randn(c)).astype(np.float32))
    x, do, g = x.to(cuda, dtype), do.to(cuda, dtype), g.to(cuda)
    _, mu, rstd = ck.layernorm_fwd(x, g, torch.zeros_like(g), 1e-5)
    before = ck.kernel_calls()["layernorm_bwd"]
    dx = ck.layernorm_bwd(x, do, g, mu, rstd)
    ref = ck.layernorm_bwd_ref(x, do, g, mu, rstd)
    torch.cuda.synchronize()
    assert ck.kernel_calls()["layernorm_bwd"] == before + 1
    assert dx.dtype == dtype and dx.shape == x.shape
    if dtype == torch.float32:
        assert _rel_err(dx, ref) <= 1e-5
    else:
        assert _bf16_bwd_close(dx, ref)


@pytest.mark.parametrize("case", range(len(chip_smoke.K6B_EDGE)))
def test_k6b_kernel_at_its_layout_edges(cuda, case):
    """K6b at ``chip_smoke.K6B_EDGE``: the vector layout's instances and
    one chunk past each, the scalar and block layouts, operands off their
    16-byte alignment and row counts that are no multiple of the
    persistent grid; fp32 within 1e-5 of the largest |dx|, bf16 within
    one rounding (``chip_smoke.k6b_close``)."""
    shape, dtype, off = chip_smoke.K6B_EDGE[case]
    x, do, g, mu, rstd = chip_smoke.k6b_operands(cuda, shape, dtype, 62, off)
    dx = ck.layernorm_bwd(x, do, g, mu, rstd)
    ok, err = chip_smoke.k6b_close(dx, ck.layernorm_bwd_ref(x, do, g, mu,
                                                            rstd))
    torch.cuda.synchronize()
    assert ok, (shape, dtype, off, err)


def _flash_bwd_case(bh, tq, tk, d, causal, dtype, device, seed=61):
    q, k, v = _qkv(bh, tq, tk, d, dtype, device, seed)
    o, lse = ck.flash_attention_fwd(q, k, v, causal)
    do = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        bh, tq, d).astype(np.float32)).to(device, dtype)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, lse, delta


# fp32: the kernels sum over tiles of 64 (32 past D 64) keys or queries in
# 3xTF32 on the tensor cores, the plain version in one fp32 product, so
# dq, dk and dv agree within 1e-5 of their largest magnitude; (96, 1024,
# 64) is one attention of the GPT-2-small training step; T 1, 7, 15, 17,
# 63, 65 and 1020 leave ragged tiles, Tq != Tk runs both ways, D 8, 72,
# 200 and 256 take the padded widths, D 32 to 256 every instance, D 320
# and 512 the instances that split D into chunks of 64 columns
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,tq,tk,d", [(3, 8, 8, 32), (2, 64, 64, 64),
                                        (2, 7, 7, 16),
                                        (2, 65, 65, 64), (2, 200, 200, 128),
                                        (96, 1024, 1024, 64),
                                        (1, 1020, 1020, 64), (2, 24, 40, 64),
                                        (2, 100, 72, 16), (2, 72, 72, 72),
                                        (2, 64, 64, 8), (2, 40, 56, 200),
                                        (2, 65, 65, 256), (2, 15, 15, 64),
                                        (2, 17, 17, 64), (2, 63, 63, 64),
                                        (2, 90, 90, 96), (2, 90, 90, 160),
                                        (2, 90, 90, 192), (2, 90, 90, 224),
                                        (2, 100, 100, 320),
                                        (2, 40, 72, 320), (2, 65, 65, 512)])
def test_k7b_k7c_kernels_match_plain(cuda, bh, tq, tk, d, causal):
    args = _flash_bwd_case(bh, tq, tk, d, causal, torch.float32, cuda)
    before = ck.kernel_calls()
    dq = ck.flash_attention_bwd_dq(*args, causal)
    dk, dv = ck.flash_attention_bwd_dkv(*args, causal)
    rdq = ck.flash_attention_bwd_dq_ref(*args, causal)
    rdk, rdv = ck.flash_attention_bwd_dkv_ref(*args, causal)
    torch.cuda.synchronize()
    after = ck.kernel_calls()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert _rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("causal", [True, False])
def test_k7b_k7c_kernels_at_one_key(cuda, causal):
    """T 1: the one key takes p = 1, so dv is do and ds = p * (do.v -
    do.o) is 0 up to rounding (the plain version may round it to exactly
    0, so dq and dk are held to 0 within 1e-6, not relative to it)."""
    args = _flash_bwd_case(2, 1, 1, 64, causal, torch.float32, cuda)
    dq = ck.flash_attention_bwd_dq(*args, causal)
    dk, dv = ck.flash_attention_bwd_dkv(*args, causal)
    torch.cuda.synchronize()
    assert _rel_err(dv, args[3]) <= 1e-5
    assert dq.abs().max().item() <= 1e-6 and dk.abs().max().item() <= 1e-6


def test_k7b_k7c_kernels_bf16_and_scale(cuda):
    args = _flash_bwd_case(4, 96, 96, 64, True, torch.bfloat16, cuda)
    dq = ck.flash_attention_bwd_dq(*args, True, 0.3)
    dk, dv = ck.flash_attention_bwd_dkv(*args, True, 0.3)
    rdq = ck.flash_attention_bwd_dq_ref(*args, True, 0.3)
    rdk, rdv = ck.flash_attention_bwd_dkv_ref(*args, True, 0.3)
    torch.cuda.synchronize()
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == torch.bfloat16
        assert _bf16_bwd_close(got, ref)


# bf16: the instances on the bf16 tensor cores (mma.sync m16n8k16, D up to
# 256 rounded up to 32; D 320 takes the WIDE instances) at ragged T (1,
# 127, 129, 1000), Tq != Tk both ways, the padded widths and every instance
# width, and one attention of the GPT-2-small step, held with chip_smoke's
# bands: o within one rounding plus one step of its largest term where
# the keys fit in one key tile, of the sum of its terms beyond (the kernel
# rounds p at its running max); lse within 1e-5; dq, dk and dv within one
# rounding (``_bf16_bwd_close``)
_BF16_FLASH_SHAPES = [(3, 8, 8, 32), (2, 64, 64, 64), (2, 127, 127, 64),
                      (2, 129, 129, 64), (2, 1000, 1000, 64),
                      (2, 24, 40, 64), (2, 40, 24, 64), (4, 100, 72, 16),
                      (2, 72, 72, 48), (2, 130, 130, 80), (2, 128, 128, 96),
                      (2, 64, 96, 112), (2, 200, 200, 128), (2, 50, 70, 150),
                      (2, 90, 90, 160), (2, 40, 56, 200), (2, 33, 33, 256),
                      (2, 65, 90, 320),
                      (96, 1024, 1024, 64)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,tq,tk,d", _BF16_FLASH_SHAPES + [
    (2, 1, 1, 64), (2, 1, 1, 128)])
def test_k7a_bf16_instance_matches_plain(cuda, bh, tq, tk, d, causal):
    q, k, v = _qkv(bh, tq, tk, d, torch.bfloat16, cuda)
    before = ck.kernel_calls()["flash_attention_fwd"]
    o, lse = ck.flash_attention_fwd(q, k, v, causal)
    ro, rlse = ck.flash_attention_fwd_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert ck.kernel_calls()["flash_attention_fwd"] == before + 1
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    terms = chip_smoke.attention_terms(
        q, k, v, causal, tk <= chip_smoke.k7a_key_tile(d))
    assert chip_smoke.bf16_attention_close(o, ro, terms, 1e-6)
    assert (lse - rlse).abs().max().item() <= 1e-5


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,tq,tk,d", _BF16_FLASH_SHAPES + [
    (2, 7, 7, 64), (2, 17, 17, 64), (2, 65, 65, 64), (1, 1020, 1020, 64)])
def test_k7c_bf16_instance_matches_plain(cuda, bh, tq, tk, d, causal):
    args = _flash_bwd_case(bh, tq, tk, d, causal, torch.bfloat16, cuda)
    before = ck.kernel_calls()
    dq = ck.flash_attention_bwd_dq(*args, causal)
    dk, dv = ck.flash_attention_bwd_dkv(*args, causal)
    rdq = ck.flash_attention_bwd_dq_ref(*args, causal)
    rdk, rdv = ck.flash_attention_bwd_dkv_ref(*args, causal)
    torch.cuda.synchronize()
    after = ck.kernel_calls()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert torch.isfinite(got).all()
        assert _bf16_bwd_close(got, ref)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,tq,tk,d", _BF16_FLASH_SHAPES + [
    (2, 7, 7, 64), (2, 15, 15, 64), (2, 17, 17, 64), (2, 63, 63, 64),
    (2, 65, 65, 64), (1, 1020, 1020, 64)])
def test_k7b_bf16_instance_matches_plain(cuda, bh, tq, tk, d, causal):
    """K7b's bf16 instance on the bf16 tensor cores (the WIDE one at D
    320) against its plain version: one launch, dq in bf16 within one
    rounding (``_bf16_bwd_close``)."""
    args = _flash_bwd_case(bh, tq, tk, d, causal, torch.bfloat16, cuda)
    before = ck.kernel_calls()["flash_attention_bwd_dq"]
    dq = ck.flash_attention_bwd_dq(*args, causal)
    ref = ck.flash_attention_bwd_dq_ref(*args, causal)
    torch.cuda.synchronize()
    assert ck.kernel_calls()["flash_attention_bwd_dq"] == before + 1
    assert dq.dtype == torch.bfloat16 and dq.shape == ref.shape
    assert torch.isfinite(dq).all()
    assert _bf16_bwd_close(dq, ref)


def test_k7a_k7b_k7c_bf16_instances_run_on_the_tensor_cores(cuda):
    """The built library's bf16 D-64 instances of K7a, K7b and K7c hold
    bf16 tensor-core instructions (``cuobjdump -sass``)."""
    from mxnet_tpu_torch.ops import _build
    q, k, v = _qkv(1, 8, 8, 64, torch.bfloat16, cuda)
    ck.flash_attention_fwd(q, k, v, True)     # builds the library
    torch.cuda.synchronize()
    counts = chip_smoke.hmma_counts(_build)
    assert set(counts) == {"K7a", "K7b", "K7c"}
    assert all(c["count"] > 0 for c in counts.values())


def test_k2_wide_instances_load_128_bits_and_use_the_cluster(cuda):
    """The built library's wide-row K2 instances at C 10000 (fp32 and
    bf16) hold 128-bit global loads and the cluster's st.async, mbarrier
    waits and barrier (``cuobjdump -sass``)."""
    from mxnet_tpu_torch.ops import _build
    ck.softmax_lastaxis(torch.zeros(2, 10000, device=cuda))  # builds it
    torch.cuda.synchronize()
    counts = chip_smoke.k2_wide_counts(_build)
    assert set(counts) == {"fp32", "bf16"}
    assert all(c[key] > 0 for c in counts.values()
               for key, _ in chip_smoke.K2_WIDE_SASS)


# fp32: the row dot runs in another order than torch's sum, so dx agrees
# within 1e-5 of its largest magnitude; a masked probability (exactly 0)
# gives a dx of exactly 0.  The K5a cases, causal probabilities: "offset"
# views p and do one element past an aligned base (scalar loads), "nan
# row" puts a NaN in row 1's do (dx's row 1 comes out NaN).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,case", [
    ((4, 1), ""), ((3, 4097), ""), ((96, 1020, 1020), "")] + [
    c for c in _SOFTMAX_CASES if c[1] != "bias offset"])
def test_k5b_kernel_matches_plain(cuda, shape, case, dtype):
    x, bias = _softmax_case_inputs(shape, "masked row" if case == "masked row"
                                   else "", True, dtype, cuda, 62)
    do = torch.from_numpy(np.random.RandomState(63).randn(*shape)
                          .astype(np.float32))
    r, c = shape[-2:]
    row = min(1, r - 1)
    if case == "nan row":
        do[..., row, c // 2] = float("nan")
    p = ck.bias_softmax(x, bias)
    do = do.to(cuda, dtype)
    if case == "offset":
        p, do = _offset(p, 1), _offset(do, 1)
    before = ck.kernel_calls()["softmax_bwd"]
    dx = ck.softmax_bwd(p, do)
    ref = ck.softmax_bwd_ref(p, do)
    torch.cuda.synchronize()
    assert ck.kernel_calls()["softmax_bwd"] == before + 1
    assert dx.dtype == dtype and dx.shape == p.shape
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(dx), nan)
    if case == "nan row":
        assert nan[..., row, :].all() and not nan[..., :row, :].any()
    if dtype == torch.float32:
        assert _rel_err(dx[~nan], ref[~nan]) <= 1e-5
    else:
        assert _bf16_bwd_close(dx[~nan], ref[~nan])
    masked = ~torch.ones(r, c, dtype=torch.bool, device=cuda).tril()
    if case in ("masked row", "nan row"):
        masked[row] = False
    assert (dx[..., masked] == 0).all()


def test_backward_kernels_raise_on_what_they_do_not_take(cuda):
    x = torch.zeros(4, 8, device=cuda)
    g, mu = torch.ones(8, device=cuda), torch.zeros(4, device=cuda)
    with pytest.raises(MXNetError, match="one per row"):
        ck.layernorm_bwd(x, x, g, torch.zeros(4, 128, device=cuda), mu)
    with pytest.raises(MXNetError, match="do must match x"):
        ck.layernorm_bwd(x, x.bfloat16(), g, mu, mu)
    q = torch.zeros(2, 8, 64, device=cuda)
    lse = torch.zeros(2, 8, device=cuda)
    with pytest.raises(MXNetError, match="lse must be"):
        ck.flash_attention_bwd_dq(q, q, q, q, lse.double(), lse)
    with pytest.raises(MXNetError, match="do must be"):
        ck.flash_attention_bwd_dkv(q, q, q, q[:, :4], lse, lse)
    with pytest.raises(MXNetError, match="share shape"):
        ck.softmax_bwd(x, x[:, :4])
    with pytest.raises(MXNetError, match="contiguous"):
        ck.softmax_bwd(x.t(), x.t())


def test_transformer_training_step_launches_the_backward_kernels(cuda,
                                                                  monkeypatch):
    """One record/backward of a small TransformerLM on the card under
    ``auto``: T 16 takes K7a/K7b/K7c, T 12 K5a/K5b, both K6a/K6b per
    LayerNorm; the gradients agree within 1e-4 of each parameter's largest
    magnitude with the same step through plain torch (knobs 0,
    ``impl="einsum"``)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.contrib.transformer import TransformerLM
    from mxnet_tpu_torch.parallel import attention
    knobs = ("MXNET_PALLAS_NORM", "MXNET_PALLAS_SOFTMAX")
    mx.random.seed(0)
    lm = TransformerLM(32, units=64, hidden_size=128, num_layers=2,
                       num_heads=4, max_len=32)
    lm.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    lm.hybridize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = lm.collect_params()

    def grads(t):
        ids = np.random.RandomState(t).randint(0, 32, (2, t + 1))
        x = mx.nd.array(ids[:, :-1].astype(np.float32), ctx=mx.gpu(0))
        y = mx.nd.array(ids[:, 1:].astype(np.float32), ctx=mx.gpu(0))
        with mx.autograd.record():
            loss = loss_fn(lm(x).reshape((-1, 32)), y.reshape((-1,))).mean()
        loss.backward()
        return {n: p.grad()._data.clone() for n, p in params.items()}

    real = attention.local_attention
    for t, attn in ((16, ("flash_attention_fwd", "flash_attention_bwd_dq",
                          "flash_attention_bwd_dkv")),
                    (12, ("bias_softmax", "softmax_bwd"))):
        for knob in knobs:
            monkeypatch.delenv(knob, raising=False)
        ck.reset_kernel_calls()
        got = grads(t)
        torch.cuda.synchronize()
        want = dict.fromkeys(ck.kernel_calls(), 0)
        want.update(layernorm_fwd=5, layernorm_bwd=5)
        want.update(dict.fromkeys(attn, 2))
        assert ck.kernel_calls() == want
        for knob in knobs:
            monkeypatch.setenv(knob, "0")
        monkeypatch.setattr(attention, "local_attention",
                            lambda *a, **kw: real(*a, **dict(kw,
                                                             impl="einsum")))
        plain = grads(t)
        monkeypatch.undo()
        for n in got:
            assert got[n].abs().max() > 0, n
            assert _rel_err(got[n], plain[n]) <= 1e-4, n


def test_checkpoint_staging_is_ordered_before_the_next_step(cuda,
                                                            monkeypatch):
    """``TrainState.capture`` queues its copies to the host without
    waiting; a fused step launched right after it (whose sweep updates
    the weights and momentum in place) must not reach the snapshot: the
    staged values equal the weights and momentum read after a full
    synchronisation before that step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.checkpoint import TrainState
    monkeypatch.delenv("MXNET_PALLAS_FUSED_OPT", raising=False)
    ctx = mx.gpu(0)
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=1000, name="fc"), name="softmax")
    rng = np.random.RandomState(0)
    x = rng.randn(64, 4096).astype(np.float32)
    y = rng.randint(0, 1000, 64).astype(np.float32)
    with ctx:
        it = mx.io.NDArrayIter(x, y, batch_size=32)
    mod = mx.mod.Module(net, context=ctx)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(kvstore="tpu", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    assert mod._fused_exec_update
    batch = it.next()
    mod.forward_backward(batch)
    mod.update()
    torch.cuda.synchronize()
    exe = mod._exec_group.execs[0]
    want_w = exe.arg_dict["fc_weight"]._data.cpu().clone()
    want_m = exe.optimizer_slots()["fc_weight"][0].cpu().clone()
    state = TrainState.capture(mod)
    for _ in range(3):          # queued behind the copies, not waited for
        mod.forward_backward(batch)
        mod.update()
    state.wait()
    import pickle
    states, _opt = pickle.loads(bytes(state.optimizer_state))
    names = mod._exec_group.param_names
    got_m = states[names.index("fc_weight")]
    assert np.array_equal(state.arg_params["fc_weight"], want_w.numpy())
    assert np.array_equal(got_m, want_m.numpy())
    torch.cuda.synchronize()
    assert not torch.equal(exe.arg_dict["fc_weight"]._data.cpu(), want_w)



@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", ["sgd_sweep", "sgd_mom_sweep", "adam_sweep"])
def test_sweep_on_each_shard_equals_the_whole_bucket(cuda, name, n):
    """ParallelTrainer's ZeRO update: each rank sweeps its contiguous 1/n
    of a padded bucket.  The n shard launches, one after another, give
    the whole-bucket launch bit for bit, and the padded tail stays zero
    (phase 22 (a) at the LM's buckets)."""
    from mxnet_tpu_torch.parallel.collectives import build_bucket_plan
    plan = build_bucket_plan(["a", "b", "c"], [(1000, 3), (7,), (4097,)],
                             0, pad_multiple=n)
    (b,) = plan
    n_slots = {"sgd_sweep": 0, "sgd_mom_sweep": 1, "adam_sweep": 2}[name]
    gen = torch.Generator(device=cuda).manual_seed(22)
    bufs = [torch.randn(b.padded_n, generator=gen, device=cuda)
            for _ in range(2 + n_slots)]
    if n_slots == 2:
        bufs[3].abs_().mul_(0.01)
    for t in bufs:
        t[b.n:] = 0
    hyper = torch.tensor(chip_smoke.sweep_hyper(name, False),
                         dtype=torch.float32, device=cuda)
    whole = [t.clone() for t in bufs]
    parts = [t.clone() for t in bufs]
    getattr(ck, name)(whole[0], whole[1], *whole[2:], hyper)
    before = ck.kernel_calls()[name]
    s = b.padded_n // n
    for r in range(n):
        getattr(ck, name)(*[t[r * s:(r + 1) * s] for t in parts], hyper)
    torch.cuda.synchronize()
    assert ck.kernel_calls()[name] == before + n
    for got, want in zip(parts, whole):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert not got[b.n:].any()


@pytest.mark.parametrize("opt, params", [
    ("adam", {"learning_rate": 0.05}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9})])
def test_parallel_trainer_sweeps_its_buckets_on_the_card(cuda, opt, params):
    """A one-rank ParallelTrainer (no process group) at zero=2 on the
    card: one sweep launch per bucket a step, bitwise the plain sweep's
    step from the same state."""
    import os
    import mxnet_tpu_torch as mx
    case = {"net": "mlp", "opt": opt, "opt_params": params, "zero": 2,
            "width": 1, "steps": 1}
    kernel = "adam_sweep" if opt == "adam" else "sgd_mom_sweep"
    with mx.gpu(0):
        tr = chip_smoke.par_case_trainer(mx, case, ctx=mx.gpu(0))
        x, y = chip_smoke.par_data()
        x, y = mx.nd.array(x), mx.nd.array(y)
        state = tr.state_dict()
        before = ck.kernel_calls()[kernel]
        tr.step(x, y)
        torch.cuda.synchronize()
        assert ck.kernel_calls()[kernel] == before + len(tr.bucket_plan)
        got = {k: v.clone() for k, v in tr.params.items()}
        tr.load_state_dict(state)
        old = os.environ.get("MXNET_PALLAS_FUSED_OPT")
        os.environ["MXNET_PALLAS_FUSED_OPT"] = "0"
        try:
            tr.step(x, y)
        finally:
            if old is None:
                os.environ.pop("MXNET_PALLAS_FUSED_OPT")
            else:
                os.environ["MXNET_PALLAS_FUSED_OPT"] = old
        torch.cuda.synchronize()
        for k, v in tr.params.items():
            assert torch.equal(v, got[k]), k
