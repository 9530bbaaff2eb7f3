"""What of the JAX package's operator library the port holds: its registry
holds every JAX op name but the ones left for later, listed here by the
queue of ROADMAP.md that owns them, and no name the JAX registry lacks;
every name this slice added is exercised by ``chip_smoke.OP_CASES`` or
the samplers' sweep; the new modules import neither JAX nor the JAX
package.  Each later slice shrinks DEFERRED.
"""
import os
import subprocess
import sys

import mxnet_tpu  # noqa: F401  (registers the JAX package's ops)
import mxnet_tpu_torch  # noqa: F401
from mxnet_tpu.ops.registry import _OP_REGISTRY as JAX_OPS
from mxnet_tpu_torch.ops.registry import _OP_REGISTRY as PORT_OPS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

DEFERRED = {
    # quantization (queue 1 item 8)
    "_contrib_quantize", "_contrib_quantize_v2", "_contrib_dequantize",
    "_contrib_requantize", "_contrib_quantized_conv",
    "_contrib_quantized_flatten", "_contrib_quantized_fully_connected",
    "_contrib_quantized_pooling",
    # CTC (queue 1 item 8)
    "CTCLoss", "_contrib_CTCLoss", "_contrib_ctc_loss", "ctc_loss",
    # the spatial-transformer family (queue 1 item 8)
    "BilinearSampler", "GridGenerator", "SpatialTransformer", "Correlation",
}

# the 71 names the port held before the operator library
EARLIER = {
    "Activation", "BatchNorm", "BatchNorm_v1", "Convolution",
    "Convolution_v1", "Dropout", "Embedding", "Flatten", "FullyConnected",
    "LayerNorm", "Pooling", "Pooling_v1", "Reshape", "Softmax",
    "SoftmaxOutput", "_Div", "_DivScalar", "_Minus", "_MinusScalar", "_Mul",
    "_MulScalar", "_Plus", "_PlusScalar", "_Power", "_PowerScalar",
    "_RDivScalar", "_RMinusScalar", "_RPowerScalar", "_add", "_arange",
    "_contrib_flash_attention", "_div", "_div_scalar", "_minus",
    "_minus_scalar", "_mul", "_mul_scalar", "_plus", "_plus_scalar",
    "_power", "_power_scalar", "_rdiv_scalar", "_rminus_scalar",
    "_rpower_scalar", "_sub", "abs", "broadcast_add", "broadcast_div",
    "broadcast_minus", "broadcast_mul", "broadcast_plus", "broadcast_power",
    "broadcast_sub", "elemwise_add", "elemwise_div", "elemwise_mul",
    "elemwise_sub", "exp", "expand_dims", "flatten", "log", "log_softmax",
    "mean", "negative", "pick", "pow", "reshape", "slice_like", "square",
    "sum", "sum_axis",
}


def test_the_port_holds_every_jax_op_but_the_deferred_ones():
    assert len(DEFERRED) == 16
    assert set(JAX_OPS) - set(PORT_OPS) == DEFERRED
    assert set(PORT_OPS) - set(JAX_OPS) == set()
    assert len(PORT_OPS) == len(JAX_OPS) - 16


def test_every_name_of_the_slice_is_exercised():
    new = set(PORT_OPS) - EARLIER
    assert len(new) == 297
    cased = {c["name"] for c in chip_smoke.OP_CASES}
    # LeakyReLU (rrelu), Dropout and RNN (between its layers) draw a
    # mask; they are not samplers
    samplers = {n for n in new if PORT_OPS[n].needs_rng
                and PORT_OPS[n].name not in ("LeakyReLU", "Dropout", "RNN")}
    assert new - cased - samplers == set()
    # the sweep runs every sampler name (random_sweep's alias loop, its
    # _like, multinomial and shuffle calls)
    assert len(samplers) == 44


def test_new_modules_import_neither_jax_nor_the_jax_package():
    mods = ("mxnet_tpu_torch.ops.constraints", "mxnet_tpu_torch.ops.misc",
            "mxnet_tpu_torch.ops.contrib",
            "mxnet_tpu_torch.ops.random_ops", "mxnet_tpu_torch.attribute",
            "mxnet_tpu_torch.ndarray.random", "mxnet_tpu_torch.ndarray.linalg",
            "mxnet_tpu_torch.ndarray.utils", "mxnet_tpu_torch.symbol.random",
            "mxnet_tpu_torch.symbol.linalg", "mxnet_tpu_torch.symbol.contrib",
            "mxnet_tpu_torch.symbols.inception_bn", "chip_smoke")
    code = ("import sys, importlib\n"
            "sys.path.insert(0, %r)\n"
            "for m in %r: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')))" % (REPO, mods))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
