"""Gradient compression with error feedback — the shared codec layer.

Counterpart of ``mxnet_tpu/gradient_compression.py`` (reference:
``src/kvstore/gradient_compression.cc:52``): each gradient element plus
its residual is quantized, and the quantization error feeds back into
the next step's residual, so the compressed stream is unbiased over
time.  The same codecs serve the three call sites of the JAX package:
the kvstore push path (:class:`GradientCompression`), the executor's
fused step (``install_fused_update(compression_params=...)``) and
``ParallelTrainer``'s bucket reductions.

Codecs:

- ``2bit`` — the reference quantizer: {-t, 0, +t}, 16 codes packed into
  each uint32 word (code 1 = +t, 2 = -t, element ``i`` of a word at bits
  ``2i``), the JAX package's payload bit for bit; torch has no uint32
  arithmetic, so the words are built in int64 and stored as uint32;
- ``bf16`` / ``fp8`` — cast codecs (2x / 4x).  The fp8 cast saturates
  at +-448, as torch's does; the JAX package's (ml_dtypes) gives NaN
  from 464 up, which the error feedback cannot repair (ROADMAP queue 3).

Every codec carries the residual: ``decode(encode(g + r))`` plus
``r' = g + r - decoded``.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["GradientCompression", "make_codec", "TwoBitCodec", "CastCodec"]


def _shifts(device):
    return (2 * torch.arange(16, dtype=torch.int64, device=device))[None, :]


def _quantize_2bit(grad, residual, threshold):
    g = grad + residual
    code = torch.where(g >= threshold, 1, torch.where(g <= -threshold, 2, 0))
    value = torch.where(code == 1, threshold,
                        torch.where(code == 2, -threshold, 0.0))
    new_residual = g - value
    flat = code.reshape(-1).to(torch.int64)
    pad = (-flat.numel()) % 16
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    words = (flat.reshape(-1, 16) << _shifts(flat.device)).sum(dim=1)
    return words.to(torch.uint32), new_residual


def _dequantize_2bit(packed, shape, threshold):
    n = 1
    for s in shape:
        n *= int(s)
    codes = (packed.to(torch.int64)[:, None] >> _shifts(packed.device)) & 3
    codes = codes.reshape(-1)[:n].reshape(shape)
    return torch.where(codes == 1, threshold,
                       torch.where(codes == 2, -threshold, 0.0)).to(
                           torch.float32)


class TwoBitCodec:
    """The reference 2-bit quantizer as a codec (16x fp32)."""

    name = "2bit"

    def __init__(self, threshold=0.5):
        self.threshold = float(threshold)

    def _t(self, like):
        return torch.tensor(self.threshold, dtype=torch.float32,
                            device=like.device)

    def encode(self, grad, residual):
        """``(grad, residual) -> (payload, decoded, new_residual)``."""
        t = self._t(grad)
        packed, new_residual = _quantize_2bit(grad.to(torch.float32),
                                              residual, t)
        decoded = _dequantize_2bit(packed, tuple(grad.shape), t)
        return packed, decoded, new_residual

    def decode(self, payload, shape):
        return _dequantize_2bit(payload, tuple(shape), self._t(payload))

    def roundtrip(self, grad, residual):
        """``(decoded, new_residual)`` — the end-to-end transform a
        gradient undergoes on a compressed exchange."""
        _, decoded, new_residual = self.encode(grad, residual)
        return decoded, new_residual

    def wire_bytes(self, n_elems):
        """Modeled on-wire payload bytes for ``n_elems`` gradients."""
        return 4 * ((int(n_elems) + 15) // 16)

    def get_params(self):
        return {"type": self.name, "threshold": self.threshold}


class CastCodec:
    """bf16/fp8 cast codec with error feedback: the payload is a tensor
    of the wire dtype."""

    def __init__(self, name, dtype):
        self.name = name
        self.dtype = dtype

    def encode(self, grad, residual):
        g = grad.to(torch.float32) + residual
        payload = g.to(self.dtype)
        decoded = payload.to(torch.float32)
        return payload, decoded, g - decoded

    def decode(self, payload, shape):
        return payload.to(torch.float32).reshape(tuple(shape))

    def roundtrip(self, grad, residual):
        _, decoded, new_residual = self.encode(grad, residual)
        return decoded, new_residual

    def wire_bytes(self, n_elems):
        return int(n_elems) * torch.empty((), dtype=self.dtype).element_size()

    def get_params(self):
        return {"type": self.name}


def make_codec(type="2bit", threshold=0.5):
    """Codec by name — the one registry every compression call site
    (kvstore push, fused executor step, ParallelTrainer buckets) shares."""
    if type in (None, "", "none"):
        return None
    if type == "2bit":
        return TwoBitCodec(threshold=threshold)
    if type in ("bf16", "bfloat16"):
        return CastCodec("bf16", torch.bfloat16)
    if type == "fp8":
        return CastCodec("fp8", torch.float8_e4m3fn)
    raise MXNetError("unknown gradient compression type %r "
                     "(supported: 2bit, bf16, fp8)" % (type,))


class GradientCompression:
    """Per-key stateful compressor over the shared codecs (reference:
    GradientCompression::Quantize/Dequantize): residuals are keyed by
    parameter name and carried across pushes."""

    def __init__(self, type="2bit", threshold=0.5):
        self._codec = make_codec(type, threshold=threshold)
        if self._codec is None:
            raise ValueError("GradientCompression needs a codec type, "
                             "got %r" % (type,))
        self.type = self._codec.name
        self.threshold = float(threshold)
        self._residual = {}

    @property
    def codec(self):
        return self._codec

    def get_params(self):
        return self._codec.get_params()

    def _res(self, key, grad):
        res = self._residual.get(key)
        if res is None or res.shape != grad.shape \
                or res.device != grad.device:
            res = torch.zeros(grad.shape, dtype=torch.float32,
                              device=grad.device)
        return res

    def compress(self, key, grad):
        """grad (tensor) -> wire payload; the residual updates."""
        payload, _, new_res = self._codec.encode(
            grad.to(torch.float32), self._res(key, grad))
        self._residual[key] = new_res
        return payload

    def decompress(self, packed, shape):
        return self._codec.decode(packed, shape)

    def compress_decompress(self, key, grad):
        """The end-to-end transform a worker's gradient undergoes."""
        decoded, new_res = self._codec.roundtrip(grad.to(torch.float32),
                                                 self._res(key, grad))
        self._residual[key] = new_res
        return decoded
