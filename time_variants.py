#!/usr/bin/env python3
"""Time textual variants of ``softmax.cu``'s K5a and K5b against the source
as it stands, on one NVIDIA GPU::

    python3 time_variants.py

Each variant is ``mxnet_tpu_torch/ops/csrc/softmax.cu`` with a few lines
replaced, compiled with the flags of ``ops/_build.py`` into
``mxnet_tpu_torch/_build/variants/`` (one ``nvcc`` each, all at once) and
called through ``ctypes`` at the C entry points the wrappers call.  Every
variant is first held to the plain versions (K5a and K2 on the same x
within 1e-6, K5b within 1e-5 of the largest |dx|), then timed by CUDA
events (``chip_smoke.time_ms``: the mean of 20 back-to-back launches,
median of 5) at the transformer's (96, 1020, 1020) fp32 shape with the
causal bias, in turns: the source as it stands, each variant, the source
again, beside ``torch.softmax(x + bias)``, ``torch._softmax_backward_data``
and ``torch.softmax(x)``.  Prints the compiler's register count of the
main-path instances and the card's name and power limit.
"""
import ctypes
import os
import re
import subprocess
import sys

import torch

import chip_smoke

# name -> [(text of softmax.cu, its replacement)]
VARIANTS = {
    "K5a: x and y without streaming hints": [
        ("load_row<T, N, VEC, TH, true>(", "load_row<T, N, VEC, TH>("),
        ("softmax_regs_finish<T, N, VEC, W, true>(",
         "softmax_regs_finish<T, N, VEC, W>(")],
    "K2 and K5b with streaming hints too": [
        ("template <typename T, int VEC, bool STREAM = false>",
         "template <typename T, int VEC, bool STREAM = true>")],
    "eight rows a block": [
        ("constexpr int kRowsPerBlock = 4;",
         "constexpr int kRowsPerBlock = 8;")],
}
# the main path's instances, by their mangled names
MAIN = ("bias_softmax_regs_kernelIfLi32ELi4ELi1E",
        "softmax_bwd_regs_kernelIfLi32ELi4E")


def compile_all(texts, out_dir):
    """Compile each of ``texts`` as ``softmax_v<k>.cu``, one ``nvcc`` each,
    all started together; returns ``[(loaded library, ptxas register
    lines of the main-path instances)]``."""
    from mxnet_tpu_torch.ops import _build
    procs = []
    for k, text in enumerate(texts):
        src = os.path.join(out_dir, "softmax_v%d.cu" % k)
        so = os.path.join(out_dir, "libsoftmax_v%d.so" % k)
        with open(src, "w") as f:
            f.write(text)
        procs.append((so, subprocess.Popen(
            [_build.nvcc_path()] + _build.FLAGS + ["-Xptxas", "-v", "-o", so,
                                                   src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = []
    for so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("nvcc failed on %s:\n%s" % (so, log))
        regs, entry = [], None
        for line in log.splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif "Used" in line and entry and any(k in entry for k in MAIN):
                regs.append("%s: %s" % (next(k for k in MAIN if k in entry),
                                        line.split(":", 1)[1].strip()))
        lib = ctypes.CDLL(so)
        lib.mxtt_bias_softmax.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p]
        lib.mxtt_softmax_bwd.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int64] * 2 + [ctypes.c_int, ctypes.c_void_p]
        lib.mxtt_softmax_lastaxis.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int64] * 2 + [ctypes.c_int, ctypes.c_void_p]
        out.append((lib, regs))
    return out


def entry_points(lib, x, bias, p, do):
    """K5a, K5b and K2 (on x, no bias) of ``lib`` as calls on the current
    stream."""
    rows, (r, c) = x.numel() // x.shape[-1], bias.shape

    def k5a():
        y = torch.empty_like(x)
        rc = lib.mxtt_bias_softmax(x.data_ptr(), bias.data_ptr(),
                                   y.data_ptr(), rows, r, c, 0,
                                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("K5a launch failed: %d" % rc)
        return y

    def k5b():
        dx = torch.empty_like(p)
        rc = lib.mxtt_softmax_bwd(p.data_ptr(), do.data_ptr(), dx.data_ptr(),
                                  rows, c, 0,
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("K5b launch failed: %d" % rc)
        return dx

    def k2():
        y = torch.empty_like(x)
        rc = lib.mxtt_softmax_lastaxis(x.data_ptr(), y.data_ptr(), rows, c, 0,
                                       torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("K2 launch failed: %d" % rc)
        return y
    return k5a, k5b, k2


def main():
    if not torch.cuda.is_available():
        print("time_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    bw, flops, _ = chip_smoke.card_rates(torch.cuda.get_device_name(0))
    bh, t = chip_smoke.LM_BATCH * chip_smoke.GPT2_SMALL["num_heads"], \
        chip_smoke.LM_T[1]
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    bias = chip_smoke.causal_bias(t, dev)
    x = torch.randn((bh, t, t), generator=gen, device=dev) * 3
    p = ck.bias_softmax_ref(x, bias)
    do = torch.randn((bh, t, t), generator=gen, device=dev)
    ref_y, ref_dx = p, ck.softmax_bwd_ref(p, do)
    ref_k2 = ck.softmax_lastaxis_ref(x)

    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC, "softmax.cu")) as f:
        source = f.read()
    runs = [("as it stands", source)]
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise AssertionError("variant %r: %r not in softmax.cu"
                                     % (name, old))
            text = text.replace(old, new)
        runs.append((name, text))
    runs.append(("as it stands, again", source))

    print("card: %s" % smi, flush=True)
    bound_a = chip_smoke.bound_ms(2 * x.numel() * 4 + bias.numel() * 4,
                                  5 * x.numel(), bw, flops)[0]
    bound_b = chip_smoke.bound_ms(3 * p.numel() * 4, 4 * p.numel(), bw,
                                  flops)[0]
    lib_a = chip_smoke.time_ms(lambda: torch.softmax(x + bias, -1))
    lib_b = chip_smoke.time_ms(
        lambda: torch._softmax_backward_data(do, p, -1, p.dtype))
    print("(%d, %d, %d) fp32 causal; bounds (bytes): K5a %.4f ms, K5b %.4f "
          "ms; torch.softmax(x + bias) %.4f ms, _softmax_backward_data %.4f "
          "ms, torch.softmax(x) %.4f ms" % (
              bh, t, t, bound_a, bound_b, lib_a, lib_b,
              chip_smoke.time_ms(lambda: torch.softmax(x, -1))), flush=True)
    # the source as it stands is built once and timed first and last
    libs = compile_all([text for _, text in runs[:-1]], out_dir)
    for (name, _), (lib, regs) in zip(runs, libs + libs[:1]):
        k5a, k5b, k2 = entry_points(lib, x, bias, p, do)
        err_a = (k5a() - ref_y).abs().max().item()
        err_b = chip_smoke.rel_err(k5b(), ref_dx)
        err_2 = (k2() - ref_k2).abs().max().item()
        if not (err_a <= 1e-6 and err_b <= 1e-5 and err_2 <= 1e-6):
            raise AssertionError("%s: K5a max |d| %g, K5b %g of the largest, "
                                 "K2 %g" % (name, err_a, err_b, err_2))
        ms_a, ms_b = chip_smoke.time_ms(k5a), chip_smoke.time_ms(k5b)
        print("%-62s K5a %.4f ms (%.0f%% of its bound), K5b %.4f ms (%.0f%%),"
              " K2 on x %.4f ms; %s" % (
                  name, ms_a, 100 * bound_a / ms_a, ms_b, 100 * bound_b / ms_b,
                  chip_smoke.time_ms(k2), "; ".join(regs)), flush=True)
    print("card: %s" % smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
