#!/usr/bin/env python3
"""Time textual variants of a kernel source against the source as it
stands, on one NVIDIA GPU::

    python3 time_variants.py              # softmax.cu: K5a, K5b (and K2)
    python3 time_variants.py layernorm    # layernorm.cu: K6b
    python3 time_variants.py flash        # flash_attention.cu: bf16 K7a-K7c
    python3 time_variants.py flash K7b    # ... only the variants named K7b*
    python3 time_variants.py flash_band   # phase 15's band over seeds

Each variant is ``mxnet_tpu_torch/ops/csrc/<source>.cu`` with a few lines
replaced, compiled with the flags of ``ops/_build.py`` into
``mxnet_tpu_torch/_build/variants/`` (one ``nvcc`` each, all at once) and
called through ``ctypes`` at the C entry points the wrappers call.  Every
variant is first held to the plain versions, then timed by CUDA events
(``chip_smoke.time_ms``: the mean of 20 back-to-back launches, median of
5) in turns: the source as it stands, each variant, the source again.

``softmax.cu``: K5a and K2 on the same x within 1e-6, K5b within 1e-5 of
the largest |dx|, timed at the transformer's (96, 1020, 1020) fp32 shape
with the causal bias, beside ``torch.softmax(x + bias)``,
``torch._softmax_backward_data`` and ``torch.softmax(x)``.

``layernorm.cu``: K6b within 1e-5 of the largest |dx| (fp32) and one
rounding (bf16) at ``chip_smoke.K6B_EDGE`` and at the training step's
(8192, 768), timed there in fp32 and bf16, each run beside aten's
dx-only ``native_layer_norm_backward`` on the same operands: back to back
(the L2 cache keeps what fits of the last launch's operands) and each
launch after the L2 cache is overwritten (``chip_smoke.time_cold_ms``).

``flash_attention.cu``: the bf16 instances of K7a, K7b and K7c on the
bf16 tensor cores, o within ``chip_smoke.bf16_attention_close`` and lse
within 1e-5, dq, dk and dv within ``chip_smoke._bf16_bwd_close`` of the
plain versions at ``FLASH_EDGE`` and at the training step's (96, 1024,
64) causal, timed there beside SDPA's bf16 forward and backward; at that
shape each variant's o is also held to an fp64 attention of the same
bf16 operands (mean |error|, and the share of o's elements that differ
from the source's), and each runs phase 15's gradient check
(``chip_smoke.bf16_grad_check``: the bf16 GPT-2-small-width transformer's
step against the knobs-0 step, in units of its band).

``flash_band``: no timing; phase 15's gradient check at each of
``BAND_SEEDS`` (the transformer's weights and its batch from the seed)
with K7b's bf16 instance three ways: the source as it stands (bf16
``mma.sync``), the older TF32 code in its place (``flash_bwd_dq_kernel``,
the variant ``K7B_TF32``), and K7b's plain version in its place (K7a,
K7c and the rest the source's), so that the spread of the band's
readings over seeds shows which differences it can tell apart.

Prints the compiler's register count of the main-path instances and the
card's name and power limit.
"""
import ctypes
import os
import re
import subprocess
import sys

import torch

import chip_smoke

# name -> [(text of softmax.cu, its replacement)]
SOFTMAX_VARIANTS = {
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
SOFTMAX_MAIN = ("bias_softmax_regs_kernelIfLi32ELi4ELi1E",
                "softmax_bwd_regs_kernelIfLi32ELi4E")
# name -> [(text of layernorm.cu, its replacement)]
LAYERNORM_VARIANTS = {
    "K6b: the grid as wide as fits (a last round of a few warps)": [
        ("    const int64_t blocks = (need + rounds - 1) / rounds;",
         "    const int64_t blocks = need < fit ? need : fit;")],
    "K6b: eight warps a block": [
        ("constexpr int kBwdWarps = 4;", "constexpr int kBwdWarps = 8;")],
    "K6b: x and do read as streaming in bf16 too": [
        ("constexpr bool kStreamIn = sizeof(T) == 4;",
         "constexpr bool kStreamIn = true;")],
    "K6b: x and do read without streaming hints in fp32 too": [
        ("constexpr bool kStreamIn = sizeof(T) == 4;",
         "constexpr bool kStreamIn = false;")],
    "K6b: dx written without streaming hints": [
        ("__stcs(reinterpret_cast<uint4*>(p), raw);",
         "*reinterpret_cast<uint4*>(p) = raw;")],
}
# K6b's main-path instances: fp32 at C 768 (6 chunks), bf16 (3 chunks)
LAYERNORM_MAIN = ("layernorm_bwd_regs_kernelIfLi6E",
                  "layernorm_bwd_regs_kernelI13__nv_bfloat16Li3E")
# K7b's bf16 instance on the TF32 code that ran it before the bf16
# tensor-core kernel (flash_bwd_dq_kernel<bf16, DP, false>)
K7B_TF32 = "K7b bf16: the older TF32 code (flash_bwd_dq_kernel)"
# name -> [(text of flash_attention.cu, its replacement)]
FLASH_VARIANTS = {
    "K7a bf16: the fast __expf": [
        ("        alpha[i] = expf(m[i] - m_new);",
         "        alpha[i] = __expf(m[i] - m_new);"),
        ("          const float p = expf(s[n][e] - m[e >> 1]);",
         "          const float p = __expf(s[n][e] - m[e >> 1]);")],
    "K7a bf16: 4 warps (64 query rows) a block at D 64": [
        ("  static constexpr int WARPS = DP <= 64 ? 8 : 4;",
         "  static constexpr int WARPS = 4;")],
    "K7a bf16: one block's registers an SM at D 64": [
        ("  static constexpr int MIN_BLOCKS = DP <= 64 ? 2 : 1;",
         "  static constexpr int MIN_BLOCKS = 1;")],
    "K7a bf16: 128 keys a step at D 64": [
        ("  static constexpr int BK = DP <= 128 ? 64 : 32;",
         "  static constexpr int BK = DP <= 64 ? 128 : DP <= 128 ? 64 : 32;"),
        ("  static constexpr int MIN_BLOCKS = DP <= 64 ? 2 : 1;",
         "  static constexpr int MIN_BLOCKS = 1;")],
    K7B_TF32: [
        ("  if (which == 1) {\n"
         "    if constexpr (std::is_same<T, bf16>::value && !WIDE) {",
         "  if (which == 1) {\n"
         "    if constexpr (false) {")],
    "K7b bf16: one block's registers an SM at D 64": [
        ("  static constexpr int MIN_BLOCKS_DQ = DP <= 64 ? 4 : 1;",
         "  static constexpr int MIN_BLOCKS_DQ = 1;")],
    "K7b bf16: registers for three blocks an SM at D 64": [
        ("  static constexpr int MIN_BLOCKS_DQ = DP <= 64 ? 4 : 1;",
         "  static constexpr int MIN_BLOCKS_DQ = DP <= 64 ? 3 : 1;")],
    "K7b bf16: Q and dO fragments held in registers at D 64": [
        ("  const int bno = bn_offset<S>(lane), "
         "bto = a_offset<S>(lane) + col0;\n"
         "  for (int j = 0; j < nt; ++j) {\n"
         "    const int k0 = j * B;",
         "  const int bno = bn_offset<S>(lane), "
         "bto = a_offset<S>(lane) + col0;\n"
         "  uint32_t qf[DP <= 64 ? DP / 16 : 1][4], "
         "gf[DP <= 64 ? DP / 16 : 1][4];\n"
         "  if constexpr (DP <= 64) {\n"
         "    cp_async_wait<0>();\n"
         "    __syncthreads();\n"
         "#pragma unroll\n"
         "    for (int kc = 0; kc < DP / 16; ++kc) {\n"
         "      ldsm_x4(qf[kc], Qs + ao + 16 * kc);\n"
         "      ldsm_x4(gf[kc], Gs + ao + 16 * kc);\n"
         "    }\n"
         "  }\n"
         "  for (int j = 0; j < nt; ++j) {\n"
         "    const int k0 = j * B;"),
        ("    rows_mma<NB, DP, S>(s, Qs + ao, Kj + bno);\n"
         "    rows_mma<NB, DP, S>(dp, Gs + ao, Vj + bno);",
         "    if constexpr (DP <= 64) {\n"
         "#pragma unroll\n"
         "      for (int kc = 0; kc < DP / 16; ++kc)\n"
         "#pragma unroll\n"
         "        for (int n = 0; n < NB; n += 2) {\n"
         "          uint32_t b[4];\n"
         "          ldsm_x4(b, Kj + bno + n * 8 * S + 16 * kc);\n"
         "          mma_bf16(s[n], qf[kc], b[0], b[1]);\n"
         "          mma_bf16(s[n + 1], qf[kc], b[2], b[3]);\n"
         "        }\n"
         "#pragma unroll\n"
         "      for (int kc = 0; kc < DP / 16; ++kc)\n"
         "#pragma unroll\n"
         "        for (int n = 0; n < NB; n += 2) {\n"
         "          uint32_t b[4];\n"
         "          ldsm_x4(b, Vj + bno + n * 8 * S + 16 * kc);\n"
         "          mma_bf16(dp[n], gf[kc], b[0], b[1]);\n"
         "          mma_bf16(dp[n + 1], gf[kc], b[2], b[3]);\n"
         "        }\n"
         "    } else {\n"
         "      rows_mma<NB, DP, S>(s, Qs + ao, Kj + bno);\n"
         "      rows_mma<NB, DP, S>(dp, Gs + ao, Vj + bno);\n"
         "    }")],
    "K7c bf16: registers for two blocks an SM at D 64 (214, no stack)": [
        ("  static constexpr int MIN_BLOCKS = DP <= 64 ? 3 : 1;",
         "  static constexpr int MIN_BLOCKS = 1;")],
    "K7c bf16: 32-row tiles at D 64 (8 warps: 4 a tile's rows, 2 columns)": [
        ("struct BwdBf16Tile {\n"
         "  static constexpr int B = DP <= 64 ? 64 : 32;\n"
         "  static constexpr int NS = DP <= 64 ? 1 : DP <= 128 ? 2 : 4;",
         "struct BwdBf16Tile {\n"
         "  static constexpr int B = 32;\n"
         "  static constexpr int NS = DP <= 32 ? 1 : DP <= 128 ? 2 : 4;")],
}
# the seeds of the transformer's weights and batch that flash_band reads
# phase 15's gradient check at
BAND_SEEDS = (0, 1, 2, 3, 4)
# the bf16 D-64 instances of K7a, K7b and K7c
FLASH_MAIN = ("flash_fwd_bf16_kernelILi64E", "flash_bwd_dq_bf16_kernelILi64E",
              "flash_bwd_dkv_bf16_kernelILi64E")
# (BH, Tq, Tk, D, causal) that each variant is held to its plain versions
# at besides the main shape: ragged tiles, Tq != Tk, the D-128 and D-256
# instances
FLASH_EDGE = ((4, 129, 129, 64, True), (4, 1000, 1000, 64, False),
              (4, 40, 72, 64, True), (4, 72, 40, 64, False),
              (4, 200, 200, 128, True), (4, 200, 200, 256, False))


def compile_all(source, texts, out_dir, main, argtypes):
    """Compile each of ``texts`` as ``<source>_v<k>.cu``, one ``nvcc``
    each, all started together; returns ``[(loaded library, ptxas
    register lines of the instances named in main)]``, with ``argtypes``
    ({C function: argtypes}) set on each library."""
    from mxnet_tpu_torch.ops import _build
    procs = []
    for k, text in enumerate(texts):
        src = os.path.join(out_dir, "%s_v%d.cu" % (source, k))
        so = os.path.join(out_dir, "lib%s_v%d.so" % (source, k))
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
            elif "Used" in line and entry and any(k in entry for k in main):
                regs.append("%s: %s" % (next(k for k in main if k in entry),
                                        line.split(":", 1)[1].strip()))
        lib = ctypes.CDLL(so)
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
        out.append((lib, regs))
    return out


SOFTMAX_ARGTYPES = {
    "mxtt_bias_softmax": [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
    + [ctypes.c_int, ctypes.c_void_p],
    "mxtt_softmax_bwd": [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
    + [ctypes.c_int, ctypes.c_void_p],
    "mxtt_softmax_lastaxis": [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2
    + [ctypes.c_int, ctypes.c_void_p]}
LAYERNORM_ARGTYPES = {
    "mxtt_layernorm_bwd": [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}
FLASH_ARGTYPES = {
    "mxtt_flash_attention_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int64]
    + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p],
    "mxtt_flash_attention_bwd_dq": [ctypes.c_void_p] * 7 + [ctypes.c_int64]
    + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p],
    "mxtt_flash_attention_bwd_dkv": [ctypes.c_void_p] * 8 + [ctypes.c_int64]
    + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p]}


def variant_texts(source, variants):
    """[(name, text)]: the source as it stands, each variant, and the
    source again; a variant's text must be found in the source."""
    from mxnet_tpu_torch.ops import _build
    with open(os.path.join(_build.CSRC, source + ".cu")) as f:
        text0 = f.read()
    runs = [("as it stands", text0)]
    for name, edits in variants.items():
        text = text0
        for old, new in edits:
            if old not in text:
                raise AssertionError("variant %r: %r not in %s.cu"
                                     % (name, old, source))
            text = text.replace(old, new)
        runs.append((name, text))
    runs.append(("as it stands, again", text0))
    return runs


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


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def softmax_main(smi, dev, bw, flops, out_dir):
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    bh, t = chip_smoke.LM_BATCH * chip_smoke.GPT2_SMALL["num_heads"], \
        chip_smoke.LM_T[1]
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    bias = chip_smoke.causal_bias(t, dev)
    x = torch.randn((bh, t, t), generator=gen, device=dev) * 3
    p = ck.bias_softmax_ref(x, bias)
    do = torch.randn((bh, t, t), generator=gen, device=dev)
    ref_y, ref_dx = p, ck.softmax_bwd_ref(p, do)
    ref_k2 = ck.softmax_lastaxis_ref(x)
    runs = variant_texts("softmax", SOFTMAX_VARIANTS)

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
    libs = compile_all("softmax", [text for _, text in runs[:-1]], out_dir,
                       SOFTMAX_MAIN, SOFTMAX_ARGTYPES)
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


def layernorm_bwd_call(lib, x, do, g, mu, rstd):
    """K6b of ``lib`` on these operands as a call on the current stream."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    c = x.shape[-1]

    def k6b():
        dx = torch.empty_like(x)
        rc = lib.mxtt_layernorm_bwd(
            x.data_ptr(), do.data_ptr(), g.data_ptr(), mu.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), x.numel() // c, c,
            ck._DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("K6b launch failed: %d" % rc)
        return dx
    return k6b


def layernorm_main(smi, dev, bw, flops, out_dir):
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    runs = variant_texts("layernorm", LAYERNORM_VARIANTS)
    libs = compile_all("layernorm", [text for _, text in runs[:-1]], out_dir,
                       LAYERNORM_MAIN, LAYERNORM_ARGTYPES)
    rows, cols = chip_smoke.LM_BATCH * chip_smoke.LM_T[0], \
        chip_smoke.GPT2_SMALL["units"]
    main = {}
    for dt in (torch.float32, torch.bfloat16):
        ops = chip_smoke.k6b_operands(dev, (rows, cols), dt, chip_smoke.SEED)
        x, do, g, mu, rstd = ops
        lib_fn = chip_smoke.aten_layernorm_dx(x, do, g)
        nbytes = 3 * x.numel() * x.element_size() + cols * 4 + 2 * rows * 4
        main[dt] = (ops, lib_fn,
                    chip_smoke.bound_ms(nbytes, 10 * x.numel(), bw, flops)[0])
        print("(%d, %d) %s: bound (bytes) %.5f ms" % (
            rows, cols, str(dt)[6:], main[dt][2]), flush=True)
    for (name, _), (lib, regs) in zip(runs, libs + libs[:1]):
        for shape, dt, off in chip_smoke.K6B_EDGE:
            x, do, g, mu, rstd = chip_smoke.k6b_operands(
                dev, shape, dt, chip_smoke.SEED + 11, off)
            dx = layernorm_bwd_call(lib, x, do, g, mu, rstd)()
            ok, err = chip_smoke.k6b_close(dx, ck.layernorm_bwd_ref(
                x, do, g, mu, rstd))
            if not ok:
                raise AssertionError("%s: K6b at %s %s offset %d: %g of the "
                                     "largest" % (name, shape, dt, off, err))
        line = []
        for dt, ((x, do, g, mu, rstd), lib_fn, bms) in main.items():
            k6b = layernorm_bwd_call(lib, x, do, g, mu, rstd)
            ms, lib_ms = chip_smoke.time_ms(k6b), chip_smoke.time_ms(lib_fn)
            cold = chip_smoke.time_cold_ms(k6b, dev)
            lib_cold = chip_smoke.time_cold_ms(lib_fn, dev)
            line.append("%s %.5f ms (%.0f%% of its bound), aten %.5f ms; "
                        "L2 flushed: %.5f ms (%.0f%%), aten %.5f ms" % (
                            str(dt)[6:], ms, 100 * bms / ms, lib_ms, cold,
                            100 * bms / cold, lib_cold))
        print("%-44s K6b %s; %s" % (name, "; ".join(line), "; ".join(regs)),
              flush=True)


def flash_calls(lib, q, k, v, do, lse, delta, causal):
    """K7a, K7b and K7c of ``lib`` on bf16 operands as calls on the
    current stream."""
    bh, tq, d = q.shape
    tk, scale = k.shape[1], d ** -0.5

    def k7a():
        o = torch.empty_like(q)
        out_lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
        rc = lib.mxtt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            out_lse.data_ptr(), bh, tq, tk, d, scale, int(causal), 1,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("K7a launch failed: %d" % rc)
        return o, out_lse

    def k7b():
        dq = torch.empty_like(q)
        rc = lib.mxtt_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, tq, tk, d,
            scale, int(causal), 1, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("K7b launch failed: %d" % rc)
        return dq

    def k7c():
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        rc = lib.mxtt_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, tq, tk, d, scale, int(causal), 1,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("K7c launch failed: %d" % rc)
        return dk, dv
    return k7a, k7b, k7c


def fp64_attention(q, k, v, causal):
    """Softmax attention of bf16 (BH, T, D) operands in float64, p
    unrounded: what K7a's o approximates."""
    s = torch.matmul(q.double(), k.double().transpose(1, 2)) \
        * q.shape[-1] ** -0.5
    if causal:
        keep = torch.ones(s.shape[1:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.matmul(torch.softmax(s, -1), v.double())


def grad_check_with(lib, seed=chip_smoke.SEED, plain=()):
    """Phase 15's gradient check (``chip_smoke.bf16_grad_check``) with
    the flash wrappers bound to ``lib``'s entry points, the transformer's
    weights and batch from ``seed``; each ``cuda_kernels`` entry point
    named in ``plain`` (``"flash_attention_bwd_dq"``, ...) is swapped for
    its plain ``_ref`` version on the kernel path."""
    import gc
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    for name, types in FLASH_ARGTYPES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        ck._FNS[name] = fn
    lm = chip_smoke.transformer_lm(mx, mx.gpu(0), seed=seed)
    lm.cast("bfloat16")
    x, y = chip_smoke.lm_batch(mx, mx.gpu(0),
                               chip_smoke.GPT2_SMALL["vocab_size"],
                               chip_smoke.LM_BATCH, chip_smoke.LM_T[0],
                               seed=seed)
    kernels = {name: getattr(ck, name) for name in plain}
    for name in plain:
        setattr(ck, name, getattr(ck, name + "_ref"))
    try:
        return chip_smoke.bf16_grad_check(
            mx, ck, lm, mx.gluon.loss.SoftmaxCrossEntropyLoss(), x, y)
    finally:
        for name, fn in kernels.items():
            setattr(ck, name, fn)
        del lm, x, y
        gc.collect()
        torch.cuda.empty_cache()


def flash_main(smi, dev, bw, flops, out_dir, only=""):
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    bf16 = chip_smoke.card_rates(torch.cuda.get_device_name(0))[3]
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    bh, t = chip_smoke.LM_BATCH * chip_smoke.GPT2_SMALL["num_heads"], \
        chip_smoke.LM_T[0]
    d = chip_smoke.GPT2_SMALL["units"] // chip_smoke.GPT2_SMALL["num_heads"]
    cases = []
    for b_, tq, tk, d_, causal in ((bh, t, t, d, True),) + FLASH_EDGE:
        args = chip_smoke.flash_bwd_operands(ck, gen, b_, tq, tk, d_, causal,
                                             torch.bfloat16, dev)
        q, k, v = args[:3]
        cases.append((args, causal, ck.flash_attention_fwd_ref(
            q, k, v, causal), ck.flash_attention_bwd_dq_ref(*args, causal),
            ck.flash_attention_bwd_dkv_ref(*args, causal),
            chip_smoke.attention_terms(
                q, k, v, causal, tk <= chip_smoke.k7a_key_tile(d_))))
    args = cases[0][0]
    heads = chip_smoke.GPT2_SMALL["num_heads"]
    q4, k4, v4 = (a.view(bh // heads, heads, t, d).clone().requires_grad_()
                  for a in args[:3])
    o4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                          is_causal=True)
    do4 = args[3].view(bh // heads, heads, t, d)
    sdpa_fwd = chip_smoke.time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True))
    sdpa_bwd = chip_smoke.time_ms(lambda: torch.autograd.grad(
        o4, (q4, k4, v4), do4, retain_graph=True))
    bound_a = chip_smoke.flash_bound(bh, t, t, d, True, 2, bw, bf16)[0]
    pairs = t * (t + 1) // 2
    bound_b, bound_c = (chip_smoke.bound_ms(
        chip_smoke.flash_bwd_bytes(bh, t, t, d, n_out, 2),
        2 * d * n_prod * bh * pairs, bw, bf16)[0]
        for n_out, n_prod in ((1, 3), (2, 4)))
    print("(%d, %d, %d) bf16 causal; bounds: K7a %.4f ms, K7b %.4f ms, K7c "
          "%.4f ms; SDPA bf16 forward %.4f ms, its backward (dq, dk, dv) "
          "%.4f ms; the plain version's o vs fp64: mean |error| %.4g" % (
              bh, t, d, bound_a, bound_b, bound_c, sdpa_fwd, sdpa_bwd,
              (cases[0][2][0].double() - fp64_attention(*args[:3], True))
              .abs().mean().item()), flush=True)
    exact = fp64_attention(*args[:3], True)
    runs = variant_texts("flash_attention", {
        name: edits for name, edits in FLASH_VARIANTS.items()
        if name.startswith(only)})
    libs = compile_all("flash_attention", [text for _, text in runs[:-1]],
                       out_dir, FLASH_MAIN, FLASH_ARGTYPES)
    first = None
    for (name, _), (lib, regs) in zip(runs, libs + libs[:1]):
        for args, causal, (ro, rlse), rdq, (rdk, rdv), terms in cases:
            k7a, k7b, k7c = flash_calls(lib, *args, causal)
            (o, lse), dq, (dk, dv) = k7a(), k7b(), k7c()
            if not (chip_smoke.bf16_attention_close(o, ro, terms, 1e-6)
                    and (lse - rlse).abs().max().item() <= 1e-5
                    and chip_smoke._bf16_bwd_close(dq, rdq)
                    and chip_smoke._bf16_bwd_close(dk, rdk)
                    and chip_smoke._bf16_bwd_close(dv, rdv)):
                raise AssertionError("%s: K7a, K7b or K7c off their plain "
                                     "versions at %s causal=%s"
                                     % (name, tuple(args[0].shape), causal))
        k7a, k7b, k7c = flash_calls(lib, *cases[0][0], True)
        ms_a, ms_b, ms_c = (chip_smoke.time_ms(f) for f in (k7a, k7b, k7c))
        o = k7a()[0]
        first = o if first is None else first
        grads = grad_check_with(lib)
        print("%-66s K7a %.4f ms (%.0f%% of its bound), K7b %.4f ms (%.0f%%), "
              "K7c %.4f ms (%.0f%%); "
              "o vs fp64: mean |error| %.4g, %.5f of o's elements differ "
              "from the source's; phase 15's gradients %.3f of their band "
              "(%s); %s" % (
                  name, ms_a, 100 * bound_a / ms_a, ms_b,
                  100 * bound_b / ms_b, ms_c, 100 * bound_c / ms_c,
                  (o.double() - exact).abs().mean().item(),
                  (o != first).float().mean().item(),
                  grads["grad_dev_by_band"], grads["worst"],
                  "; ".join(regs)), flush=True)


def flash_band_main(smi, dev, bw, flops, out_dir):
    runs = variant_texts("flash_attention",
                         {K7B_TF32: FLASH_VARIANTS[K7B_TF32]})
    libs = compile_all("flash_attention", [text for _, text in runs[:2]],
                       out_dir, FLASH_MAIN, FLASH_ARGTYPES)
    ways = [("K7b as it stands (bf16)", libs[0][0], ()),
            ("K7b on the older TF32 code", libs[1][0], ()),
            ("K7b's plain version", libs[0][0], ("flash_attention_bwd_dq",))]
    print("phase 15's gradients in units of their band, seeds %s"
          % (BAND_SEEDS,), flush=True)
    for label, lib, plain in ways:
        reads = []
        for seed in BAND_SEEDS:
            grads = grad_check_with(lib, seed, plain)
            reads.append(grads["grad_dev_by_band"])
            print("  %-26s seed %d: %.3f (%s)" % (
                label, seed, grads["grad_dev_by_band"], grads["worst"]),
                flush=True)
        print("%-28s min %.3f, mean %.3f, max %.3f over %d seeds" % (
            label, min(reads), sum(reads) / len(reads), max(reads),
            len(reads)), flush=True)


def main():
    if not torch.cuda.is_available():
        print("time_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from mxnet_tpu_torch.ops import _build
    source = sys.argv[1] if len(sys.argv) > 1 else "softmax"
    runner = {"softmax": softmax_main, "layernorm": layernorm_main,
              "flash": flash_main, "flash_band": flash_band_main}.get(source)
    if runner is None:
        print("time_variants: the source is softmax, layernorm, flash or "
              "flash_band, not %r" % source, file=sys.stderr)
        return 2
    smi = card_name()
    dev = torch.device("cuda", 0)
    bw, flops, *_ = chip_smoke.card_rates(torch.cuda.get_device_name(0))
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    print("card: %s" % smi, flush=True)
    runner(smi, dev, bw, flops, out_dir, *sys.argv[2:])
    print("card: %s" % smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
