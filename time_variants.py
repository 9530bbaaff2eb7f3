#!/usr/bin/env python3
"""Time textual variants of a kernel source against the source as it
stands, on one NVIDIA GPU::

    python3 time_variants.py              # softmax.cu: K5a, K5b (and K2)
    python3 time_variants.py k2_wide      # softmax.cu: K2 past 1024 columns
    python3 time_variants.py layernorm    # layernorm.cu: K6b
    python3 time_variants.py flash        # flash_attention.cu: bf16 K7a-K7c
    python3 time_variants.py flash K7b    # ... only the variants named K7b*
    python3 time_variants.py flash_band   # phase 15's band over seeds
    python3 time_variants.py inception_serve [fits] [request sets]
    python3 time_variants.py rnn_accuracy # the RNN op: cuDNN vs float64
    python3 time_variants.py telemetry_cost [rounds]  # phase 19's parts
    python3 time_variants.py trace_drop [rounds]  # phase 19's device trace

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

``k2_wide``: K2 past 1024 columns, the source as it stands against the
parent commit's strided form and the designs it was chosen over
(``K2_WIDE_VARIANTS``: one CTA a row at every row count, a cluster of
two or more at every row count, the slice loaded by a TMA bulk copy,
the cluster's partials read through distributed shared memory between
two ``cluster.sync()`` instead of sent by ``st.async``, 32 values a
thread), each within 1e-6 (fp32; the parent's form within
``chip_smoke.K2_LM_TOL`` of the largest probability) or one rounding
(bf16) of the plain version, timed by the profiler at
``K2_WIDE_SHAPES`` in fp32 and at (1920, 10000) in bf16, beside
``torch.softmax``.  ``chip_smoke.py`` builds the parent's form the same
way (``k2_parent_library``) to time it beside the kernel.

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

``telemetry_cost``: no variant; phase 19 (a)'s ResNet-50 fit
(``chip_smoke.train``, 3 + 10 steps, cuDNN deterministic) with each part
of the instrumentation alone (``TELEMETRY_PARTS``: the hot-path
counters, the step log, tracing) and all of it, in turns, in a process
that ran no profiler session, each step's ms by CUDA events.

``trace_drop``: no variant; phase 19 (a)'s profiled fit, its device
trace stopped right after the last kernels and, in turns, after the
profiler's settle: each run's kernel counter beside the trace's
launches, its device events and the largest gap between two K1b
launches.

``flash_band``: no timing; phase 15's gradient check at each of
``BAND_SEEDS`` (the transformer's weights and its batch from the seed)
with K7b's bf16 instance three ways: the source as it stands (bf16
``mma.sync``), the older TF32 code in its place (``flash_bwd_dq_kernel``,
the variant ``K7B_TF32``), and K7b's plain version in its place (K7a,
K7c and the rest the source's), so that the spread of the band's
readings over seeds shows which differences it can tell apart.

``inception_serve``: no variant and no timing; phase 14's serving check
repeated (4 fits of Inception-BN as phase 14 runs them, 6 sets of
requests each by default): every answer against a ``Predictor`` at its
own bucket, a 32-row ``Predictor`` and the module's 32-row forward on
the same parameters, the distribution of each distance; for the answer
furthest from the module's, every node's output on each side (the
monitor's taps, ``Monitor(monitor_all=True)``) and the first node that
differs, the kernels each bucket launches (the profiler), and the engine
and knobs cuDNN ran for each convolution at each bucket (its debug log,
``CUDNN_LOGLEVEL_DBG=3``, a child process per bucket; the log's useful
lines and the report go to ``mxnet_tpu_torch/_build/variants/
inception_serve/``).

``rnn_accuracy``: no variant and no timing; the ``RNN`` op's torch
paths (``ops/nn.py`` ``_rnn_layers``) in fp32 against a float64 run on
the CPU of the same weights, inputs and states (``RNN_ACCURACY``: the
op table's small cases, the widths of phase 17's fused check, hidden 64
and 128): cuDNN on the card (TF32 off), torch's own CUDA kernels on the
card with cuDNN disabled, and the CPU; each as its largest |difference|
over the largest output.

Prints the compiler's register count of the main-path instances and the
card's name and power limit.
"""
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

import chip_smoke

REPO = os.path.dirname(os.path.abspath(__file__))

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
# K2 past 1024 columns: the parent commit's strided form, and the designs
# the on-chip form was chosen over.  name -> [(text of softmax.cu, its
# replacement)]
K2_PARENT = "K2 as the parent commit had it: the strided three-pass form"
K2_STRIDED_KERNEL = """// K2 for cols > 1024 (the strided three-pass form)
template <typename T>
__global__ void softmax_rows_kernel(const T* __restrict__ x,
                                    T* __restrict__ y, int64_t rows,
                                    int64_t cols) {
  const int64_t row =
      (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  softmax_row(x + row * cols, static_cast<const float*>(nullptr),
              y + row * cols, cols, threadIdx.x % kWarp);
}

"""
K2_TMA_LOAD = r"""  extern __shared__ __align__(128) unsigned char tma_row[];
  __shared__ __align__(8) uint64_t tma_bar;
  if constexpr (VEC * sizeof(T) == 16) {
    const uint32_t bar = (uint32_t)__cvta_generic_to_shared(&tma_bar);
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(tma_row);
    const uint32_t bytes = (uint32_t)(w > 0 ? w : 0) * sizeof(T);
    if (i == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar), "r"(bytes) : "memory");
      if (bytes)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(xr), "r"(bytes),
            "r"(bar) : "memory");
    }
    __syncthreads();
    asm volatile(
        "{\n.reg .pred P1;\nLAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
        "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar) : "memory");
    load_slice<T, N, VEC>(reinterpret_cast<const T*>(tma_row), v, w, i, TH);
  } else {
    load_slice<T, N, VEC>(xr, v, w, i, TH);
  }
"""
# the body of cluster_exchange, and the one that replaces it
K2_ST_ASYNC_BODY = r"""  if ((int)threadIdx.x < K) {
    const uint32_t q = threadIdx.x, me = cg::this_cluster().block_rank();
    uint32_t dst, rbar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(dst)
                 : "r"(smem_addr(slots + me)), "r"(q));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(rbar)
                 : "r"(smem_addr(bar)), "r"(q));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], "
        "%1, [%2];\n" ::"r"(dst), "r"(__float_as_uint(v)), "r"(rbar)
        : "memory");
  }
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "0;\n@!P1 bra WAIT;\n}\n" ::"r"(smem_addr(bar))
      : "memory");
  float r = slots[0];
  for (int q = 1; q < K; ++q) r = MAX ? fmaxf(r, slots[q]) : r + slots[q];
  return r;
}
"""
K2_CLUSTER_SYNC_EXCHANGE = r"""  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0) slots[0] = v;
  cl.sync();
  float r = *cl.map_shared_rank(slots, 0);
  for (int q = 1; q < K; ++q) {
    const float u = *cl.map_shared_rank(slots, q);
    r = MAX ? fmaxf(r, u) : r + u;
  }
  cl.sync();  // no CTA leaves while its slot is read
  return r;
}
"""
K2_WIDE_VARIANTS = {
    K2_PARENT: [
        ("// K5a for cols > 1024: rows = B * bias_rows; row r adds bias row",
         K2_STRIDED_KERNEL
         + "// K5a for cols > 1024: rows = B * bias_rows; row r adds bias row"),
        ("""  const void* ptrs[] = {x, y};
  with_vec<T, 16 / (int)sizeof(T)>(cols, ptrs, 2, nullptr, [&](auto vec) {
    launch_wide<T, decltype(vec)::value>(xt, yt, rows, cols, stream);
  });""",
         """  softmax_rows_kernel<T><<<(unsigned)((rows + kRowsPerBlock - 1) /
                                      kRowsPerBlock),
                           kRowsPerBlock * kWarp, 0, stream>>>(xt, yt, rows,
                                                               cols);""")],
    "K2: one CTA a row at every row count (no cluster for few rows)": [
        ("  while (K < kWideMaxCluster && rows * K * 2 <= sms &&",
         "  while (false && rows * K * 2 <= sms &&")],
    "K2: the slice loaded by a TMA bulk copy into shared memory": [
        ("  load_slice<T, N, VEC>(xr, v, w, i, TH);\n", K2_TMA_LOAD),
        ("    cfg.dynamicSmemBytes = 0;",
         "    cfg.dynamicSmemBytes = (size_t)slice * VEC * sizeof(T);\n"
         "    cudaFuncSetAttribute(softmax_rows_onchip_kernel<T, N, VEC>,\n"
         "                         cudaFuncAttributeMaxDynamicSharedMemorySize,"
         "\n                         (int)cfg.dynamicSmemBytes);")],
    "K2: a cluster of two CTAs or more a row at every row count": [
        ("  int K = 1;\n  while (K < kWideMaxCluster",
         "  int K = 2;\n  while (K < kWideMaxCluster")],
    "K2: the partials read from the other CTAs' shared memory between "
    "two cluster.sync()": [(K2_ST_ASYNC_BODY, K2_CLUSTER_SYNC_EXCHANGE)],
    "K2: 32 values a thread (fewer threads a CTA)": [
        ("  if (fits(8))\n    go(std::integral_constant<int, 8>{});\n"
         "  else if (fits(16))",
         "  if (false)\n    go(std::integral_constant<int, 8>{});\n"
         "  else if (false)")],
}
# the wide form's fp32 instance at C 10000 and its bf16 one
K2_WIDE_MAIN = tuple(frag for _, frag in chip_smoke.K2_WIDE_KERNELS)
# (rows, C) of the wide form's timing: one row, a 32-row batch, the
# bucketed LM's logits at T 10 and T 60
K2_WIDE_SHAPES = ((1, 10000), (32, 10000), (320, 10000), (1920, 10000))
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
    os.makedirs(out_dir, exist_ok=True)
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

    return k5a, k5b, k2_call(lib, x)


def k2_call(lib, x):
    """K2 of ``lib`` on x (softmax over its last axis) as a call on the
    current stream."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    c = x.shape[-1]

    def k2():
        y = torch.empty_like(x)
        rc = lib.mxtt_softmax_lastaxis(x.data_ptr(), y.data_ptr(),
                                       x.numel() // c, c,
                                       ck._DTYPE_CODE[x.dtype],
                                       torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("K2 launch failed: %d" % rc)
        return y
    return k2


def k2_parent_library(out_dir):
    """``softmax.cu`` with K2 past 1024 columns as the parent commit had
    it (the variant ``K2_PARENT``), built into ``out_dir`` and loaded."""
    text = dict(variant_texts("softmax", {
        K2_PARENT: K2_WIDE_VARIANTS[K2_PARENT]}))[K2_PARENT]
    return compile_all("softmax_parent", [text], out_dir, (),
                       SOFTMAX_ARGTYPES)[0][0]


def k2_wide_main(smi, dev, bw, flops, out_dir):
    """K2 past 1024 columns: the source as it stands, the parent's
    strided form and the other designs of ``K2_WIDE_VARIANTS``, each held
    to the plain version (in fp32 the parent's form to
    ``chip_smoke.K2_LM_TOL`` of the largest probability, its band at the
    LM's shapes, the others to 1e-6) and timed by the profiler (device
    time, 20 launches) at ``K2_WIDE_SHAPES`` fp32 and at (1920, 10000)
    bf16, beside ``torch.softmax`` and the byte bound."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    xs = [torch.randn(shape, generator=gen, device=dev) * 3
          for shape in K2_WIDE_SHAPES]
    xs.append(xs[-1].to(torch.bfloat16))
    refs = [ck.softmax_lastaxis_ref(x) for x in xs]
    desc = ["%s %s" % (tuple(x.shape), str(x.dtype)[6:]) for x in xs]
    for d, x in zip(desc, xs):
        b = chip_smoke.bound_ms(2 * x.numel() * x.element_size(),
                                5 * x.numel(), bw, flops)[0]
        print("%-22s bound %.5f ms (bytes), torch.softmax %.5f ms" % (
            d, b, chip_smoke.device_ms(lambda x=x: torch.softmax(x, -1))),
            flush=True)
    runs = variant_texts("softmax", K2_WIDE_VARIANTS)
    libs = compile_all("softmax", [text for _, text in runs[:-1]], out_dir,
                       K2_WIDE_MAIN, SOFTMAX_ARGTYPES)
    for (name, _), (lib, regs) in zip(runs, libs + libs[:1]):
        times = []
        for d, x, ref in zip(desc, xs, refs):
            k2 = k2_call(lib, x)
            y = k2()
            err = (y.float() - ref.float()).abs().max().item()
            if x.dtype != torch.float32:
                ok = chip_smoke._bf16_close(y, ref, 1e-6)
            elif name == K2_PARENT:   # its band at the LM's shapes
                ok = err <= chip_smoke.K2_LM_TOL * ref.max().item()
            else:
                ok = err <= 1e-6
            if not ok:
                raise AssertionError("%s at %s: max |d| %g" % (name, d, err))
            times.append("%s %.5f" % (d, chip_smoke.device_ms(k2)))
        print("%-66s ms: %s; %s" % (name, ", ".join(times), "; ".join(regs)),
              flush=True)


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


# ---------------------------------------------------------------------------
# inception_serve: why phase 14's served answers and the module's forward
# differ
# ---------------------------------------------------------------------------
# a forward of Inception-BN at one shape, run alone in a child process
# so that cuDNN's debug log holds that shape only (argv: bucket)
CUDNN_CHILD = """
import sys
sys.path.insert(0, %r)
import numpy as np
import torch
import chip_smoke
import mxnet_tpu_torch as mx
b = int(sys.argv[1])
sym = chip_smoke.inception_symbol()
arg, aux = chip_smoke.initial_params(mx, mx.gpu(0), sym, chip_smoke.IMAGE, b)
pred = mx.Predictor.from_parts(sym, arg, aux,
                               {"data": (b,) + chip_smoke.IMAGE}, ctx=mx.gpu(0))
x = np.random.RandomState(0).uniform(-1, 1, (b,) + chip_smoke.IMAGE)
pred.forward(data=mx.nd.array(x.astype(np.float32), ctx=mx.gpu(0)))
pred.get_output(0).asnumpy()
"""
# words of cuDNN's debug log worth keeping: the API calls, and whatever
# names an algorithm, an engine or a knob of the plan it picked
CUDNN_WORDS = ("function cudnn", "algo", "Algo", "ALGO", "engine", "Engine",
               "ENGINE", "knob", "KNOB", "GLOBAL_INDEX", "heur", "HEUR",
               "CONVOLUTION", "Convolution")


def node_taps(mx, exe, feed, rows):
    """Every op node's output (its first ``rows`` rows) of one eval
    forward of ``exe``, through ``Monitor(monitor_all=True)``'s taps:
    ``[(name, host array)]`` in graph order."""
    mon = mx.Monitor(1, stat_func=lambda a: a[:rows].copy(), pattern=".*",
                     monitor_all=True)
    mon.install(exe)
    mon.tic()
    exe.forward(is_train=False, **feed)
    recs = [(name, stat.asnumpy()) for _, name, stat in mon.queue]
    exe.set_monitor_callback(None)
    return recs


def first_differences(a, b, k=6):
    """The first ``k`` nodes (in graph order) whose outputs differ between
    two ``node_taps`` runs, with their distance over the larger side's
    largest magnitude, and the count of differing nodes."""
    out, n = [], 0
    for (na, xa), (nb, xb) in zip(a, b):
        if na != nb:
            raise AssertionError("tap order differs: %s vs %s" % (na, nb))
        if not np.array_equal(xa, xb):
            n += 1
            if len(out) < k:
                out.append((na, chip_smoke.largest_rel(xa, xb)))
    return out, n


def conv_kernels(pred, x):
    """The names of the kernels one forward of ``pred`` launches, in
    order, that are not K3 or K2 (the convolutions' and the rest's)."""
    from torch.profiler import ProfilerActivity, profile
    pred.forward(data=x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pred.forward(data=x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type.name == "CUDA"]
    return [n for n in names if "scale_bias_relu" not in n
            and "softmax" not in n]


def cudnn_log(bucket, out_dir):
    """cuDNN's debug log (``CUDNN_LOGLEVEL_DBG=3``) of one forward at
    ``bucket`` rows in a child process: the lines worth keeping, written
    gzipped under ``out_dir``, and a count of the API calls by name."""
    import gzip
    path = os.path.join(out_dir, "cudnn_b%d.log" % bucket)
    env = dict(os.environ, CUDNN_LOGLEVEL_DBG="3", CUDNN_LOGDEST_DBG=path)
    subprocess.run([sys.executable, "-c", CUDNN_CHILD % REPO, str(bucket)],
                   env=env, check=True, timeout=600)
    calls, kept = {}, []
    with open(path, errors="replace") as f:
        for line in f:
            if "function cudnn" in line:
                fn = line.split("function ", 1)[1].split("(")[0]
                calls[fn] = calls.get(fn, 0) + 1
            if any(w in line for w in CUDNN_WORDS):
                kept.append(line)
    with gzip.open(path + ".kept.gz", "wt") as f:
        f.writelines(kept)
    engines = executed_engines(kept)
    size = os.path.getsize(path)
    with open(path, errors="replace") as f, \
            gzip.open(path + ".head.gz", "wt") as g:
        for i, line in enumerate(f):
            if i >= 4000:
                break
            g.write(line)
    os.remove(path)
    return {"bytes": size, "kept_lines": len(kept), "calls": calls,
            "engines": engines}


def executed_engines(lines):
    """The engine and knobs of each plan cuDNN executed, in order, from its
    debug log's lines: ``[(engine id, ((knob, value), ...))]``, one a
    ``cudnnBackendExecuteInternal`` call (one a convolution here)."""
    out, cur = [], None
    for line in lines:
        if line.startswith("I! "):
            if cur is not None:
                out.append((cur[0], tuple(cur[1])))
            cur = [None, []] if "cudnnBackendExecuteInternal()" in line \
                else None
        elif cur is not None:
            if "engine_id:" in line and cur[0] is None:
                cur[0] = int(line.rsplit("val=", 1)[1].rstrip(";\n"))
            elif "CUDNN_KNOB_TYPE_" in line:
                knob = line.split("CUDNN_KNOB_TYPE_", 1)[1].split(":", 1)[0]
                cur[1].append((knob, int(line.rsplit("val=", 1)[1]
                                         .rstrip(";\n"))))
    if cur is not None:
        out.append((cur[0], tuple(cur[1])))
    return out


def inception_serve_main(smi, dev, bw, flops, out_dir, trainings="4",
                         repeats="6"):
    """Phase 14's serving check, repeated: ``trainings`` fits of
    Inception-BN as phase 14 runs them (no cuDNN determinism), and for
    each ``repeats`` sets of requests (the first phase 14's own, the
    others fresh), every answer held to (a) a Predictor at its own bucket
    on the same parameters (``chip_smoke.bucket_forwards``), (b) a
    Predictor at 32 rows on the same parameters and (c) the module's
    batch-32 forward, whose weights are views of the fused step's
    buckets.  For the request furthest from (c): every node's output on
    the three sides (the monitor's taps) and the first node that
    differs, the kernels each shape launches, and cuDNN's debug log of a
    forward at each bucket."""
    import json
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    ctx = mx.gpu(0)
    image, batch = chip_smoke.IMAGE, chip_smoke.BATCH
    sym = chip_smoke.inception_symbol()
    report = {"card": smi, "runs": []}
    worst = None
    for t in range(int(trainings)):
        mod, _ = chip_smoke.train(mx, ck, ctx, sym, image, batch,
                                  chip_smoke.INCEPTION_STEPS,
                                  chip_smoke.INCEPTION_WARMUP)
        arg, aux = mod.get_params()
        exe = mod._exec_group.execs[0]
        misaligned = sum(exe.arg_dict[n]._data.data_ptr() % 16 != 0
                         for n in mod._exec_group.param_names)
        for r in range(int(repeats)):
            seed = chip_smoke.SEED + 3 if r == 0 else 1000 + 100 * t + r
            xs = chip_smoke.inception_requests(image, batch, seed)
            answers, _ = chip_smoke.served_answers(mx, ctx, sym, arg, aux,
                                                   image, batch, xs)
            same, buckets, _ = chip_smoke.bucket_forwards(
                mx, ctx, sym, arg, aux, image, batch, xs)
            p32, _, _ = chip_smoke.bucket_forwards(
                mx, ctx, sym, arg, aux, image, batch, xs, bucket=batch)
            mods = chip_smoke.module_forwards(mx, ctx, mod, image, batch, xs)
            for i, (a, s, p, m) in enumerate(zip(answers, same, p32, mods)):
                row = {"training": t, "repeat": r, "request": i,
                       "rows": int(xs[i].shape[0]), "bucket": buckets[i],
                       "served_vs_same_bucket": chip_smoke.largest_rel(a, s),
                       "served_bitwise_same_bucket": bool(
                           np.array_equal(a, s)),
                       "served_vs_p32": chip_smoke.largest_rel(a, p),
                       "p32_vs_module": chip_smoke.largest_rel(p, m),
                       "p32_bitwise_module": bool(np.array_equal(p, m)),
                       "served_vs_module": chip_smoke.largest_rel(a, m),
                       "misaligned_weights": int(misaligned)}
                report["runs"].append(row)
                if worst is None or row["served_vs_module"] > \
                        worst[0]["served_vs_module"]:
                    worst = (row, mod, arg, aux, xs[i])
            last = report["runs"][-len(xs):]
            print("training %d requests %d (seed %d): served vs same "
                  "bucket max %.3g (bitwise %d/%d), vs the module's batch "
                  "%d forward max %.3g, a 32-row Predictor vs the module "
                  "max %.3g" % (
                      t, r, seed, max(x["served_vs_same_bucket"]
                                      for x in last),
                      sum(x["served_bitwise_same_bucket"] for x in last),
                      len(last), batch,
                      max(x["served_vs_module"] for x in last),
                      max(x["p32_vs_module"] for x in last)), flush=True)
        if worst[1] is not mod:
            del mod
    runs = report["runs"]
    for key in ("served_vs_same_bucket", "served_vs_p32", "p32_vs_module",
                "served_vs_module"):
        v = np.array([x[key] for x in runs])
        report[key] = {"min": float(v.min()), "median": float(np.median(v)),
                       "max": float(v.max()),
                       "over_1e-6": int((v > 1e-6).sum()), "n": len(v)}
        print("%s over %d answers: min %.3g, median %.3g, max %.3g, %d past "
              "1e-6" % (key, len(v), v.min(), np.median(v), v.max(),
                        int((v > 1e-6).sum())), flush=True)
    by_bucket = {}
    for x in runs:
        by_bucket.setdefault(x["bucket"], []).append(x["served_vs_module"])
    report["served_vs_module_by_bucket"] = {
        b: {"max": float(max(v)), "median": float(np.median(v)),
            "n": len(v)} for b, v in sorted(by_bucket.items())}
    print("served vs module by bucket: %s"
          % report["served_vs_module_by_bucket"], flush=True)

    # the furthest answer, node by node
    row, mod, arg, aux, x = worst
    rows, b = row["rows"], row["bucket"]
    from mxnet_tpu_torch.io import pad_batch
    padded_b, _ = pad_batch([x], b)
    padded_32, _ = pad_batch([x], batch)
    zero_32 = np.zeros((batch,) + tuple(image), np.float32)
    zero_32[:rows] = x
    pred_b = mx.Predictor.from_parts(sym, arg, aux, {"data": (b,) + image},
                                     ctx=ctx)
    pred_32 = mx.Predictor.from_parts(sym, arg, aux,
                                      {"data": (batch,) + image}, ctx=ctx)
    taps_b = node_taps(mx, pred_b._exe,
                       {"data": mx.nd.array(padded_b, ctx=ctx)}, rows)
    taps_32 = node_taps(mx, pred_32._exe,
                        {"data": mx.nd.array(padded_32, ctx=ctx)}, rows)
    taps_32z = node_taps(mx, pred_32._exe,
                         {"data": mx.nd.array(zero_32, ctx=ctx)}, rows)
    taps_mod = node_taps(mx, mod._exec_group.execs[0],
                         {"data": mx.nd.array(zero_32, ctx=ctx)}, rows)
    report["worst"] = row
    for label, (a, c) in (("bucket %d vs 32 rows, same params" % b,
                           (taps_b, taps_32)),
                          ("32 rows: pad by the last row vs by zeros",
                           (taps_32, taps_32z)),
                          ("32 rows: a Predictor vs the module",
                           (taps_32z, taps_mod))):
        first, n = first_differences(a, c)
        report.setdefault("first_differences", {})[label] = {
            "first": first, "nodes_differing": n, "nodes": len(a)}
        print("%s: %d of %d node outputs differ; the first: %s"
              % (label, n, len(a), first), flush=True)
    # the kernels each shape launches
    kern = {}
    for bb in sorted(set(x["bucket"] for x in runs) | {batch}):
        pred = pred_b if bb == b else (pred_32 if bb == batch else
                                       mx.Predictor.from_parts(
                                           sym, arg, aux,
                                           {"data": (bb,) + image}, ctx=ctx))
        xx = mx.nd.array(pad_batch([x], bb)[0] if bb >= rows else
                         x[:bb], ctx=ctx)
        kern[bb] = conv_kernels(pred, xx)
    ref = kern[batch]
    for bb, names in sorted(kern.items()):
        diff = sum(1 for p, q in zip(names, ref) if p != q)
        print("bucket %d: %d kernels, %d of them other than at %d rows; "
              "distinct names %d" % (bb, len(names), diff, batch,
                                     len(set(names))), flush=True)
    report["kernels"] = {bb: names for bb, names in kern.items()}
    # cuDNN's log, a child process per bucket
    log_dir = os.path.join(out_dir, "inception_serve")
    os.makedirs(log_dir, exist_ok=True)
    report["cudnn"] = {}
    for bb in sorted(kern):
        try:
            report["cudnn"][bb] = cudnn_log(bb, log_dir)
            print("cudnn log bucket %d: %s" % (bb, report["cudnn"][bb]),
                  flush=True)
        except Exception as exc:    # noqa: BLE001 — reported, not fatal
            report["cudnn"][bb] = {"error": repr(exc)}
            print("cudnn log bucket %d failed: %r" % (bb, exc), flush=True)
    convs = [n.name for n in sym._topo()
             if not n.is_variable and n.op.name == "Convolution"]
    ref = report["cudnn"].get(batch, {}).get("engines")
    for bb, rec in sorted(report["cudnn"].items()):
        eng = rec.get("engines")
        if not eng or not ref or len(eng) != len(convs):
            print("bucket %d: %s engines for %d convolutions"
                  % (bb, len(eng or ()), len(convs)))
            continue
        other = [i for i, (e, r) in enumerate(zip(eng, ref)) if e != r]
        rec["convs_other_than_%d_rows" % batch] = [convs[i] for i in other]
        print("bucket %d: cuDNN ran another engine or knobs than at %d rows "
              "for %d of %d convolutions; the first %s; %s: engine %s at "
              "%d rows, %s at %d" % (
                  bb, batch, len(other), len(convs),
                  [convs[i] for i in other[:3]],
                  convs[other[0]] if other else None,
                  eng[other[0]] if other else None, bb,
                  ref[other[0]] if other else None, batch), flush=True)
    with open(os.path.join(log_dir, "report.json"), "w") as f:
        json.dump(report, f, default=str)
    print("card: %s; report in %s" % (smi, os.path.join(log_dir,
                                                     "report.json")))


# (mode, layers, bidirectional, T, N, input, hidden): chip_smoke's RNN
# op cases, phase 17's fused check at the LM's widths, and narrower cells
RNN_ACCURACY = (("lstm", 2, True, 5, 3, 4, 6), ("gru", 1, False, 5, 3, 4, 6),
                ("rnn_relu", 2, False, 5, 3, 4, 6),
                ("lstm", 2, False, 60, 32, 200, 200),
                ("gru", 2, False, 60, 32, 200, 200),
                ("lstm", 2, True, 60, 32, 200, 200),
                ("rnn_tanh", 2, True, 60, 32, 200, 200),
                ("lstm", 2, False, 20, 16, 48, 64),
                ("lstm", 2, False, 60, 32, 200, 128),
                ("gru", 2, False, 20, 16, 48, 64))


def rnn_accuracy_main(smi, dev, bw, flops, out_dir):
    from mxnet_tpu_torch.ops.nn import (_rnn_layers, rnn_param_size,
                                        rnn_unpack_params)
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    print("cuDNN %s, cudnn.allow_tf32 %s" % (
        torch.backends.cudnn.version(), torch.backends.cudnn.allow_tf32))
    for mode, layers, bi, t, n, i, h in RNN_ACCURACY:
        d = 2 if bi else 1
        lim = 1.0 / h ** 0.5        # torch's default RNN initialisation

        def u(*shape, scale=1.0):
            return (torch.rand(shape, generator=gen, dtype=torch.float64)
                    * 2 - 1) * scale

        p = u(rnn_param_size(mode, layers, i, h, d), scale=lim)
        x, h0, c0 = u(t, n, i), u(layers * d, n, h, scale=0.5), \
            u(layers * d, n, h, scale=0.5)
        hx = (h0, c0) if mode == "lstm" else (h0,)

        def run(device, dtype):
            pp = p.to(device, dtype)
            return _rnn_layers(mode, x.to(device, dtype),
                               tuple(s.to(device, dtype) for s in hx),
                               rnn_unpack_params(pp, mode, layers, i, h, d),
                               layers, bi)[0].double().cpu()

        ref = run("cpu", torch.float64)
        errs = {}
        for name, device, cudnn in (("cpu_fp32", "cpu", True),
                                    ("cudnn_fp32", dev, True),
                                    ("native_cuda_fp32", dev, False)):
            with torch.backends.cudnn.flags(enabled=cudnn,
                                            allow_tf32=False):
                y = run(device, torch.float32)
            errs[name] = float((y - ref).abs().max() / ref.abs().max())
        print("RNN %s layers %d bidirectional %s (T %d, N %d, input %d, "
              "hidden %d): %s" % (mode, layers, bi, t, n, i, h, ", ".join(
                  "%s %.3g" % kv for kv in errs.items())), flush=True)


# telemetry_cost's configurations: (name, observed(...)'s arguments)
TELEMETRY_PARTS = (
    ("off", None),
    ("counters", {"counters": True, "spans": False}),
    ("step_log", {"counters": False, "spans": False, "log": True}),
    ("tracing", {"counters": False, "spans": True}),
    ("all", {"counters": True, "spans": True, "log": True}))


def telemetry_cost_main(smi, dev, bw, flops, out_dir, rounds="2"):
    """Phase 19 (a)'s ResNet-50 fit (``chip_smoke.train``, 3 + 10 steps,
    cuDNN deterministic, one initialisation) under each part of the
    instrumentation alone and all of it, in turns (each round forwards
    then backwards through ``TELEMETRY_PARTS``), in a process that has
    run no profiler session; the step ms by CUDA events of each."""
    import contextlib
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    sym = chip_smoke.resnet_symbol(chip_smoke.LAYERS, chip_smoke.IMAGE)
    ctx = mx.gpu(0)
    arg, aux = chip_smoke.initial_params(mx, ctx, sym, chip_smoke.IMAGE,
                                         chip_smoke.BATCH)
    log = os.path.join(out_dir, "telemetry_cost_steps.jsonl")
    order = list(TELEMETRY_PARTS) + list(reversed(TELEMETRY_PARTS))
    times = {name: [] for name, _ in TELEMETRY_PARTS}
    torch.backends.cudnn.deterministic = True
    for _ in range(int(rounds)):
        for name, kw in order:
            if kw is None:
                scope = contextlib.nullcontext()
            else:
                kw = dict(kw)
                scope = chip_smoke.observed(
                    mx, log=log if kw.pop("log", False) else None, **kw)
            with scope:
                _mod, res = chip_smoke.train(
                    mx, ck, ctx, sym, chip_smoke.IMAGE, chip_smoke.BATCH,
                    chip_smoke.OBS_STEPS, chip_smoke.OBS_WARMUP,
                    arg_params=arg, aux_params=aux)
            del _mod
            times[name].append(res["step_ms"])
            print("%-9s %.2f ms/step" % (name, res["step_ms"]), flush=True)
    off = float(np.mean(times["off"]))
    for name, ts in times.items():
        print("telemetry_cost on %s: %-9s %s ms/step, mean %.2f, %+.2f%% "
              "against off" % (smi, name, ["%.2f" % t for t in ts],
                               np.mean(ts), 100 * (np.mean(ts) / off - 1)))


def trace_drop_main(smi, dev, bw, flops, out_dir, rounds="6"):
    """Phase 19 (a)'s profiled fit (``chip_smoke.train`` under
    ``chip_smoke.observed`` with the device trace, 3 + 10 steps, cuDNN
    deterministic) ``rounds`` times with the trace stopped right after
    the last kernels and as many times after the profiler's settle
    (``profiler._DEVICE_TRACE_SETTLE_S``), in turns: each run's kernel
    counter against the trace's launches, its device events, and the
    largest gap between two K1b launches in the trace (a missing step in
    the middle shows as about twice a step)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    sym = chip_smoke.resnet_symbol(chip_smoke.LAYERS, chip_smoke.IMAGE)
    ctx = mx.gpu(0)
    arg, aux = chip_smoke.initial_params(mx, ctx, sym, chip_smoke.IMAGE,
                                         chip_smoke.BATCH)
    settle = profiler._DEVICE_TRACE_SETTLE_S
    torch.backends.cudnn.deterministic = True
    for rnd in range(int(rounds)):
        for mode in ("no_wait", "settled"):
            profiler._DEVICE_TRACE_SETTLE_S = settle \
                if mode == "settled" else 0.0
            trace_dir = os.path.join(out_dir, "trace_drop")
            try:
                with chip_smoke.observed(mx, trace_dir=trace_dir) as obs:
                    _mod, res = chip_smoke.train(
                        mx, ck, ctx, sym, chip_smoke.IMAGE,
                        chip_smoke.BATCH, chip_smoke.OBS_STEPS,
                        chip_smoke.OBS_WARMUP, arg_params=arg,
                        aux_params=aux)
                    snap = mx.telemetry.snapshot()
            finally:
                profiler._DEVICE_TRACE_SETTLE_S = settle
            del _mod
            counts = chip_smoke.dump_counts(obs.dump)
            counter = chip_smoke._families(
                snap, "mxnet_pallas_kernel_calls_total", "kernel")
            k1b = sorted(e["ts"] for e in obs.dump["traceEvents"]
                         if e.get("pid") == "device"
                         and e.get("cat") == "kernel"
                         and "sweep_kernel" in e["name"])
            gaps = np.diff(k1b) / 1e3 if len(k1b) > 1 else np.zeros(1)
            print("trace_drop on %s: round %d %-7s counter %s trace %s, "
                  "device events %d, the largest K1b gap %.1f ms (step "
                  "%.1f ms)" % (
                      smi, rnd, mode, counter, counts["launches"],
                      counts["device_events"], float(gaps.max()),
                      res["step_ms"]), flush=True)


def main():
    if not torch.cuda.is_available():
        print("time_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from mxnet_tpu_torch.ops import _build
    source = sys.argv[1] if len(sys.argv) > 1 else "softmax"
    runner = {"softmax": softmax_main, "k2_wide": k2_wide_main,
              "layernorm": layernorm_main,
              "flash": flash_main, "flash_band": flash_band_main,
              "inception_serve": inception_serve_main,
              "rnn_accuracy": rnn_accuracy_main,
              "telemetry_cost": telemetry_cost_main,
              "trace_drop": trace_drop_main}.get(source)
    if runner is None:
        print("time_variants: the source is softmax, k2_wide, layernorm, "
              "flash, flash_band, inception_serve, rnn_accuracy, "
              "telemetry_cost or trace_drop, not %r" % source,
              file=sys.stderr)
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
