// Last-axis softmax, plain (K2) and with an additive bias (K5a), and its
// backward (K5b):
//   K2:  y[r, :] = exp(x[r, :] - max) / sum(exp(x[r, :] - max))
//   K5a: y[b, r, :] = softmax(x[b, r, :] + bias[r, :])
//   K5b: dx[r, :] = p[r, :] * (do[r, :] - sum(p[r, :] * do[r, :]))
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _softmax_fwd_kernel (K2),
// mxnet_tpu/ops/pallas_kernels.py _softmax_bias_fwd_kernel (K5a) and
// mxnet_tpu/ops/pallas_kernels.py _softmax_bwd_kernel (K5b), reached
// through fused_bias_softmax -> _softmax_fwd / _softmax_bwd_dx ->
// _softmax_call: K2 is the forward of SoftmaxOutput (ops/loss.py) and of
// unmasked attention, K5a the masked attention of
// parallel/attention.py local_attention, whose (Tq, Tk) causal mask
// arrives as a 0 / -1e30 fp32 bias shared by every (batch, head), and K5b
// the backward of both attention forms (the bias's gradient, where one
// is needed, is the sum of dx over the batch, in plain torch).
//
// Bound on Hopper: memory bytes (each logit read once, each probability
// written once, the bias read once per (batch, head) but from L2; K5b
// reads p and do and writes dx; a handful of operations between).  At the
// serving shape of K2, (batch, 1000), the call moves a few hundred
// kilobytes, so the launch and the chain of dependent memory round trips
// inside it are the cost; K5a at the attention shape (96, 1020, 1020)
// moves 0.8 GB, K5b 1.2 GB, K2 at the bucketed LM's (1920, 10000)
// logits 154 MB (0.046 ms at 3.35 TB/s).
//
// Rows of up to 1024 columns keep the row in registers and read it once
// (softmax_regs_kernel for K2 and bias_softmax_regs_kernel for K5a, one
// body: load_row, add_bias, softmax_regs_finish; softmax_bwd_regs_kernel
// for K5b):
//   - K2 and K5a: below 1024 rows (the serving batches), one row a block
//     of W = 1, 2, 4 or 8 warps (C <= 128, 256, 512, 1024), each lane
//     holding 4 values: a batch of 1-32 rows spreads over as many SMs as
//     it has rows, and each lane's chain of loads, exps and divisions is
//     4 long; from 1024 rows on, one warp a row and four rows a block,
//     each lane holding N = 4, 8, 16 or 32 values.  K5b: one warp a row
//     and four rows a block at every row count, N values of p and N of
//     do a lane (64 fp32 registers of data at C 1020);
//   - every load of the row is issued before the first value is used,
//     16 bytes a load where C and every pointer allow it (VEC columns a
//     load: fp32 C % 4 == 0, bf16 C % 8 == 0), 8-byte bf16 loads where
//     C % 4 == 0, scalar loads otherwise; the columns past C are held at
//     -inf (K2, K5a) or 0 (K5b, adding nothing to the dot);
//   - K5a is K2 with bias[row % R] added in fp32 as x arrives, read at
//     x's width (16-byte loads where x takes them), keeping only the sum;
//     x is read and y written as streaming (evicted first), so that the
//     4 MB of bias, read again by each of the 96 (batch, head) slices at
//     (96, 1020, 1020), stay in L2 while 0.8 GB stream past;
//   - the max and the exp-sum (K5b: the row dot) reduced over those
//     registers with warp shuffles (and, for W > 1, across the block's
//     warps through shared memory), then one vectorised write.
// K2 rows wider than 1024 (the bucketed LM's (32 T, 10000) logits) are
// read from device memory once and kept on chip:
//   - softmax_rows_onchip_kernel: a row is held by a cluster of K = 1, 2,
//     4 or 8 CTAs of 256-1024 threads, CTA k of the cluster holding a
//     contiguous slice of the row, N = 8, 16 or 32 values a thread in
//     registers, loaded 16 bytes a load where C and the pointers allow it
//     (as the forms above choose); the max and the exp-sum are reduced
//     with warp shuffles, across the CTA's warps through shared memory
//     and, for K > 1, across the cluster: each CTA sends its partial
//     into every CTA's shared memory by st.async, counted by that CTA's
//     mbarrier, and reads the K partials in rank order, so all agree
//     (no cluster-wide barrier, and so no memory fence, after the first);
//     each exp is computed once and kept, and the row is written once
//     with streaming stores.  K > 1 where the rows are too few to fill
//     the SMs (a 32-row batch, one row), each CTA keeping 1024 columns or
//     more, or where the row does not fit in one CTA's registers;
//   - softmax_rows_stream_kernel, for a row that does not fit even in
//     eight CTAs (past 262,144 columns): one CTA a row, one read keeping
//     a per-thread online max and rescaled sum, merged across the block,
//     then the write pass reading x again.
// K5a and K5b past 1024 columns keep the strided form (no main path runs
// them): one warp per row, four rows per 128-thread block, no shared
// memory and no block barrier; K5a a max pass, an exp-sum pass and the
// normalised write, K5b the row dot and the write, all in fp32, the row
// re-read from L1/L2; K5a adds bias[row % R] in fp32 in every pass, so
// the bias is never broadcast to x's size in memory.  Any row count and
// any column count, with no padding.  The TPU kernel pads C to whole
// 128-lane tiles with a finite -1e30 (0 for p and do), a Mosaic layout
// rule that has no counterpart here.  Every byte of the operands is read:
// no column is skipped where p is 0 or the bias masks it, so a NaN
// anywhere in a row reaches the whole row.
// The arithmetic is the same on every form: fp32 max, expf, an fp32 sum
// and a correctly rounded division e / sum, rounded once to x's dtype
// (K5b: an fp32 dot and p * (do - dot), rounded once); only the order of
// the sum differs between forms, and the streaming form's sum is
// rescaled as its running max grows.  Subtracting the
// row max keeps every exponent <= 0, so logits of any finite size (1e4
// and beyond) give finite probabilities, and C = 1 gives exactly 1.  A
// masked column (bias -1e30) underflows to exactly 0 as long as its row
// keeps one unmasked column, and its dx is then exactly 0; a row masked
// entirely comes out uniform (x + -1e30 rounds to -1e30 in fp32).
#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;

// One row of the strided form (K5a past 1024 columns): x and y point at
// the row, bias at its bias row or is null.
template <typename T>
__device__ __forceinline__ void softmax_row(const T* __restrict__ xr,
                                            const float* __restrict__ br,
                                            T* __restrict__ yr, int64_t cols,
                                            int lane) {
  float m = -INFINITY;
  for (int64_t j = lane; j < cols; j += kWarp)
    m = fmaxf(m, to_float(xr[j]) + (br ? br[j] : 0.0f));
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  float s = 0.0f;
  for (int64_t j = lane; j < cols; j += kWarp)
    s += expf(to_float(xr[j]) + (br ? br[j] : 0.0f) - m);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);

  for (int64_t j = lane; j < cols; j += kWarp)
    store(yr + j,
          __fdiv_rn(expf(to_float(xr[j]) + (br ? br[j] : 0.0f) - m), s));
}

// K5a for cols > 1024: rows = B * bias_rows; row r adds bias row
// r % bias_rows.
template <typename T>
__global__ void bias_softmax_rows_kernel(const T* __restrict__ x,
                                         const float* __restrict__ bias,
                                         T* __restrict__ y, int64_t rows,
                                         int64_t bias_rows, int64_t cols) {
  const int64_t row =
      (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  softmax_row(x + row * cols, bias + (row % bias_rows) * cols,
              y + row * cols, cols, threadIdx.x % kWarp);
}

// VEC values of T as one load of VEC * sizeof(T) bytes; STREAM marks a
// vector load or store as streaming (__ldcs, __stcs: evicted first from
// L1 and L2)
template <int BYTES> struct Bits;
template <> struct Bits<16> { using type = uint4; };
template <> struct Bits<8> { using type = uint2; };

template <typename T, int VEC, bool STREAM = false>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_float(*p);
  } else {
    using B = typename Bits<VEC * sizeof(T)>::type;
    const B* q = reinterpret_cast<const B*>(p);
    B raw;
    if constexpr (STREAM)
      raw = __ldcs(q);
    else
      raw = *q;
    T t[VEC];
    memcpy(t, &raw, sizeof(B));
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = to_float(t[e]);
  }
}

// VEC fp32 bias values: 16-byte loads for VEC 4 and 8, else one scalar
template <int VEC>
__device__ __forceinline__ void load_bias(const float* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = *p;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 b = *reinterpret_cast<const float4*>(p + e);
      out[e] = b.x;
      out[e + 1] = b.y;
      out[e + 2] = b.z;
      out[e + 3] = b.w;
    }
  }
}

template <typename T, int VEC, bool STREAM = false>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  if constexpr (VEC == 1) {
    store(p, in[0]);
  } else {
    using B = typename Bits<VEC * sizeof(T)>::type;
    T t[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) store(t + e, in[e]);
    B raw;
    memcpy(&raw, t, sizeof(B));
    if constexpr (STREAM)
      __stcs(reinterpret_cast<B*>(p), raw);
    else
      *reinterpret_cast<B*>(p) = raw;
  }
}

// max and sum over the W warps of a block (W > 1: one row a block), after
// each warp has reduced its own lanes; red holds W floats of shared memory
template <int W>
__device__ __forceinline__ float block_max(float v, float* red) {
  if constexpr (W > 1) {
    if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
    __syncthreads();
    v = red[0];
#pragma unroll
    for (int w = 1; w < W; ++w) v = fmaxf(v, red[w]);
  }
  return v;
}
template <int W>
__device__ __forceinline__ float block_sum(float v, float* red) {
  if constexpr (W > 1) {
    if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
    __syncthreads();
    v = red[0];
#pragma unroll
    for (int w = 1; w < W; ++w) v += red[w];
  }
  return v;
}

// K2 and K5a for cols <= 32 * W * N: one row in the registers of W warps
// (thread i of TH = 32 W), N values a lane.  Chunk c of thread i holds
// columns [(c * TH + i) * VEC, + VEC), whole or past cols (cols % VEC ==
// 0), so the loads of one chunk are contiguous.  load_row issues every
// load of the row into v (-inf past cols), add_bias adds a bias row (in
// global or shared memory) at the same columns, softmax_regs_finish
// normalises v and writes it.  STREAM: x read and y written as streaming
// (K5a, so that the bias rows stay in L2).
template <typename T, int N, int VEC, int TH, bool STREAM = false>
__device__ __forceinline__ void load_row(const T* __restrict__ xr, float* v,
                                         int cols, int i) {
#pragma unroll
  for (int c = 0; c < N / VEC; ++c) {
    const int col = (c * TH + i) * VEC;
    if (col < cols) {
      load_vec<T, VEC, STREAM>(xr + col, v + c * VEC);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[c * VEC + e] = -INFINITY;
    }
  }
}

template <int N, int VEC, int TH>
__device__ __forceinline__ void add_bias(const float* br, float* v, int cols,
                                         int i) {
#pragma unroll
  for (int c = 0; c < N / VEC; ++c) {
    const int col = (c * TH + i) * VEC;
    if (col < cols) {
      float b[VEC];
      load_bias<VEC>(br + col, b);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[c * VEC + e] += b[e];
    }
  }
}

template <typename T, int N, int VEC, int W, bool STREAM = false>
__device__ __forceinline__ void softmax_regs_finish(float* v,
                                                    T* __restrict__ yr,
                                                    int cols, int i) {
  constexpr int TH = kWarp * W;
  constexpr int CH = N / VEC;
  __shared__ float red_m[W], red_s[W];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < N; ++k) m = fmaxf(m, v[k]);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  m = block_max<W>(m, red_m);

  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const bool in = (c * TH + i) * VEC < cols;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float p = in ? expf(v[c * VEC + e] - m) : 0.0f;
      v[c * VEC + e] = p;
      s += p;
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  s = block_sum<W>(s, red_s);

#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (c * TH + i) * VEC;
    if (col < cols) {
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = __fdiv_rn(v[c * VEC + e], s);
      store_vec<T, VEC, STREAM>(yr + col, o);
    }
  }
}

// W == 1: one warp a row, blockDim / 32 rows a block; W > 1: one row a
// block of W warps
template <typename T, int N, int VEC, int W>
__global__ void softmax_regs_kernel(const T* __restrict__ x,
                                    T* __restrict__ y, int64_t rows,
                                    int cols) {
  constexpr int TH = kWarp * W;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / TH) +
                      threadIdx.x / TH;
  if (row >= rows) return;
  const int i = threadIdx.x % TH;
  float v[N];
  load_row<T, N, VEC, TH>(x + row * cols, v, cols, i);
  softmax_regs_finish<T, N, VEC, W>(v, y + row * cols, cols, i);
}

// K2's layout with bias row r % bias_rows added (rows = B * bias_rows);
// x is read and y written as streaming (evicted first), so that the
// bias rows, read again by every (batch, head) slice, stay in L2
template <typename T, int N, int VEC, int W>
__global__ void bias_softmax_regs_kernel(const T* __restrict__ x,
                                         const float* __restrict__ bias,
                                         T* __restrict__ y, int64_t rows,
                                         int64_t bias_rows, int cols) {
  constexpr int TH = kWarp * W;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / TH) +
                      threadIdx.x / TH;
  if (row >= rows) return;
  const int i = threadIdx.x % TH;
  float v[N];
  load_row<T, N, VEC, TH, true>(x + row * cols, v, cols, i);
  add_bias<N, VEC, TH>(bias + (row % bias_rows) * cols, v, cols, i);
  softmax_regs_finish<T, N, VEC, W, true>(v, y + row * cols, cols, i);
}

// K5b for cols <= 32 * N: one warp a row, blockDim / 32 rows a block; lane
// i's chunk c holds columns [(c * 32 + i) * VEC, + VEC) of p and of do.
template <typename T, int N, int VEC>
__global__ void softmax_bwd_regs_kernel(const T* __restrict__ p,
                                        const T* __restrict__ dout,
                                        T* __restrict__ dx, int64_t rows,
                                        int cols) {
  const int64_t row =
      (int64_t)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (row >= rows) return;
  const int lane = threadIdx.x % kWarp;
  const T* pr = p + row * cols;
  const T* gr = dout + row * cols;
  constexpr int CH = N / VEC;
  float pv[N], gv[N];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (c * kWarp + lane) * VEC;
    if (col < cols) {
      load_vec<T, VEC>(pr + col, pv + c * VEC);
      load_vec<T, VEC>(gr + col, gv + c * VEC);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) pv[c * VEC + e] = gv[c * VEC + e] = 0.0f;
    }
  }
  float dot = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) dot += pv[k] * gv[k];
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  T* xr = dx + row * cols;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (c * kWarp + lane) * VEC;
    if (col < cols) {
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o[e] = pv[c * VEC + e] * (gv[c * VEC + e] - dot);
      store_vec<T, VEC>(xr + col, o);
    }
  }
}

// K5b for cols > 1024 (the strided form): the row dot, then the write
template <typename T>
__global__ void softmax_bwd_rows_kernel(const T* __restrict__ p,
                                        const T* __restrict__ dout,
                                        T* __restrict__ dx, int64_t rows,
                                        int64_t cols) {
  const int64_t row =
      (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  const int lane = threadIdx.x % kWarp;
  const T* pr = p + row * cols;
  const T* gr = dout + row * cols;
  float dot = 0.0f;
  for (int64_t j = lane; j < cols; j += kWarp)
    dot += to_float(pr[j]) * to_float(gr[j]);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  T* xr = dx + row * cols;
  for (int64_t j = lane; j < cols; j += kWarp)
    store(xr + j, to_float(pr[j]) * (to_float(gr[j]) - dot));
}

// ---------------------------------------------------------------------------
// K2 past 1024 columns
// ---------------------------------------------------------------------------
constexpr int kWideMaxThreads = 1024;
constexpr int kWideMinThreads = 256;
constexpr int kWideMaxCluster = 8;
constexpr int kWideMinSlice = 1024;   // columns a CTA of a cluster keeps
constexpr int kWideMaxValues = 32;    // values a thread holds on chip

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// max and sum over the CTA's blockDim.x / 32 warps (each reduces its lanes
// first), every thread getting the result; red holds 32 floats of shared
// memory, read in warp order
__device__ __forceinline__ float cta_max(float v, float* red) {
  v = warp_max(v);
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)blockDim.x / kWarp; ++w) v = fmaxf(v, red[w]);
  return v;
}
__device__ __forceinline__ float cta_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)blockDim.x / kWarp; ++w) v += red[w];
  return v;
}

// The cluster barrier: arrive without ordering memory (each CTA's
// mbarrier init is ordered by its own fence), then wait with acquire.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Thread 0 readies the CTA's two exchange mbarriers (one for the max,
// one for the sum), each completing when K * 4 bytes have arrived; the
// cluster barrier's arrive follows, its wait comes before the first
// st.async into another CTA (cluster_exchange).
__device__ __forceinline__ void exchange_init(uint64_t* bar, int K) {
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_addr(bar + b)));
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_addr(bar + b)), "r"(K * 4) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive_relaxed();
}

// The cluster's max (MAX) or sum of the K CTAs' values v (the same in
// every thread of a CTA): thread q < K sends v into slot [rank] of CTA
// q's slots by st.async, counted by CTA q's mbarrier bar; once all K
// have arrived every thread reads the slots in rank order, so that every
// CTA of the cluster gets the same result.  No CTA leaves before the K
// values sent to it have arrived, so none is written after it left.
template <bool MAX>
__device__ __forceinline__ float cluster_exchange(float v, float* slots,
                                                  uint64_t* bar, int K) {
  if ((int)threadIdx.x < K) {
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

// Chunk c of thread i holds columns [(c * TH + i) * VEC, + VEC) of the
// slice, whole or past its width w (w % VEC == 0); -inf past w.
template <typename T, int N, int VEC>
__device__ __forceinline__ void load_slice(const T* __restrict__ xr,
                                           float* v, int w, int i, int TH) {
#pragma unroll
  for (int c = 0; c < N / VEC; ++c) {
    const int col = (c * TH + i) * VEC;
    if (col < w) {
      load_vec<T, VEC>(xr + col, v + c * VEC);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[c * VEC + e] = -INFINITY;
    }
  }
}

// Row blockIdx.x / K is held by the K CTAs of one cluster (K = 1: no
// cluster); CTA k holds columns [k * span, min((k + 1) * span, cols)),
// N values a thread.
template <typename T, int N, int VEC>
__global__ void __launch_bounds__(kWideMaxThreads)
    softmax_rows_onchip_kernel(const T* __restrict__ x, T* __restrict__ y,
                               int64_t cols, int span, int K) {
  __shared__ float red_m[kWarp], red_s[kWarp];
  __shared__ float part[2][kWideMaxCluster];  // the cluster's partials
  __shared__ __align__(8) uint64_t bar[2];
  if (K > 1) exchange_init(bar, K);
  const int64_t row = blockIdx.x / K;
  const int64_t c0 = (int64_t)(blockIdx.x % K) * span;
  const int w = (int)(cols - c0 < span ? cols - c0 : span);
  const T* xr = x + row * cols + c0;
  T* yr = y + row * cols + c0;
  const int TH = blockDim.x, i = threadIdx.x;
  constexpr int CH = N / VEC;
  float v[N];
  load_slice<T, N, VEC>(xr, v, w, i, TH);

  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < N; ++k) m = fmaxf(m, v[k]);
  m = cta_max(m, red_m);
  if (K > 1) {
    cluster_wait();  // every CTA's mbarriers are ready
    m = cluster_exchange<true>(m, part[0], bar, K);
  }

  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const bool in = (c * TH + i) * VEC < w;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float p = in ? expf(v[c * VEC + e] - m) : 0.0f;
      v[c * VEC + e] = p;
      s += p;
    }
  }
  s = cta_sum(s, red_s);
  if (K > 1) s = cluster_exchange<false>(s, part[1], bar + 1, K);

#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (c * TH + i) * VEC;
    if (col < w) {
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = __fdiv_rn(v[c * VEC + e], s);
      store_vec<T, VEC, true>(yr + col, o);
    }
  }
}

// (m, s) of a running softmax sum rescaled to the larger max nm; the
// scale is 1 where the max did not move (-inf included)
__device__ __forceinline__ float rescale(float s, float m, float nm) {
  return m == nm ? s : s * expf(m - nm);
}
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float nm = fmaxf(m, m2);
  s = rescale(s, m, nm) + rescale(s2, m2, nm);
  m = nm;
}

// One CTA a row; each thread keeps an online max and a rescaled sum over
// its chunks of VEC columns (a -inf column adds 0, a NaN adds NaN), the
// pairs are merged across the warp and then across the CTA in warp order,
// and the write pass reads x again.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWideMaxThreads)
    softmax_rows_stream_kernel(const T* __restrict__ x, T* __restrict__ y,
                               int64_t cols) {
  __shared__ float red_m[kWarp], red_s[kWarp];
  const T* xr = x + (int64_t)blockIdx.x * cols;
  T* yr = y + (int64_t)blockIdx.x * cols;
  const int64_t step = (int64_t)blockDim.x * VEC;
  float m = -INFINITY, s = 0.0f;
  for (int64_t col = (int64_t)threadIdx.x * VEC; col < cols; col += step) {
    float v[VEC];
    load_vec<T, VEC>(xr + col, v);
    float nm = m;
#pragma unroll
    for (int e = 0; e < VEC; ++e) nm = fmaxf(nm, v[e]);
    s = rescale(s, m, nm);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      s += v[e] == -INFINITY ? 0.0f : expf(v[e] - nm);
    m = nm;
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    merge(m, s, __shfl_xor_sync(0xffffffffu, m, off),
          __shfl_xor_sync(0xffffffffu, s, off));
  if (threadIdx.x % kWarp == 0) {
    red_m[threadIdx.x / kWarp] = m;
    red_s[threadIdx.x / kWarp] = s;
  }
  __syncthreads();
  m = red_m[0];
  s = red_s[0];
  for (int w = 1; w < (int)blockDim.x / kWarp; ++w)
    merge(m, s, red_m[w], red_s[w]);

  for (int64_t col = (int64_t)threadIdx.x * VEC; col < cols; col += step) {
    float v[VEC];
    load_vec<T, VEC>(xr + col, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = __fdiv_rn(expf(v[e] - m), s);
    store_vec<T, VEC, true>(yr + col, v);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Calls go(std::integral_constant<int, VEC>) with the widest VEC, of the
// VMAX values of T that 16 bytes hold, the 4 of an 8-byte bf16 load, and
// 1, that divides cols and to whose VEC * sizeof(T) bytes every pointer
// of ptrs is aligned (16 bytes for the fp32 bias, read 4 values a load).
template <typename T, int VMAX, typename Go>
void with_vec(int64_t cols, const void* const* ptrs, int n, const float* bias,
              Go go) {
  auto fits = [&](int vec) {
    if (cols % vec != 0 || (bias && !aligned(bias, 16))) return false;
    for (int k = 0; k < n; ++k)
      if (!aligned(ptrs[k], vec * sizeof(T))) return false;
    return true;
  };
  if (fits(VMAX)) {
    go(std::integral_constant<int, VMAX>{});
    return;
  }
  if constexpr (VMAX > 4) {
    if (fits(4)) {
      go(std::integral_constant<int, 4>{});
      return;
    }
  }
  go(std::integral_constant<int, 1>{});
}

template <typename T, int N>
constexpr int kVecMax = 16 / (int)sizeof(T) < N ? 16 / (int)sizeof(T) : N;

// K2 (bias null) or K5a: rows_per_block rows of W warps each
template <typename T, int N, int W>
void launch_regs(const T* x, const float* bias, T* y, int64_t rows,
                 int64_t bias_rows, int cols, int rows_per_block,
                 cudaStream_t st) {
  const unsigned blocks =
      (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  const int threads = rows_per_block * W * kWarp;
  const void* ptrs[] = {x, y};
  with_vec<T, kVecMax<T, N>>(cols, ptrs, 2, bias, [&](auto vec) {
    constexpr int V = decltype(vec)::value;
    if (bias)
      bias_softmax_regs_kernel<T, N, V, W><<<blocks, threads, 0, st>>>(
          x, bias, y, rows, bias_rows, cols);
    else
      softmax_regs_kernel<T, N, V, W><<<blocks, threads, 0, st>>>(
          x, y, rows, cols);
  });
}

// K2 past 1024 columns: the cluster size K, the CTA's threads and the
// values a thread N, from the row count, the SM count and C.
template <typename T, int VEC>
void launch_wide(const T* x, T* y, int64_t rows, int64_t cols,
                 cudaStream_t st) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t chunks = cols / VEC;
  // few rows: a cluster a row, until the CTAs fill half the SMs or a CTA
  // would keep fewer than kWideMinSlice columns
  int K = 1;
  while (K < kWideMaxCluster && rows * K * 2 <= sms &&
         cols >= (int64_t)2 * K * kWideMinSlice)
    K *= 2;
  // a slice must fit in kWideMaxThreads threads of kWideMaxValues values
  constexpr int64_t kFit = (int64_t)kWideMaxThreads * kWideMaxValues / VEC;
  while (K <= kWideMaxCluster && (chunks + K - 1) / K > kFit) K *= 2;
  if (K > kWideMaxCluster) {
    softmax_rows_stream_kernel<T, VEC>
        <<<(unsigned)rows, kWideMaxThreads, 0, st>>>(x, y, cols);
    return;
  }
  const int64_t slice = (chunks + K - 1) / K;  // chunks a CTA
  auto go = [&](auto n) {
    constexpr int N = decltype(n)::value;
    const int64_t need = (slice + N / VEC - 1) / (N / VEC);
    const int threads = (int)(need <= kWideMinThreads
                                  ? kWideMinThreads
                                  : (need + kWarp - 1) / kWarp * kWarp);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(rows * K));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = K > 1 ? 1 : 0;
    cudaLaunchKernelEx(&cfg, softmax_rows_onchip_kernel<T, N, VEC>, x, y,
                       cols, (int)(slice * VEC), K);
  };
  // the fewest values a thread with which kWideMaxThreads threads hold
  // the slice
  auto fits = [&](int n) {
    return (slice + n / VEC - 1) / (n / VEC) <= kWideMaxThreads;
  };
  if (fits(8))
    go(std::integral_constant<int, 8>{});
  else if (fits(16))
    go(std::integral_constant<int, 16>{});
  else
    go(std::integral_constant<int, kWideMaxValues>{});
}

template <typename T>
void launch(const void* x, const float* bias, void* y, int64_t rows,
            int64_t bias_rows, int64_t cols, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (cols <= 1024) {
    const int c = (int)cols;
    if (rows < 1024) {
      // few rows: one row a block of up to 8 warps, 4 values a lane, so
      // each lane's chain of loads, exps and divisions is short
      if (c <= 128)
        launch_regs<T, 4, 1>(xt, bias, yt, rows, bias_rows, c, 1, stream);
      else if (c <= 256)
        launch_regs<T, 4, 2>(xt, bias, yt, rows, bias_rows, c, 1, stream);
      else if (c <= 512)
        launch_regs<T, 4, 4>(xt, bias, yt, rows, bias_rows, c, 1, stream);
      else
        launch_regs<T, 4, 8>(xt, bias, yt, rows, bias_rows, c, 1, stream);
    } else {
      // many rows: one warp a row, four rows a block
      if (c <= 128)
        launch_regs<T, 4, 1>(xt, bias, yt, rows, bias_rows, c,
                             kRowsPerBlock, stream);
      else if (c <= 256)
        launch_regs<T, 8, 1>(xt, bias, yt, rows, bias_rows, c,
                             kRowsPerBlock, stream);
      else if (c <= 512)
        launch_regs<T, 16, 1>(xt, bias, yt, rows, bias_rows, c,
                              kRowsPerBlock, stream);
      else
        launch_regs<T, 32, 1>(xt, bias, yt, rows, bias_rows, c,
                              kRowsPerBlock, stream);
    }
    return;
  }
  if (bias) {
    const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    bias_softmax_rows_kernel<T><<<(unsigned)blocks, kRowsPerBlock * kWarp,
                                  0, stream>>>(xt, bias, yt, rows, bias_rows,
                                               cols);
    return;
  }
  const void* ptrs[] = {x, y};
  with_vec<T, 16 / (int)sizeof(T)>(cols, ptrs, 2, nullptr, [&](auto vec) {
    launch_wide<T, decltype(vec)::value>(xt, yt, rows, cols, stream);
  });
}

template <typename T, int N>
void launch_bwd_regs(const T* p, const T* dout, T* dx, int64_t rows,
                     int cols, cudaStream_t st) {
  const unsigned blocks =
      (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const void* ptrs[] = {p, dout, dx};
  with_vec<T, kVecMax<T, N>>(cols, ptrs, 3, nullptr, [&](auto vec) {
    softmax_bwd_regs_kernel<T, N, decltype(vec)::value>
        <<<blocks, kRowsPerBlock * kWarp, 0, st>>>(p, dout, dx, rows, cols);
  });
}

template <typename T>
void launch_bwd(const void* p, const void* dout, void* dx, int64_t rows,
                int64_t cols, cudaStream_t st) {
  const T* pt = static_cast<const T*>(p);
  const T* gt = static_cast<const T*>(dout);
  T* xt = static_cast<T*>(dx);
  const int c = (int)cols;
  if (cols <= 128)
    launch_bwd_regs<T, 4>(pt, gt, xt, rows, c, st);
  else if (cols <= 256)
    launch_bwd_regs<T, 8>(pt, gt, xt, rows, c, st);
  else if (cols <= 512)
    launch_bwd_regs<T, 16>(pt, gt, xt, rows, c, st);
  else if (cols <= 1024)
    launch_bwd_regs<T, 32>(pt, gt, xt, rows, c, st);
  else
    softmax_bwd_rows_kernel<T><<<(unsigned)((rows + kRowsPerBlock - 1) /
                                            kRowsPerBlock),
                                 kRowsPerBlock * kWarp, 0, st>>>(
        pt, gt, xt, rows, cols);
}

int dispatch(const void* x, const float* bias, void* y, int64_t rows,
             int64_t bias_rows, int64_t cols, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows > 0 && cols > 0) {
    if (dtype == 0)
      launch<float>(x, bias, y, rows, bias_rows, cols, st);
    else if (dtype == 1)
      launch<__nv_bfloat16>(x, bias, y, rows, bias_rows, cols, st);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K2.  x, y: a contiguous (rows, cols) matrix; dtype 0 = fp32, 1 = bf16.
// Returns cudaGetLastError() after the launch.
extern "C" int mxtt_softmax_lastaxis(const void* x, void* y, int64_t rows,
                                     int64_t cols, int dtype, void* stream) {
  return dispatch(x, nullptr, y, rows, 1, cols, dtype, stream);
}

// K5a.  x, y: contiguous (B, bias_rows, cols); bias: contiguous fp32
// (bias_rows, cols); rows = B * bias_rows.  Returns cudaGetLastError().
extern "C" int mxtt_bias_softmax(const void* x, const float* bias, void* y,
                                 int64_t rows, int64_t bias_rows,
                                 int64_t cols, int dtype, void* stream) {
  if (bias == nullptr || bias_rows <= 0) return (int)cudaErrorInvalidValue;
  return dispatch(x, bias, y, rows, bias_rows, cols, dtype, stream);
}

// K5b.  p, do, dx: contiguous (rows, cols); dtype 0 = fp32, 1 = bf16.
// Returns cudaGetLastError() after the launch.
extern "C" int mxtt_softmax_bwd(const void* p, const void* dout, void* dx,
                                int64_t rows, int64_t cols, int dtype,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows > 0 && cols > 0) {
    if (dtype == 0)
      launch_bwd<float>(p, dout, dx, rows, cols, st);
    else if (dtype == 1)
      launch_bwd<__nv_bfloat16>(p, dout, dx, rows, cols, st);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
