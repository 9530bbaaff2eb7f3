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
// moves 0.8 GB, K5b 1.2 GB.
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
// Rows wider than 1024 keep the strided form, right for any width: one
// warp per row, four rows per 128-thread block, no shared memory and no
// block barrier; K2/K5a a max pass, an exp-sum pass and the normalised
// write, K5b the row dot and the write, all in fp32, the row re-read from
// L1/L2; K5a adds bias[row % R] in fp32 in every pass, so the bias is
// never broadcast to x's size in memory.  Any row count and any column
// count, with no padding.  The TPU kernel pads C to whole 128-lane tiles
// with a finite -1e30 (0 for p and do), a Mosaic layout rule that has no
// counterpart here.  Every byte of the operands is read: no column is
// skipped where p is 0 or the bias masks it, so a NaN anywhere in a row
// reaches the whole row.
// The arithmetic is the same on every form: fp32 max, expf, an fp32 sum
// and a correctly rounded division e / sum, rounded once to x's dtype
// (K5b: an fp32 dot and p * (do - dot), rounded once).  Subtracting the
// row max keeps every exponent <= 0, so logits of any finite size (1e4
// and beyond) give finite probabilities, and C = 1 gives exactly 1.  A
// masked column (bias -1e30) underflows to exactly 0 as long as its row
// keeps one unmasked column, and its dx is then exactly 0; a row masked
// entirely comes out uniform (x + -1e30 rounds to -1e30 in fp32).
#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// One row: x and y point at the row, bias at its bias row or is null.
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

// K2 for cols > 1024 (the strided three-pass form)
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

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Calls go(std::integral_constant<int, VEC>) with the widest VEC, of the
// VMAX values of T that 16 bytes hold, the 4 of an 8-byte bf16 load, and
// 1, that divides cols and to whose VEC * sizeof(T) bytes every pointer
// of ptrs is aligned (16 bytes for the fp32 bias, read 4 values a load).
template <typename T, int VMAX, typename Go>
void with_vec(int cols, const void* const* ptrs, int n, const float* bias,
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
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (bias)
    bias_softmax_rows_kernel<T><<<(unsigned)blocks, kRowsPerBlock * kWarp,
                                  0, stream>>>(xt, bias, yt, rows, bias_rows,
                                               cols);
  else
    softmax_rows_kernel<T><<<(unsigned)blocks, kRowsPerBlock * kWarp, 0,
                             stream>>>(xt, yt, rows, cols);
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
