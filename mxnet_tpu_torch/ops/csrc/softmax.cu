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
// K2 rows of up to 1024 columns (softmax_regs_kernel) keep the row in
// registers and read it once:
//   - below 1024 rows (the serving batches), one row a block of W = 1,
//     2, 4 or 8 warps (C <= 128, 256, 512, 1024), each lane holding 4
//     values: a batch of 1-32 rows spreads over as many SMs as it has
//     rows, and each lane's chain of loads, exps and divisions is 4 long;
//     from 1024 rows on, one warp a row and four rows a block, each lane
//     holding N = 4, 8, 16 or 32 values;
//   - the row is loaded once, with one round of independent 16-byte
//     loads where C and the row start allow it (VEC columns a load: fp32
//     C % 4 == 0, bf16 C % 8 == 0, or 8-byte bf16 loads at N 4) and
//     scalar loads otherwise, the columns past C held at -inf;
//   - the max and the exp-sum reduced over those registers with warp
//     shuffles (and, for W > 1, across the block's warps through shared
//     memory), then one vectorised write of exp(x - max) / sum.
// Rows wider than 1024 (K2), K5a and K5b keep the strided form, right for
// any width: one warp per row, four rows per 128-thread block, no shared
// memory and no block barrier; K2/K5a a max pass, an exp-sum pass and the
// normalised write, K5b the row dot and the write, all in fp32, the row
// re-read from L1/L2; K5a adds bias[row % R] in fp32 in every pass, so the
// bias is never broadcast to x's size in memory.  Any row count and any
// column count, with no padding.  The TPU kernel pads C to whole 128-lane
// tiles with a finite -1e30 (0 for p and do), a Mosaic layout rule that
// has no counterpart here.
// The arithmetic is the same on both forms: fp32 max, expf, an fp32 sum
// and a correctly rounded division e / sum, rounded once to x's dtype.
// Subtracting the row max keeps every exponent <= 0, so logits of any
// finite size (1e4 and beyond) give finite probabilities, and C = 1 gives
// exactly 1.  A masked column (bias -1e30) underflows to exactly 0 as
// long as its row keeps one unmasked column, and its dx is then exactly 0.
// A NaN logit makes its row NaN, as in the plain version.
#include <cmath>
#include <cstdint>
#include <cstring>
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

// rows = B * bias_rows; row r adds bias row r % bias_rows.
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

// VEC values of T as one load of VEC * sizeof(T) bytes
template <int BYTES> struct Bits;
template <> struct Bits<16> { using type = uint4; };
template <> struct Bits<8> { using type = uint2; };

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (VEC == 1) {
    out[0] = to_float(*p);
  } else {
    using B = typename Bits<VEC * sizeof(T)>::type;
    const B raw = *reinterpret_cast<const B*>(p);
    T t[VEC];
    memcpy(t, &raw, sizeof(B));
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = to_float(t[e]);
  }
}

template <typename T, int VEC>
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

// K2 for cols <= 32 * W * N: the row in the registers of W warps, N values
// a lane.  W == 1: one warp a row, blockDim / 32 rows a block; W > 1: one
// row a block of W warps.  Chunk c of thread i (i < 32 W) holds columns
// [(c * 32 W + i) * VEC, + VEC), whole or past cols (cols % VEC == 0), so
// the loads of one chunk are contiguous.
template <typename T, int N, int VEC, int W>
__global__ void softmax_regs_kernel(const T* __restrict__ x,
                                    T* __restrict__ y, int64_t rows,
                                    int cols) {
  constexpr int TH = kWarp * W;    // threads of one row
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / TH) +
                      threadIdx.x / TH;
  if (row >= rows) return;
  const int i = threadIdx.x % TH;
  const T* xr = x + row * cols;
  T* yr = y + row * cols;
  constexpr int CH = N / VEC;
  __shared__ float red_m[W], red_s[W];
  float v[N];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (c * TH + i) * VEC;
    if (col < cols) {
      load_vec<T, VEC>(xr + col, v + c * VEC);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[c * VEC + e] = -INFINITY;
    }
  }
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
      store_vec<T, VEC>(yr + col, o);
    }
  }
}

// rows_per_block rows of W warps each
template <typename T, int N, int W>
void launch_regs(const T* x, T* y, int64_t rows, int cols, int rows_per_block,
                 cudaStream_t st) {
  constexpr int VEC = 16 / (int)sizeof(T) < N ? 16 / (int)sizeof(T) : N;
  const uintptr_t align = VEC * sizeof(T);
  const bool vec = cols % VEC == 0 && (uintptr_t)x % align == 0 &&
                   (uintptr_t)y % align == 0;
  const unsigned blocks =
      (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  const int threads = rows_per_block * W * kWarp;
  if (vec)
    softmax_regs_kernel<T, N, VEC, W><<<blocks, threads, 0, st>>>(x, y, rows,
                                                                  cols);
  else
    softmax_regs_kernel<T, N, 1, W><<<blocks, threads, 0, st>>>(x, y, rows,
                                                                cols);
}

template <typename T>
void launch(const void* x, const float* bias, void* y, int64_t rows,
            int64_t bias_rows, int64_t cols, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (!bias && cols <= 1024) {
    const int c = (int)cols;
    if (rows < 1024) {
      // few rows: one row a block of up to 8 warps, 4 values a lane, so
      // each lane's chain of loads, exps and divisions is short
      if (c <= 128)
        launch_regs<T, 4, 1>(xt, yt, rows, c, 1, stream);
      else if (c <= 256)
        launch_regs<T, 4, 2>(xt, yt, rows, c, 1, stream);
      else if (c <= 512)
        launch_regs<T, 4, 4>(xt, yt, rows, c, 1, stream);
      else
        launch_regs<T, 4, 8>(xt, yt, rows, c, 1, stream);
    } else {
      // many rows: one warp a row, four rows a block
      if (c <= 128)
        launch_regs<T, 4, 1>(xt, yt, rows, c, 4, stream);
      else if (c <= 256)
        launch_regs<T, 8, 1>(xt, yt, rows, c, 4, stream);
      else if (c <= 512)
        launch_regs<T, 16, 1>(xt, yt, rows, c, 4, stream);
      else
        launch_regs<T, 32, 1>(xt, yt, rows, c, 4, stream);
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

// K5b: one warp per row of p, do and dx, each (rows, cols).
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
    const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    if (dtype == 0)
      softmax_bwd_rows_kernel<float><<<(unsigned)blocks,
                                       kRowsPerBlock * kWarp, 0, st>>>(
          static_cast<const float*>(p), static_cast<const float*>(dout),
          static_cast<float*>(dx), rows, cols);
    else if (dtype == 1)
      softmax_bwd_rows_kernel<__nv_bfloat16><<<(unsigned)blocks,
                                               kRowsPerBlock * kWarp, 0,
                                               st>>>(
          static_cast<const __nv_bfloat16*>(p),
          static_cast<const __nv_bfloat16*>(dout),
          static_cast<__nv_bfloat16*>(dx), rows, cols);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
