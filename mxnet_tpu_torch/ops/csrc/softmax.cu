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
// kilobytes and the launch is the cost; K5a at the attention shape (96,
// 1020, 1020) moves 0.8 GB, K5b 1.2 GB.  The design is the simplest that
// is right for any shape:
//   - one warp per row, four rows per 128-thread block: no shared memory
//     and no block barrier, the reductions are warp shuffles;
//   - K2/K5a: a max pass, then an exp-sum pass, then the normalised write;
//     K5b: the row dot, then the write; all in fp32; the row is re-read
//     from L1/L2, not from HBM, for rows of a few thousand columns;
//   - K5a adds bias[row % R] in fp32 in every pass, so the bias is never
//     broadcast to x's size in memory;
//   - any row count and any column count, with no padding.  The TPU
//     kernel pads C to whole 128-lane tiles with a finite -1e30 (0 for
//     p and do), a Mosaic layout rule that has no counterpart here.
// Subtracting the row max keeps every exponent <= 0, so logits of any
// finite size (1e4 and beyond) give finite probabilities, and C = 1 gives
// exactly 1.  A masked column (bias -1e30) underflows to exactly 0 as
// long as its row keeps one unmasked column, and its dx is then exactly 0.
// A NaN logit makes its row NaN, as in the plain version.
#include <cmath>
#include <cstdint>
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

template <typename T>
void launch(const void* x, const float* bias, void* y, int64_t rows,
            int64_t bias_rows, int64_t cols, cudaStream_t stream) {
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (bias)
    bias_softmax_rows_kernel<T><<<(unsigned)blocks, kRowsPerBlock * kWarp,
                                  0, stream>>>(
        static_cast<const T*>(x), bias, static_cast<T*>(y), rows, bias_rows,
        cols);
  else
    softmax_rows_kernel<T><<<(unsigned)blocks, kRowsPerBlock * kWarp, 0,
                             stream>>>(static_cast<const T*>(x),
                                       static_cast<T*>(y), rows, cols);
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
