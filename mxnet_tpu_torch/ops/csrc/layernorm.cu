// LayerNorm over the last axis, the forward (K6a) and the backward's dx
// (K6b):
//   K6a: mu = mean(x), xc = x - mu, var = mean(xc * xc),
//        rstd = rsqrt(var + eps), o = (xc * rstd) * gamma + beta, and mu,
//        rstd saved per row;
//   K6b: xhat = (x - mu) * rstd, dxh = do * gamma,
//        dx = rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat)),
//        from the mu and rstd K6a saved.  dgamma = sum(do * xhat) and
//        dbeta = sum(do) over the rows stay plain torch reductions, as in
//        the JAX package.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _layernorm_fwd_kernel (K6a)
// and mxnet_tpu/ops/pallas_kernels.py _layernorm_bwd_kernel (K6b), reached
// through fused_layernorm -> _layernorm_fwd and _fused_layernorm_bwd_rule (the LayerNorm op, ops/nn.py, when
// MXNET_PALLAS_NORM is on).
//
// Bound on Hopper: memory bytes.  Each element is read once and written
// once (K6b: x and do read, dx written) with ~8-10 fp32 operations
// between, far below the ~20 operations per byte where the fp32 units
// would become the limit; at the transformer's shape, (8192, 768), K6a
// moves 50 MB in fp32, K6b 75.5 MB in fp32 (0.0225 ms at 3.35 TB/s) and
// 37.7 MB in bf16 (0.0113 ms).
//
// K6b, where C <= 1024, C is a multiple of the 16-byte vector (4 fp32 or
// 8 bf16 values) and x, do, dx and gamma are 16-byte aligned (the
// transformer's rows are): a persistent grid of 128-thread blocks, as
// many as fit on the card at once and spread so that every warp takes
// the same number of rows (give or take one), each warp striding over
// rows.  A lane loads its slice of gamma (fp32) into registers once for
// all its rows, reads CH chunks of x and do with 16-byte loads (every
// load of a row issued before its first multiply; at C 768 six chunks a
// lane in fp32, three in bf16), reduces the two row means in one shuffle
// loop and writes dx with 16-byte streaming stores (evicted first:
// nothing reads them again here).  x and do are read as streaming in
// fp32 only (kStreamIn).  Other rows take K6a's layouts below.
//
// Any C >= 1 and any row count, with no padding, in three layouts chosen
// by C (K6a, and K6b where the vector layout does not apply):
//   - C <= 1024: one warp per row, four rows per 128-thread block: no
//     shared memory and no block barrier, the reductions are warp
//     shuffles; each lane holds VPT = ceil(C / 32) values (a template
//     argument), element lane + 32 i, so a warp's loads are coalesced and
//     the row is read from device memory exactly once;
//   - 1024 < C <= 8192: one 256-thread block per row, each thread holding
//     VPT = ceil(C / 256) values in registers (element tid + 256 i); the
//     reductions are warp shuffles and then a sum of the 8 warps' partials
//     through shared memory; the row is still read once;
//   - C > 8192: one 256-thread block per row striding over the row in
//     device memory, which K6a reads three times (mean, centred squares,
//     output) and K6b twice (the two row means, dx); the re-reads of one
//     row hit L2.
// K6a makes two passes, the mean and then the mean of the centred
// squares, as the TPU kernel computes them (not E[x^2] - mu^2, which
// cancels when |mu| >> std); K6b's two row means are one pass.  All in
// fp32.  The TPU kernels need C % 128 == 0 (Mosaic's lane tiling) and
// broadcast mu and rstd over 128 lanes; here they are one fp32 per row.
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
constexpr int kWarpMaxCols = 1024;   // the warp-per-row layout's limit
constexpr int kBlock = 256;          // threads of the block-per-row layouts
constexpr int kBlockWarps = kBlock / kWarp;
constexpr int kBlockMaxVpt = 32;     // registers per thread, C <= 8192

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int VPT>
__global__ void layernorm_fwd_kernel(const T* __restrict__ x,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     T* __restrict__ o, float* __restrict__ mu,
                                     float* __restrict__ rstd, int64_t rows,
                                     int cols, float eps) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  const T* xr = x + row * cols;
  T* orow = o + row * cols;

  float v[VPT];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = lane + kWarp * i;
    v[i] = j < cols ? to_float(xr[j]) : 0.0f;
    s += v[i];
  }
  const float mean = warp_sum(s) / (float)cols;

  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = lane + kWarp * i;
    if (j < cols) {
      v[i] -= mean;
      q += v[i] * v[i];
    }
  }
  const float var = warp_sum(q) / (float)cols;
  const float rs = rsqrtf(var + eps);

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = lane + kWarp * i;
    if (j < cols) store(orow + j, (v[i] * rs) * gamma[j] + beta[j]);
  }
  if (lane == 0) {
    mu[row] = mean;
    rstd[row] = rs;
  }
}

// sum over the block of kBlock threads; red holds kBlockWarps floats and
// is not reused by a later call, so one barrier is enough
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) t += red[w];
  return t;
}

// one block per row, VPT values per thread in registers (C <= kBlock * VPT)
template <typename T, int VPT>
__global__ void __launch_bounds__(kBlock)
    layernorm_fwd_row_kernel(const T* __restrict__ x,
                             const float* __restrict__ gamma,
                             const float* __restrict__ beta,
                             T* __restrict__ o, float* __restrict__ mu,
                             float* __restrict__ rstd, int cols, float eps) {
  __shared__ float red[2][kBlockWarps];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * cols;
  T* orow = o + row * cols;

  float v[VPT];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = tid + kBlock * i;
    v[i] = j < cols ? to_float(xr[j]) : 0.0f;
    s += v[i];
  }
  const float mean = block_sum(s, red[0]) / (float)cols;

  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = tid + kBlock * i;
    if (j < cols) {
      v[i] -= mean;
      q += v[i] * v[i];
    }
  }
  const float rs = rsqrtf(block_sum(q, red[1]) / (float)cols + eps);

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = tid + kBlock * i;
    if (j < cols) store(orow + j, (v[i] * rs) * gamma[j] + beta[j]);
  }
  if (tid == 0) {
    mu[row] = mean;
    rstd[row] = rs;
  }
}

// one block per row of any width, striding over it in device memory
template <typename T>
__global__ void __launch_bounds__(kBlock)
    layernorm_fwd_wide_kernel(const T* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              T* __restrict__ o, float* __restrict__ mu,
                              float* __restrict__ rstd, int cols, float eps) {
  __shared__ float red[2][kBlockWarps];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * cols;
  T* orow = o + row * cols;

  float s = 0.0f;
  for (int j = tid; j < cols; j += kBlock) s += to_float(xr[j]);
  const float mean = block_sum(s, red[0]) / (float)cols;

  float q = 0.0f;
  for (int j = tid; j < cols; j += kBlock) {
    const float c = to_float(xr[j]) - mean;
    q += c * c;
  }
  const float rs = rsqrtf(block_sum(q, red[1]) / (float)cols + eps);

  for (int j = tid; j < cols; j += kBlock)
    store(orow + j, ((to_float(xr[j]) - mean) * rs) * gamma[j] + beta[j]);
  if (tid == 0) {
    mu[row] = mean;
    rstd[row] = rs;
  }
}

// K6b, one warp per row (C <= kWarpMaxCols)
template <typename T, int VPT>
__global__ void layernorm_bwd_kernel(const T* __restrict__ x,
                                     const T* __restrict__ dout,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ mu,
                                     const float* __restrict__ rstd,
                                     T* __restrict__ dx, int64_t rows,
                                     int cols) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  const T* xr = x + row * cols;
  const T* dr = dout + row * cols;
  const float m = mu[row], rs = rstd[row];

  float xh[VPT], g[VPT];
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = lane + kWarp * i;
    xh[i] = g[i] = 0.0f;
    if (j < cols) {
      xh[i] = (to_float(xr[j]) - m) * rs;
      g[i] = to_float(dr[j]) * gamma[j];
      s1 += g[i];
      s2 += g[i] * xh[i];
    }
  }
  const float c1 = warp_sum(s1) / (float)cols;
  const float c2 = warp_sum(s2) / (float)cols;

  T* dxr = dx + row * cols;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = lane + kWarp * i;
    if (j < cols) store(dxr + j, rs * (g[i] - c1 - xh[i] * c2));
  }
}

// K6b's vector layout (C <= 1024, C % VEC == 0, 16-byte aligned rows):
// a persistent grid of warps, each striding over rows.  Lane l holds
// chunks c * 32 + l (c < CH) of VEC columns each, VEC = 16 / sizeof(T),
// so every load of x and do is 16 bytes; its slice of gamma (fp32) sits
// in registers for all its rows.  Measured on an H100 and not kept: the
// next row's loads issued before this row's reductions, in a second
// register set that takes turns with the first: 159-168 registers a
// thread against 96-128, three blocks an SM instead of five, no faster in
// fp32 and slower in bf16; above 24 values a lane the two sets spill.
constexpr int kBwdWarps = 4;  // warps of a block of the vector layout
// x and do read as streaming (evicted first) in fp32 only: there the
// hints take K6b from 81% to 97% of its byte bound (back to back, on an
// H100), while in bf16 they were no faster, and up to 11% slower with the
// L2 cache flushed before each launch
template <typename T>
constexpr bool kStreamIn = sizeof(T) == 4;

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
};

// VEC = 16 / sizeof(T) values of T at p (16-byte aligned), as fp32;
// nothing reads them again in this kernel
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  constexpr int VEC = Vec16<T>::N;
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 raw;
  if constexpr (kStreamIn<T>)
    raw = __ldcs(q);
  else
    raw = *q;
  T t[VEC];
  memcpy(t, &raw, sizeof(raw));
#pragma unroll
  for (int e = 0; e < VEC; ++e) out[e] = to_float(t[e]);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float* in) {
  constexpr int VEC = Vec16<T>::N;
  T t[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) store(t + e, in[e]);
  uint4 raw;
  memcpy(&raw, t, sizeof(raw));
  __stcs(reinterpret_cast<uint4*>(p), raw);
}

// One row's operands in a lane's registers: x and do (columns past C are
// 0, adding nothing to the sums), and the row's mu and rstd.
template <typename T, int CH>
struct BwdRow {
  float x[CH * Vec16<T>::N], d[CH * Vec16<T>::N];
  float m, rs;

  __device__ __forceinline__ void load(const T* __restrict__ x_,
                                       const T* __restrict__ dout,
                                       const float* __restrict__ mu,
                                       const float* __restrict__ rstd,
                                       int64_t row, int cols, int lane) {
    constexpr int VEC = Vec16<T>::N;
    const T* xr = x_ + row * cols;
    const T* dr = dout + row * cols;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int col = (c * kWarp + lane) * VEC;
      if (col < cols) {
        load16(xr + col, x + c * VEC);
        load16(dr + col, d + c * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[c * VEC + e] = d[c * VEC + e] = 0.0f;
      }
    }
    m = mu[row];
    rs = rstd[row];
  }

  // dx of this row from the lane's gamma slice g: both row sums in one
  // shuffle loop, then one 16-byte streaming store a chunk
  __device__ __forceinline__ void finish(const float* g, T* __restrict__ dx,
                                         int64_t row, int cols, int lane) {
    constexpr int VEC = Vec16<T>::N;
    constexpr int N = CH * VEC;
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      x[k] = (x[k] - m) * rs;      // xhat (garbage past C, never stored)
      d[k] *= g[k];                // dxh (0 past C)
      s1 += d[k];
      s2 += d[k] * x[k];
    }
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float c1 = s1 / (float)cols, c2 = s2 / (float)cols;
    T* dxr = dx + row * cols;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int col = (c * kWarp + lane) * VEC;
      if (col < cols) {
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int k = c * VEC + e;
          o[e] = rs * (d[k] - c1 - x[k] * c2);
        }
        store16(dxr + col, o);
      }
    }
  }
};

template <typename T, int CH>
__global__ void __launch_bounds__(kBwdWarps * kWarp)
    layernorm_bwd_regs_kernel(const T* __restrict__ x,
                              const T* __restrict__ dout,
                              const float* __restrict__ gamma,
                              const float* __restrict__ mu,
                              const float* __restrict__ rstd,
                              T* __restrict__ dx, int64_t rows, int cols) {
  constexpr int VEC = Vec16<T>::N;
  const int lane = threadIdx.x % kWarp;
  const int64_t stride = (int64_t)gridDim.x * kBwdWarps;
  int64_t row = (int64_t)blockIdx.x * kBwdWarps + threadIdx.x / kWarp;
  if (row >= rows) return;
  float g[CH * VEC];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (c * kWarp + lane) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (col < cols) v = *reinterpret_cast<const float4*>(gamma + col + e);
      g[c * VEC + e] = v.x;
      g[c * VEC + e + 1] = v.y;
      g[c * VEC + e + 2] = v.z;
      g[c * VEC + e + 3] = v.w;
    }
  }
  BwdRow<T, CH> a;
  for (; row < rows; row += stride) {
    a.load(x, dout, mu, rstd, row, cols, lane);
    a.finish(g, dx, row, cols, lane);
  }
}

// K6b, one block per row, VPT values per thread in registers
template <typename T, int VPT>
__global__ void __launch_bounds__(kBlock)
    layernorm_bwd_row_kernel(const T* __restrict__ x,
                             const T* __restrict__ dout,
                             const float* __restrict__ gamma,
                             const float* __restrict__ mu,
                             const float* __restrict__ rstd,
                             T* __restrict__ dx, int cols) {
  __shared__ float red[2][kBlockWarps];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * cols;
  const T* dr = dout + row * cols;
  const float m = mu[row], rs = rstd[row];

  float xh[VPT], g[VPT];
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = tid + kBlock * i;
    xh[i] = g[i] = 0.0f;
    if (j < cols) {
      xh[i] = (to_float(xr[j]) - m) * rs;
      g[i] = to_float(dr[j]) * gamma[j];
      s1 += g[i];
      s2 += g[i] * xh[i];
    }
  }
  const float c1 = block_sum(s1, red[0]) / (float)cols;
  const float c2 = block_sum(s2, red[1]) / (float)cols;

  T* dxr = dx + row * cols;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int j = tid + kBlock * i;
    if (j < cols) store(dxr + j, rs * (g[i] - c1 - xh[i] * c2));
  }
}

// K6b, one block per row of any width, striding over it in device memory
template <typename T>
__global__ void __launch_bounds__(kBlock)
    layernorm_bwd_wide_kernel(const T* __restrict__ x,
                              const T* __restrict__ dout,
                              const float* __restrict__ gamma,
                              const float* __restrict__ mu,
                              const float* __restrict__ rstd,
                              T* __restrict__ dx, int cols) {
  __shared__ float red[2][kBlockWarps];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * cols;
  const T* dr = dout + row * cols;
  const float m = mu[row], rs = rstd[row];

  float s1 = 0.0f, s2 = 0.0f;
  for (int j = tid; j < cols; j += kBlock) {
    const float xh = (to_float(xr[j]) - m) * rs;
    const float g = to_float(dr[j]) * gamma[j];
    s1 += g;
    s2 += g * xh;
  }
  const float c1 = block_sum(s1, red[0]) / (float)cols;
  const float c2 = block_sum(s2, red[1]) / (float)cols;

  T* dxr = dx + row * cols;
  for (int j = tid; j < cols; j += kBlock) {
    const float xh = (to_float(xr[j]) - m) * rs;
    const float g = to_float(dr[j]) * gamma[j];
    store(dxr + j, rs * (g - c1 - xh * c2));
  }
}

// The backward's launches, by the same three layouts as the forward's.
template <typename T>
struct Bwd {
  const void *x, *dout;
  const float *gamma, *mu, *rstd;
  void* dx;
  int64_t rows;
  int cols;
  cudaStream_t st;

  template <int VPT>
  void warp_rows() const {
    const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    layernorm_bwd_kernel<T, VPT><<<(unsigned)blocks, kRowsPerBlock * kWarp,
                                   0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dout), gamma, mu,
        rstd, static_cast<T*>(dx), rows, cols);
  }
  template <int VPT>
  void block_rows() const {
    layernorm_bwd_row_kernel<T, VPT><<<(unsigned)rows, kBlock, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dout), gamma, mu,
        rstd, static_cast<T*>(dx), cols);
  }
  // the vector layout at CH chunks a lane: at most as many blocks as fit
  // on the card at once, spread so that every warp takes the same number
  // of rows (give or take one), not a last round of a few warps
  template <int CH>
  void vec_rows() const {
    int dev = 0, sms = 1, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, layernorm_bwd_regs_kernel<T, CH>, kBwdWarps * kWarp, 0);
    const int64_t need = (rows + kBwdWarps - 1) / kBwdWarps;
    const int64_t fit =
        (int64_t)(sms > 1 ? sms : 1) * (per_sm > 1 ? per_sm : 1);
    const int64_t rounds = (need + fit - 1) / fit;
    const int64_t blocks = (need + rounds - 1) / rounds;
    layernorm_bwd_regs_kernel<T, CH>
        <<<(unsigned)blocks, kBwdWarps * kWarp, 0, st>>>(
            static_cast<const T*>(x), static_cast<const T*>(dout), gamma, mu,
            rstd, static_cast<T*>(dx), rows, cols);
  }
  // whether the vector layout takes these operands: C % VEC == 0 and
  // every row of x, do, dx and gamma 16-byte aligned
  bool vec_ok() const {
    constexpr int VEC = Vec16<T>::N;
    auto al = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    return cols % VEC == 0 && al(x) && al(dout) && al(dx) && al(gamma);
  }
  void run() const {
    if (cols <= kWarpMaxCols && vec_ok()) {
      // CH chunks of 16 bytes a lane: 4 (fp32) or 8 (bf16) values each
      const int ch = (cols / Vec16<T>::N + kWarp - 1) / kWarp;
      if (ch <= 1)
        vec_rows<1>();
      else if (ch <= 2)
        vec_rows<2>();
      else if (ch <= 3)
        vec_rows<3>();
      else if (ch <= 4)
        vec_rows<4>();
      else if (ch <= 6)
        vec_rows<6>();
      else
        vec_rows<8>();
      return;
    }
    if (cols > kBlock * kBlockMaxVpt) {
      layernorm_bwd_wide_kernel<T><<<(unsigned)rows, kBlock, 0, st>>>(
          static_cast<const T*>(x), static_cast<const T*>(dout), gamma, mu,
          rstd, static_cast<T*>(dx), cols);
      return;
    }
    if (cols > kWarpMaxCols) {
      const int vpt = (cols + kBlock - 1) / kBlock;
      if (vpt <= 8)
        block_rows<8>();
      else if (vpt <= 16)
        block_rows<16>();
      else
        block_rows<kBlockMaxVpt>();
      return;
    }
    const int vpt = (cols + kWarp - 1) / kWarp;
    if (vpt <= 1)
      warp_rows<1>();
    else if (vpt <= 2)
      warp_rows<2>();
    else if (vpt <= 4)
      warp_rows<4>();
    else if (vpt <= 8)
      warp_rows<8>();
    else if (vpt <= 16)
      warp_rows<16>();
    else if (vpt <= 24)
      warp_rows<24>();
    else
      warp_rows<32>();
  }
};

template <typename T, int VPT>
void launch_rows(const void* x, const float* g, const float* b, void* o,
                 float* mu, float* rs, int64_t rows, int cols, float eps,
                 cudaStream_t st) {
  layernorm_fwd_row_kernel<T, VPT><<<(unsigned)rows, kBlock, 0, st>>>(
      static_cast<const T*>(x), g, b, static_cast<T*>(o), mu, rs, cols, eps);
}

template <typename T, int VPT>
void launch(const void* x, const float* g, const float* b, void* o, float* mu,
            float* rs, int64_t rows, int cols, float eps, cudaStream_t st) {
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layernorm_fwd_kernel<T, VPT><<<(unsigned)blocks, kRowsPerBlock * kWarp, 0,
                                 st>>>(static_cast<const T*>(x), g, b,
                                       static_cast<T*>(o), mu, rs, rows, cols,
                                       eps);
}

template <typename T>
int launch_cols(const void* x, const float* g, const float* b, void* o,
                float* mu, float* rs, int64_t rows, int cols, float eps,
                cudaStream_t st) {
  if (cols > kBlock * kBlockMaxVpt) {
    layernorm_fwd_wide_kernel<T><<<(unsigned)rows, kBlock, 0, st>>>(
        static_cast<const T*>(x), g, b, static_cast<T*>(o), mu, rs, cols,
        eps);
    return 0;
  }
  if (cols > kWarpMaxCols) {
    const int vpt = (cols + kBlock - 1) / kBlock;
    if (vpt <= 8)
      launch_rows<T, 8>(x, g, b, o, mu, rs, rows, cols, eps, st);
    else if (vpt <= 16)
      launch_rows<T, 16>(x, g, b, o, mu, rs, rows, cols, eps, st);
    else
      launch_rows<T, kBlockMaxVpt>(x, g, b, o, mu, rs, rows, cols, eps, st);
    return 0;
  }
  const int vpt = (cols + kWarp - 1) / kWarp;
  if (vpt <= 1)
    launch<T, 1>(x, g, b, o, mu, rs, rows, cols, eps, st);
  else if (vpt <= 2)
    launch<T, 2>(x, g, b, o, mu, rs, rows, cols, eps, st);
  else if (vpt <= 4)
    launch<T, 4>(x, g, b, o, mu, rs, rows, cols, eps, st);
  else if (vpt <= 8)
    launch<T, 8>(x, g, b, o, mu, rs, rows, cols, eps, st);
  else if (vpt <= 16)
    launch<T, 16>(x, g, b, o, mu, rs, rows, cols, eps, st);
  else if (vpt <= 24)
    launch<T, 24>(x, g, b, o, mu, rs, rows, cols, eps, st);
  else
    launch<T, 32>(x, g, b, o, mu, rs, rows, cols, eps, st);
  return 0;
}

}  // namespace

// x, o: contiguous (rows, cols) in dtype 0 = fp32 or 1 = bf16, cols >= 1,
// rows < 2^31 when cols > 1024; gamma, beta: fp32 (cols,); mu, rstd: fp32
// (rows,).  Returns cudaGetLastError() after the launch.
extern "C" int mxtt_layernorm_fwd(const void* x, const float* gamma,
                                  const float* beta, void* o, float* mu,
                                  float* rstd, int64_t rows, int cols,
                                  float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cols < 1 || (cols > kWarpMaxCols && rows >= (int64_t(1) << 31)))
    return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    if (dtype == 0)
      launch_cols<float>(x, gamma, beta, o, mu, rstd, rows, cols, eps, st);
    else if (dtype == 1)
      launch_cols<__nv_bfloat16>(x, gamma, beta, o, mu, rstd, rows, cols, eps,
                                 st);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K6b.  x, do, dx: contiguous (rows, cols) in dtype 0 = fp32 or 1 = bf16,
// cols >= 1, rows < 2^31 when cols > 1024; gamma: fp32 (cols,); mu, rstd:
// fp32 (rows,), as K6a wrote them.  Returns cudaGetLastError() after the
// launch.
extern "C" int mxtt_layernorm_bwd(const void* x, const void* dout,
                                  const float* gamma, const float* mu,
                                  const float* rstd, void* dx, int64_t rows,
                                  int cols, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cols < 1 || (cols > kWarpMaxCols && rows >= (int64_t(1) << 31)))
    return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    if (dtype == 0)
      Bwd<float>{x, dout, gamma, mu, rstd, dx, rows, cols, st}.run();
    else if (dtype == 1)
      Bwd<__nv_bfloat16>{x, dout, gamma, mu, rstd, dx, rows, cols, st}.run();
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
