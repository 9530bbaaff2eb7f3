// Flash-attention forward (K7a): for each (batch*head) slice of q, k, v
// of shape (T, D),
//   s = (q k^T) * scale, masked to -1e30 where qpos < kpos when causal,
//   o = softmax(s) v, lse = logsumexp(s) per query row,
// by online softmax over tiles of keys, never forming the (Tq, Tk) matrix
// in device memory.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _flash_fwd_kernel, reached
// through flash_attention -> _flash_fwd (parallel/attention.py
// local_attention when _flash_eligible holds, or impl="flash").
//
// Bound on Hopper: fp32 operations.  The two products take 4 T^2 D
// operations per slice (half of them under a causal mask) against 4 T D
// elements moved, so at (96, 1024, 64) causal the 12.9 GFLOP take 0.19
// ms at the 67 TFLOP/s fp32 rate and the 100 MB 0.03 ms at HBM rate.
// The reference is fp32, so the products run as fp32 FMAs on the CUDA
// cores, not as TF32 or bf16 on the tensor cores.  The design is the
// simple SIMT form of the TPU kernel's schedule:
//   - one 256-thread block per (slice, 64-row query tile); a loop over
//     64-row key tiles takes the place of the TPU's sequential grid axis,
//     so the running max m, sum l and the fp32 accumulator stay in
//     registers from the first tile to the last;
//   - the query tile and each key and value tile are staged in shared
//     memory as fp32 (rows padded by one float against bank conflicts);
//     each thread owns 4 query rows and computes a 4 x 4 block of scores
//     (columns tx + 16 j) and a 4 x D/16 block of the output (columns tx
//     + 16 j); a row's max and sum are reduced over the 16 threads that
//     share it with warp shuffles;
//   - the probabilities go through shared memory to the second product;
//     they stay fp32 (the TPU kernel rounds them to v's dtype for its
//     matrix unit);
//   - under a causal mask the key tiles past the last query row of the
//     tile are skipped, as the TPU kernel skips blocks above the diagonal;
//     keys past Tk (a ragged last tile) get -inf, so they add exactly 0,
//     and masked keys get the TPU kernel's finite -1e30 with the same
//     shared origin (qpos >= kpos);
//   - D any multiple of 16 up to 128 (16, 32, ..., 128), one template
//     instance each, so each thread's D / 16 output columns are a
//     compile-time count; any T.
// o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)), as on the TPU.
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

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16: ty picks 4 rows, tx 4 columns
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

// max and sum over the 16 threads of a row (lanes that differ in tx only)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, float scale,
                     int causal) {
  constexpr int QS = D + 1, KS = D + 1, PS = kBK + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // kBQ x QS
  float* Ks = Qs + kBQ * QS;    // kBK x KS
  float* Vs = Ks + kBK * KS;    // kBK x D
  float* Ps = Vs + kBK * D;     // kBQ x PS

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const T* qb = q + bh * tq * D;
  const T* kb = k + bh * tk * D;
  const T* vb = v + bh * tk * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    Qs[r * QS + d] =
        q0 + r < tq ? to_float(qb[(int64_t)(q0 + r) * D + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  // under a causal mask no query row of this tile sees a key past its last
  // row, so those tiles are skipped (they would add exactly 0)
  const int kend = causal ? min(tk, min(q0 + kBQ, tq)) : tk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();    // the last tile's readers are done (and Qs written)
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < tk;
      const int64_t off = (int64_t)(k0 + r) * D + d;
      Ks[r * KS + d] = in ? to_float(kb[off]) : 0.0f;
      Vs[r * D + d] = in ? to_float(vb[off]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 16
    for (int kk = 0; kk < D; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * QS + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * KS + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float val = s[i][j] * scale;
        if (kpos >= tk)
          val = -INFINITY;
        else if (causal && qpos < kpos)
          val = kNegInf;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < kBK; ++c) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + bh * tq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r < tq) {
      const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        store(ob + (int64_t)r * D + tx + 16 * j, acc[i][j] / lc);
      if (tx == 0) lse[bh * tq + r] = m[i] + logf(lc);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int64_t bh, int tq, int tk, float scale, int causal,
           cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)bh, (unsigned)((tq + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, tq, tk, scale,
      causal);
  return 0;
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse,
             int64_t bh, int tq, int tk, int d, float scale, int causal,
             cudaStream_t st) {
  switch (d) {
#define MXTT_FLASH_CASE(D) \
    case D: return launch<T, D>(q, k, v, o, lse, bh, tq, tk, scale, causal, st);
    MXTT_FLASH_CASE(16)
    MXTT_FLASH_CASE(32)
    MXTT_FLASH_CASE(48)
    MXTT_FLASH_CASE(64)
    MXTT_FLASH_CASE(80)
    MXTT_FLASH_CASE(96)
    MXTT_FLASH_CASE(112)
    MXTT_FLASH_CASE(128)
#undef MXTT_FLASH_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: contiguous (bh, tq, d); k, v: contiguous (bh, tk, d); dtype 0 =
// fp32, 1 = bf16; lse: fp32 (bh, tq); d in {16, 32, ..., 128}; 1 <= bh <
// 2^31, 1 <= tq <= 65535 * 64.  Returns cudaGetLastError() after the
// launch (or the error of setting the kernel's shared-memory size).
extern "C" int mxtt_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int64_t bh, int tq, int tk, int d,
                                        float scale, int causal, int dtype,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || tq <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  int rc;
  if (dtype == 0)
    rc = launch_d<float>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, st);
  else if (dtype == 1)
    rc = launch_d<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, d, scale,
                                 causal, st);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
