// Flash attention, the forward (K7a) and its two backward kernels (K7b,
// K7c).  For each (batch*head) slice of q (Tq, D) and k, v (Tk, D):
//   forward:  s = (q k^T) * scale, masked to -1e30 where qpos < kpos when
//             causal; o = softmax(s) v, lse = logsumexp(s) per query row;
//   K7b (dq): p = exp(s - lse), dp = do v^T, ds = (p * (dp - delta)) *
//             scale, dq = ds k, with delta = sum(do * o) per query row
//             (computed by the caller in plain torch, as the TPU does);
//   K7c (dk, dv): dv = p^T do, dk = ds^T q;
// by tiles of keys (forward, dq) or of queries (dk, dv), never forming
// the (Tq, Tk) matrix in device memory.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _flash_fwd_kernel (K7a),
// mxnet_tpu/ops/pallas_kernels.py _flash_bwd_dq_kernel (K7b) and
// mxnet_tpu/ops/pallas_kernels.py _flash_bwd_dkv_kernel (K7c), reached
// through flash_attention -> _flash_fwd / _flash_bwd_rule (parallel/attention.py
// local_attention when _flash_eligible holds, or impl="flash").
//
// Bound on Hopper: fp32 operations.  The forward's two products take
// 4 T^2 D operations per slice, the backward's five products 10 T^2 D
// (dq three, dk and dv four, since each kernel recomputes s), half of
// them under a causal mask, against a few T D elements moved; at (96,
// 1024, 64) causal the forward's 12.9 GFLOP take 0.19 ms at the 67
// TFLOP/s fp32 rate.  The reference is fp32, so the products run as fp32
// FMAs on the CUDA cores, not as TF32 or bf16 on the tensor cores.  The
// design is the simple SIMT form of the TPU kernels' schedule:
//   - one 256-thread block per (slice, tile of TILE query rows) for the
//     forward and dq, per (slice, tile of TILE key rows) for dk and dv; a
//     loop over the other operand's tiles takes the place of the TPU's
//     sequential grid axis, so the running max, sum and the fp32
//     accumulators (o, dq, or dk and dv) stay in registers from the first
//     tile to the last;
//   - the tiles are staged in shared memory as fp32 (rows padded by one
//     float against bank conflicts); each thread owns TILE/16 rows and
//     computes a (TILE/16)^2 block of scores (columns tx + 16 j) and a
//     TILE/16 x DP/16 block of its accumulators (columns tx + 16 j); a
//     row's max and sum are reduced over the 16 threads that share it with
//     warp shuffles;
//   - the probabilities (forward) or ds and p (backward) go through
//     shared memory to the next product.  The forward keeps p in fp32;
//     under bf16 the backward rounds p and ds to the input's dtype before
//     the products where the TPU kernels do (pallas_kernels.py :226,
//     :261, :267);
//   - under a causal mask the forward and dq skip the key tiles past the
//     tile's last query row, and dk/dv start at the query tile that holds
//     the tile's first key, as the TPU kernels skip blocks above the
//     diagonal; keys past Tk get -inf in the forward and p = 0 in the
//     backward, queries past Tq p = 0, so a ragged tile adds exactly 0;
//     masked pairs get the TPU kernel's finite -1e30 with the same shared
//     origin (qpos >= kpos), whose exp(s - lse) is exactly 0;
//   - any head dim D up to 256: the kernels are instances for a width DP,
//     D rounded up to 16 (multiples of 16 up to 128, of 32 beyond), with
//     the tail columns zero on load (they add 0 to every product) and
//     never stored.  TILE is 64 up to DP 128 and 32 beyond, where 64-row
//     fp32 tiles would not fit in shared memory; any T.
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
// v rounded to T (the TPU kernels' .astype before a product)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kThreads = 256;    // 16 x 16: ty picks rows, tx columns
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

template <int DP>
__host__ __device__ constexpr int tile() {
  return DP <= 128 ? 64 : 32;
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

// rows [r0, r0 + ROWS) of two (t, d) matrices into ROWS x DP fp32 tiles
// with row strides S1 and S2 (the second may be null); rows past t and
// columns past d are zero.  At d == DP the source stride is a constant.
template <typename T, int ROWS, int DP, int S1, int S2 = S1>
__device__ __forceinline__ void load_tiles(float* dst1, const T* src1,
                                           float* dst2, const T* src2,
                                           int r0, int t, int d) {
  if (d == DP) {
    for (int idx = threadIdx.x; idx < ROWS * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP;
      const bool in = r0 + r < t;
      const int64_t off = (int64_t)(r0 + r) * DP + c;
      dst1[r * S1 + c] = in ? to_float(src1[off]) : 0.0f;
      if (src2 != nullptr) dst2[r * S2 + c] = in ? to_float(src2[off]) : 0.0f;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    const bool in = r0 + r < t && c < d;
    const int64_t off = (int64_t)(r0 + r) * d + c;
    dst1[r * S1 + c] = in ? to_float(src1[off]) : 0.0f;
    if (src2 != nullptr) dst2[r * S2 + c] = in ? to_float(src2[off]) : 0.0f;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, int d,
                     float scale, int causal) {
  constexpr int BQ = tile<DP>(), BK = BQ, R = BQ / 16, J = BK / 16;
  constexpr int DJ = DP / 16, S = DP + 1, PS = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x S
  float* Ks = Qs + BQ * S;      // BK x S
  float* Vs = Ks + BK * S;      // BK x DP
  float* Ps = Vs + BK * DP;     // BQ x PS

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;
  load_tiles<T, BQ, DP, S>(Qs, q + bh * tq * d, nullptr, nullptr, q0, tq, d);

  float m[R], l[R], acc[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  // under a causal mask no query row of this tile sees a key past its last
  // row, so those tiles are skipped (they would add exactly 0)
  const int kend = causal ? min(tk, min(q0 + BQ, tq)) : tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();    // the last tile's readers are done (and Qs written)
    load_tiles<T, BK, DP, S, DP>(Ks, kb, Vs, vb, k0, tk, d);
    __syncthreads();

    float s[R][J];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) s[i][j] = 0.0f;
#pragma unroll 16
    for (int kk = 0; kk < DP; ++kk) {
      float a[R], b[J];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = Qs[(ty * R + i) * S + kk];
#pragma unroll
      for (int j = 0; j < J; ++j) b[j] = Ks[(tx + 16 * j) * S + kk];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q0 + ty * R + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < J; ++j) {
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
      for (int j = 0; j < J; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * R + i) * PS + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float p[R], vv[DJ];
#pragma unroll
      for (int i = 0; i < R; ++i) p[i] = Ps[(ty * R + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + bh * tq * d;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ty * R + i;
    if (r < tq) {
      const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = tx + 16 * j;
        if (c < d) store(ob + (int64_t)r * d + c, acc[i][j] / lc);
      }
      if (tx == 0) lse[bh * tq + r] = m[i] + logf(lc);
    }
  }
}

// K7b: one block per (slice, query tile); dq accumulates over key tiles
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int tq, int tk, int d, float scale, int causal) {
  constexpr int BQ = tile<DP>(), BK = BQ, R = BQ / 16, J = BK / 16;
  constexpr int DJ = DP / 16, S = DP + 1, PS = BK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x S
  float* Gs = Qs + BQ * S;      // BQ x S: the rows of do
  float* Ks = Gs + BQ * S;      // BK x S
  float* Vs = Ks + BK * S;      // BK x S
  float* Ds = Vs + BK * S;      // BQ x PS: ds

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;
  load_tiles<T, BQ, DP, S>(Qs, q + bh * tq * d, Gs, dout + bh * tq * d, q0,
                           tq, d);

  float lrow[R], drow[R], acc[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ty * R + i;
    lrow[i] = r < tq ? lse[bh * tq + r] : 0.0f;
    drow[i] = r < tq ? delta[bh * tq + r] : 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  const int kend = causal ? min(tk, min(q0 + BQ, tq)) : tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    load_tiles<T, BK, DP, S>(Ks, kb, Vs, vb, k0, tk, d);
    __syncthreads();

    float s[R][J], dp[R][J];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < DP; ++kk) {
      float a[R], g[R], b[J], c[J];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a[i] = Qs[(ty * R + i) * S + kk];
        g[i] = Gs[(ty * R + i) * S + kk];
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        b[j] = Ks[(tx + 16 * j) * S + kk];
        c[j] = Vs[(tx + 16 * j) * S + kk];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], c[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float val = s[i][j] * scale;
        if (causal && qpos < kpos) val = kNegInf;
        const float p = kpos < tk ? expf(val - lrow[i]) : 0.0f;
        const float ds = (p * (dp[i][j] - drow[i])) * scale;
        Ds[(ty * R + i) * PS + tx + 16 * j] = round_to(ds, k);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float ds[R], kv[DJ];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = Ds[(ty * R + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[c * S + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

  T* db = dq + bh * tq * d;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + ty * R + i;
    if (r < tq) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = tx + 16 * j;
        if (c < d) store(db + (int64_t)r * d + c, acc[i][j]);
      }
    }
  }
}

// K7c: one block per (slice, key tile); dk and dv accumulate over query
// tiles, from the diagonal on under a causal mask
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int tq, int tk, int d,
                         float scale, int causal) {
  constexpr int BK = tile<DP>(), BQ = BK, R = BK / 16, J = BQ / 16;
  constexpr int DJ = DP / 16, S = DP + 1, PS = BQ + 1;
  extern __shared__ float smem[];
  float* Ks = smem;             // BK x S
  float* Vs = Ks + BK * S;      // BK x S
  float* Qs = Vs + BK * S;      // BQ x S
  float* Gs = Qs + BQ * S;      // BQ x S: the rows of do
  float* Pt = Gs + BQ * S;      // BK x PS: p transposed
  float* Dt = Pt + BK * PS;     // BK x PS: ds transposed
  float* Ls = Dt + BK * PS;     // BQ: lse
  float* Es = Ls + BQ;          // BQ: delta

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const T* qb = q + bh * tq * d;
  const T* gb = dout + bh * tq * d;
  load_tiles<T, BK, DP, S>(Ks, k + bh * tk * d, Vs, v + bh * tk * d, k0, tk,
                           d);

  float dka[R][DJ], dva[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.0f;

  // under a causal mask the query rows before k0 see none of this tile's
  // keys: start at the query tile that holds row k0
  const int qstart = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = qstart; q0 < tq; q0 += BQ) {
    __syncthreads();    // the last tile's readers are done (and Ks written)
    load_tiles<T, BQ, DP, S>(Qs, qb, Gs, gb, q0, tq, d);
    if (tid < BQ) {
      const bool in = q0 + tid < tq;
      Ls[tid] = in ? lse[bh * tq + q0 + tid] : 0.0f;
      Es[tid] = in ? delta[bh * tq + q0 + tid] : 0.0f;
    }
    __syncthreads();

    float s[R][J], dp[R][J];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 8
    for (int kk = 0; kk < DP; ++kk) {
      float a[R], c[R], b[J], g[J];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a[i] = Ks[(ty * R + i) * S + kk];
        c[i] = Vs[(ty * R + i) * S + kk];
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        b[j] = Qs[(tx + 16 * j) * S + kk];
        g[j] = Gs[(tx + 16 * j) * S + kk];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          s[i][j] = fmaf(b[j], a[i], s[i][j]);
          dp[i][j] = fmaf(g[j], c[i], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kpos = k0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int qc = tx + 16 * j, qpos = q0 + qc;
        float val = s[i][j] * scale;
        if (causal && qpos < kpos) val = kNegInf;
        const float p = qpos < tq ? expf(val - Ls[qc]) : 0.0f;
        const float ds = (p * (dp[i][j] - Es[qc])) * scale;
        Pt[(ty * R + i) * PS + qc] = round_to(p, q);
        Dt[(ty * R + i) * PS + qc] = round_to(ds, q);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BQ; ++c) {
      float p[R], ds[R], gv[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        p[i] = Pt[(ty * R + i) * PS + c];
        ds[i] = Dt[(ty * R + i) * PS + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        gv[j] = Gs[c * S + tx + 16 * j];
        qv[j] = Qs[c * S + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dva[i][j] = fmaf(p[i], gv[j], dva[i][j]);
          dka[i][j] = fmaf(ds[i], qv[j], dka[i][j]);
        }
    }
  }

  T* dkb = dk + bh * tk * d;
  T* dvb = dv + bh * tk * d;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = k0 + ty * R + i;
    if (r < tk) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int c = tx + 16 * j;
        if (c < d) {
          store(dkb + (int64_t)r * d + c, dka[i][j]);
          store(dvb + (int64_t)r * d + c, dva[i][j]);
        }
      }
    }
  }
}

template <int DP>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * tile<DP>() * (DP + 1) + tile<DP>() * DP +
                          tile<DP>() * (tile<DP>() + 1));
}
template <int DP>
constexpr size_t dq_smem() {
  return sizeof(float) *
         (4 * tile<DP>() * (DP + 1) + tile<DP>() * (tile<DP>() + 1));
}
template <int DP>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * tile<DP>() * (DP + 1) +
                          2 * tile<DP>() * (tile<DP>() + 1) + 2 * tile<DP>());
}

// the pointers and sizes of one call, as the C entry points take them
struct Args {
  const void *q, *k, *v, *dout;
  void *o, *dq, *dk, *dv;
  float* lse;
  const float* delta;
  int64_t bh;
  int tq, tk, d;
  float scale;
  int causal;
  cudaStream_t st;
};

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// which: 0 = forward, 1 = dq (K7b), 2 = dk and dv (K7c)
template <typename T, int DP>
int launch(int which, const Args& a) {
  constexpr int TL = tile<DP>();
  const unsigned rows = (unsigned)(((which == 2 ? a.tk : a.tq) + TL - 1) / TL);
  const dim3 grid((unsigned)a.bh, rows);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  int rc;
  if (which == 0) {
    constexpr size_t smem = fwd_smem<DP>();
    if ((rc = set_smem(flash_fwd_kernel<T, DP>, smem)) != 0) return rc;
    flash_fwd_kernel<T, DP><<<grid, kThreads, smem, a.st>>>(
        q, k, v, static_cast<T*>(a.o), a.lse, a.tq, a.tk, a.d, a.scale,
        a.causal);
  } else if (which == 1) {
    constexpr size_t smem = dq_smem<DP>();
    if ((rc = set_smem(flash_bwd_dq_kernel<T, DP>, smem)) != 0) return rc;
    flash_bwd_dq_kernel<T, DP><<<grid, kThreads, smem, a.st>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse, a.delta,
        static_cast<T*>(a.dq), a.tq, a.tk, a.d, a.scale, a.causal);
  } else {
    constexpr size_t smem = dkv_smem<DP>();
    if ((rc = set_smem(flash_bwd_dkv_kernel<T, DP>, smem)) != 0) return rc;
    flash_bwd_dkv_kernel<T, DP><<<grid, kThreads, smem, a.st>>>(
        q, k, v, static_cast<const T*>(a.dout), a.lse, a.delta,
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.tq, a.tk, a.d,
        a.scale, a.causal);
  }
  return 0;
}

// D rounded up to the next instance width: a multiple of 16 up to 128,
// of 32 beyond
template <typename T>
int launch_d(int which, const Args& a) {
  const int dp = a.d <= 128 ? (a.d + 15) / 16 * 16 : (a.d + 31) / 32 * 32;
  switch (dp) {
#define MXTT_FLASH_CASE(DP) \
    case DP: return launch<T, DP>(which, a);
    MXTT_FLASH_CASE(16)
    MXTT_FLASH_CASE(32)
    MXTT_FLASH_CASE(48)
    MXTT_FLASH_CASE(64)
    MXTT_FLASH_CASE(80)
    MXTT_FLASH_CASE(96)
    MXTT_FLASH_CASE(112)
    MXTT_FLASH_CASE(128)
    MXTT_FLASH_CASE(160)
    MXTT_FLASH_CASE(192)
    MXTT_FLASH_CASE(224)
    MXTT_FLASH_CASE(256)
#undef MXTT_FLASH_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int which, const Args& a, int dtype) {
  // the grid's second axis counts tiles of at most 32 rows of Tq (or Tk)
  if (a.bh <= 0 || a.bh >= (int64_t(1) << 31) || a.tq <= 0 || a.tk <= 0 ||
      a.tq > 65535 * 32 || a.tk > 65535 * 32 || a.d < 1 || a.d > kMaxD)
    return (int)cudaErrorInvalidValue;
  int rc;
  if (dtype == 0)
    rc = launch_d<float>(which, a);
  else if (dtype == 1)
    rc = launch_d<__nv_bfloat16>(which, a);
  else
    return (int)cudaErrorInvalidValue;
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// All: q, do, o, dq contiguous (bh, tq, d); k, v, dk, dv contiguous (bh,
// tk, d); dtype 0 = fp32, 1 = bf16; lse and delta fp32 (bh, tq); 1 <= d <=
// 256; 1 <= bh < 2^31; 1 <= tq, tk <= 65535 * 32.  Each returns
// cudaGetLastError() after the launch (or the error of setting the
// kernel's shared-memory size).

// K7a: o and lse from q, k, v.
extern "C" int mxtt_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, float* lse,
                                        int64_t bh, int tq, int tk, int d,
                                        float scale, int causal, int dtype,
                                        void* stream) {
  Args a{q, k, v, nullptr, o, nullptr, nullptr, nullptr, lse, nullptr,
         bh, tq, tk, d, scale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch(0, a, dtype);
}

// K7b: dq from q, k, v, do and the forward's lse, with delta = sum(do * o).
extern "C" int mxtt_flash_attention_bwd_dq(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const float* lse,
                                           const float* delta, void* dq,
                                           int64_t bh, int tq, int tk, int d,
                                           float scale, int causal, int dtype,
                                           void* stream) {
  Args a{q, k, v, dout, nullptr, dq, nullptr, nullptr,
         const_cast<float*>(lse), delta, bh, tq, tk, d, scale, causal,
         static_cast<cudaStream_t>(stream)};
  return dispatch(1, a, dtype);
}

// K7c: dk and dv from the same operands.
extern "C" int mxtt_flash_attention_bwd_dkv(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const float* lse,
                                            const float* delta, void* dk,
                                            void* dv, int64_t bh, int tq,
                                            int tk, int d, float scale,
                                            int causal, int dtype,
                                            void* stream) {
  Args a{q, k, v, dout, nullptr, nullptr, dk, dv, const_cast<float*>(lse),
         delta, bh, tq, tk, d, scale, causal,
         static_cast<cudaStream_t>(stream)};
  return dispatch(2, a, dtype);
}
