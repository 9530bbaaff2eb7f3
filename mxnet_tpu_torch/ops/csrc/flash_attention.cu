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
// TFLOP/s fp32 rate.  The reference is fp32 (a TF32 forward misses the
// transformer's 1e-4 logits bound), so the products run as fp32 FMAs on
// the CUDA cores, and what limits them is how they are fed: shared-memory
// reads per FMA, loads that stall the products, and the grid's tail.
//
// All three kernels keep the TPU kernels' schedule in SIMT form: one block
// per (slice, tile of query rows) for the forward and dq, per (slice, tile
// of key rows) for dk and dv; a loop over the other operand's tiles takes
// the place of the TPU's sequential grid axis, so the running max, sum
// and the fp32 accumulators (o, dq, or dk and dv) stay in registers from
// the first tile to the last; the probabilities (forward) or ds and p
// (backward) go through shared memory to the next product.
//
// K7a (flash_fwd_kernel, its own tiles and loads):
//   - 128 threads, each holding 8 x 8 scores and 8 x 8 accumulators at D
//     64 (tiles of 128 query rows and 64 keys; 64 x 32 up to D 128, 32 x
//     32 beyond); Q and K are staged row-major with a row stride of D + 4
//     floats, so each thread's operands for four kk come in one 16-byte
//     read per row without bank conflicts: 16 reads of 16 bytes feed 256
//     FMAs (4 FMAs per word read, against 2 in the kernels below); P V
//     reads 16-byte pieces of P rows and V rows the same way;
//   - K and V arrive by cp.async: the next tile's K is copied while this
//     tile's softmax and P V run, the next V while the next Q K^T runs,
//     with one buffer each (105 KB of shared memory at D 64, two blocks an
//     SM); bf16 or unaligned operands load through registers instead;
//   - under a causal mask the query tiles launch from the last (which
//     sees every key tile) to the first, so the grid's tail is made of
//     the shortest blocks;
//   - instances for D rounded up to 32; p stays fp32 for P V.
// K7b and K7c (256 threads, 16 x 16): tiles staged as fp32 rows padded by
// one float against bank conflicts; each thread owns TILE/16 rows and
// computes a (TILE/16)^2 block of scores (columns tx + 16 j) and a TILE/16
// x DP/16 block of its accumulators from scalar shared-memory reads (2
// FMAs per read); tiles load synchronously between two barriers; under
// bf16 they round p and ds to the input's dtype before the products where
// the TPU kernels do (pallas_kernels.py :226, :261, :267); instances for D
// rounded up to 16 (to 32 above 128), TILE 64 up to DP 128 and 32 beyond.
//
// All three: under a causal mask the forward and dq skip the key tiles
// past the tile's last query row, and dk/dv start at the query tile that
// holds the tile's first key, as the TPU kernels skip blocks above the
// diagonal; keys past Tk get -inf in the forward and p = 0 in the
// backward, queries past Tq p = 0, so a ragged tile adds exactly 0; masked
// pairs get the TPU kernel's finite -1e30 with the same shared origin
// (qpos >= kpos), whose exp(s - lse) is exactly 0; any head dim D up to
// 256, the tail columns of an instance zero on load (they add 0 to every
// product) and never stored; any T.
// o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)), as on the TPU.
#include <cmath>
#include <cstdint>
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

// ---------------------------------------------------------------------------
// K7a: its own tiles, layout and loads (K7b and K7c keep tile<DP>() and
// load_tiles above)
// ---------------------------------------------------------------------------
// K7a's tiles for an instance width DP (a multiple of 32): BQ query rows
// and BK keys a step, 16 x TX threads, Q and K rows strided by QS floats
// (QS / 4 odd, so eight 16-byte reads of eight rows fall in eight distinct
// bank groups), P rows by PS (PS % 32 == TX, so a warp's scalar writes of
// 32 / TX rows hit 32 distinct banks).  Each thread holds RI = BQ / 16
// rows of BK / TX scores and of DP / TX accumulator columns.
template <int DP>
struct FwdTile {
  static constexpr int BQ = DP <= 64 ? 128 : DP <= 128 ? 64 : 32;
  static constexpr int BK = DP <= 64 ? 64 : 32;
  static constexpr int TX = 8;                 // threads that share a row
  static constexpr int THREADS = 16 * TX;
  static constexpr int QS = DP + 4;
  static constexpr int PS = BK + TX;
  static constexpr size_t smem =
      sizeof(float) * ((BQ + BK) * QS + BK * DP + BQ * PS);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of a (t, d) matrix into a ROWS x DP fp32 tile of row
// stride STRIDE, rows past t and columns past d zero: 16-byte cp.async
// copies that land while the block computes (fp32 with d % 4 == 0 and
// 16-byte aligned operands: ``async``), else loads through registers.
template <typename T, int ROWS, int DP, int STRIDE, int THREADS>
__device__ __forceinline__ void fwd_tile(float* dst, const T* src, int r0,
                                         int t, int d, bool async) {
  if constexpr (std::is_same<T, float>::value) {
    if (async) {
      constexpr int C4 = DP / 4;
      for (int idx = threadIdx.x; idx < ROWS * C4; idx += THREADS) {
        const int r = idx / C4, c = idx % C4 * 4;
        const bool in = r0 + r < t && c < d;
        cp_async16(dst + r * STRIDE + c,
                   in ? src + (int64_t)(r0 + r) * d + c : src, in);
      }
      return;
    }
  }
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += THREADS) {
    const int r = idx / DP, c = idx % DP;
    dst[r * STRIDE + c] = r0 + r < t && c < d
                              ? to_float(src[(int64_t)(r0 + r) * d + c])
                              : 0.0f;
  }
}

// max and sum over the TX threads of a row (lanes that differ in tx only)
template <int TX>
__device__ __forceinline__ float row_max_tx(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
template <int TX>
__device__ __forceinline__ float row_sum_tx(float v) {
#pragma unroll
  for (int off = TX / 2; off > 0; off /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// s[i][c] = Q row (ty + 16 i) . K row (tx + TX c), four kk a 16-byte read
// of each row
template <int RI, int CJ, int TX, int DP, int QS>
__device__ __forceinline__ void qk_tile(float (&s)[RI][CJ],
                                        const float* Qs, const float* Ks,
                                        int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) s[i][c] = 0.0f;
#pragma unroll 2
  for (int kk = 0; kk < DP; kk += 4) {
    float4 a[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QS + kk);
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const float4 b =
          *reinterpret_cast<const float4*>(Ks + (tx + TX * c) * QS + kk);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        s[i][c] = fmaf(a[i].x, b.x, s[i][c]);
        s[i][c] = fmaf(a[i].y, b.y, s[i][c]);
        s[i][c] = fmaf(a[i].z, b.z, s[i][c]);
        s[i][c] = fmaf(a[i].w, b.w, s[i][c]);
      }
    }
  }
}

// acc[i][g] += P row (ty + 16 i) V for value columns 4 TX g + 4 tx + e,
// four keys a 16-byte read of the P row
template <int RI, int G, int TX, int BK, int DP, int PS>
__device__ __forceinline__ void pv_tile(float (&acc)[RI][G][4],
                                        const float* Ps, const float* Vs,
                                        int ty, int tx) {
#pragma unroll 2
  for (int c = 0; c < BK; c += 4) {
    float4 p[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      p[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PS + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float4 vv[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        vv[g] = *reinterpret_cast<const float4*>(Vs + (c + e) * DP +
                                                 4 * TX * g + 4 * tx);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float pe = lane4(p[i], e);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[i][g][0] = fmaf(pe, vv[g].x, acc[i][g][0]);
          acc[i][g][1] = fmaf(pe, vv[g].y, acc[i][g][1]);
          acc[i][g][2] = fmaf(pe, vv[g].z, acc[i][g][2]);
          acc[i][g][3] = fmaf(pe, vv[g].w, acc[i][g][3]);
        }
      }
    }
  }
}

// One block per (slice, query tile); thread (ty, tx) owns query rows ty +
// 16 i, key columns tx + TX j of s and p, and value columns 4 TX g + 4 tx
// + e of acc.  Per tile of keys: s = Q K^T from 16-byte reads of Q and K rows
// (four kk a read, 4 FMAs per word at 128 x 64), the online softmax in
// registers, p through shared memory, acc += P V from 16-byte reads of P
// rows and V rows.  K of the next tile is copied in during this tile's
// softmax and P V, V of the next during its Q K^T.
template <typename T, int DP>
__global__ void __launch_bounds__(FwdTile<DP>::THREADS, 2)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int tq, int tk, int d,
                     float scale, int causal, bool async) {
  using F = FwdTile<DP>;
  constexpr int BQ = F::BQ, BK = F::BK, QS = F::QS, PS = F::PS;
  constexpr int TX = F::TX, TH = F::THREADS;
  constexpr int RI = BQ / 16, CJ = BK / TX, G = DP / (4 * TX);
  extern __shared__ float4 fwd_smem[];
  float* Qs = reinterpret_cast<float*>(fwd_smem);    // BQ x QS
  float* Ks = Qs + BQ * QS;                          // BK x QS
  float* Vs = Ks + BK * QS;                          // BK x DP
  float* Ps = Vs + BK * DP;                          // BQ x PS

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int64_t bh = blockIdx.x;
  // under a causal mask the last query tiles see the most keys: they are
  // launched first, so that the grid's tail is made of short blocks
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;
  // under a causal mask no query row of this tile sees a key past its last
  // row, so those tiles are skipped (they would add exactly 0)
  const int kend = causal ? min(tk, min(q0 + BQ, tq)) : tk;
  const int nt = (kend + BK - 1) / BK;

  fwd_tile<T, BQ, DP, QS, TH>(Qs, q + bh * tq * d, q0, tq, d, async);
  fwd_tile<T, BK, DP, QS, TH>(Ks, kb, 0, tk, d, async);
  cp_async_commit();
  fwd_tile<T, BK, DP, DP, TH>(Vs, vb, 0, tk, d, async);
  cp_async_commit();

  float m[RI], l[RI], acc[RI][G][4];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.0f;
  }

  for (int j = 0; j < nt; ++j) {
    const int k0 = j * BK;
    cp_async_wait<1>();     // Q and this tile's K (its V may be in flight)
    __syncthreads();

    float s[RI][CJ];
    qk_tile<RI, CJ, TX, DP, QS>(s, Qs, Ks, ty, tx);
    __syncthreads();        // every thread is done with Ks
    if (j + 1 < nt) fwd_tile<T, BK, DP, QS, TH>(Ks, kb, k0 + BK, tk, d, async);
    cp_async_commit();

    // a tile that holds keys past tk or a masked (query, key) pair
    const bool edge = k0 + BK > tk || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        float val = s[i][c] * scale;
        if (edge) {
          const int kpos = k0 + tx + TX * c;
          if (kpos >= tk)
            val = -INFINITY;
          else if (causal && qpos < kpos)
            val = kNegInf;
        }
        s[i][c] = val;
        mx = fmaxf(mx, val);
      }
      const float m_new = fmaxf(m[i], row_max_tx<TX>(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const float p = expf(s[i][c] - m_new);
        Ps[(ty + 16 * i) * PS + tx + TX * c] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum_tx<TX>(sum);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
    }
    cp_async_wait<1>();     // this tile's V (the next K may be in flight)
    __syncthreads();        // and every row of Ps written

    pv_tile<RI, G, TX, BK, DP, PS>(acc, Ps, Vs, ty, tx);
    __syncthreads();        // every thread is done with Vs and Ps
    if (j + 1 < nt) fwd_tile<T, BK, DP, DP, TH>(Vs, vb, k0 + BK, tk, d, async);
    cp_async_commit();
  }

  T* ob = o + bh * tq * d;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < tq) {
      const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c = 4 * TX * g + 4 * tx;
        float out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) out[e] = acc[i][g][e] / lc;
        if constexpr (std::is_same<T, float>::value) {
          if (d == DP) {
            *reinterpret_cast<float4*>(ob + (int64_t)r * d + c) =
                make_float4(out[0], out[1], out[2], out[3]);
            continue;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) store(ob + (int64_t)r * d + c + e, out[e]);
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

// K7a at instance width DP
template <typename T, int DP>
int launch_fwd(const Args& a) {
  using F = FwdTile<DP>;
  const dim3 grid((unsigned)a.bh, (unsigned)((a.tq + F::BQ - 1) / F::BQ));
  // cp.async moves 16-byte pieces of fp32 rows: d % 4 == 0, aligned starts
  const bool async = std::is_same<T, float>::value && a.d % 4 == 0 &&
                     ((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v) %
                             16 == 0;
  int rc;
  if ((rc = set_smem(flash_fwd_kernel<T, DP>, F::smem)) != 0) return rc;
  // two blocks of up to 105 KB share an SM only with the largest carveout
  if ((rc = (int)cudaFuncSetAttribute(
           flash_fwd_kernel<T, DP>,
           cudaFuncAttributePreferredSharedMemoryCarveout,
           (int)cudaSharedmemCarveoutMaxShared)) != 0)
    return rc;
  flash_fwd_kernel<T, DP><<<grid, F::THREADS, F::smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.tq, a.tk,
      a.d, a.scale, a.causal, async);
  return 0;
}

// K7a: D rounded up to the next multiple of 32
template <typename T>
int launch_fwd_d(const Args& a) {
  switch ((a.d + 31) / 32 * 32) {
#define MXTT_FWD_CASE(DP) \
    case DP: return launch_fwd<T, DP>(a);
    MXTT_FWD_CASE(32)
    MXTT_FWD_CASE(64)
    MXTT_FWD_CASE(96)
    MXTT_FWD_CASE(128)
    MXTT_FWD_CASE(160)
    MXTT_FWD_CASE(192)
    MXTT_FWD_CASE(224)
    MXTT_FWD_CASE(256)
#undef MXTT_FWD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// which: 1 = dq (K7b), 2 = dk and dv (K7c)
template <typename T, int DP>
int launch(int which, const Args& a) {
  constexpr int TL = tile<DP>();
  const unsigned rows = (unsigned)(((which == 2 ? a.tk : a.tq) + TL - 1) / TL);
  const dim3 grid((unsigned)a.bh, rows);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  int rc;
  if (which == 1) {
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

// K7b, K7c: D rounded up to the next instance width, a multiple of 16 up
// to 128, of 32 beyond
template <typename T>
int launch_d(int which, const Args& a) {
  if (which == 0) return launch_fwd_d<T>(a);
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
  // the grid's second axis counts tiles of at least 32 rows of Tq (or Tk)
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
