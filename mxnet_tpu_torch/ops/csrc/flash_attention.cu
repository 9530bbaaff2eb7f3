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
// Bound on Hopper: operations, but for the bf16 forward.  The forward's
// two products take 4 T^2 D operations per slice, K7b's three (s, dp, dq)
// 6 T^2 D and K7c's four (s, dp, dv, dk) 8 T^2 D, half of them under a
// causal mask, against a few T D elements moved.  At (96, 1024, 64)
// causal one product over the visible pairs is 6.45 GFLOP: on the fp32
// CUDA cores (67 TFLOP/s) the forward's two take 0.19 ms, K7b's three
// 0.29 ms, K7c's four 0.39 ms; on the tensor cores in 3xTF32 (three TF32
// products of 495 TFLOP/s for each fp32 one) K7b needs 0.117 ms and K7c
// 0.156 ms.  In bf16 on the dense bf16 tensor cores (989 TFLOP/s) the
// forward's products take 0.013 ms, under the 0.015 ms its 50.7 MB of
// bf16 q, k, v, o and fp32 lse take at 3.35 TB/s (so bytes bound it);
// K7b's 0.0196 ms and K7c's 0.026 ms.
//
// All three keep the TPU kernels' schedule: one block per (slice, tile of
// query rows) for the forward and dq, per (slice, tile of key rows) for dk
// and dv; a loop over the other operand's tiles takes the place of the
// TPU's sequential grid axis, so the running max and sum and the fp32
// accumulators (o, dq, or dk and dv) stay in registers from the first
// tile to the last.
//
// K7a's fp32 instance and its WIDE bf16 ones (flash_fwd_kernel, SIMT
// fp32 FMAs on the CUDA cores):
//   - 128 threads, each holding 8 x 8 scores and 8 x 8 accumulators at D
//     64 (tiles of 128 query rows and 64 keys; 64 x 32 up to D 128, 32 x
//     32 beyond); Q and K are staged row-major with a row stride of D + 4
//     floats, so each thread's operands for four kk come in one 16-byte
//     read per row without bank conflicts: 16 reads of 16 bytes feed 256
//     FMAs (4 FMAs per word read); P V reads 16-byte pieces of P rows and
//     V rows the same way;
//   - K and V arrive by cp.async: the next tile's K is copied while this
//     tile's softmax and P V run, the next V while the next Q K^T runs,
//     with one buffer each (105 KB of shared memory at D 64, two blocks an
//     SM); bf16 (the WIDE chunks) or unaligned operands load through
//     registers instead;
//   - under a causal mask the query tiles launch from the last (which
//     sees every key tile) to the first, so the grid's tail is made of
//     the shortest blocks;
//   - instances for D rounded up to 32; p is rounded to the input dtype
//     before P V (a no-op in fp32) and summed into l unrounded, as the TPU
//     kernel multiplies p.astype(v.dtype) by V (pallas_kernels.py :185-188).
//
// K7b's and K7c's fp32 and WIDE bf16 instances (flash_bwd_dq_kernel,
// flash_bwd_dkv_kernel), products on the tensor cores with mma.sync
// m16n8k8 TF32 and fp32 accumulation:
//   - fp32 runs in 3xTF32: each operand x is split into hi = x rounded to
//     TF32 (cvt.rna) and lo = x - hi (which the tensor cores truncate to
//     TF32), and each product is lo*hi + hi*lo + hi*hi, the small terms
//     first.  What is dropped (lo*lo, lo's truncation) is ~2^-21 of each
//     term against fp32's 2^-24 and TF32's 2^-11, so the kernels hold the
//     1e-5 bound of the fp32 plain version where plain TF32 would not.
//     The tensor cores also truncate as they add into an accumulator, so
//     each chain of mma runs into a fresh partial of at most 64 keys or
//     columns that an fp32 add folds into the sum (one chain over 1024
//     queries drifted past 1e-5 of the largest dk and dv on the card).
//     bf16 operands (the WIDE bf16 instances), and p and ds rounded to
//     bf16, are exact in TF32: one product each, the TPU
//     kernels' own arithmetic (bf16 products summed in fp32), at half the
//     k of a bf16 mma and from fp32 tiles;
//   - the split is made when a fragment is read from shared memory, not
//     when a tile is staged: tiles stay fp32 (cp.async cannot convert, and
//     two TF32 copies would halve the tiles that fit), at 2 ALU
//     instructions per element against 3 mma per 2 B-fragment words;
//     p = exp(s - lse) takes the fast __expf (ex2.approx, within a few
//     fp32 ulps), since the products, not the exps, hold the 1e-5 bound;
//   - each warp owns 16 rows of the block's tile (query rows in K7b, key
//     rows in K7c) and, for D above 64, a share of the output columns
//     (NS warps split D; each recomputes the scores of its rows);
//     s and dp come out in the accumulator layout (rows g and g + 8,
//     columns 2t and 2t + 1 of each 8, g = lane / 4, t = lane % 4); p and
//     ds are formed there in registers with the finite -1e30 mask, and
//     are the A fragment of the next product as they stand: its k index
//     is permuted within each 8 (position t is key 2t, t + 4 is 2t + 1),
//     and the B fragment reads the same permutation, so p and ds never go
//     through shared memory;
//   - tiles are staged with a row stride of D + 4 floats (D a multiple of
//     32): both fragment patterns (row g, column t; row 2t, column g) hit
//     32 distinct banks;
//   - the streamed operand (K and V in K7b, Q and dO with lse and delta in
//     K7c) is double-buffered and copied by cp.async one tile ahead, one
//     barrier per tile; bf16 or unaligned operands load through registers;
//   - K7b launches its heaviest causal query tiles first, as K7a; K7c's
//     first key tiles already see the most query tiles;
//   - tiles of 64 rows up to D 64 (4 warps, 104 KB, two blocks an SM), of
//     32 rows beyond (NS = 2 up to D 128, 4 warps; NS = 4 beyond, 8
//     warps, 200 KB at D 256); instances for D rounded up to 32.  On the
//     card, 32-row streamed tiles (three blocks an SM) and 128-row own
//     tiles ran no faster at D 64, so what holds the kernels back is the
//     mma.sync throughput and the instructions around it, not occupancy
//     (rounding lo with a cvt of its own, one instruction more per split
//     element, was slower in proportion).
//
// The bf16 instances of all three up to D 256 (flash_fwd_bf16_kernel,
// flash_bwd_dq_bf16_kernel, flash_bwd_dkv_bf16_kernel) run every product
// as mma.sync m16n8k16 bf16 x bf16 with fp32 accumulation, the TPU
// kernels' arithmetic:
//   - Q, K, V (and in K7b and K7c dO) stay bf16 in shared memory, copied by
//     16-byte cp.async (d % 8 == 0 and 16-byte aligned operands; else
//     through registers), rows strided by S = DP + 8 elements so that
//     the eight 16-byte rows of an ldmatrix phase fall in eight distinct
//     bank groups; fragments are read with ldmatrix.x4 (A: rows 0-7 and
//     8-15 at k 0-7, then at k 8-15; B from the rows of the n operand
//     untransposed, or with .trans from the rows of the k operand);
//   - each warp owns 16 rows (query rows in K7a and K7b, key rows in
//     K7c); the scores (s in K7a; s and dp in K7b; s^T and dp^T in K7c)
//     come out in the accumulator
//     layout (rows g and g + 8, columns 2t and 2t + 1 of each n8 tile, g
//     = lane / 4, t = lane % 4), where p (and ds) are formed, rounded to
//     bf16 and packed into the A fragments of the next product as they
//     stand (n8 tiles 2kc and 2kc + 1 are k16 step kc), never passing
//     through shared memory; K7a's row max and sum over a row's four
//     lanes are two quad shuffles, and its exps the accurate expf, as in
//     the fp32 instance: o's error against an fp64 attention is the same
//     with the fast __expf, but over five seeds the bf16 transformer
//     step's gradients then lay further from the plain step's on four,
//     once past chip_smoke's band, and with expf as far as with K7a's
//     plain version in its place (time_variants.py flash_band, PERF.md
//     §6);
//   - K7a: 16 x WARPS query rows a block (8 warps up to D 64, 4 beyond),
//     keys 64 a step (32 past D 128), K and V double-buffered, K of the
//     next tile copied during this tile's Q K^T and V during its P V;
//     55 KB of shared memory and 128 registers at D 64 (two blocks an
//     SM); under a causal mask heaviest tiles first, and each warp skips
//     the key tiles past its own last row;
//   - K7c: BwdTile's rows and warps (64 own and streamed rows, 4 warps,
//     up to D 64; 32 rows with 2 or 4 warps sharing the columns beyond),
//     Q, dO, lse and delta double-buffered and copied one tile ahead; 56
//     KB of shared memory and 168 registers at D 64 (three blocks an SM);
//     each warp's DC = DP / NS columns are n8 tiles read two an x4
//     ldmatrix, and at DP 160 and 224 (DC 40 and 56) an odd last one by
//     an x2;
//   - K7b: K7c's tiles with queries and keys swapped (64 own query rows
//     and streamed key rows, 4 warps, up to D 64; 32 rows beyond), K and V
//     double-buffered and copied one tile ahead, lse and delta of a warp's
//     rows in registers, Q and dO A fragments read by ldmatrix each key
//     tile; shared memory 30, 54, 39, 51, 63, 75, 87 and 99 KB at DP 32
//     to 256, 128 registers and 8 bytes of stack at D 64 (four blocks an
//     SM); ds rounded to bf16 as it is packed (the TPU's ds.astype(
//     k.dtype)), dq += ds K with K read by ldmatrix.trans; under a causal
//     mask heaviest tiles first, every warp through the whole diagonal
//     tile;
//   - the score products chain into fresh 64-column partials above D 64,
//     as the TF32 ones do (K7a's lse is held to 1e-5).
// The WIDE bf16 instances (D > 256) keep the older code above.
//
// All three: under a causal mask the forward and dq skip the key tiles
// past the tile's last query row, and dk/dv start at the query tile that
// holds the tile's first key, as the TPU kernels skip blocks above the
// diagonal; keys past Tk get -inf in the forward and p = 0 in the
// backward, queries past Tq p = 0, so a ragged tile adds exactly 0; masked
// pairs get the TPU kernel's finite -1e30 with the same shared origin
// (qpos >= kpos), whose exp(s - lse) is exactly 0; the tail columns of an
// instance zero on load (they add 0 to every product) and never stored;
// any T.  Any D: above 256 (the widest instance) the output's columns are
// split over the grid's third axis in chunks of 64; each block reduces s
// (and dp) over all of D, staging its operands through shared memory 64
// columns at a time, and writes only its own columns (the forward's
// online-softmax state comes out the same in every chunk, so chunk 0
// alone writes lse).
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

constexpr float kNegInf = -1e30f;
constexpr int kMaxD = 256;    // the widest instance; wider D is chunked
constexpr int kWideD = 64;    // the chunk of D above kMaxD

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

// rows [r0, r0 + ROWS) and columns [c0, c0 + DP) of a (t, d) matrix into
// a ROWS x DP fp32 tile of row stride STRIDE, rows past t and columns past
// d zero: 16-byte cp.async copies that land while the block computes (fp32
// with d % 4 == 0 and 16-byte aligned operands: ``async``), else loads
// through registers.
template <typename T, int ROWS, int DP, int STRIDE, int THREADS>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, int r0,
                                           int t, int d, int c0,
                                           bool async) {
  if constexpr (std::is_same<T, float>::value) {
    if (async) {
      constexpr int C4 = DP / 4;
      for (int idx = threadIdx.x; idx < ROWS * C4; idx += THREADS) {
        const int r = idx / C4, c = idx % C4 * 4;
        const bool in = r0 + r < t && c0 + c < d;
        cp_async16(dst + r * STRIDE + c,
                   in ? src + (int64_t)(r0 + r) * d + c0 + c : src, in);
      }
      return;
    }
  }
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += THREADS) {
    const int r = idx / DP, c = idx % DP;
    dst[r * STRIDE + c] = r0 + r < t && c0 + c < d
                              ? to_float(src[(int64_t)(r0 + r) * d + c0 + c])
                              : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// K7a
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

// s[i][c] += Q row (ty + 16 i) . K row (tx + TX c), four kk a 16-byte read
// of each row
template <int RI, int CJ, int TX, int DP, int QS>
__device__ __forceinline__ void qk_tile(float (&s)[RI][CJ],
                                        const float* Qs, const float* Ks,
                                        int ty, int tx) {
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

// One block per (slice, query tile[, chunk of D when WIDE]); thread (ty,
// tx) owns query rows ty + 16 i, key columns tx + TX j of s and p, and
// value columns 4 TX g + 4 tx + e of acc.  Per tile of keys: s = Q K^T from
// 16-byte reads of Q and K rows (four kk a read, 4 FMAs per word at 128 x
// 64), the online softmax in registers, p through shared memory, acc += P
// V from 16-byte reads of P rows and V rows.  K of the next tile is copied
// in during this tile's softmax and P V, V of the next during its Q K^T.
// WIDE (D > kMaxD, DP = kWideD): s sums Q K^T over every DP-column chunk
// of D, each staged in turn, and P V takes the block's own chunk of V.
template <typename T, int DP, bool WIDE>
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
  const int col0 = WIDE ? blockIdx.z * DP : 0;   // the block's o columns
  const T* qb = q + bh * tq * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;
  // under a causal mask no query row of this tile sees a key past its last
  // row, so those tiles are skipped (they would add exactly 0)
  const int kend = causal ? min(tk, min(q0 + BQ, tq)) : tk;
  const int nt = (kend + BK - 1) / BK;

  if constexpr (!WIDE) {
    stage_tile<T, BQ, DP, QS, TH>(Qs, qb, q0, tq, d, 0, async);
    stage_tile<T, BK, DP, QS, TH>(Ks, kb, 0, tk, d, 0, async);
    cp_async_commit();
    stage_tile<T, BK, DP, DP, TH>(Vs, vb, 0, tk, d, 0, async);
    cp_async_commit();
  }

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
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int c = 0; c < CJ; ++c) s[i][c] = 0.0f;
    if constexpr (!WIDE) {
      cp_async_wait<1>();   // Q and this tile's K (its V may be in flight)
      __syncthreads();
      qk_tile<RI, CJ, TX, DP, QS>(s, Qs, Ks, ty, tx);
      __syncthreads();      // every thread is done with Ks
      if (j + 1 < nt)
        stage_tile<T, BK, DP, QS, TH>(Ks, kb, k0 + BK, tk, d, 0, async);
      cp_async_commit();
    } else {
      for (int c0 = 0; c0 < d; c0 += DP) {
        __syncthreads();    // every thread is done with Qs, Ks (and Ps)
        stage_tile<T, BQ, DP, QS, TH>(Qs, qb, q0, tq, d, c0, async);
        stage_tile<T, BK, DP, QS, TH>(Ks, kb, k0, tk, d, c0, async);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        qk_tile<RI, CJ, TX, DP, QS>(s, Qs, Ks, ty, tx);
      }
    }

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
        Ps[(ty + 16 * i) * PS + tx + TX * c] = round_to(p, (const T*)nullptr);
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum_tx<TX>(sum);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
    }
    if constexpr (!WIDE) {
      cp_async_wait<1>();   // this tile's V (the next K may be in flight)
      __syncthreads();      // and every row of Ps written
      pv_tile<RI, G, TX, BK, DP, PS>(acc, Ps, Vs, ty, tx);
      __syncthreads();      // every thread is done with Vs and Ps
      if (j + 1 < nt)
        stage_tile<T, BK, DP, DP, TH>(Vs, vb, k0 + BK, tk, d, 0, async);
      cp_async_commit();
    } else {
      __syncthreads();      // Ps written, the last tile's P V done with Vs
      stage_tile<T, BK, DP, DP, TH>(Vs, vb, k0, tk, d, col0, async);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      pv_tile<RI, G, TX, BK, DP, PS>(acc, Ps, Vs, ty, tx);
    }
  }

  T* ob = o + bh * tq * d;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < tq) {
      const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int c = col0 + 4 * TX * g + 4 * tx;
        float out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) out[e] = acc[i][g][e] / lc;
        if constexpr (std::is_same<T, float>::value) {
          if (d % 4 == 0 && c + 4 <= d) {
            *reinterpret_cast<float4*>(ob + (int64_t)r * d + c) =
                make_float4(out[0], out[1], out[2], out[3]);
            continue;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) store(ob + (int64_t)r * d + c + e, out[e]);
      }
      if (tx == 0 && blockIdx.z == 0) lse[bh * tq + r] = m[i] + logf(lc);
    }
  }
}

// ---------------------------------------------------------------------------
// K7b and K7c: tensor-core products (mma.sync m16n8k8 TF32, fp32 sums)
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as TF32 operands: with SPLIT (fp32 operands) hi = x rounded to TF32
// and lo = x - hi, whose low 13 bits the tensor cores ignore (lo truncated
// to TF32, as CUTLASS's 3xTF32 passes its small part); without (values
// exact in TF32: bf16 inputs, p and ds rounded to bf16) x itself, and lo
// unused.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (SPLIT) {
    hi = tf32_rna(x);
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// c += A B for a 16 x 8 A (rows g, g + 8; columns t, t + 4) and an 8 x 8 B
// (rows t, t + 4; column g)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// one fp32 product step: 3xTF32 with SPLIT (small terms first), else one
template <bool SPLIT>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  if constexpr (SPLIT) {
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
  }
  mma_tf32(c, ah, bh0, bh1);
}

// The tensor cores add each product into the accumulator with truncation,
// so a long chain of mma into one register drifts toward zero (on the
// card, past 1e-5 of the largest dk and dv over 1024 queries).  The
// products below run their chains into a fresh partial of at most 64
// columns or keys (24 mma a chain in 3xTF32) and add it to the sum with
// an fp32 add, which rounds to nearest.
constexpr int kChain = 64;

// c[n] += X Y^T over DP columns: X the warp's 16 rows (row stride S), Y
// rows 8 n .. 8 n + 7 of a tile (scores s = Q K^T, dp = dO V^T and their
// transposes); c in the accumulator layout
template <bool SPLIT, int NB, int DP, int S>
__device__ __forceinline__ void rows_product(float (&c)[NB][4],
                                             const float* X, const float* Y,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* x0 = X + g * S + t;
  const float* y0 = Y + g * S + t;
#pragma unroll 1
  for (int k0 = 0; k0 < DP; k0 += kChain) {
    float part[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.0f;
#pragma unroll 2
    for (int kk = k0; kk < min(k0 + kChain, DP); kk += 8) {
      uint32_t ah[4], al[4];
      split<SPLIT>(x0[kk], ah[0], al[0]);
      split<SPLIT>(x0[8 * S + kk], ah[1], al[1]);
      split<SPLIT>(x0[kk + 4], ah[2], al[2]);
      split<SPLIT>(x0[8 * S + kk + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        uint32_t bh0, bh1, bl0, bl1;
        split<SPLIT>(y0[n * 8 * S + kk], bh0, bl0);
        split<SPLIT>(y0[n * 8 * S + kk + 4], bh1, bl1);
        mma3<SPLIT>(part[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[n][e] += part[n][e];
  }
}

// acc[n] += P Y[:, 8 n .. 8 n + 7]: P (16 x 8 KB) the warp's p or ds in
// the accumulator layout, Y a tile of 8 KB rows (stride S) from its first
// output column.  A's column t is key 2t of each 8 and column t + 4 key 2t
// + 1, so P's accumulator registers (g, 2t), (g, 2t + 1), (g + 8, 2t), (g
// + 8, 2t + 1) are A's a0, a2, a1, a3; B's rows t and t + 4 read Y rows
// 2t and 2t + 1.
template <bool SPLIT, int KB, int NN, int S>
__device__ __forceinline__ void acc_product(float (&acc)[NN][4],
                                            const float (&p)[KB][4],
                                            const float* Y, int lane) {
  static_assert(8 * KB <= kChain, "one partial a tile");
  const int g = lane >> 2, t = lane & 3;
  const float* y0 = Y + 2 * t * S + g;
  float part[NN][4];
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[n][e] = 0.0f;
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    uint32_t ah[4], al[4];
    split<SPLIT>(p[kb][0], ah[0], al[0]);
    split<SPLIT>(p[kb][2], ah[1], al[1]);
    split<SPLIT>(p[kb][1], ah[2], al[2]);
    split<SPLIT>(p[kb][3], ah[3], al[3]);
    const float* yk = y0 + kb * 8 * S;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      uint32_t bh0, bh1, bl0, bl1;
      split<SPLIT>(yk[n * 8], bh0, bl0);
      split<SPLIT>(yk[S + n * 8], bh1, bl1);
      mma3<SPLIT>(part[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// K7b's and K7c's tiles for an instance width DP (a multiple of 32): B
// rows of the block's own tile and of each streamed tile; NS warps share
// 16 own rows, each with DC output columns; tiles strided by S = DP + 4
// floats (S % 32 == 4: conflict-free fragment reads).  Shared memory: the
// two own tiles, the two streamed tiles twice, and (K7c) lse and delta
// twice.
template <int DP>
struct BwdTile {
  static constexpr int B = DP <= 64 ? 64 : 32;
  static constexpr int NS = DP <= 64 ? 1 : DP <= 128 ? 2 : 4;
  static constexpr int THREADS = 32 * (B / 16) * NS;
  static constexpr int S = DP + 4;
  static constexpr int DC = DP / NS;
  static constexpr int NB = B / 8;
  static constexpr size_t smem = sizeof(float) * (6 * B * S + 4 * B);
};

// K7b: one block per (slice, query tile[, chunk of D when WIDE]); warp
// (rw, cw) owns query rows 16 rw .. 16 rw + 15 and dq columns DC cw .. DC
// cw + DC - 1.  Per key tile: s = Q K^T and dp = dO V^T (3xTF32), p and ds
// in registers, dq += ds K.  K and V of the next tile are copied in while
// this one computes.  WIDE: s and dp sum over every DP-column chunk of D,
// each staged in turn, and ds K takes the block's own chunk of K.
template <typename T, int DP, bool WIDE>
__global__ void __launch_bounds__(BwdTile<DP>::THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int tq, int tk, int d, float scale, int causal,
                        bool async) {
  using F = BwdTile<DP>;
  constexpr int B = F::B, S = F::S, NB = F::NB, DC = F::DC, TH = F::THREADS;
  constexpr bool SPLIT = std::is_same<T, float>::value;
  extern __shared__ float4 bwd_smem[];
  float* Qs = reinterpret_cast<float*>(bwd_smem);   // B x S
  float* Gs = Qs + B * S;                           // B x S: the rows of do
  float* Ks = Gs + B * S;                           // 2 x B x S
  float* Vs = Ks + 2 * B * S;                       // 2 x B x S

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = warp / F::NS, cw = warp % F::NS;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  // heaviest causal tiles first, as K7a
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * B;
  const int col0 = (WIDE ? blockIdx.z * DP : 0) + cw * DC;
  const T* qb = q + bh * tq * d;
  const T* gb = dout + bh * tq * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;
  const int kend = causal ? min(tk, min(q0 + B, tq)) : tk;
  const int nt = (kend + B - 1) / B;

  float lr[2], dr[2], acc[DC / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + 16 * rw + g + 8 * i;
    lr[i] = r < tq ? lse[bh * tq + r] : 0.0f;
    dr[i] = r < tq ? delta[bh * tq + r] : 0.0f;
  }
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  if constexpr (!WIDE) {
    stage_tile<T, B, DP, S, TH>(Qs, qb, q0, tq, d, 0, async);
    stage_tile<T, B, DP, S, TH>(Gs, gb, q0, tq, d, 0, async);
    stage_tile<T, B, DP, S, TH>(Ks, kb, 0, tk, d, 0, async);
    stage_tile<T, B, DP, S, TH>(Vs, vb, 0, tk, d, 0, async);
    cp_async_commit();
  }
  for (int j = 0; j < nt; ++j) {
    const int k0 = j * B;
    const float* Kj = Ks + (WIDE ? 0 : (j & 1) * B * S);
    const float* Vj = Vs + (WIDE ? 0 : (j & 1) * B * S);
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
    if constexpr (!WIDE) {
      cp_async_wait<0>();   // tile j (and, at j == 0, Q and dO)
      __syncthreads();      // ... for all; all done with tile j - 1
      if (j + 1 < nt) {
        const int nb = ((j + 1) & 1) * B * S;
        stage_tile<T, B, DP, S, TH>(Ks + nb, kb, k0 + B, tk, d, 0, async);
        stage_tile<T, B, DP, S, TH>(Vs + nb, vb, k0 + B, tk, d, 0, async);
      }
      cp_async_commit();
      rows_product<SPLIT, NB, DP, S>(s, Qs + 16 * rw * S, Kj, lane);
      rows_product<SPLIT, NB, DP, S>(dp, Gs + 16 * rw * S, Vj, lane);
    } else {
      for (int c0 = 0; c0 < d; c0 += DP) {
        __syncthreads();
        stage_tile<T, B, DP, S, TH>(Qs, qb, q0, tq, d, c0, async);
        stage_tile<T, B, DP, S, TH>(Gs, gb, q0, tq, d, c0, async);
        stage_tile<T, B, DP, S, TH>(Ks, kb, k0, tk, d, c0, async);
        stage_tile<T, B, DP, S, TH>(Vs, vb, k0, tk, d, c0, async);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        rows_product<SPLIT, NB, DP, S>(s, Qs + 16 * rw * S, Kj, lane);
        rows_product<SPLIT, NB, DP, S>(dp, Gs + 16 * rw * S, Vj, lane);
      }
      __syncthreads();
      stage_tile<T, B, DP, S, TH>(Ks, kb, k0, tk, d, col0 - cw * DC, async);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }

    // p and ds where s and dp lie: rows g + 8 i, keys 8 n + 2 t + (e & 1)
    const bool edge = k0 + B > tk || (causal && k0 + B - 1 > q0);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int qpos = q0 + 16 * rw + g + 8 * i;
        const int kpos = k0 + 8 * n + 2 * t + (e & 1);
        float val = s[n][e] * scale;
        if (edge && causal && qpos < kpos) val = kNegInf;
        const float p = edge && kpos >= tk ? 0.0f : __expf(val - lr[i]);
        s[n][e] = round_to((p * (dp[n][e] - dr[i])) * scale, k);   // ds
      }
    acc_product<SPLIT, NB, DC / 8, S>(acc, s, Kj + cw * DC, lane);
  }
  cp_async_wait<0>();   // nothing left in flight at exit

  T* db = dq + bh * tq * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + 16 * rw + g + 8 * i;
    if (r >= tq) continue;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = col0 + 8 * n + 2 * t + e;
        if (c < d) store(db + (int64_t)r * d + c, acc[n][2 * i + e]);
      }
  }
}

// K7c: one block per (slice, key tile[, chunk of D when WIDE]); warp (rw,
// cw) owns key rows 16 rw .. 16 rw + 15 and dk, dv columns DC cw .. DC cw
// + DC - 1.  Per query tile, from the diagonal on under a causal mask: s^T
// = K Q^T and dp^T = V dO^T (3xTF32), p^T and ds^T in registers, dv +=
// p^T dO, dk += ds^T Q.  Q, dO, lse and delta of the next tile are copied
// in while this one computes.  WIDE: s^T and dp^T sum over every
// DP-column chunk of D, and the products take the block's own chunk of
// dO and Q.
template <typename T, int DP, bool WIDE>
__global__ void __launch_bounds__(BwdTile<DP>::THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int tq, int tk, int d,
                         float scale, int causal, bool async) {
  using F = BwdTile<DP>;
  constexpr int B = F::B, S = F::S, NB = F::NB, DC = F::DC, TH = F::THREADS;
  constexpr bool SPLIT = std::is_same<T, float>::value;
  extern __shared__ float4 bwd_smem[];
  float* Ks = reinterpret_cast<float*>(bwd_smem);   // B x S
  float* Vs = Ks + B * S;                           // B x S
  float* Qs = Vs + B * S;                           // 2 x B x S
  float* Gs = Qs + 2 * B * S;                       // 2 x B x S: do
  float* Ls = Gs + 2 * B * S;                       // 2 x B: lse
  float* Es = Ls + 2 * B;                           // 2 x B: delta

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = warp / F::NS, cw = warp % F::NS;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * B;
  const int col0 = (WIDE ? blockIdx.z * DP : 0) + cw * DC;
  const T* qb = q + bh * tq * d;
  const T* gb = dout + bh * tq * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;
  const float* lb = lse + bh * tq;
  const float* eb = delta + bh * tq;
  // under a causal mask the query rows before k0 see none of this tile's
  // keys: start at the query tile that holds row k0
  const int qstart = causal ? k0 : 0;
  const int nt = qstart < tq ? (tq - qstart + B - 1) / B : 0;

  float dka[DC / 8][4], dva[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  // lse and delta of query rows [q0, q0 + B) into Ls, Es + o
  auto stage_rows = [&](int q0, int o) {
    for (int r = threadIdx.x; r < B; r += TH) {
      const bool in = q0 + r < tq;
      Ls[o + r] = in ? lb[q0 + r] : 0.0f;
      Es[o + r] = in ? eb[q0 + r] : 0.0f;
    }
  };
  if constexpr (!WIDE) {
    stage_tile<T, B, DP, S, TH>(Ks, kb, k0, tk, d, 0, async);
    stage_tile<T, B, DP, S, TH>(Vs, vb, k0, tk, d, 0, async);
    stage_tile<T, B, DP, S, TH>(Qs, qb, qstart, tq, d, 0, async);
    stage_tile<T, B, DP, S, TH>(Gs, gb, qstart, tq, d, 0, async);
    stage_rows(qstart, 0);
    cp_async_commit();
  }
  for (int j = 0; j < nt; ++j) {
    const int q0 = qstart + j * B;
    const int buf = WIDE ? 0 : j & 1;
    const float* Qj = Qs + buf * B * S;
    const float* Gj = Gs + buf * B * S;
    const float* Lj = Ls + buf * B;
    const float* Ej = Es + buf * B;
    float st[NB][4], dpt[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
    if constexpr (!WIDE) {
      cp_async_wait<0>();   // tile j (and, at j == 0, K and V)
      __syncthreads();      // ... for all; all done with tile j - 1
      if (j + 1 < nt) {
        const int nb = ((j + 1) & 1) * B * S;
        stage_tile<T, B, DP, S, TH>(Qs + nb, qb, q0 + B, tq, d, 0, async);
        stage_tile<T, B, DP, S, TH>(Gs + nb, gb, q0 + B, tq, d, 0, async);
        stage_rows(q0 + B, ((j + 1) & 1) * B);
      }
      cp_async_commit();
      rows_product<SPLIT, NB, DP, S>(st, Ks + 16 * rw * S, Qj, lane);
      rows_product<SPLIT, NB, DP, S>(dpt, Vs + 16 * rw * S, Gj, lane);
    } else {
      for (int c0 = 0; c0 < d; c0 += DP) {
        __syncthreads();
        stage_tile<T, B, DP, S, TH>(Ks, kb, k0, tk, d, c0, async);
        stage_tile<T, B, DP, S, TH>(Vs, vb, k0, tk, d, c0, async);
        stage_tile<T, B, DP, S, TH>(Qs, qb, q0, tq, d, c0, async);
        stage_tile<T, B, DP, S, TH>(Gs, gb, q0, tq, d, c0, async);
        if (c0 == 0) stage_rows(q0, 0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        rows_product<SPLIT, NB, DP, S>(st, Ks + 16 * rw * S, Qj, lane);
        rows_product<SPLIT, NB, DP, S>(dpt, Vs + 16 * rw * S, Gj, lane);
      }
      __syncthreads();
      stage_tile<T, B, DP, S, TH>(Qs, qb, q0, tq, d, col0 - cw * DC, async);
      stage_tile<T, B, DP, S, TH>(Gs, gb, q0, tq, d, col0 - cw * DC, async);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }

    // p^T and ds^T where s^T and dp^T lie: keys g + 8 i, queries 8 n + 2 t
    // + (e & 1); p rounded to dO's dtype and ds to Q's before their
    // products, as on the TPU
    const bool edge = q0 + B > tq || (causal && q0 < k0 + B - 1);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 16 * rw + g + 8 * (e >> 1);
        const int qc = 8 * n + 2 * t + (e & 1), qpos = q0 + qc;
        float val = st[n][e] * scale;
        if (edge && causal && qpos < kpos) val = kNegInf;
        const float p = edge && qpos >= tq ? 0.0f : __expf(val - Lj[qc]);
        const float ds = (p * (dpt[n][e] - Ej[qc])) * scale;
        st[n][e] = round_to(p, q);
        dpt[n][e] = round_to(ds, q);
      }
    acc_product<SPLIT, NB, DC / 8, S>(dva, st, Gj + cw * DC, lane);
    acc_product<SPLIT, NB, DC / 8, S>(dka, dpt, Qj + cw * DC, lane);
  }
  cp_async_wait<0>();   // nothing left in flight at exit (nt may be 0)

  T* dkb = dk + bh * tk * d;
  T* dvb = dv + bh * tk * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = k0 + 16 * rw + g + 8 * i;
    if (r >= tk) continue;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = col0 + 8 * n + 2 * t + e;
        if (c < d) {
          store(dkb + (int64_t)r * d + c, dka[n][2 * i + e]);
          store(dvb + (int64_t)r * d + c, dva[n][2 * i + e]);
        }
      }
  }
}

// ---------------------------------------------------------------------------
// The bf16 instances of K7a, K7b and K7c on the bf16 tensor cores
// (mma.sync m16n8k16, bf16 x bf16 summed in fp32); the WIDE ones (D >
// kMaxD) above keep the TF32 and SIMT paths.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

// an x4 ldmatrix: lanes 8 i .. 8 i + 7 give the row addresses of the i-th
// 8 x 8 matrix of bf16 (16 bytes a row), which lands in r[i]; lane (g, t)
// receives row g, columns 2t and 2t + 1 of each (with .trans, of each
// matrix's transpose: rows 2t and 2t + 1 of column g)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// an x2 ldmatrix with .trans: lanes 0-15 give the row addresses of two
// matrices (lanes 16-31 are not read)
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// c += A B for a 16 x 16 bf16 A (a[0]: rows g, columns 2t, 2t + 1; a[1]:
// rows g + 8; a[2], a[3]: the same at columns 8 + 2t) and a 16 x 8 B (b0:
// rows 2t, 2t + 1 of column g; b1: rows 8 + 2t, 9 + 2t), fp32 c (rows g,
// g + 8; columns 2t, 2t + 1)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments over keys 16 kc .. 16 kc + 15 of a warp's 16 rows of p
// (or ds) held in the accumulator layout of n8 tiles 2 kc and 2 kc + 1,
// rounded to bf16 where they stand (the TPU's p.astype(v.dtype))
template <int NB>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&p)[NB][4], int kc) {
  a[0] = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
  a[1] = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
  a[2] = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
  a[3] = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
}

// rows [r0, r0 + ROWS) and columns [0, DP) of a (t, d) bf16 matrix into a
// ROWS x S bf16 tile, rows past t and columns past d zero: 16-byte
// cp.async copies when ``async`` (d % 8 == 0, 16-byte aligned operands),
// else loads through registers
template <int ROWS, int DP, int S, int THREADS>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src, int r0,
                                           int t, int d, bool async) {
  if (async) {
    constexpr int C8 = DP / 8;
    for (int idx = threadIdx.x; idx < ROWS * C8; idx += THREADS) {
      const int r = idx / C8, c = idx % C8 * 8;
      const bool in = r0 + r < t && c < d;
      cp_async16(dst + r * S + c, in ? src + (int64_t)(r0 + r) * d + c : src,
                 in);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += THREADS) {
    const int r = idx / DP, c = idx % DP;
    dst[r * S + c] = r0 + r < t && c < d ? src[(int64_t)(r0 + r) * d + c]
                                         : __float2bfloat16_rn(0.0f);
  }
}

// ldmatrix row offsets (in elements, row stride S) of a lane's row
// address: a_offset for an A tile of 16 rows x 16 columns (x4 matrices:
// rows 0-7 and 8-15 at columns 0-7, then at 8-15), which is also the
// pattern of two B tiles of 16 rows (k) x 8 columns (n) read with .trans;
// bn_offset for two B tiles of 8 rows (n) x 16 columns (k) read without
// transposing (rows 0-7 at k 0-7 and 8-15, then rows 8-15)
template <int S>
__device__ __forceinline__ int a_offset(int lane) {
  return ((lane & 7) + 8 * ((lane >> 3) & 1)) * S + 8 * (lane >> 4);
}
template <int S>
__device__ __forceinline__ int bn_offset(int lane) {
  return ((lane & 7) + 8 * (lane >> 4)) * S + 8 * ((lane >> 3) & 1);
}

// c[n] += X Y^T over columns [k0, k1) for a warp's 16 rows X (A fragments
// at ``xa``, the lane's a_offset already added) and NB n8 tiles of rows of
// Y (at ``yb``, bn_offset added)
template <int NB, int S>
__device__ __forceinline__ void rows_chain(float (&c)[NB][4], const bf16* xa,
                                           const bf16* yb, int k0, int k1) {
  static_assert(NB % 2 == 0, "an x4 ldmatrix reads two n8 tiles");
#pragma unroll
  for (int kk = k0; kk < k1; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, xa + kk);
#pragma unroll
    for (int n = 0; n < NB; n += 2) {
      uint32_t b[4];
      ldsm_x4(b, yb + n * 8 * S + kk);
      mma_bf16(c[n], a, b[0], b[1]);
      mma_bf16(c[n + 1], a, b[2], b[3]);
    }
  }
}

// c = X Y^T over DP columns (c zero on entry): scores q k^T and dp = do
// v^T.  Above kChain columns each chain of mma runs into a fresh partial
// that an fp32 add folds into c, as the TF32 products do: the tensor
// cores truncate as they add, and K7a's lse is held to 1e-5.
template <int NB, int DP, int S>
__device__ __forceinline__ void rows_mma(float (&c)[NB][4], const bf16* xa,
                                         const bf16* yb) {
  if constexpr (DP <= kChain) {
    rows_chain<NB, S>(c, xa, yb, 0, DP);
  } else {
#pragma unroll
    for (int k0 = 0; k0 < DP; k0 += kChain) {
      float part[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.0f;
      rows_chain<NB, S>(part, xa, yb, k0, min(k0 + kChain, DP));
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] += part[n][e];
    }
  }
}

// acc[n] += P Y[:, 8 n .. 8 n + 7] for P a warp's 16 rows of p (or ds) over
// KB keys in the accumulator layout, and Y KB rows of NN x 8 columns (at
// ``yt``, a_offset added), read with .trans: two n8 tiles an x4 ldmatrix,
// and an odd last one (K7b's and K7c's DC 40 and 56, at DP 160 and 224)
// by an x2
template <int KB, int NN, int S>
__device__ __forceinline__ void acc_mma(float (&acc)[NN][4],
                                        const float (&p)[KB / 8][4],
                                        const bf16* yt) {
#pragma unroll
  for (int kc = 0; kc < KB / 16; ++kc) {
    uint32_t a[4];
    acc_to_a<KB / 8>(a, p, kc);
#pragma unroll
    for (int n = 0; n + 1 < NN; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, yt + kc * 16 * S + n * 8);
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
    if constexpr (NN % 2 == 1) {
      uint32_t b[2];
      ldsm_x2_t(b, yt + kc * 16 * S + (NN - 1) * 8);
      mma_bf16(acc[NN - 1], a, b[0], b[1]);
    }
  }
}

// K7a's bf16 tiles for an instance width DP (a multiple of 32, up to
// kMaxD): WARPS warps of 16 query rows each, BK keys a step; Q and the
// double-buffered K and V as bf16 with a row stride of S = DP + 8
// elements, so that the eight 16-byte rows of an ldmatrix phase fall in
// eight distinct bank groups.
template <int DP>
struct FwdBf16Tile {
  static constexpr int WARPS = DP <= 64 ? 8 : 4;
  static constexpr int BQ = 16 * WARPS;
  static constexpr int BK = DP <= 128 ? 64 : 32;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MIN_BLOCKS = DP <= 64 ? 2 : 1;
  static constexpr int S = DP + 8;
  static constexpr size_t smem = sizeof(bf16) * (BQ + 4 * BK) * S;
};

// K7a, bf16: one block per (slice, query tile); warp w owns query rows 16
// w .. 16 w + 15.  Per key tile: s = Q K^T (ldmatrix of Q and K rows), the
// online softmax in the accumulator layout with quad shuffles, p rounded
// to bf16 and packed as P V's A fragments where it stands, acc += P V
// (V read with ldmatrix.trans).  K of the next tile is copied in by
// cp.async during this tile's Q K^T, V of the next during its P V; under
// a causal mask a warp skips the key tiles past its own last row.
template <int DP>
__global__ void __launch_bounds__(FwdBf16Tile<DP>::THREADS,
                                  FwdBf16Tile<DP>::MIN_BLOCKS)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int tq, int tk, int d,
                          float scale, int causal, bool async) {
  using F = FwdBf16Tile<DP>;
  constexpr int BQ = F::BQ, BK = F::BK, S = F::S, TH = F::THREADS;
  constexpr int NB = BK / 8, ND = DP / 8;
  extern __shared__ float4 fwd_bf16_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fwd_bf16_smem);   // BQ x S
  bf16* Ks = Qs + BQ * S;                               // 2 x BK x S
  bf16* Vs = Ks + 2 * BK * S;                           // 2 x BK x S

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  // heaviest causal tiles first, as the fp32 instance
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  const int qw = q0 + 16 * warp;   // the warp's first query row
  const bf16* qb = q + bh * tq * d;
  const bf16* kb = k + bh * tk * d;
  const bf16* vb = v + bh * tk * d;
  const int kend = causal ? min(tk, min(q0 + BQ, tq)) : tk;
  const int nt = (kend + BK - 1) / BK;
  // the keys this warp's rows can see: under a causal mask none past its
  // last row, so later tiles would add exactly 0
  const int wend = causal ? min(kend, qw + 16) : kend;

  stage_bf16<BQ, DP, S, TH>(Qs, qb, q0, tq, d, async);
  stage_bf16<BK, DP, S, TH>(Ks, kb, 0, tk, d, async);
  cp_async_commit();
  stage_bf16<BK, DP, S, TH>(Vs, vb, 0, tk, d, async);
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const bf16* qa = Qs + 16 * warp * S + a_offset<S>(lane);
  const int kbo = bn_offset<S>(lane), vto = a_offset<S>(lane);

  for (int j = 0; j < nt; ++j) {
    const int k0 = j * BK;
    const int nb = ((j + 1) & 1) * BK * S;   // the next tile's buffer
    const bf16* Kj = Ks + (j & 1) * BK * S;
    const bf16* Vj = Vs + (j & 1) * BK * S;
    const bool active = k0 < wend;           // warp-uniform
    cp_async_wait<1>();   // Q and this tile's K (its V may be in flight)
    __syncthreads();      // ... for all; all done with tile j - 1
    if (j + 1 < nt) stage_bf16<BK, DP, S, TH>(Ks + nb, kb, k0 + BK, tk, d,
                                              async);
    cp_async_commit();

    float s[NB][4];
    if (active) {
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
      rows_mma<NB, DP, S>(s, qa, Kj + kbo);
      // rows g + 8 i, keys k0 + 8 n + 2 t + (e & 1): masked, the running
      // max and sum over the quad that shares a row, p in place of s
      const bool edge = k0 + BK > tk || (causal && k0 + BK - 1 > qw);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float val = s[n][e] * scale;
          if (edge) {
            const int kpos = k0 + 8 * n + 2 * t + (e & 1);
            if (kpos >= tk)
              val = -INFINITY;
            else if (causal && qw + g + 8 * (e >> 1) < kpos)
              val = kNegInf;
          }
          s[n][e] = val;
          mx[e >> 1] = fmaxf(mx[e >> 1], val);
        }
      float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], row_max_tx<4>(mx[i]));
        alpha[i] = expf(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[n][e] - m[e >> 1]);
          s[n][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        l[i] = l[i] * alpha[i] + row_sum_tx<4>(sum[i]);
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    }
    cp_async_wait<1>();   // this tile's V (the next K may be in flight)
    __syncthreads();
    if (j + 1 < nt) stage_bf16<BK, DP, S, TH>(Vs + nb, vb, k0 + BK, tk, d,
                                              async);
    cp_async_commit();
    if (active) acc_mma<BK, ND, S>(acc, s, Vj + vto);
  }
  cp_async_wait<0>();   // nothing left in flight at exit

  bf16* ob = o + bh * tq * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qw + g + 8 * i;
    if (r >= tq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = 8 * n + 2 * t;
      const float o0 = acc[n][2 * i] / lc, o1 = acc[n][2 * i + 1] / lc;
      bf16* dst = ob + (int64_t)r * d + c;
      if (d % 2 == 0 && c + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(o0, o1);
      } else {
        if (c < d) *dst = __float2bfloat16_rn(o0);
        if (c + 1 < d) dst[1] = __float2bfloat16_rn(o1);
      }
    }
    if (t == 0) lse[bh * tq + r] = m[i] + logf(lc);
  }
}

// K7b's and K7c's bf16 tiles for an instance width DP (a multiple of 32,
// up to kMaxD): B rows of the block's own tile (queries in K7b, keys in
// K7c) and of each streamed tile; NS warps share 16 own rows, each with
// DC output columns; bf16 tiles with a row stride of S = DP + 8 elements.
// Shared memory: the two own tiles once, the two streamed tiles twice,
// and in K7c lse and delta twice (fp32; K7b keeps its rows' in registers).
template <int DP>
struct BwdBf16Tile {
  static constexpr int B = DP <= 64 ? 64 : 32;
  static constexpr int NS = DP <= 64 ? 1 : DP <= 128 ? 2 : 4;
  static constexpr int THREADS = 32 * (B / 16) * NS;
  // K7c's registers for three blocks an SM up to D 64: on the card 6%
  // faster than with the 214 registers two blocks allow, though ptxas
  // keeps 88 bytes on the stack (PERF.md §6)
  static constexpr int MIN_BLOCKS = DP <= 64 ? 3 : 1;
  // K7b's for four blocks an SM up to D 64 (128, 8 bytes on the stack):
  // on the card 6% less time than with three blocks' 168 and 24% less
  // than with one block's 200 (PERF.md §6)
  static constexpr int MIN_BLOCKS_DQ = DP <= 64 ? 4 : 1;
  static constexpr int S = DP + 8;
  static constexpr int DC = DP / NS;
  static constexpr int NB = B / 8;
  static constexpr size_t smem_dq = sizeof(bf16) * 6 * B * S;
  static constexpr size_t smem = smem_dq + sizeof(float) * 4 * B;
};

// K7b, bf16: one block per (slice, query tile); warp (rw, cw) owns query
// rows 16 rw .. 16 rw + 15 and dq columns DC cw .. DC cw + DC - 1.  Per key
// tile: s = Q K^T and dp = dO V^T (A fragments of the warp's Q and dO
// rows, B fragments of K and V rows by ldmatrix), p and ds in registers,
// ds rounded to bf16 and packed as A fragments where it stands, dq += ds K
// (K read with ldmatrix.trans).  K and V of the next tile are copied in by
// cp.async while this one computes; under a causal mask the heaviest query
// tiles launch first.  Every warp runs the whole diagonal tile: skipping
// the 16-key steps past a warp's last row there, warp-uniform branches
// around the unrolled mma, was 20% slower on the card (PERF.md §6).
template <int DP>
__global__ void __launch_bounds__(BwdBf16Tile<DP>::THREADS,
                                  BwdBf16Tile<DP>::MIN_BLOCKS_DQ)
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int tq, int tk, int d,
                             float scale, int causal, bool async) {
  using F = BwdBf16Tile<DP>;
  constexpr int B = F::B, S = F::S, NB = F::NB, DC = F::DC, TH = F::THREADS;
  extern __shared__ float4 dq_bf16_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(dq_bf16_smem);   // B x S
  bf16* Gs = Qs + B * S;                               // B x S: do
  bf16* Ks = Gs + B * S;                               // 2 x B x S
  bf16* Vs = Ks + 2 * B * S;                           // 2 x B x S

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = warp / F::NS, cw = warp % F::NS;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  // heaviest causal tiles first, as K7a
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * B;
  const int qw = q0 + 16 * rw;   // the warp's first query row
  const int col0 = cw * DC;
  const bf16* qb = q + bh * tq * d;
  const bf16* gb = dout + bh * tq * d;
  const bf16* kb = k + bh * tk * d;
  const bf16* vb = v + bh * tk * d;
  const int kend = causal ? min(tk, min(q0 + B, tq)) : tk;
  const int nt = (kend + B - 1) / B;

  float lr[2], dr[2], acc[DC / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qw + g + 8 * i;
    lr[i] = r < tq ? lse[bh * tq + r] : 0.0f;
    dr[i] = r < tq ? delta[bh * tq + r] : 0.0f;
  }
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  stage_bf16<B, DP, S, TH>(Qs, qb, q0, tq, d, async);
  stage_bf16<B, DP, S, TH>(Gs, gb, q0, tq, d, async);
  stage_bf16<B, DP, S, TH>(Ks, kb, 0, tk, d, async);
  stage_bf16<B, DP, S, TH>(Vs, vb, 0, tk, d, async);
  cp_async_commit();

  const int ao = 16 * rw * S + a_offset<S>(lane);
  const int bno = bn_offset<S>(lane), bto = a_offset<S>(lane) + col0;
  for (int j = 0; j < nt; ++j) {
    const int k0 = j * B;
    const bf16* Kj = Ks + (j & 1) * B * S;
    const bf16* Vj = Vs + (j & 1) * B * S;
    cp_async_wait<0>();   // tile j (and, at j == 0, Q and dO)
    __syncthreads();      // ... for all; all done with tile j - 1
    if (j + 1 < nt) {
      const int nb = ((j + 1) & 1) * B * S;
      stage_bf16<B, DP, S, TH>(Ks + nb, kb, k0 + B, tk, d, async);
      stage_bf16<B, DP, S, TH>(Vs + nb, vb, k0 + B, tk, d, async);
    }
    cp_async_commit();
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
    rows_mma<NB, DP, S>(s, Qs + ao, Kj + bno);
    rows_mma<NB, DP, S>(dp, Gs + ao, Vj + bno);

    // p and ds where s and dp lie: rows g + 8 i, keys 8 n + 2 t + (e & 1);
    // ds is rounded to bf16 as it is packed for its product
    const bool edge = k0 + B > tk || (causal && k0 + B - 1 > q0);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int qpos = qw + g + 8 * i;
        const int kpos = k0 + 8 * n + 2 * t + (e & 1);
        float val = s[n][e] * scale;
        if (edge && causal && qpos < kpos) val = kNegInf;
        const float p = edge && kpos >= tk ? 0.0f : __expf(val - lr[i]);
        s[n][e] = (p * (dp[n][e] - dr[i])) * scale;
      }
    acc_mma<B, DC / 8, S>(acc, s, Kj + bto);
  }
  cp_async_wait<0>();   // nothing left in flight at exit

  bf16* db = dq + bh * tq * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qw + g + 8 * i;
    if (r >= tq) continue;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      const int c = col0 + 8 * n + 2 * t;
      bf16* dst = db + (int64_t)r * d + c;
      if (d % 2 == 0 && c + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
      } else {
        if (c < d) *dst = __float2bfloat16_rn(acc[n][2 * i]);
        if (c + 1 < d) dst[1] = __float2bfloat16_rn(acc[n][2 * i + 1]);
      }
    }
  }
}

// K7c, bf16: one block per (slice, key tile); warp (rw, cw) owns key rows
// 16 rw .. 16 rw + 15 and dk, dv columns DC cw .. DC cw + DC - 1.  Per
// query tile, from the diagonal on under a causal mask: s^T = K Q^T and
// dp^T = V dO^T (A fragments of the warp's K and V rows, B fragments of Q
// and dO rows by ldmatrix), p^T and ds^T in registers, rounded to bf16 and
// packed as A fragments where they stand, dv += p^T dO and dk += ds^T Q
// (dO and Q read with ldmatrix.trans).  Q, dO, lse and delta of the next
// tile are copied in by cp.async while this one computes.
template <int DP>
__global__ void __launch_bounds__(BwdBf16Tile<DP>::THREADS,
                                  BwdBf16Tile<DP>::MIN_BLOCKS)
    flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int tq, int tk, int d, float scale, int causal,
                              bool async) {
  using F = BwdBf16Tile<DP>;
  constexpr int B = F::B, S = F::S, NB = F::NB, DC = F::DC, TH = F::THREADS;
  extern __shared__ float4 bwd_bf16_smem[];
  float* Ls = reinterpret_cast<float*>(bwd_bf16_smem);   // 2 x B: lse
  float* Es = Ls + 2 * B;                                // 2 x B: delta
  bf16* Ks = reinterpret_cast<bf16*>(Es + 2 * B);        // B x S
  bf16* Vs = Ks + B * S;                                 // B x S
  bf16* Qs = Vs + B * S;                                 // 2 x B x S
  bf16* Gs = Qs + 2 * B * S;                             // 2 x B x S: do

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = warp / F::NS, cw = warp % F::NS;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * B;
  const int col0 = cw * DC;
  const bf16* qb = q + bh * tq * d;
  const bf16* gb = dout + bh * tq * d;
  const bf16* kb = k + bh * tk * d;
  const bf16* vb = v + bh * tk * d;
  const float* lb = lse + bh * tq;
  const float* eb = delta + bh * tq;
  // under a causal mask the query rows before k0 see none of this tile's
  // keys: start at the query tile that holds row k0
  const int qstart = causal ? k0 : 0;
  const int nt = qstart < tq ? (tq - qstart + B - 1) / B : 0;

  float dka[DC / 8][4], dva[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  // lse and delta of query rows [q0, q0 + B) into Ls, Es + o
  auto stage_rows = [&](int q0, int o) {
    for (int r = threadIdx.x; r < B; r += TH) {
      const bool in = q0 + r < tq;
      Ls[o + r] = in ? lb[q0 + r] : 0.0f;
      Es[o + r] = in ? eb[q0 + r] : 0.0f;
    }
  };
  stage_bf16<B, DP, S, TH>(Ks, kb, k0, tk, d, async);
  stage_bf16<B, DP, S, TH>(Vs, vb, k0, tk, d, async);
  stage_bf16<B, DP, S, TH>(Qs, qb, qstart, tq, d, async);
  stage_bf16<B, DP, S, TH>(Gs, gb, qstart, tq, d, async);
  stage_rows(qstart, 0);
  cp_async_commit();

  const int ao = 16 * rw * S + a_offset<S>(lane);
  const int bno = bn_offset<S>(lane), bto = a_offset<S>(lane) + col0;
  for (int j = 0; j < nt; ++j) {
    const int q0 = qstart + j * B;
    const int buf = j & 1;
    const bf16* Qj = Qs + buf * B * S;
    const bf16* Gj = Gs + buf * B * S;
    const float* Lj = Ls + buf * B;
    const float* Ej = Es + buf * B;
    cp_async_wait<0>();   // tile j (and, at j == 0, K and V)
    __syncthreads();      // ... for all; all done with tile j - 1
    if (j + 1 < nt) {
      const int nb = (buf ^ 1) * B * S;
      stage_bf16<B, DP, S, TH>(Qs + nb, qb, q0 + B, tq, d, async);
      stage_bf16<B, DP, S, TH>(Gs + nb, gb, q0 + B, tq, d, async);
      stage_rows(q0 + B, (buf ^ 1) * B);
    }
    cp_async_commit();
    float st[NB][4], dpt[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
    rows_mma<NB, DP, S>(st, Ks + ao, Qj + bno);
    rows_mma<NB, DP, S>(dpt, Vs + ao, Gj + bno);

    // p^T and ds^T where s^T and dp^T lie: keys g + 8 i, queries 8 n + 2 t
    // + (e & 1); rounded to bf16 as they are packed for their products
    const bool edge = q0 + B > tq || (causal && q0 < k0 + B - 1);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 16 * rw + g + 8 * (e >> 1);
        const int qc = 8 * n + 2 * t + (e & 1), qpos = q0 + qc;
        float val = st[n][e] * scale;
        if (edge && causal && qpos < kpos) val = kNegInf;
        const float p = edge && qpos >= tq ? 0.0f : __expf(val - Lj[qc]);
        st[n][e] = p;
        dpt[n][e] = (p * (dpt[n][e] - Ej[qc])) * scale;
      }
    acc_mma<B, DC / 8, S>(dva, st, Gj + bto);
    acc_mma<B, DC / 8, S>(dka, dpt, Qj + bto);
  }
  cp_async_wait<0>();   // nothing left in flight at exit (nt may be 0)

  bf16* dkb = dk + bh * tk * d;
  bf16* dvb = dv + bh * tk * d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = k0 + 16 * rw + g + 8 * i;
    if (r >= tk) continue;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      const int c = col0 + 8 * n + 2 * t;
      const int64_t at = (int64_t)r * d + c;
      if (d % 2 == 0 && c + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + at) =
            __floats2bfloat162_rn(dka[n][2 * i], dka[n][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvb + at) =
            __floats2bfloat162_rn(dva[n][2 * i], dva[n][2 * i + 1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c + e < d) {
            dkb[at + e] = __float2bfloat16_rn(dka[n][2 * i + e]);
            dvb[at + e] = __float2bfloat16_rn(dva[n][2 * i + e]);
          }
      }
    }
  }
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

// the dynamic shared memory of a kernel, and the largest carveout so that
// two blocks of up to 105 KB share an SM
template <typename K>
int set_smem(K kernel, size_t bytes) {
  int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != 0) return rc;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

// cp.async moves 16-byte pieces of fp32 rows: d % 4 == 0, aligned starts
template <typename T>
bool can_async(const Args& a) {
  return std::is_same<T, float>::value && a.d % 4 == 0 &&
         ((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
          (uintptr_t)a.dout) % 16 == 0;
}

// ... and of the bf16 instances' bf16 rows: d % 8 == 0, aligned starts
bool can_async_bf16(const Args& a) {
  return a.d % 8 == 0 && ((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                          (uintptr_t)a.dout) % 16 == 0;
}

// the grid's third axis: chunks of D for the WIDE instances
template <int DP, bool WIDE>
unsigned chunks(const Args& a) {
  return WIDE ? (unsigned)((a.d + DP - 1) / DP) : 1u;
}

// K7a at instance width DP
template <typename T, int DP, bool WIDE>
int launch_fwd(const Args& a) {
  if constexpr (std::is_same<T, bf16>::value && !WIDE) {
    using F = FwdBf16Tile<DP>;
    const dim3 grid((unsigned)a.bh, (unsigned)((a.tq + F::BQ - 1) / F::BQ));
    int rc;
    if ((rc = set_smem(flash_fwd_bf16_kernel<DP>, F::smem)) != 0) return rc;
    flash_fwd_bf16_kernel<DP><<<grid, F::THREADS, F::smem, a.st>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.tq,
        a.tk, a.d, a.scale, a.causal, can_async_bf16(a));
  } else {
    using F = FwdTile<DP>;
    const dim3 grid((unsigned)a.bh, (unsigned)((a.tq + F::BQ - 1) / F::BQ),
                    chunks<DP, WIDE>(a));
    int rc;
    if ((rc = set_smem(flash_fwd_kernel<T, DP, WIDE>, F::smem)) != 0)
      return rc;
    flash_fwd_kernel<T, DP, WIDE><<<grid, F::THREADS, F::smem, a.st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.tq, a.tk,
        a.d, a.scale, a.causal, can_async<T>(a));
  }
  return 0;
}

// which: 1 = dq (K7b), 2 = dk and dv (K7c)
template <typename T, int DP, bool WIDE>
int launch_bwd(int which, const Args& a) {
  using F = BwdTile<DP>;
  const unsigned rows =
      (unsigned)(((which == 2 ? a.tk : a.tq) + F::B - 1) / F::B);
  const dim3 grid((unsigned)a.bh, rows, chunks<DP, WIDE>(a));
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.dout);
  int rc;
  if (which == 1) {
    if constexpr (std::is_same<T, bf16>::value && !WIDE) {
      using G = BwdBf16Tile<DP>;
      const dim3 grid1((unsigned)a.bh, (unsigned)((a.tq + G::B - 1) / G::B));
      if ((rc = set_smem(flash_bwd_dq_bf16_kernel<DP>, G::smem_dq)) != 0)
        return rc;
      flash_bwd_dq_bf16_kernel<DP><<<grid1, G::THREADS, G::smem_dq, a.st>>>(
          q, k, v, g, a.lse, a.delta, static_cast<bf16*>(a.dq), a.tq, a.tk,
          a.d, a.scale, a.causal, can_async_bf16(a));
    } else {
      if ((rc = set_smem(flash_bwd_dq_kernel<T, DP, WIDE>, F::smem)) != 0)
        return rc;
      flash_bwd_dq_kernel<T, DP, WIDE><<<grid, F::THREADS, F::smem, a.st>>>(
          q, k, v, g, a.lse, a.delta, static_cast<T*>(a.dq), a.tq, a.tk, a.d,
          a.scale, a.causal, can_async<T>(a));
    }
  } else if constexpr (std::is_same<T, bf16>::value && !WIDE) {
    using G = BwdBf16Tile<DP>;
    const dim3 grid2((unsigned)a.bh, (unsigned)((a.tk + G::B - 1) / G::B));
    if ((rc = set_smem(flash_bwd_dkv_bf16_kernel<DP>, G::smem)) != 0)
      return rc;
    flash_bwd_dkv_bf16_kernel<DP><<<grid2, G::THREADS, G::smem, a.st>>>(
        q, k, v, g, a.lse, a.delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.tq, a.tk, a.d, a.scale, a.causal,
        can_async_bf16(a));
  } else {
    if ((rc = set_smem(flash_bwd_dkv_kernel<T, DP, WIDE>, F::smem)) != 0)
      return rc;
    flash_bwd_dkv_kernel<T, DP, WIDE><<<grid, F::THREADS, F::smem, a.st>>>(
        q, k, v, g, a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.tq, a.tk, a.d, a.scale, a.causal,
        can_async<T>(a));
  }
  return 0;
}

template <typename T, int DP, bool WIDE>
int launch(int which, const Args& a) {
  return which == 0 ? launch_fwd<T, DP, WIDE>(a)
                    : launch_bwd<T, DP, WIDE>(which, a);
}

// D rounded up to the next multiple of 32 up to kMaxD; above it the WIDE
// instances, kWideD columns a chunk
template <typename T>
int launch_d(int which, const Args& a) {
  if (a.d > kMaxD) return launch<T, kWideD, true>(which, a);
  switch ((a.d + 31) / 32 * 32) {
#define MXTT_FLASH_CASE(DP) \
    case DP: return launch<T, DP, false>(which, a);
    MXTT_FLASH_CASE(32)
    MXTT_FLASH_CASE(64)
    MXTT_FLASH_CASE(96)
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
  // the grid's second axis counts tiles of at least 32 rows of Tq (or Tk),
  // its third chunks of 64 columns of D
  if (a.bh <= 0 || a.bh >= (int64_t(1) << 31) || a.tq <= 0 || a.tk <= 0 ||
      a.tq > 65535 * 32 || a.tk > 65535 * 32 || a.d < 1 ||
      a.d > 65535 * kWideD)
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
// 65535 * 64; 1 <= bh < 2^31; 1 <= tq, tk <= 65535 * 32.  Each returns
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
