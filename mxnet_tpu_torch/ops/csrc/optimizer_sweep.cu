// One-sweep optimizer updates over a flat fp32 bucket, in place:
// SGD (K1a), SGD with momentum (K1b) and Adam (K4).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py _sgd_kernel (:538),
// _sgd_mom_kernel (:543) and _adam_kernel (:551), launched through
// _sweep_call_single (:593) by fused_sgd_momentum / fused_adam, which
// Executor._sweep_update calls once per bucket of the fused train step.
//
// What it computes, per element, with the hyperparameters read from one
// small fp32 device vector in the JAX package's order:
//   g' = clip(g * rescale, -c, c) + wd * w          (clip only if on)
//   K1a  h = [lr, wd, rescale, (c)]:       w' = w - lr * g'
//   K1b  h = [lr, mu, wd, rescale, (c)]:   m' = mu * m - lr * g';  w' = w + m'
//   K4   h = [lr_eff, b1, b2, 1-b1, 1-b2, eps, wd, rescale, (c)]:
//        m' = b1 * m + (1-b1) * g';  v' = b2 * v + (1-b2) * (g' * g')
//        w' = w - (lr_eff * m') / (sqrt(v') + eps)
//
// Bound on Hopper: memory bytes.  Each element is read once from each
// input and written once to each state, with 5 to 12 float operations
// between, far below the ~20 operations per byte at which an H100
// stops waiting on HBM.  For ResNet-50's large bucket (25.53 M
// parameters, 102 MB) K1a moves 3 x 102 MB, K1b 5 x and K4 7 x, about
// 0.09, 0.15 and 0.21 ms at 3.35 TB/s; buckets that size do not fit the
// 50 MB L2, so the kernel streams.  The design moves each byte once and
// nothing else:
//   - the bucket is a flat n-element buffer with no padding: the kernel
//     masks the ragged end itself (the TPU kernel's (rows, 128) layout
//     and zero-padded tail do not exist here);
//   - a grid-stride loop over 16-byte (float4) accesses when every
//     pointer is 16-byte aligned (the wrapper checks), then a scalar
//     tail; a misaligned view takes the scalar loop throughout;
//   - w, m and v are updated in place, so the executor's weights, which
//     are views of the bucket, are the update's output: no second buffer
//     and no unflatten;
//   - the hyperparameters are read once per thread from device memory,
//     so a schedule step is one small copy into that vector and no new
//     launch argument (the executor queues that copy from pinned host
//     memory without blocking, see Executor._device_hyper).
// Arithmetic: fp32 with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn /
// __fsqrt_rn, so nvcc cannot contract a product and a sum into an FMA:
// PyTorch's eager ops round each product, and the kernel is bitwise
// equal to its plain version (cuda_kernels.*_sweep_ref, which mirrors
// ops/optimizer_ops.py).  The clip is two compares that let a NaN
// through, as torch.clamp does.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Kind { kSgd = 0, kSgdMom = 1, kAdam = 2 };

struct Hyper {
  float lr, mu, b1, b2, omb1, omb2, eps, wd, rescale, clip;
};

template <int KIND, bool CLIP>
__device__ __forceinline__ Hyper load_hyper(const float* __restrict__ h) {
  Hyper p = {};
  if (KIND == kSgd) {
    p.lr = h[0]; p.wd = h[1]; p.rescale = h[2];
    if (CLIP) p.clip = h[3];
  } else if (KIND == kSgdMom) {
    p.lr = h[0]; p.mu = h[1]; p.wd = h[2]; p.rescale = h[3];
    if (CLIP) p.clip = h[4];
  } else {
    p.lr = h[0]; p.b1 = h[1]; p.b2 = h[2]; p.omb1 = h[3]; p.omb2 = h[4];
    p.eps = h[5]; p.wd = h[6]; p.rescale = h[7];
    if (CLIP) p.clip = h[8];
  }
  return p;
}

template <int KIND, bool CLIP>
__device__ __forceinline__ void update(const Hyper& p, float& w, float g,
                                       float& m, float& v) {
  g = __fmul_rn(g, p.rescale);
  if (CLIP) {
    g = g < -p.clip ? -p.clip : g;
    g = g > p.clip ? p.clip : g;
  }
  g = __fadd_rn(g, __fmul_rn(p.wd, w));
  if (KIND == kSgd) {
    w = __fsub_rn(w, __fmul_rn(p.lr, g));
  } else if (KIND == kSgdMom) {
    m = __fsub_rn(__fmul_rn(p.mu, m), __fmul_rn(p.lr, g));
    w = __fadd_rn(w, m);
  } else {
    m = __fadd_rn(__fmul_rn(p.b1, m), __fmul_rn(p.omb1, g));
    v = __fadd_rn(__fmul_rn(p.b2, v), __fmul_rn(p.omb2, __fmul_rn(g, g)));
    w = __fsub_rn(w, __fdiv_rn(__fmul_rn(p.lr, m),
                               __fadd_rn(__fsqrt_rn(v), p.eps)));
  }
}

template <int KIND, bool CLIP, bool VEC>
__global__ void __launch_bounds__(256)
    sweep_kernel(float* __restrict__ w, const float* __restrict__ g,
                 float* __restrict__ m, float* __restrict__ v,
                 const float* __restrict__ h, int64_t n) {
  const Hyper p = load_hyper<KIND, CLIP>(h);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if (VEC) {
    const int64_t nvec = n >> 2;
    float4* w4 = reinterpret_cast<float4*>(w);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (int64_t i = tid; i < nvec; i += stride) {
      float4 wv = w4[i];
      const float4 gv = __ldg(g4 + i);
      float4 mv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = mv;
      if (KIND != kSgd) mv = m4[i];
      if (KIND == kAdam) vv = v4[i];
      update<KIND, CLIP>(p, wv.x, gv.x, mv.x, vv.x);
      update<KIND, CLIP>(p, wv.y, gv.y, mv.y, vv.y);
      update<KIND, CLIP>(p, wv.z, gv.z, mv.z, vv.z);
      update<KIND, CLIP>(p, wv.w, gv.w, mv.w, vv.w);
      w4[i] = wv;
      if (KIND != kSgd) m4[i] = mv;
      if (KIND == kAdam) v4[i] = vv;
    }
    head = nvec << 2;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    float wi = w[i];
    float mi = 0.f, vi = 0.f;
    if (KIND != kSgd) mi = m[i];
    if (KIND == kAdam) vi = v[i];
    update<KIND, CLIP>(p, wi, __ldg(g + i), mi, vi);
    w[i] = wi;
    if (KIND != kSgd) m[i] = mi;
    if (KIND == kAdam) v[i] = vi;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    return 132;
  return sms;
}

template <int KIND, bool CLIP, bool VEC>
void launch(void* w, const void* g, void* m, void* v, const void* h,
            int64_t n, cudaStream_t st) {
  const int threads = 256;
  const int64_t work = VEC ? (n >> 2) + (n & 3) : n;
  int64_t blocks = (work + threads - 1) / threads;
  // enough blocks to fill every SM (8 resident blocks of 256 threads
  // each); the grid-stride loop covers the rest
  const int64_t cap = (int64_t)sm_count() * 8;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  sweep_kernel<KIND, CLIP, VEC><<<(unsigned)blocks, threads, 0, st>>>(
      static_cast<float*>(w), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const float*>(h), n);
}

template <int KIND>
void dispatch(void* w, const void* g, void* m, void* v, const void* h,
              int64_t n, int clip, int vec, cudaStream_t st) {
  if (clip) {
    if (vec) launch<KIND, true, true>(w, g, m, v, h, n, st);
    else launch<KIND, true, false>(w, g, m, v, h, n, st);
  } else {
    if (vec) launch<KIND, false, true>(w, g, m, v, h, n, st);
    else launch<KIND, false, false>(w, g, m, v, h, n, st);
  }
}

}  // namespace

// kind 0 = SGD (m and v unused, may be null), 1 = SGD with momentum (v
// unused), 2 = Adam.  w, g, m, v: n contiguous fp32 elements each;
// hyper: the kind's fp32 vector above, on the device.  clip != 0 reads
// the clip bound as the vector's last entry.  vec != 0 asks for 16-byte
// accesses: the caller guarantees that every pointer it passes is
// 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int mxtt_optimizer_sweep(int kind, void* w, const void* g,
                                    void* m, void* v, const void* hyper,
                                    int64_t n, int clip, int vec,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (kind == kSgd)
      dispatch<kSgd>(w, g, m, v, hyper, n, clip, vec, st);
    else if (kind == kSgdMom)
      dispatch<kSgdMom>(w, g, m, v, hyper, n, clip, vec, st);
    else if (kind == kAdam)
      dispatch<kAdam>(w, g, m, v, hyper, n, clip, vec, st);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
