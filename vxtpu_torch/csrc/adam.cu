// Adam's update for Hopper (sm_90a): one pass over a float32 parameter, its
// gradient and its two moments.
//
// Replaces no Pallas kernel: the JAX package's optimizer is optax.adam,
// plain jnp that XLA fuses into one pass. In eager PyTorch,
// torch.optim.Adam's default foreach path runs the same update as seven
// multi-tensor kernels (lerp, mul, addcmul, sqrt, div, add, addcdiv) that
// read and write the moments and a parameter-sized temporary again and
// again: some eighteen passes over 2.147 GB a step for the c4 fit's
// [512^3, 4] table. This kernel reads p, g, m and v once and writes p, m
// and v once.
//
// The math, torch.optim.Adam's in float32 (vxbench/reference/soft.py:adam
// writes it with the same tensor ops), with the scalars the host works out
// in double from the step count t and rounds to float:
//   m     <- m + (1 - beta1) (g - m)             (torch's lerp, weight < 0.5)
//   v     <- beta2 v + (1 - beta2) g g           (mul, then addcmul)
//   denom <- sqrt(v) / sqrt(1 - beta2^t) + eps
//   p     <- p - (lr / (1 - beta1^t)) m / denom  (addcdiv)
// Each line rounds where torch's CUDA kernels round: the lerp, the addcmul
// and the addcdiv are single fused multiply-adds there (torch's kernels are
// built with contraction on, and its pointwise ops call fma), so they are
// __fmaf_rn here; everything else rounds after each operation, as
// -fmad=false keeps it. sqrtf and the divisions are the IEEE-rounded ones.
//
// What bounds it on this card: bytes, at 13 float32 operations for 28
// bytes an element. At D = 512 the four reads and three writes of
// 2.147 GB are 15.03 GB: 4.487 ms at 3.35 TB/s.
// What the design does about it:
//   * one thread updates one float4 of each tensor, and a warp's 32 lanes
//     take 32 consecutive float4s: every load and store instruction moves
//     512 contiguous bytes. Where any of the four pointers is not 16-byte
//     aligned the same code runs on single floats; the last n % 4 elements
//     always do;
//   * each thread issues its four 16-byte loads before it uses any, and
//     the launch has a block for every 256 float4s (524,288 blocks at
//     D = 512), so an SM holds six blocks at 40 registers a thread: 96 KB
//     of loads in flight an SM, several times what 3.35 TB/s over ~1 us of
//     latency needs (~25 KB an SM). A grid of only the blocks the card
//     holds at once, walking the tensor in a grid-stride loop two float4s
//     a thread at a time, measured 5.27-5.31 ms against this one's 4.93
//     on an H100 80GB HBM3 at 700 W (share 0.91 of the byte bound, as much
//     as torch's own copy of a 2.147 GB tensor reaches there);
//   * every access is a streaming one (__ldcs / __stcs: evict first): 15 GB
//     pass through a 50 MB L2 with no reuse;
//   * the scalars come as arguments from the host: no device read, no host
//     synchronisation. No atomics: every element is computed alone, so a
//     step is the same bit for bit from run to run, whatever the grid.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct AdamScalars {
  float one_minus_beta1;  // lerp weight
  float beta2;
  float one_minus_beta2;
  float bc2_sqrt;         // sqrt(1 - beta2^t)
  float neg_step;         // -lr / (1 - beta1^t)
  float eps;
};

__device__ __forceinline__ void adam1(float& p, float g, float& m, float& v,
                                      const AdamScalars& s) {
  m = __fmaf_rn(s.one_minus_beta1, g - m, m);
  v = __fmaf_rn(s.one_minus_beta2, g * g, v * s.beta2);
  const float denom = sqrtf(v) / s.bc2_sqrt + s.eps;
  p = __fmaf_rn(s.neg_step, m / denom, p);
}

__device__ __forceinline__ void adam4(float4& p, const float4 g, float4& m,
                                      float4& v, const AdamScalars& s) {
  adam1(p.x, g.x, m.x, v.x, s);
  adam1(p.y, g.y, m.y, v.y, s);
  adam1(p.z, g.z, m.z, v.z, s);
  adam1(p.w, g.w, m.w, v.w, s);
}

// n elements; the first 4 * n4 as float4s (n4 = 0 where a pointer is not
// 16-byte aligned), the rest one at a time. The launch gives each thread
// one float4 (or one element); the grid-stride loops take any grid.
__global__ void __launch_bounds__(kThreads)
adam_step_kernel(float* __restrict__ p, const float* __restrict__ g,
                 float* __restrict__ m, float* __restrict__ v, int64_t n,
                 int64_t n4, AdamScalars s) {
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t i = first; i < n4; i += stride) {
    float4 pp = __ldcs(p4 + i), gg = __ldcs(g4 + i), mm = __ldcs(m4 + i),
           vv = __ldcs(v4 + i);
    adam4(pp, gg, mm, vv, s);
    __stcs(p4 + i, pp);
    __stcs(m4 + i, mm);
    __stcs(v4 + i, vv);
  }
  for (int64_t e = 4 * n4 + first; e < n; e += stride) {
    float pe = __ldcs(p + e), me = __ldcs(m + e), ve = __ldcs(v + e);
    adam1(pe, __ldcs(g + e), me, ve, s);
    __stcs(p + e, pe);
    __stcs(m + e, me);
    __stcs(v + e, ve);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError(); nothing here synchronises. p, g, m, v: n
// contiguous floats each, on one device. The scalars as AdamScalars names
// them.
extern "C" int vx_adam_step(float* p, const float* g, float* m, float* v,
                            int64_t n, float one_minus_beta1, float beta2,
                            float one_minus_beta2, float bc2_sqrt,
                            float neg_step, float eps, cudaStream_t stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(m) |
                         reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int64_t n4 = aligned ? n / 4 : 0;
  // one thread a float4, or an element where there are none
  const int64_t work = n4 > 0 ? n4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) blocks = 0x7FFFFFFF;
  const AdamScalars s{one_minus_beta1, beta2, one_minus_beta2, bc2_sqrt,
                      neg_step, eps};
  adam_step_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(p, g, m, v, n,
                                                               n4, s);
  return (int)cudaGetLastError();
}
