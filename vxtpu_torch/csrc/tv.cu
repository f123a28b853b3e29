// The Morton TV prior of the field-kernel fit for Hopper (sm_90a): its
// value and its gradient, each one pass over the [D^3, 4] table.
//
// Replaces no Pallas kernel: the JAX package's prior
// (vxtpu/train/loss.py:tv_loss_morton) is plain jnp that XLA fuses into
// one pass. In eager PyTorch the same function (train/loss.py:
// tv_prior_morton, the plain version) takes three strided differences of
// the table, squares them and, in autograd's backward, zero-fills,
// copies and adds a table-sized gradient per difference: some fifteen
// to twenty passes over 1-2 GB a step at D = 512. These kernels do it in
// one read (the value) and one read and one write (the gradient).
//
// The math (the plain version defines it). Row e of the table holds the
// four channels (sigma, r, g, b) of the voxel whose Morton code is e; the
// pairs compared are (e, e | bit) for e with the bit clear, bit 0 of the
// index being x, bit 1 y and bit 2 z, so every pair lies inside one
// aligned group of 8 rows, a 2x2x2 brick. With w'_0 = tv_sigma and
// w'_1 = w'_2 = w'_3 = tv_rgb / 3:
//   value       (2/3) sum_c w'_c sum_axis mean over the D^3/2 pairs of
//               (v1 - v0)^2, computed as the plain version writes it:
//               per_c = S_c / (D^3 / 2), S_c the sum over all 3 D^3 / 2
//               pairs, then 2 (tv_sigma per_0 + tv_rgb mean(per_1..3)) / 3;
//   gradient    of row e, channel c: g (8 / (3 D^3)) w'_c sum_axis
//               (v[e][c] - v[e ^ bit][c]), g the upstream gradient.
//
// What bounds them on this card: bytes, at well under one operation a
// byte. The value must read the table once (2.147 GB at D = 512: 0.641 ms
// at 3.35 TB/s), the gradient read it once and write its own [D^3, 4]
// once (4.295 GB: 1.282 ms).
// What the design does about it:
//   * every load and store is a 16-byte row, and a warp's 32 lanes take
//     32 consecutive rows: 512 contiguous bytes an instruction, so each
//     instruction is fully coalesced. The 8 lanes of an aligned group
//     hold one 2x2x2 brick, and lane l's partner across an axis is lane
//     l ^ bit: the pair's other row comes in by a register shuffle, not a
//     second read. (One thread a brick, each reading its own 128 bytes,
//     would spread every load instruction over 32 lines.)
//   * each thread issues kUnroll loads before it uses any, so enough
//     bytes are in flight to cover the latency of device memory;
//   * the value: each lane sums the squared differences of the pairs
//     whose low row it holds, per channel, in registers; a block reduces
//     them by warp shuffles and shared memory in a fixed order and writes
//     one [4] partial; tv_fwd_finish_kernel adds the partials in a fixed
//     order and applies the weights. No float atomics: the value is the
//     same bit for bit from run to run on one card. tv_fwd_kernel runs a
//     grid-stride loop on at most as many blocks as the caller's scratch
//     has partial rows (kernel_tv.py sizes it to the blocks an H100
//     holds at once), so no block waits for a second wave and the
//     partials stay few;
//   * the gradient: one flat pass, each lane writing the 16-byte gradient
//     row of the row it read. g is read from its device pointer; nothing
//     here synchronises with the host.
//
// Floating point: float32 throughout, built with -fmad=false like the
// other kernels. The sums run in another order than the plain version's
// (which reduces per axis with PyTorch's tree), so the value agrees with
// it to rounding; the gradient of each row is the same few operations.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float4 shfl_xor4(const float4 v, int bit) {
  return make_float4(__shfl_xor_sync(kFull, v.x, bit),
                     __shfl_xor_sync(kFull, v.y, bit),
                     __shfl_xor_sync(kFull, v.z, bit),
                     __shfl_xor_sync(kFull, v.w, bit));
}

// Row e = base + j * kThreads + threadIdx.x of each unrolled slot j; a row
// past the end (a whole 8-row brick, since n is a multiple of 8) reads 0.
// Every lane of the warp runs this, so the shuffles see all 32.
__device__ __forceinline__ void load_rows(const float4* __restrict__ tab,
                                          int64_t n, int64_t base,
                                          float4 (&v)[kUnroll]) {
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const int64_t e = base + (int64_t)j * kThreads + threadIdx.x;
    v[j] = e < n ? __ldg(tab + e) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Adds, for each pair whose low row this lane holds, (v1 - v0)^2 per
// channel to acc.
__device__ __forceinline__ void add_pairs(const float4 v, int lane,
                                          float4& acc) {
#pragma unroll
  for (int bit = 1; bit <= 4; bit <<= 1) {
    const float4 o = shfl_xor4(v, bit);
    const bool low = (lane & bit) == 0;
    const float dx = o.x - v.x, dy = o.y - v.y, dz = o.z - v.z,
                dw = o.w - v.w;
    acc.x = acc.x + (low ? dx * dx : 0.0f);
    acc.y = acc.y + (low ? dy * dy : 0.0f);
    acc.z = acc.z + (low ? dz * dz : 0.0f);
    acc.w = acc.w + (low ? dw * dw : 0.0f);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = x + __shfl_xor_sync(kFull, x, off);
  return x;
}

// The block's sum of acc, in a fixed order, on thread 0.
__device__ __forceinline__ float4 block_sum(float4 acc) {
  __shared__ float4 warp_part[kWarps];
  acc = make_float4(warp_sum(acc.x), warp_sum(acc.y), warp_sum(acc.z),
                    warp_sum(acc.w));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_part[warp] = acc;
  __syncthreads();
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s.x = s.x + warp_part[w].x;
      s.y = s.y + warp_part[w].y;
      s.z = s.z + warp_part[w].z;
      s.w = s.w + warp_part[w].w;
    }
  }
  return s;
}

// Block b's sum of the squared pair differences over its rows, per
// channel, into part[b].
__global__ void __launch_bounds__(kThreads)
tv_fwd_kernel(const float4* __restrict__ tab, int64_t n,
              float4* __restrict__ part) {
  const int lane = threadIdx.x & 31;
  const int64_t step = (int64_t)gridDim.x * kThreads * kUnroll;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int64_t base = (int64_t)blockIdx.x * kThreads * kUnroll; base < n;
       base += step) {
    float4 v[kUnroll];
    load_rows(tab, n, base, v);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) add_pairs(v[j], lane, acc);
  }
  const float4 s = block_sum(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// The value from the nparts partials: the channel sums added in a fixed
// order, then the plain version's expression. One block.
__global__ void __launch_bounds__(kThreads)
tv_fwd_finish_kernel(const float4* __restrict__ part, int nparts,
                     float pairs, float tv_sigma, float tv_rgb,
                     float* __restrict__ out) {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < nparts; i += kThreads) {
    const float4 p = part[i];
    acc.x = acc.x + p.x;
    acc.y = acc.y + p.y;
    acc.z = acc.z + p.z;
    acc.w = acc.w + p.w;
  }
  const float4 s = block_sum(acc);
  if (threadIdx.x == 0) {
    const float per0 = s.x / pairs, per1 = s.y / pairs, per2 = s.z / pairs,
                per3 = s.w / pairs;
    const float rgb = (per1 + per2 + per3) / 3.0f;
    *out = 2.0f * (tv_sigma * per0 + tv_rgb * rgb) / 3.0f;
  }
}

// grad[e] = g (8 / (3 D^3)) w'_c sum_axis (v[e] - v[e ^ bit]), channel c.
__global__ void __launch_bounds__(kThreads)
tv_bwd_kernel(const float4* __restrict__ tab, int64_t n,
              const float* __restrict__ g, float coef, float w_sigma,
              float w_rgb3, float4* __restrict__ grad) {
  const int64_t base = (int64_t)blockIdx.x * kThreads * kUnroll;
  float4 v[kUnroll];
  load_rows(tab, n, base, v);
  const float gc = __ldg(g) * coef;
  const float s0 = gc * w_sigma, s1 = gc * w_rgb3;
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int bit = 1; bit <= 4; bit <<= 1) {
      const float4 o = shfl_xor4(v[j], bit);
      d.x = d.x + (v[j].x - o.x);
      d.y = d.y + (v[j].y - o.y);
      d.z = d.z + (v[j].z - o.z);
      d.w = d.w + (v[j].w - o.w);
    }
    const int64_t e = base + (int64_t)j * kThreads + threadIdx.x;
    if (e < n) grad[e] = make_float4(s0 * d.x, s1 * d.y, s1 * d.z, s1 * d.w);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns cudaGetLastError(); nothing here synchronises. tab and grad: the
// 16-byte aligned [n, 4] tables, n = D^3 (a multiple of 8).

// out: one float on the device, the prior's value; part: the caller's
// [parts, 4] scratch, parts >= 1. tv_fwd_kernel runs on at most `parts`
// blocks, one partial a block.
extern "C" int vx_tv_fwd(const float* tab, int64_t n, float tv_sigma,
                         float tv_rgb, float* part, int parts, float* out,
                         cudaStream_t stream) {
  if (n < 8 || n % 8 || parts < 1) return (int)cudaErrorInvalidValue;
  const int64_t need = (n + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const int blocks = (int)(need < parts ? need : parts);
  tv_fwd_kernel<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(tab), n, reinterpret_cast<float4*>(part));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tv_fwd_finish_kernel<<<1, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(part), blocks, (float)(n / 2), tv_sigma,
      tv_rgb, out);
  return (int)cudaGetLastError();
}

// g: one float on the device, the upstream gradient; grad: [n, 4], every
// row written.
extern "C" int vx_tv_bwd(const float* tab, int64_t n, const float* g,
                         float tv_sigma, float tv_rgb, float* grad,
                         cudaStream_t stream) {
  if (n < 8 || n % 8) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  const float coef = 8.0f / (3.0f * (float)n);
  tv_bwd_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(tab), n, g, coef, tv_sigma,
      tv_rgb / 3.0f, reinterpret_cast<float4*>(grad));
  return (int)cudaGetLastError();
}
