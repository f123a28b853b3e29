// March-cost probe kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vxtpu's march-cost probes, nine
// pl.pallas_call sites in eight scripts under tools/:
//   probe_pallas2_cost.py (_kernel)   every tile runs exactly n_iters march
//                                     iterations, done or not, with stages
//                                     toggled: full, nofetch, nomath, empty;
//   probe_pallas2_fixed.py            the fixed read cost: a read from a
//                                     static window against one at a data-
//                                     dependent address (here: static);
//   probe_r5_fetch.py, probe_r5_fetch2.py, probe_r5_fetch3.py,
//   probe_r4_tune.py                  the same loop over other TPU
//                                     formulations of the table read (here:
//                                     the two table layouts of the port);
//   probe_r4_tile16.py                the same loop at two tile heights
//                                     (here: the block size of the launch);
//   probe_r4_matfetch.py (2 sites)    the exactness of a fetch of known
//                                     words (here: acc equals the plain
//                                     version bit for bit, and an identity
//                                     table gives the expected words).
//
// One thread per ray; the variant and the table layout are template
// parameters, the block size comes from the wrapper. The step is the TPU
// probe's abridged one (probe_pallas2_cost.py:73-133): from the clipped
// floor of o, the DDA or empty-box target of the current voxel and dist,
// the progress guard on x and y only (the probe has no z guard; kept, so
// that the port computes what the probe computes), no grid-exit or t_max
// test. The read is the exact word; the TPU probe's one-hot read equals it
// only when its window covers the table.
//
// What bounds it on this card: full and nomath chain n_iters dependent
// table reads per thread (latency); empty, nofetch and static are float
// and integer arithmetic per iteration (operations). The probe exists to
// split a march iteration's cost into loop, DDA math and table read, so
// its design is the march's: __ldg reads of a table resident in L2.
//
// Floating point: built with -fmad=false and without fast math, so acc is
// the plain version's bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr float kEps = 1e-4f;    // the target voxel is sampled at t + EPS
constexpr float kBig = 3.0e30f;  // 1/d where |d| < 1e-12

// variants (probe.py VARIANTS) and layouts (probe.py LAYOUTS)
constexpr int kEmpty = 0, kNofetch = 1, kNomath = 2, kFull = 3, kStatic = 4;
constexpr int kMorton16 = 0, kRowMajor32 = 1;

__device__ __forceinline__ int part1by2(int v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) < 1e-12f ? kBig : 1.0f / d;
}

__device__ __forceinline__ int floor_clip(float p, int n) {
  return (int)fminf(fmaxf(floorf(p), 0.0f), (float)(n - 1));
}

__device__ __forceinline__ bool child_bit(int cb, int vx, int vy, int vz) {
  const int ci = ((vx & 1) << 2) | ((vy & 1) << 1) | (vz & 1);
  return ((cb >> ci) & 1) != 0;
}

__device__ __forceinline__ float axis_t(int v, int dist, float o, float d,
                                        float iv) {
  const float vf = (float)v;
  const float cf = (float)(v >> 1);
  const float df = (float)dist;
  const bool big = dist > 0;
  const float lo = big ? 2.0f * cf - 2.0f * (df - 1.0f) : vf;
  const float hi = big ? 2.0f * cf + 2.0f * df : vf + 1.0f;
  const float t = ((d >= 0.0f ? hi : lo) - o) * iv;
  return fabsf(d) < 1e-12f ? kBig : t;
}

// index of coarse cell (cx, cy, cz): Morton order, or row-major over the
// coarse dims (Y/2, Z/2)
template <int kLayout>
__device__ __forceinline__ int cell_index(int cx, int cy, int cz, int Y,
                                          int Z) {
  if constexpr (kLayout == kMorton16) {
    return part1by2(cx) | (part1by2(cy) << 1) | (part1by2(cz) << 2);
  } else {
    return (cx * (Y / 2) + cy) * (Z / 2) + cz;
  }
}

// the word at idx; kVolatile keeps a read whose address does not change
// inside the loop (the static variant), which __ldg would let the compiler
// hoist out of it
template <int kLayout, bool kVolatile>
__device__ __forceinline__ int read_word(const void* table, int idx) {
  if constexpr (kLayout == kMorton16) {
    const int16_t* p = static_cast<const int16_t*>(table) + idx;
    if constexpr (kVolatile) {
      short v;
      asm volatile("ld.global.nc.s16 %0, [%1];" : "=h"(v) : "l"(p));
      return v;
    } else {
      return __ldg(p);
    }
  } else {
    const int32_t* p = static_cast<const int32_t*>(table) + idx;
    if constexpr (kVolatile) {
      int v;
      asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
      return v;
    } else {
      return __ldg(p);
    }
  }
}

// child bits and empty-box radius of a word: the signed Morton word
// (+child_bits or -D), or the row-major word child_bits | D << 8
template <int kLayout>
__device__ __forceinline__ void decode(int w, int& cb, int& dist) {
  if constexpr (kLayout == kMorton16) {
    cb = max(w, 0);
    dist = max(-w, 0);
  } else {
    cb = w & 255;
    dist = w >> 8;
  }
}

template <int kVariant, int kLayout>
__global__ void __launch_bounds__(kMaxThreads)
march_probe_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   int n, const void* __restrict__ table, int X, int Y, int Z,
                   int n_iters, float* __restrict__ acc_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ivx = inv_dir(dx), ivy = inv_dir(dy), ivz = inv_dir(dz);
  const int sgx = dx >= 0.0f ? 1 : -1;
  const int sgy = dy >= 0.0f ? 1 : -1;
  const int sgz = dz >= 0.0f ? 1 : -1;
  int vx = floor_clip(ox, X);
  int vy = floor_clip(oy, Y);
  int vz = floor_clip(oz, Z);
  int dist = 0;
  float acc = 0.0f;
  // static: one address per ray, the start voxel's cell, fixed before the
  // loop
  const int fixed =
      cell_index<kLayout>(vx >> 1, vy >> 1, vz >> 1, Y, Z);
  for (int it = 0; it < n_iters; ++it) {
    if constexpr (kVariant == kEmpty) {
      acc = acc + 1.0f;
      continue;
    }
    int nvx, nvy, nvz;
    if constexpr (kVariant == kNomath) {
      // naive step: the cheapest progress
      nvx = min(max(vx + sgx, 0), X - 1);
      nvy = min(max(vy + sgy, 0), Y - 1);
      nvz = min(max(vz + sgz, 0), Z - 1);
    } else {
      const float tx = axis_t(vx, dist, ox, dx, ivx);
      const float ty = axis_t(vy, dist, oy, dy, ivy);
      const float tz = axis_t(vz, dist, oz, dz, ivz);
      const float t_new = fminf(fminf(tx, ty), tz);
      const bool mx = (tx <= ty) && (tx <= tz);
      const bool my = !mx && (ty <= tz);
      nvx = floor_clip(ox + (t_new + kEps) * dx, X);
      nvy = floor_clip(oy + (t_new + kEps) * dy, Y);
      nvz = floor_clip(oz + (t_new + kEps) * dz, Z);
      if (nvx == vx && nvy == vy && nvz == vz) {
        // the probe's progress guard: x and y only
        if (mx) nvx = min(max(vx + sgx, 0), X - 1);
        if (my) nvy = min(max(vy + sgy, 0), Y - 1);
      }
    }
    if constexpr (kVariant == kNofetch) {
      acc = acc + (float)nvx * 1e-9f;
    } else {
      const int w =
          kVariant == kStatic
              ? read_word<kLayout, true>(table, fixed)
              : read_word<kLayout, false>(
                    table, cell_index<kLayout>(nvx >> 1, nvy >> 1, nvz >> 1,
                                               Y, Z));
      int ncb;
      decode<kLayout>(w, ncb, dist);
      acc = acc + (child_bit(ncb, nvx, nvy, nvz) ? 1.0f : 0.0f);
    }
    vx = nvx;
    vy = nvy;
    vz = nvz;
  }
  acc_out[i] = acc;
}

template <int kVariant>
int launch(int layout, int blocks, int threads, cudaStream_t stream,
           const float* o, const float* d, int n, const void* table, int X,
           int Y, int Z, int n_iters, float* acc) {
  if (layout == kMorton16) {
    march_probe_kernel<kVariant, kMorton16><<<blocks, threads, 0, stream>>>(
        o, d, n, table, X, Y, Z, n_iters, acc);
  } else if (layout == kRowMajor32) {
    march_probe_kernel<kVariant, kRowMajor32><<<blocks, threads, 0, stream>>>(
        o, d, n, table, X, Y, Z, n_iters, acc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes): launches the probe's
// (variant, layout) instantiation with `threads` threads a block on
// `stream` and returns cudaGetLastError(); nothing here synchronises.
extern "C" int vx_march_probe(const float* o, const float* d, int n,
                              const void* table, int X, int Y, int Z,
                              int n_iters, int variant, int layout,
                              int threads, float* acc, cudaStream_t stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n + threads - 1) / threads;
  switch (variant) {
    case kEmpty:
      return launch<kEmpty>(layout, blocks, threads, stream, o, d, n, table,
                            X, Y, Z, n_iters, acc);
    case kNofetch:
      return launch<kNofetch>(layout, blocks, threads, stream, o, d, n,
                              table, X, Y, Z, n_iters, acc);
    case kNomath:
      return launch<kNomath>(layout, blocks, threads, stream, o, d, n, table,
                             X, Y, Z, n_iters, acc);
    case kFull:
      return launch<kFull>(layout, blocks, threads, stream, o, d, n, table,
                           X, Y, Z, n_iters, acc);
    case kStatic:
      return launch<kStatic>(layout, blocks, threads, stream, o, d, n,
                             table, X, Y, Z, n_iters, acc);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
