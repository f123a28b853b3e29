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
//                                     the three table layouts of the port);
//   probe_r4_tile16.py                the same loop at two tile shapes
//                                     (here: the block size of the launch,
//                                     and the ray order the wrapper's
//                                     caller picks, render/probe.py
//                                     tile_order: the pixels a warp and a
//                                     block cover);
//   probe_r4_matfetch.py (2 sites)    the exactness of a fetch of known
//                                     words (here: acc equals the plain
//                                     version bit for bit, and an identity
//                                     table gives the expected words).
//
// One thread per ray; the variant, the table layout and the step are
// template parameters, the block size comes from the wrapper. Every ray
// runs the TPU probe's abridged step (probe_pallas2_cost.py:73-133) from
// the clipped floor of o: the DDA or empty-box target of the current voxel
// and dist, the progress guard on x and y only (the probe has no z guard;
// kept, so that the port computes what the probe computes), no grid-exit
// or t_max test. The read is the exact word; the TPU probe's one-hot read
// equals it only when its window covers the table.
//
// Two steps compute that iteration. kStepK1 is the step of the fused march
// as it is now (csrc/march.cu:march_ray), so that the probe's ns per
// ray-iteration stand for iterations K1 and K5 run:
//   * the faces the ray leaves by are integers (2c - 2(D-1), 2c + 2D, v,
//     v + 1), one an axis, formed as the voxel index with its low bit
//     masked in a box plus one of two offsets, and converted once;
//   * the voxel index is clamped in float and truncated once (no floor);
//   * the Morton index of a cell from a dilation table in shared memory,
//     max(X, Y, Z) ints filled once a block (entry v: part1by2(v >> 1)),
//     in place of three part1by2; the grid sizes are kernel parameters;
//   * full reads the table only when a coordinate changes above its
//     lowest bit (the word is a function of the cell, so acc is the same);
//     nomath and static read every iteration.
// kStepTpu is the TPU probe's float form as first ported, kept as the
// yardstick the step is measured against: each face rebuilt in float from
// v >> 1 and dist, floor then clamp, three part1by2 a Morton read, a read
// every iteration.
//
// What bounds it on this card: full and nomath chain dependent table
// reads per thread (latency); empty, nofetch and static are float and
// integer arithmetic per iteration (instruction issue). The tables are
// resident in L2 (32 MiB at 512^3 for the 16-bit layouts).
//
// Floating point: built with -fmad=false and without fast math, so acc is
// the plain version's bit for bit. The faces are exact integers however
// they are formed, and clamp-then-truncate gives floor-then-clamp's
// integer for every float but NaN, so both steps visit the same voxels.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr float kEps = 1e-4f;    // the target voxel is sampled at t + EPS
constexpr float kBig = 3.0e30f;  // 1/d where |d| < 1e-12

// variants (probe.py VARIANTS), layouts (probe.py LAYOUTS), steps
// (probe.py STEPS)
constexpr int kEmpty = 0, kNofetch = 1, kNomath = 2, kFull = 3, kStatic = 4;
constexpr int kMorton16 = 0, kRowMajor32 = 1, kBricked16 = 2;
constexpr int kStepK1 = 0, kStepTpu = 1;

// grid sizes, passed by value (kernel parameters live in constant memory)
struct Grid {
  int X, Y, Z;             // fine dims
  float fXm1, fYm1, fZm1;  // the largest voxel index on each axis
  int cyd, czd;            // row-major coarse dims on y and z
  int by, bz;              // bricks of the bricked layout on y and z
  int n_dil;               // entries of the dilation table: max(X, Y, Z)
};

__device__ __forceinline__ int part1by2(int v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

// whether an instantiation reads the Morton index from the dilation table
__host__ __device__ constexpr bool uses_dilation(int variant, int layout,
                                                 int step) {
  return step == kStepK1 && layout == kMorton16 && variant != kEmpty &&
         variant != kNofetch;
}

__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) < 1e-12f ? kBig : 1.0f / d;
}

__device__ __forceinline__ bool child_bit(int cb, int vx, int vy, int vz) {
  const int ci = ((vx & 1) << 2) | ((vy & 1) << 1) | (vz & 1);
  return ((cb >> ci) & 1) != 0;
}

// the cell of coarse cell (cx, cy, cz) in the bricked table (as
// march_packed.cu:cell_of): 4x4x4 coarse cells a brick, bricks row-major
// over the padded coarse dims
__device__ __forceinline__ int brick_cell(int cx, int cy, int cz,
                                          const Grid& g) {
  return ((((cx >> 2) * g.by + (cy >> 2)) * g.bz + (cz >> 2)) << 6) |
         ((cx & 3) << 4) | ((cy & 3) << 2) | (cz & 3);
}

// the word at idx; kVolatile keeps a read whose address does not change
// inside the loop (the static variant), which __ldg would let the compiler
// hoist out of it. The bricked words are uint16 (child_bits | D << 8).
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
  } else if constexpr (kLayout == kBricked16) {
    const uint16_t* p = static_cast<const uint16_t*>(table) + idx;
    if constexpr (kVolatile) {
      unsigned short v;
      asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(v) : "l"(p));
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
// (+child_bits or -D), or the row-major word child_bits | D << 8 (both
// row-major layouts)
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

// ---- kStepK1: K1's formulations ------------------------------------------

// clamp to [0, m] in float, then convert (truncating): floor(p) for a p in
// range, 0 or m outside it; floor-then-clamp's integer for every p but NaN
__device__ __forceinline__ int clip_floor(float p, float m) {
  return (int)fminf(fmaxf(p, 0.0f), m);
}

// t at which the ray reaches `face` (an integer) on one axis
__device__ __forceinline__ float face_t(int face, float o, float d,
                                        float iv) {
  const float t = ((float)face - o) * iv;
  return fabsf(d) < 1e-12f ? kBig : t;
}

// the cell index of fine voxel (vx, vy, vz): Morton from the dilation
// table, row-major over the coarse dims, or bricked
template <int kLayout>
__device__ __forceinline__ int voxel_cell(const int* dil, int vx, int vy,
                                          int vz, const Grid& g) {
  if constexpr (kLayout == kMorton16) {
    return dil[vx] | (dil[vy] << 1) | (dil[vz] << 2);
  } else if constexpr (kLayout == kRowMajor32) {
    return ((vx >> 1) * g.cyd + (vy >> 1)) * g.czd + (vz >> 1);
  } else {
    return brick_cell(vx >> 1, vy >> 1, vz >> 1, g);
  }
}

template <int kVariant, int kLayout>
__device__ __forceinline__ float probe_k1(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          const void* table, const int* dil,
                                          const Grid& g, int n_iters) {
  const float ivx = inv_dir(dx), ivy = inv_dir(dy), ivz = inv_dir(dz);
  const int sgx = dx >= 0.0f ? 1 : -1;
  const int sgy = dy >= 0.0f ? 1 : -1;
  const int sgz = dz >= 0.0f ? 1 : -1;
  int vx = clip_floor(ox, g.fXm1);
  int vy = clip_floor(oy, g.fYm1);
  int vz = clip_floor(oz, g.fZm1);
  int dist = 0, cb = 0;
  float acc = 0.0f;
  // static: one address per ray, the start voxel's cell
  int fixed = 0;
  if constexpr (kVariant == kStatic)
    fixed = voxel_cell<kLayout>(dil, vx, vy, vz, g);
  bool fresh = true;  // full: no word in registers yet
  for (int it = 0; it < n_iters; ++it) {
    if constexpr (kVariant == kEmpty) {
      acc = acc + 1.0f;
      continue;
    }
    int nvx, nvy, nvz;
    if constexpr (kVariant == kNomath) {
      // naive step: the cheapest progress
      nvx = min(max(vx + sgx, 0), g.X - 1);
      nvy = min(max(vy + sgy, 0), g.Y - 1);
      nvz = min(max(vz + sgz, 0), g.Z - 1);
    } else {
      // the faces the ray leaves by: of the empty box [2c - 2(dist-1),
      // 2c + 2 dist) where dist > 0, else of the voxel [v, v + 1); one an
      // axis, an exact integer
      const int base = ~min(dist, 1);
      const int hi = max(2 * dist, 1);
      const int lo = min(2 - 2 * dist, 0);
      const float tx = face_t((vx & base) + (dx >= 0.0f ? hi : lo), ox, dx,
                              ivx);
      const float ty = face_t((vy & base) + (dy >= 0.0f ? hi : lo), oy, dy,
                              ivy);
      const float tz = face_t((vz & base) + (dz >= 0.0f ? hi : lo), oz, dz,
                              ivz);
      const float t_new = fminf(fminf(tx, ty), tz);
      const bool mx = (tx <= ty) && (tx <= tz);
      const bool my = !mx && (ty <= tz);
      nvx = clip_floor(ox + (t_new + kEps) * dx, g.fXm1);
      nvy = clip_floor(oy + (t_new + kEps) * dy, g.fYm1);
      nvz = clip_floor(oz + (t_new + kEps) * dz, g.fZm1);
      if (nvx == vx && nvy == vy && nvz == vz) {
        // the probe's progress guard: x and y only
        if (mx) nvx = min(max(vx + sgx, 0), g.X - 1);
        if (my) nvy = min(max(vy + sgy, 0), g.Y - 1);
      }
    }
    if constexpr (kVariant == kNofetch) {
      acc = acc + (float)nvx * 1e-9f;
    } else {
      if constexpr (kVariant == kFull) {
        // the word is a function of the cell: read it only when a
        // coordinate changes above its lowest bit
        if (fresh || (((nvx ^ vx) | (nvy ^ vy) | (nvz ^ vz)) > 1)) {
          decode<kLayout>(read_word<kLayout, false>(
                              table, voxel_cell<kLayout>(dil, nvx, nvy, nvz,
                                                         g)),
                          cb, dist);
          fresh = false;
        }
      } else if constexpr (kVariant == kStatic) {
        decode<kLayout>(read_word<kLayout, true>(table, fixed), cb, dist);
      } else {
        decode<kLayout>(read_word<kLayout, false>(
                            table, voxel_cell<kLayout>(dil, nvx, nvy, nvz,
                                                       g)),
                        cb, dist);
      }
      acc = acc + (child_bit(cb, nvx, nvy, nvz) ? 1.0f : 0.0f);
    }
    vx = nvx;
    vy = nvy;
    vz = nvz;
  }
  return acc;
}

// ---- kStepTpu: the TPU probe's float form ---------------------------------

__device__ __forceinline__ int floor_clip(float p, int n) {
  return (int)fminf(fmaxf(floorf(p), 0.0f), (float)(n - 1));
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

// index of coarse cell (cx, cy, cz): Morton order, row-major over the
// coarse dims (Y/2, Z/2), or bricked
template <int kLayout>
__device__ __forceinline__ int cell_index(int cx, int cy, int cz,
                                          const Grid& g) {
  if constexpr (kLayout == kMorton16) {
    return part1by2(cx) | (part1by2(cy) << 1) | (part1by2(cz) << 2);
  } else if constexpr (kLayout == kRowMajor32) {
    return (cx * (g.Y / 2) + cy) * (g.Z / 2) + cz;
  } else {
    return brick_cell(cx, cy, cz, g);
  }
}

template <int kVariant, int kLayout>
__device__ __forceinline__ float probe_tpu(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           const void* table, const Grid& g,
                                           int n_iters) {
  const int X = g.X, Y = g.Y, Z = g.Z;
  const float ivx = inv_dir(dx), ivy = inv_dir(dy), ivz = inv_dir(dz);
  const int sgx = dx >= 0.0f ? 1 : -1;
  const int sgy = dy >= 0.0f ? 1 : -1;
  const int sgz = dz >= 0.0f ? 1 : -1;
  int vx = floor_clip(ox, X);
  int vy = floor_clip(oy, Y);
  int vz = floor_clip(oz, Z);
  int dist = 0;
  float acc = 0.0f;
  const int fixed = cell_index<kLayout>(vx >> 1, vy >> 1, vz >> 1, g);
  for (int it = 0; it < n_iters; ++it) {
    if constexpr (kVariant == kEmpty) {
      acc = acc + 1.0f;
      continue;
    }
    int nvx, nvy, nvz;
    if constexpr (kVariant == kNomath) {
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
                                               g));
      int ncb;
      decode<kLayout>(w, ncb, dist);
      acc = acc + (child_bit(ncb, nvx, nvy, nvz) ? 1.0f : 0.0f);
    }
    vx = nvx;
    vy = nvy;
    vz = nvz;
  }
  return acc;
}

template <int kVariant, int kLayout, int kStep>
__global__ void __launch_bounds__(kMaxThreads)
march_probe_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   int n, const void* __restrict__ table, const Grid g,
                   int n_iters, float* __restrict__ acc_out) {
  // the block's dilation table: entry v is part1by2(v >> 1), filled by
  // every thread of the block before any returns
  extern __shared__ int dil[];
  if constexpr (uses_dilation(kVariant, kLayout, kStep)) {
    for (int v = threadIdx.x; v < g.n_dil; v += blockDim.x)
      dil[v] = part1by2(v >> 1);
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  if constexpr (kStep == kStepK1) {
    acc_out[i] = probe_k1<kVariant, kLayout>(ox, oy, oz, dx, dy, dz, table,
                                             dil, g, n_iters);
  } else {
    acc_out[i] = probe_tpu<kVariant, kLayout>(ox, oy, oz, dx, dy, dz, table,
                                              g, n_iters);
  }
}

template <int kLayout, int kStep>
const void* by_variant(int variant) {
  switch (variant) {
    case kEmpty:
      return (const void*)march_probe_kernel<kEmpty, kLayout, kStep>;
    case kNofetch:
      return (const void*)march_probe_kernel<kNofetch, kLayout, kStep>;
    case kNomath:
      return (const void*)march_probe_kernel<kNomath, kLayout, kStep>;
    case kFull:
      return (const void*)march_probe_kernel<kFull, kLayout, kStep>;
    case kStatic:
      return (const void*)march_probe_kernel<kStatic, kLayout, kStep>;
    default:
      return nullptr;
  }
}

template <int kStep>
const void* by_layout(int variant, int layout) {
  switch (layout) {
    case kMorton16:
      return by_variant<kMorton16, kStep>(variant);
    case kRowMajor32:
      return by_variant<kRowMajor32, kStep>(variant);
    case kBricked16:
      return by_variant<kBricked16, kStep>(variant);
    default:
      return nullptr;
  }
}

// the (variant, layout, step) instantiation, or null
const void* probe_instance(int variant, int layout, int step) {
  switch (step) {
    case kStepK1:
      return by_layout<kStepK1>(variant, layout);
    case kStepTpu:
      return by_layout<kStepTpu>(variant, layout);
    default:
      return nullptr;
  }
}

int max3(int a, int b, int c) {
  const int m = a > b ? a : b;
  return m > c ? m : c;
}

int dilation_bytes(int variant, int layout, int step, int X, int Y, int Z) {
  return uses_dilation(variant, layout, step)
             ? (int)sizeof(int) * max3(X, Y, Z)
             : 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes): launches the probe's (variant,
// layout, step) instantiation with `threads` threads a block on `stream`
// and returns the launch's error code; nothing here synchronises.
extern "C" int vx_march_probe(const float* o, const float* d, int n,
                              const void* table, int X, int Y, int Z,
                              int n_iters, int variant, int layout, int step,
                              int threads, float* acc, cudaStream_t stream) {
  const void* fn = probe_instance(variant, layout, step);
  if (fn == nullptr || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Grid g;
  g.X = X;
  g.Y = Y;
  g.Z = Z;
  g.fXm1 = (float)(X - 1);
  g.fYm1 = (float)(Y - 1);
  g.fZm1 = (float)(Z - 1);
  g.cyd = Y / 2;
  g.czd = Z / 2;
  g.by = (Y / 2 + 3) / 4;
  g.bz = (Z / 2 + 3) / 4;
  g.n_dil = max3(X, Y, Z);
  void* args[] = {&o, &d, &n, &table, &g, &n_iters, &acc};
  const cudaError_t e = cudaLaunchKernel(
      fn, dim3((n + threads - 1) / threads), dim3(threads), args,
      dilation_bytes(variant, layout, step, X, Y, Z), stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// Blocks of `threads` threads of the (variant, layout, step) instantiation
// an SM holds at once for an X x Y x Z grid (its occupancy, for the
// record); 0 for an unknown instantiation or a failed query.
extern "C" int vx_march_probe_blocks_per_sm(int variant, int layout,
                                            int step, int threads, int X,
                                            int Y, int Z) {
  const void* fn = probe_instance(variant, layout, step);
  int blocks = 0;
  if (fn == nullptr ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fn, threads,
          dilation_bytes(variant, layout, step, X, Y, Z)) != cudaSuccess)
    return 0;
  return blocks;
}
