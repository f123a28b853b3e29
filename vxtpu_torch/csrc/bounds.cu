// The masked fit's bounds pass for Hopper (sm_90a): each ray's occupied
// band [t0, t1] over the occupancy mask, both distance-field marches of
// one ray in one thread.
//
// Replaces no Pallas kernel: the JAX package's bounds pass
// (vxtpu/render/occmask.py:mask_segment_bounds) is two batched marches
// (vxtpu/render/kernel_xla.py:march_xla_df) of plain jnp in a while loop.
// In eager PyTorch the same batched path (render/occmask.py:
// mask_segment_bounds_batched, the plain version, which defines the
// function) steps every ray in lock-step with ~60 small tensor ops a step,
// replayed from a CUDA graph, and asks the host every 32 steps whether
// all rays are done: up to 2 x 416 graph replays and 26 host
// synchronisations for the c4 fit's 65,536 rays over its 128^3 mask, each
// op a launch of 1-3 us of work. This kernel runs the whole pass in one
// launch and never reads a value back to the host.
//
// The function (the plain version defines it). With om = o / G (G the
// mask scale) and the mask grid [0, X] x [0, Y] x [0, Z]:
//   (t_enter, t_exit, valid) = the slab clip of (om, d) to the grid;
//   fwd  = the distance-field march of (om, d): the first occupied cell;
//   o_b  = om + (t_exit + 1) d;
//   bwd  = the distance-field march of (o_b, -d): the last occupied cell;
//   hit  = fwd.hit & bwd.hit & valid;
//   t0   = G (hit ? fwd.t : 0);  t1 = max(G (hit ? (t_exit + 1) - bwd.t : 0), t0).
// A march (kernel_xla.march_xla_df) starts at the clipped entry voxel and
// takes either one DDA step (the axis of the smallest t_next; the first of
// tied minima) or, where the field says the voxel's distance dist > 1, a
// jump to the exit of the box [v - (dist - 1), v + dist], re-initialising
// the DDA there (unless rounding leaves it in the same voxel); it stops at
// a voxel whose field value is 0 (a hit), outside the grid or past t_exit.
// Each march runs at most `cap` steps: ceil(max_steps / 32) * 32, as far as
// the batched path's chunks of 32 steps let a ray run.
//
// Floating point: every operation is the batched path's, in its order, in
// float32, rounded after each operation (built with -fmad=false, as the
// plain version's tensor ops each round their one operation): the same
// bits as the batched path on the card. Two details follow torch's CUDA
// kernels: o / G is o times the float reciprocal of G (torch's CUDA
// division by a host scalar multiplies by its reciprocal; for a power of
// two the same as the division), and min/max are fminf/fmaxf (torch's
// minimum, maximum and clamp), the slab clip's reductions over the axes
// `a > b ? a : b` (amax's, amin's with <).
//
// What bounds it on this card: latency, not bytes. The bytes are the rays
// in, the bounds out and the field once (4.2 MB for the c4 pass: ~1.3 us
// at 3.35 TB/s); a step is ~40 float operations and one dependent 1-byte
// read of a field that sits in the 50 MB L2, and a warp runs as long as
// its longest ray. What the design does about it:
//   * one thread a ray, consecutive rays (a row of pixels) in one warp, so
//     a warp's lanes march alike and diverge little;
//   * small blocks (64 threads), so the 1,024 blocks of the c4 pass spread
//     over the 132 SMs with the fewest left over, and no shared memory and
//     no atomics;
//   * the state stays in registers; the field is read through the
//     read-only path (__ldg); each march computes the jump only where the
//     field allows one, and nothing of the hit record the bounds do not
//     need (normals, step counts, the final voxel).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
// dda.py's and kernel_xla.py's constants, as float32
constexpr float kEpsDir = 1e-12f;    // EPS_DIR: a direction component below is 0
constexpr float kBig = 1e30f;        // BIG: safe_inverse's clamp
constexpr float kEntryEps = 1e-4f;   // ENTRY_EPS: nudge past the entry plane
constexpr float kNever = 3.0e30f;    // NEVER: t_next of an axis never crossed
constexpr float kBigT = 1e30f;       // BIG_T: no t_max, no hit

struct Grid {
  const uint8_t* __restrict__ df;  // the flat distance field, row-major
  int dims[3];
};

// dda.safe_inverse
__device__ __forceinline__ float safe_inverse(float d) {
  const float sign = d >= 0.0f ? 1.0f : -1.0f;
  const float mag = fmaxf(fabsf(d), kEpsDir);
  return fminf(fmaxf(sign / mag, -kBig), kBig);
}

// world/distfield.distfield_fetch: out-of-bounds reads give 255
__device__ __forceinline__ int fetch(const Grid& g, const int v[3]) {
  if (v[0] < 0 || v[1] < 0 || v[2] < 0 || v[0] >= g.dims[0] ||
      v[1] >= g.dims[1] || v[2] >= g.dims[2])
    return 255;
  const int64_t idx =
      ((int64_t)v[0] * g.dims[1] + v[1]) * g.dims[2] + v[2];
  return __ldg(g.df + idx);
}

// dda.ray_grid_clip: (t_enter, t_exit), valid = t_enter <= t_exit
__device__ __forceinline__ void grid_clip(const float o[3], const float d[3],
                                          const float inv[3], const int dims[3],
                                          float& t_enter, float& t_exit) {
  float tn[3], tf[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (0.0f - o[a]) * inv[a];
    const float t1 = ((float)dims[a] - o[a]) * inv[a];
    tn[a] = fminf(t0, t1);
    tf[a] = fmaxf(t0, t1);
  }
  float near = tn[0], far = tf[0];
#pragma unroll
  for (int a = 1; a < 3; ++a) {
    near = near > tn[a] ? near : tn[a];
    far = far < tf[a] ? far : tf[a];
  }
  t_enter = fmaxf(near, 0.0f);  // relu_like_jax: maximum(x, 0)
  t_exit = far;
}

// dda.dda_init at t_start: the voxel and t_next (t_delta and the step
// signs depend on d alone and are the caller's)
__device__ __forceinline__ void dda_init(const float o[3], const float d[3],
                                         const float inv[3], const int dims[3],
                                         float t_start, int v[3],
                                         float t_next[3]) {
  const float ts = t_start + kEntryEps;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p = o[a] + ts * d[a];
    const float c = fminf(fmaxf(floorf(p), 0.0f), (float)(dims[a] - 1));
    v[a] = (int)c;
    const float vf = (float)v[a];
    const float tn = ((d[a] >= 0.0f ? vf + 1.0f : vf) - o[a]) * inv[a];
    t_next[a] = fabsf(d[a]) < kEpsDir ? kNever : tn;
  }
}

// kernel_xla.march_xla_df of one ray with no t_max, its clip given:
// whether it hits, and where (t_hit).
__device__ __forceinline__ void march_df(const Grid& g, const float o[3],
                                         const float d[3], float t_enter,
                                         float t_exit, int cap, bool& hit,
                                         float& t_hit) {
  float inv[3], t_delta[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    inv[a] = safe_inverse(d[a]);
    t_delta[a] = fabsf(inv[a]);
  }
  const bool valid = t_enter <= t_exit;
  const float t_end = fminf(t_exit, kBigT);
  int v[3];
  float t_next[3];
  dda_init(o, d, inv, g.dims, t_enter, v, t_next);
  int dist = fetch(g, v);
  hit = valid && dist == 0 && t_enter <= kBigT;
  t_hit = hit ? t_enter : kBigT;
  if (hit || !valid) return;
#pragma unroll 1
  for (int it = 0; it < cap; ++it) {
    // dda_advance: the axis of the smallest t_next, the first of ties
    // (every index below is a constant once unrolled: the state stays in
    // registers, none of it in local memory)
    int ax = 0;
    float t_cross = t_next[0];
    if (t_next[1] < t_cross) {
      ax = 1;
      t_cross = t_next[1];
    }
    if (t_next[2] < t_cross) {
      ax = 2;
      t_cross = t_next[2];
    }
    int vn[3];
    float tnn[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      vn[a] = v[a] + (a == ax ? (d[a] >= 0.0f ? 1 : -1) : 0);
      tnn[a] = t_next[a] + (a == ax ? t_delta[a] : 0.0f);
    }
    if (dist > 1) {
      // every voxel within L_inf distance dist - 1 of v is empty: jump to
      // the exit of the box [v - (dist - 1), v + dist]
      const float r = (float)(dist - 1);
      float t_jump = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float vf = (float)v[a];
        const float bound = d[a] >= 0.0f ? (vf + r) + 1.0f : vf - r;
        const float t_ax = fabsf(d[a]) < kEpsDir ? kNever
                                                 : (bound - o[a]) * inv[a];
        t_jump = a == 0 ? t_ax : (t_jump < t_ax ? t_jump : t_ax);
      }
      int vj[3];
      float tnj[3];
      dda_init(o, d, inv, g.dims, t_jump, vj, tnj);
      if (vj[0] != v[0] || vj[1] != v[1] || vj[2] != v[2]) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          vn[a] = vj[a];
          tnn[a] = tnj[a];
        }
        t_cross = t_jump;
      }
    }
    // _finish
    const int dfv = fetch(g, vn);
    const bool inside = vn[0] >= 0 && vn[1] >= 0 && vn[2] >= 0 &&
                        vn[0] < g.dims[0] && vn[1] < g.dims[1] &&
                        vn[2] < g.dims[2];
    const bool past_end = t_cross > t_end;
    if (inside && !past_end && dfv == 0) {
      hit = true;
      t_hit = t_cross;
      return;
    }
    if (!inside || past_end) return;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = vn[a];
      t_next[a] = tnn[a];
    }
    dist = dfv;
  }
}

__global__ void __launch_bounds__(kThreads)
mask_bounds_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   int64_t n, Grid g, float scale, int cap,
                   float* __restrict__ t0_out, float* __restrict__ t1_out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float inv_scale = 1.0f / scale;
  float om[3], dd[3], nd[3], inv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    om[a] = o[3 * i + a] * inv_scale;
    dd[a] = d[3 * i + a];
    nd[a] = -dd[a];
    inv[a] = safe_inverse(dd[a]);
  }
  float t_enter, t_exit;
  grid_clip(om, dd, inv, g.dims, t_enter, t_exit);
  const bool valid = t_enter <= t_exit;
  bool fwd_hit, bwd_hit;
  float fwd_t, bwd_t;
  march_df(g, om, dd, t_enter, t_exit, cap, fwd_hit, fwd_t);
  const float te1 = t_exit + 1.0f;
  float ob[3], ninv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ob[a] = om[a] + te1 * dd[a];
    ninv[a] = safe_inverse(nd[a]);
  }
  float b_enter, b_exit;
  grid_clip(ob, nd, ninv, g.dims, b_enter, b_exit);
  march_df(g, ob, nd, b_enter, b_exit, cap, bwd_hit, bwd_t);
  const bool hit = fwd_hit && bwd_hit && valid;
  const float t0 = (hit ? fwd_t : 0.0f) * scale;
  t0_out[i] = t0;
  t1_out[i] = fmaxf((hit ? te1 - bwd_t : 0.0f) * scale, t0);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError(); nothing here synchronises. o, d: n rays,
// [n, 3] float32 (world units); df: the mask's flat uint8 distance field
// [X * Y * Z], row-major; scale: the mask scale G; cap: the steps a march
// may take; t0, t1: [n] float32, written.
extern "C" int vx_mask_bounds(const float* o, const float* d, int64_t n,
                              const uint8_t* df, int X, int Y, int Z,
                              float scale, int cap, float* t0, float* t1,
                              cudaStream_t stream) {
  if (n < 0 || X < 1 || Y < 1 || Z < 1 || cap < 0 || !(scale > 0.0f))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  const Grid g{df, {X, Y, Z}};
  mask_bounds_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      o, d, n, g, scale, cap, t0, t1);
  return (int)cudaGetLastError();
}
