// Trilinear field-sampling kernels for Hopper (sm_90a): the gather and
// scatter pair under the differentiable soft renderer.
//
// Replaces the Pallas TPU kernels of vxtpu/render/kernel_sample.py:
//   sample_fwd_kernel  <- _sample_fwd_kernel (via sample_fields_fwd): for
//                         ray n and sample s, p = o + (t0 + dt (s + 1/2)) d,
//                         then trilinear samples of four fine-Morton f32
//                         fields (sigma, r, g, b) and, lit, the spatial
//                         gradient of sigma -> [S, N] planes;
//   sample_bwd_kernel  <- _sample_bwd_kernel (via sample_fields_bwd): the
//                         same samples again, the cotangents times the
//                         corner weights scatter-added into the gradient
//                         of the table and, with kRayGrads, the per-ray
//                         cotangents of o, d, t0 and dt summed over the
//                         samples;
//   sample_ray_sum_kernel  the second pass of those per-ray sums.
// None of the TPU machinery carries over: no Morton row windows, no bf16
// one-hot fetch, no pending-corner loop, no VMEM gradient window.
//
// The table: one channel-interleaved [D^3, 4] float32 array in fine-voxel
// Morton order, row m = (sigma, r, g, b) of the voxel whose Morton code is
// m. It is the trainer's parameter itself, and its gradient has the same
// shape, so neither kernel re-lays anything out.
//
// What bounds them on this card: bytes, and how many 32-byte sectors a
// sample's 2x2x2 stencil spans. A stencil in Morton order touches ~3.4
// aligned 8-word blocks on average; at the c4 shape neighbouring rays are
// ~3 voxels apart and successive samples 2-3.5, so warps share almost no
// sector, and the dense tables (2.1 GB at 512^3) mostly miss the 50 MB
// L2. In four planar tables a sample read (or added) 32 scalar words over
// ~13.5 sectors; in the interleaved table it is 8 float4 words over ~6
// sectors, two voxels' four channels to a sector. The backward must also
// write the dense gradient: 0.72 ms of traffic at the c4 shape, against
// 268 MB of cotangents.
// What the design does about it:
//   * the forward runs one thread per (s, n) with output index s*N + n,
//     so a warp's stores are contiguous; it reads its 8 corner rows as
//     float4 through the read-only path (__ldg) and runs the four lerp
//     ladders (and, lit, sigma's gradient ladder) from registers;
//   * the backward is two compile-time variants of one kernel. The main
//     path's rays carry no gradient (kRayGrads = false): a pure scatter,
//     one thread per (s, n) as in the forward (16.7 M threads at the c4
//     shape, not 65,536), that reads its cotangents coalesced, reads no
//     table word and computes no ray cotangent. With kRayGrads (camera
//     optimisation) a thread takes one ray and a chunk of kChunk samples,
//     scatters them, reads their corner rows as float4, sums its 8 ray
//     terms over the chunk and writes them to a [chunks, 8, N] scratch;
//     sample_ray_sum_kernel adds the chunks in chunk order, so the ray
//     cotangents are deterministic and equal the plain version (which
//     sums in the same order) bit for bit;
//   * the scatter adds one float4 atomicAdd (a vector RED, global memory,
//     sm_90) per corner straight into the zeroed [D^3, 4] gradient that
//     becomes the parameter's: 8 a sample over ~6 sectors. At the c4
//     shape the planar scatter (32 scalar atomics a sample) took 11.9 ms,
//     this one 2.9 ms;
//   * where lanes of a warp hit the same word (rays from one point, as an
//     inside camera's first samples), they sum first and one atomic adds
//     the run (scatter_corner): without it the float32 rounding of
//     thousands of atomics on one word exceeds the gradient's tolerance.
//     A warp whose words are all distinct, nearly every warp at the c4
//     shape, skips that scan after one vote.
//
// Floating point: built with -fmad=false, and every expression follows
// vxtpu's _corner_setup / _lerp_ladder / _grad_ladder / _value_f_grads /
// _grad_f_grads operation by operation, so the plain PyTorch versions in
// render/kernel_sample.py round the same way. The float atomicAdd order
// of the scatter changes from run to run: the gradient agrees with the
// plain version (which sums it in float64) and with another run to
// rounding, not bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int part1by2(int v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

// The 8-corner stencil at p: corner k = ex*4 + ey*2 + ez (c000..c111),
// its Morton word index, and the fractions f = q - floor(q), q = p - 1/2.
// i1 = clamp(clamp(floor q) + 1): in the half-voxel shell next to a low
// face the sample mixes voxels 0 and 1 with f in [0.5, 1), as vxtpu does.
struct Stencil {
  int code[8];
  float fx, fy, fz;
};

__device__ __forceinline__ Stencil corner_setup(float px, float py, float pz,
                                                int D) {
  Stencil st;
  const float qx = px - 0.5f, qy = py - 0.5f, qz = pz - 0.5f;
  const float q0x = floorf(qx), q0y = floorf(qy), q0z = floorf(qz);
  st.fx = qx - q0x;
  st.fy = qy - q0y;
  st.fz = qz - q0z;
  const float hi = (float)(D - 1);
  // clamp in float before converting, as the plain version does
  const int i0x = (int)fminf(fmaxf(q0x, 0.0f), hi);
  const int i0y = (int)fminf(fmaxf(q0y, 0.0f), hi);
  const int i0z = (int)fminf(fmaxf(q0z, 0.0f), hi);
  const int sx[2] = {part1by2(i0x), part1by2(min(i0x + 1, D - 1))};
  const int sy[2] = {part1by2(i0y), part1by2(min(i0y + 1, D - 1))};
  const int sz[2] = {part1by2(i0z), part1by2(min(i0z + 1, D - 1))};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    st.code[k] = sx[(k >> 2) & 1] | (sy[(k >> 1) & 1] << 1) |
                 (sz[k & 1] << 2);
  return st;
}

// trilinear value: combine z, then y, then x
__device__ __forceinline__ float lerp_ladder(const float* v, float fx,
                                             float fy, float fz) {
  const float c00 = v[0] * (1.0f - fz) + v[1] * fz;
  const float c01 = v[2] * (1.0f - fz) + v[3] * fz;
  const float c10 = v[4] * (1.0f - fz) + v[5] * fz;
  const float c11 = v[6] * (1.0f - fz) + v[7] * fz;
  const float c0 = c00 * (1.0f - fy) + c01 * fy;
  const float c1 = c10 * (1.0f - fy) + c11 * fy;
  return c0 * (1.0f - fx) + c1 * fx;
}

// analytic spatial gradient of the trilinear basis
__device__ __forceinline__ void grad_ladder(const float* v, float fx, float fy,
                                            float fz, float* gx, float* gy,
                                            float* gz) {
  *gx = ((v[4] - v[0]) * (1.0f - fy) + (v[6] - v[2]) * fy) * (1.0f - fz) +
        ((v[5] - v[1]) * (1.0f - fy) + (v[7] - v[3]) * fy) * fz;
  *gy = ((v[2] - v[0]) * (1.0f - fx) + (v[6] - v[4]) * fx) * (1.0f - fz) +
        ((v[3] - v[1]) * (1.0f - fx) + (v[7] - v[5]) * fx) * fz;
  *gz = ((v[1] - v[0]) * (1.0f - fx) + (v[5] - v[4]) * fx) * (1.0f - fy) +
        ((v[3] - v[2]) * (1.0f - fx) + (v[7] - v[6]) * fx) * fy;
}

// d(trilinear value)/d(fx, fy, fz)
__device__ __forceinline__ void value_f_grads(const float* v, float fx,
                                              float fy, float fz, float* dfx,
                                              float* dfy, float* dfz) {
  const float c00 = v[0] * (1.0f - fz) + v[1] * fz;
  const float c01 = v[2] * (1.0f - fz) + v[3] * fz;
  const float c10 = v[4] * (1.0f - fz) + v[5] * fz;
  const float c11 = v[6] * (1.0f - fz) + v[7] * fz;
  const float c0 = c00 * (1.0f - fy) + c01 * fy;
  const float c1 = c10 * (1.0f - fy) + c11 * fy;
  *dfx = c1 - c0;
  *dfy = (c01 - c00) * (1.0f - fx) + (c11 - c10) * fx;
  *dfz = ((v[1] - v[0]) * (1.0f - fy) + (v[3] - v[2]) * fy) * (1.0f - fx) +
         ((v[5] - v[4]) * (1.0f - fy) + (v[7] - v[6]) * fy) * fx;
}

// cotangents of the gradient channels chained to (fx, fy, fz): the
// adjoint of grad_ladder with respect to f
__device__ __forceinline__ void grad_f_grads(const float* v, float fx,
                                             float fy, float fz, float ggx,
                                             float ggy, float ggz, float* gfx,
                                             float* gfy, float* gfz) {
  const float c000 = v[0], c001 = v[1], c010 = v[2], c011 = v[3];
  const float c100 = v[4], c101 = v[5], c110 = v[6], c111 = v[7];
  const float dgx_dfy = ((c110 - c010) - (c100 - c000)) * (1.0f - fz) +
                        ((c111 - c011) - (c101 - c001)) * fz;
  const float dgx_dfz =
      ((c101 - c001) * (1.0f - fy) + (c111 - c011) * fy) -
      ((c100 - c000) * (1.0f - fy) + (c110 - c010) * fy);
  const float dgy_dfx = ((c110 - c100) - (c010 - c000)) * (1.0f - fz) +
                        ((c111 - c101) - (c011 - c001)) * fz;
  const float dgy_dfz =
      ((c011 - c001) * (1.0f - fx) + (c111 - c101) * fx) -
      ((c010 - c000) * (1.0f - fx) + (c110 - c100) * fx);
  const float dgz_dfx = ((c101 - c100) - (c001 - c000)) * (1.0f - fy) +
                        ((c111 - c110) - (c011 - c010)) * fy;
  const float dgz_dfy =
      ((c011 - c010) * (1.0f - fx) + (c111 - c110) * fx) -
      ((c001 - c000) * (1.0f - fx) + (c101 - c100) * fx);
  *gfx = ggy * dgy_dfx + ggz * dgz_dfx;
  *gfy = ggx * dgx_dfy + ggz * dgz_dfy;
  *gfz = ggx * dgx_dfz + ggy * dgy_dfz;
}

// The cotangent of table c at corner k of one sample: gv[c] times the
// corner weight, and for sigma (lit) the gradient channels' cotangents
// gv[4..6] through d(w_k)/d(f).
template <bool kLit>
__device__ __forceinline__ void corner_cotangents(const Stencil& st,
                                                  const float* gv,
                                                  float g[4][8]) {
  const float wx[2] = {1.0f - st.fx, st.fx};
  const float wy[2] = {1.0f - st.fy, st.fy};
  const float wz[2] = {1.0f - st.fz, st.fz};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ex = (k >> 2) & 1, ey = (k >> 1) & 1, ez = k & 1;
    const float w = wx[ex] * wy[ey] * wz[ez];
#pragma unroll
    for (int c = 0; c < 4; ++c) g[c][k] = gv[c] * w;
    if constexpr (kLit) {
      const float dsx = (ex ? 1.0f : -1.0f) * wy[ey] * wz[ez];
      const float dsy = wx[ex] * (ey ? 1.0f : -1.0f) * wz[ez];
      const float dsz = wx[ex] * wy[ey] * (ez ? 1.0f : -1.0f);
      g[0][k] = g[0][k] + gv[4] * dsx + gv[5] * dsy + gv[6] * dsz;
    }
  }
}

// Sum of v over this lane's run of equal keys, lanes [start, lane]
// (a segmented Hillis-Steele scan: the run's last lane gets the run's
// sum). Every lane of the warp must call it.
__device__ __forceinline__ float run_sum(float v, int lane, int start) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane - off >= start) v = v + o;
  }
  return v;
}

// The warp's run structure for this lane's word `key` (-1: none): whether
// any lane shares its word with the lane before it, this lane's run start
// and whether it ends a run. Every lane of the warp must call it.
struct Runs {
  bool shared, tail;
  int start;
};

__device__ __forceinline__ Runs warp_runs(int key, int lane) {
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  const int next = __shfl_down_sync(0xffffffffu, key, 1);
  Runs r;
  r.shared = __any_sync(0xffffffffu, lane > 0 && key >= 0 && prev == key);
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || prev != key);
  r.start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
  r.tail = lane == 31 || next != key;
  return r;
}

// channel c (0..3: sigma, r, g, b) of a table row
__device__ __forceinline__ float channel(const float4& w, int c) {
  return c == 0 ? w.x : c == 1 ? w.y : c == 2 ? w.z : w.w;
}

// the 8 corner rows of a stencil, through the read-only path
__device__ __forceinline__ void fetch_rows(const float4* __restrict__ tab,
                                          const Stencil& st, float4* w) {
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = __ldg(tab + st.code[k]);
}

struct Planes {
  float* __restrict__ p[7];  // [S, N] each; 4..6 (lit) the sigma gradient
};

struct Cots {
  const float* __restrict__ p[7];  // [S, N] cotangents of the planes
};

// samples per thread in the kRayGrads variant. render/kernel_sample.py
// owns the value (RAY_CHUNK: its plain version sums in the same chunks,
// and it sizes the scratch); vx_sample_bwd refuses any other.
constexpr int kChunk = 16;

__global__ void __launch_bounds__(kThreads)
sample_fwd_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t0, const float* __restrict__ dt,
                  int n, int S, const float4* __restrict__ tab, int D,
                  int lit, Planes out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)S * n) return;
  const int s = (int)(idx / n);
  const int i = (int)(idx - (int64_t)s * n);
  const int nout = lit ? 7 : 4;
  const float dti = dt[i];
  if (!(dti > 0.0f)) {
    // a zero-length segment (AABB miss): no fetch, every channel 0
    for (int c = 0; c < nout; ++c) out.p[c][idx] = 0.0f;
    return;
  }
  const float t = t0[i] + dti * ((float)s + 0.5f);
  const float px = o[3 * i] + t * d[3 * i];
  const float py = o[3 * i + 1] + t * d[3 * i + 1];
  const float pz = o[3 * i + 2] + t * d[3 * i + 2];
  const Stencil st = corner_setup(px, py, pz, D);
  float4 w[8];
  fetch_rows(tab, st, w);
  float v[8];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = channel(w[k], c);
    out.p[c][idx] = lerp_ladder(v, st.fx, st.fy, st.fz);
    if (c == 0 && lit) {
      float gx, gy, gz;
      grad_ladder(v, st.fx, st.fy, st.fz, &gx, &gy, &gz);
      out.p[4][idx] = gx;
      out.p[5][idx] = gy;
      out.p[6][idx] = gz;
    }
  }
}

// Adds g[c] (c < 4) at word `key` of the channel-interleaved [D^3, 4]
// gradient with one float4 atomicAdd (key -1: nothing). The lanes of a
// run of equal words are summed first and the run's last lane adds the
// sum: fewer atomics on one address, and a smaller rounding error where
// many rays meet (rays from one point). A warp whose words are all
// distinct skips the scan (the sum of a run of one is the value itself).
// Zero sums skip their atomic. Every lane of the warp must call it.
__device__ __forceinline__ void scatter_corner(float4* grad, int key,
                                               const float* g, int lane) {
  const Runs r = warp_runs(key, lane);
  float sum[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    sum[c] = r.shared ? run_sum(g[c], lane, r.start) : g[c];
  if (r.tail && key >= 0 &&
      (sum[0] != 0.0f || sum[1] != 0.0f || sum[2] != 0.0f || sum[3] != 0.0f))
    atomicAdd(grad + key, make_float4(sum[0], sum[1], sum[2], sum[3]));
}

// Thread (j, i), index j*N + i: ray i's samples s in [j, j + 1) (the pure
// scatter) or [j*kChunk, (j + 1)*kChunk) clipped to S (kRayGrads, whose
// 8 partial ray sums go to part[j, k, i]). The lanes of a warp stay
// together through the samples (scatter_corner sums across lanes): every
// lane runs `per` iterations, those past S or of a ray with dt == 0 with
// no word.
template <bool kRayGrads, bool kLit>
__global__ void __launch_bounds__(kThreads)
sample_bwd_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t0, const float* __restrict__ dt,
                  int n, int S, const float4* __restrict__ tab, int D,
                  Cots cot,
                  float4* __restrict__ grad, float* __restrict__ part) {
  constexpr int nc = kLit ? 7 : 4;
  constexpr int per = kRayGrads ? kChunk : 1;
  const int64_t rows = ((int64_t)S + per - 1) / per;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = idx < rows * n;
  const int j = in ? (int)(idx / n) : 0;
  const int i = in ? (int)(idx - (int64_t)j * n) : 0;
  const int lane = threadIdx.x & 31;
  const float dti = in ? dt[i] : 0.0f;
  const bool act = dti > 0.0f;
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  // a warp with no active ray skips the samples
  if (__any_sync(0xffffffffu, act)) {
    const float t0i = act ? t0[i] : 0.0f;
    const float ox = act ? o[3 * i] : 0.0f, oy = act ? o[3 * i + 1] : 0.0f;
    const float oz = act ? o[3 * i + 2] : 0.0f;
    const float dx = act ? d[3 * i] : 0.0f, dy = act ? d[3 * i + 1] : 0.0f;
    const float dz = act ? d[3 * i + 2] : 0.0f;
    for (int q = 0; q < per; ++q) {
      const int s = j * per + q;
      const bool live = act && s < S;
      const float sf = (float)s + 0.5f;
      const float t = t0i + dti * sf;
      const Stencil st = corner_setup(ox + t * dx, oy + t * dy, oz + t * dz,
                                      D);
      const int64_t at = (int64_t)s * n + i;
      float gv[nc];
#pragma unroll
      for (int c = 0; c < nc; ++c) gv[c] = live ? cot.p[c][at] : 0.0f;
      float g[4][8];
      corner_cotangents<kLit>(st, gv, g);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float gk[4] = {g[0][k], g[1][k], g[2][k], g[3][k]};
        scatter_corner(grad, live ? st.code[k] : -1, gk, lane);
      }
      if constexpr (kRayGrads) {
        if (!live) continue;
        float4 w[8];
        fetch_rows(tab, st, w);
        float v[4][8];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int k = 0; k < 8; ++k) v[c][k] = channel(w[k], c);
        }
        float gfx = 0.0f, gfy = 0.0f, gfz = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float dfx, dfy, dfz;
          value_f_grads(v[c], st.fx, st.fy, st.fz, &dfx, &dfy, &dfz);
          gfx = gfx + gv[c] * dfx;
          gfy = gfy + gv[c] * dfy;
          gfz = gfz + gv[c] * dfz;
        }
        if constexpr (kLit) {
          // the second-order terms go in after the four value channels
          float g2x, g2y, g2z;
          grad_f_grads(v[0], st.fx, st.fy, st.fz, gv[4], gv[5], gv[6], &g2x,
                       &g2y, &g2z);
          gfx = gfx + g2x;
          gfy = gfy + g2y;
          gfz = gfz + g2z;
        }
        const float gdot = gfx * dx + gfy * dy + gfz * dz;
        acc[0] = acc[0] + gfx;
        acc[1] = acc[1] + gfy;
        acc[2] = acc[2] + gfz;
        acc[3] = acc[3] + gfx * t;
        acc[4] = acc[4] + gfy * t;
        acc[5] = acc[5] + gfz * t;
        acc[6] = acc[6] + gdot;
        acc[7] = acc[7] + gdot * sf;
      }
    }
  }
  if constexpr (kRayGrads) {
    if (!in) return;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      part[((int64_t)j * 8 + k) * n + i] = acc[k];
    }
  }
}

// Ray i's cotangents: the chunks' partial sums added in chunk order.
__global__ void __launch_bounds__(kThreads)
sample_ray_sum_kernel(const float* __restrict__ part, int n, int chunks,
                      float* __restrict__ go, float* __restrict__ gd,
                      float* __restrict__ gt0, float* __restrict__ gdt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float a = 0.0f;
    for (int j = 0; j < chunks; ++j) {
      a = a + part[((int64_t)j * 8 + k) * n + i];
    }
    acc[k] = a;
  }
  go[3 * i] = acc[0];
  go[3 * i + 1] = acc[1];
  go[3 * i + 2] = acc[2];
  gd[3 * i] = acc[3];
  gd[3 * i + 1] = acc[4];
  gd[3 * i + 2] = acc[5];
  gt0[i] = acc[6];
  gdt[i] = acc[7];
}

template <bool kRayGrads, bool kLit>
int launch_bwd(const float* o, const float* d, const float* t0,
               const float* dt, int n, int S, const float4* tab, int D,
               const Cots& C, float4* grad, float* part,
               cudaStream_t stream) {
  const int64_t rows = kRayGrads ? ((int64_t)S + kChunk - 1) / kChunk : S;
  const int64_t blocks = (rows * n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  sample_bwd_kernel<kRayGrads, kLit><<<(unsigned)blocks, kThreads, 0,
                                       stream>>>(o, d, t0, dt, n, S, tab, D, C,
                                                 grad, part);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches its kernel on
// `stream` and returns cudaGetLastError(); nothing here synchronises.
// tab: the 16-byte aligned [D^3, 4] table; outs / cots: 4 (7 when lit)
// device pointers.

extern "C" int vx_sample_fwd(const float* o, const float* d, const float* t0,
                             const float* dt, int n, int S, const float* tab,
                             int D, int lit, float* const* outs,
                             cudaStream_t stream) {
  Planes P;
  for (int c = 0; c < 7; ++c) P.p[c] = (c < 4 || lit) ? outs[c] : nullptr;
  const int64_t total = (int64_t)S * n;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  sample_fwd_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      o, d, t0, dt, n, S, reinterpret_cast<const float4*>(tab), D, lit, P);
  return (int)cudaGetLastError();
}

// grad: the zeroed [D^3, 4] gradient of the table; part: the
// [ceil(S / chunk), 8, n] scratch of the ray sums when ray_grads, else
// unused (null). chunk: the caller's chunk length, which must be kChunk
// (else cudaErrorInvalidValue, nothing launched).
extern "C" int vx_sample_bwd(const float* o, const float* d, const float* t0,
                             const float* dt, int n, int S,
                             const float* tab4, int D, int lit, int ray_grads,
                             int chunk, const float* const* cots,
                             float* grad4, float* part, cudaStream_t stream) {
  if (ray_grads && chunk != kChunk) return (int)cudaErrorInvalidValue;
  const float4* const tab = reinterpret_cast<const float4*>(tab4);
  float4* const grad = reinterpret_cast<float4*>(grad4);
  Cots C;
  for (int c = 0; c < 7; ++c) C.p[c] = (c < 4 || lit) ? cots[c] : nullptr;
  if (ray_grads)
    return lit ? launch_bwd<true, true>(o, d, t0, dt, n, S, tab, D, C, grad,
                                        part, stream)
               : launch_bwd<true, false>(o, d, t0, dt, n, S, tab, D, C, grad,
                                         part, stream);
  return lit ? launch_bwd<false, true>(o, d, t0, dt, n, S, tab, D, C, grad,
                                       part, stream)
             : launch_bwd<false, false>(o, d, t0, dt, n, S, tab, D, C, grad,
                                        part, stream);
}

extern "C" int vx_sample_ray_sum(const float* part, int n, int chunks,
                                 float* go, float* gd, float* gt0, float* gdt,
                                 cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  sample_ray_sum_kernel<<<blocks, kThreads, 0, stream>>>(part, n, chunks, go,
                                                         gd, gt0, gdt);
  return (int)cudaGetLastError();
}
