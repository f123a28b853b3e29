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
//                         corner weights scatter-added into four [D^3]
//                         gradient tables, and the per-ray cotangents of
//                         o, d, t0 and dt summed over the samples.
// None of the TPU machinery carries over: no Morton row windows, no bf16
// one-hot fetch, no pending-corner loop, no VMEM gradient window.
//
// What bounds them on this card: bytes. The forward writes 4 (lit: 7)
// f32 planes of S x N and reads 32 table words per sample, most of them
// from L1/L2 because neighbouring rays and successive samples share
// corners. The backward reads those planes as cotangents and must write
// four dense [D^3] gradient tables (2.1 GB at 512^3, zero-filled by the
// wrapper), so the dense tables, not the samples, set its bound; its
// scatter is 32 atomicAdds per sample into L2.
// What the simple design does about it: the forward runs one thread per
// (s, n) with output index s*N + n, so a warp's stores are contiguous and
// its table reads hit nearby Morton words; tables are read through the
// read-only path (__ldg). The backward runs one thread per ray and loops
// over s, so the per-ray sums stay in registers and need no second pass.
// Neighbouring rays of an image tile often share a corner word at the
// same sample, so before its atomicAdd each warp sums the contributions
// of adjacent lanes that hit the same word (a segmented shuffle scan):
// fewer atomics on the same address, and a smaller rounding error from
// their order. Zero sums skip their atomic.
//
// Floating point: built with -fmad=false, and every expression follows
// vxtpu's _corner_setup / _lerp_ladder / _grad_ladder / _value_f_grads /
// _grad_f_grads operation by operation, so the plain PyTorch versions in
// render/kernel_sample.py round the same way. The float atomicAdd order
// of the scatter changes from run to run: the gradient tables agree with
// the plain version (which sums them in float64) and with another run to
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

struct Fields {
  const float* __restrict__ tab[4];  // sigma, r, g, b: flat Morton [D^3]
};

struct Planes {
  float* __restrict__ p[7];  // [S, N] each; 4..6 (lit) the sigma gradient
};

struct Cots {
  const float* __restrict__ p[7];  // [S, N] cotangents of the planes
};

__global__ void __launch_bounds__(kThreads)
sample_fwd_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t0, const float* __restrict__ dt,
                  int n, int S, Fields F, int D, int lit, Planes out) {
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
  float v[8];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __ldg(F.tab[c] + st.code[k]);
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

__global__ void __launch_bounds__(kThreads)
sample_bwd_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t0, const float* __restrict__ dt,
                  int n, int S, Fields F, int D, int lit, Cots cot,
                  float* __restrict__ gsig, float* __restrict__ gr,
                  float* __restrict__ gg, float* __restrict__ gb,
                  float* __restrict__ go, float* __restrict__ gd,
                  float* __restrict__ gt0, float* __restrict__ gdt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool in = i < n;
  const float dti = in ? dt[i] : 0.0f;
  const bool act = dti > 0.0f;
  float* const gtab[4] = {gsig, gr, gg, gb};
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  // the warp's lanes stay together through the sample loop (the scatter
  // sums across lanes); a warp with no active ray skips it
  if (__any_sync(0xffffffffu, act)) {
    const float t0i = in ? t0[i] : 0.0f;
    const float ox = in ? o[3 * i] : 0.0f, oy = in ? o[3 * i + 1] : 0.0f;
    const float oz = in ? o[3 * i + 2] : 0.0f;
    const float dx = in ? d[3 * i] : 0.0f, dy = in ? d[3 * i + 1] : 0.0f;
    const float dz = in ? d[3 * i + 2] : 0.0f;
    for (int s = 0; s < S; ++s) {
      const float sf = (float)s + 0.5f;
      const float t = t0i + dti * sf;
      const float px = ox + t * dx;
      const float py = oy + t * dy;
      const float pz = oz + t * dz;
      const Stencil st = corner_setup(px, py, pz, D);
      const float fx = st.fx, fy = st.fy, fz = st.fz;
      const float wx[2] = {1.0f - fx, fx};
      const float wy[2] = {1.0f - fy, fy};
      const float wz[2] = {1.0f - fz, fz};
      const size_t at = (size_t)s * n + i;
      float gv[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (act)
        for (int c = 0; c < (lit ? 7 : 4); ++c) gv[c] = cot.p[c][at];
      float gfx = 0.0f, gfy = 0.0f, gfz = 0.0f;
      float g2x = 0.0f, g2y = 0.0f, g2z = 0.0f;
      float v[4][8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int ex = (k >> 2) & 1, ey = (k >> 1) & 1, ez = k & 1;
        // lanes whose corner is the same word as their neighbour's sum
        // their contributions first; the last lane of each run of equal
        // words adds the run's sum with one atomic
        const int key = act ? st.code[k] : -1;
        const int prev = __shfl_up_sync(0xffffffffu, key, 1);
        const int next = __shfl_down_sync(0xffffffffu, key, 1);
        const unsigned heads =
            __ballot_sync(0xffffffffu, lane == 0 || prev != key);
        const int start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
        const bool tail = lane == 31 || next != key;
        const float w = wx[ex] * wy[ey] * wz[ez];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float g = gv[c] * w;
          if (c == 0 && lit) {
            // the gradient channels' cotangents through d(w_k)/d(f)
            const float dsx = (ex ? 1.0f : -1.0f) * wy[ey] * wz[ez];
            const float dsy = wx[ex] * (ey ? 1.0f : -1.0f) * wz[ez];
            const float dsz = wx[ex] * wy[ey] * (ez ? 1.0f : -1.0f);
            g = g + gv[4] * dsx + gv[5] * dsy + gv[6] * dsz;
          }
          const float sum = run_sum(g, lane, start);
          if (tail && key >= 0 && sum != 0.0f)
            atomicAdd(gtab[c] + key, sum);
          v[c][k] = act ? __ldg(F.tab[c] + st.code[k]) : 0.0f;
        }
      }
      if (!act) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float dfx, dfy, dfz;
        value_f_grads(v[c], fx, fy, fz, &dfx, &dfy, &dfz);
        gfx = gfx + gv[c] * dfx;
        gfy = gfy + gv[c] * dfy;
        gfz = gfz + gv[c] * dfz;
      }
      if (lit) {
        // the second-order terms go in after the four value channels
        grad_f_grads(v[0], fx, fy, fz, gv[4], gv[5], gv[6], &g2x, &g2y,
                     &g2z);
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
  if (!in) return;
  go[3 * i] = acc[0];
  go[3 * i + 1] = acc[1];
  go[3 * i + 2] = acc[2];
  gd[3 * i] = acc[3];
  gd[3 * i + 1] = acc[4];
  gd[3 * i + 2] = acc[5];
  gt0[i] = acc[6];
  gdt[i] = acc[7];
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches its kernel on
// `stream` and returns cudaGetLastError(); nothing here synchronises.
// tabs: 4 device pointers; outs / cots: 4 (7 when lit) device pointers.

extern "C" int vx_sample_fwd(const float* o, const float* d, const float* t0,
                             const float* dt, int n, int S,
                             const float* const* tabs, int D, int lit,
                             float* const* outs, cudaStream_t stream) {
  Fields F;
  Planes P;
  for (int c = 0; c < 4; ++c) F.tab[c] = tabs[c];
  for (int c = 0; c < 7; ++c) P.p[c] = (c < 4 || lit) ? outs[c] : nullptr;
  const int64_t total = (int64_t)S * n;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  sample_fwd_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      o, d, t0, dt, n, S, F, D, lit, P);
  return (int)cudaGetLastError();
}

extern "C" int vx_sample_bwd(const float* o, const float* d, const float* t0,
                             const float* dt, int n, int S,
                             const float* const* tabs, int D, int lit,
                             const float* const* cots, float* const* gtabs,
                             float* go, float* gd, float* gt0, float* gdt,
                             cudaStream_t stream) {
  Fields F;
  Cots C;
  for (int c = 0; c < 4; ++c) F.tab[c] = tabs[c];
  for (int c = 0; c < 7; ++c) C.p[c] = (c < 4 || lit) ? cots[c] : nullptr;
  const int blocks = (n + kThreads - 1) / kThreads;
  sample_bwd_kernel<<<blocks, kThreads, 0, stream>>>(
      o, d, t0, dt, n, S, F, D, lit, C, gtabs[0], gtabs[1], gtabs[2],
      gtabs[3], go, gd, gt0, gdt);
  return (int)cudaGetLastError();
}
