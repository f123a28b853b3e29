// Row-major DDA march kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of vxtpu/render/kernel_pallas.py:
//   march_packed_kernel  <- _march_kernel (via march_pallas): the DDA
//                           march over the row-major packed table, whose
//                           word is child_bits | D << 8, for any even dims.
//                           There is no shade epilogue: the composable
//                           pipeline shades in PyTorch (render/shade.py).
//
// What bounds it on this card: one thread per ray runs a divergent loop
// whose every change of coarse cell is a dependent table read, so the
// march is latency-bound on those reads, not on bandwidth or arithmetic.
// The design: the int32 table (8 MB at 256^3) stays resident in the 50 MB
// L2 and is read with __ldg; the current cell's word stays in registers,
// so steps inside one 2x2x2 cell read nothing; a cell with D > 0 jumps the
// ray across the whole provably-empty box [2c - 2(D-1), 2c + 2D).
//
// The per-ray contract is vxtpu v1's (see render/kernel_packed.py): at most
// max_steps iterations, steps counts every live iteration (the exiting one
// included), the voxel follows the clipped next voxel on every live
// iteration, valid = t_enter <= t_exit, and the entry hit needs
// t_enter <= t_max.
//
// Floating point: built with -fmad=false and without fast math, so every
// add, multiply and divide rounds as the plain PyTorch version's
// element-wise ops do and DDA boundaries land on the same voxels.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-4f;    // reinit samples the voxel at t + EPS
constexpr float kBig = 3.0e30f;  // 1/d where |d| < 1e-12
constexpr float kBigT = 1e30f;   // t of a miss

__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) < 1e-12f ? kBig : 1.0f / d;
}

// floor, clamp to [0, n-1] in float, then convert: the plain version
// clamps before converting too, so out-of-range values agree
__device__ __forceinline__ int floor_clip(float p, int n) {
  return (int)fminf(fmaxf(floorf(p), 0.0f), (float)(n - 1));
}

__device__ __forceinline__ bool child_bit(int cb, int vx, int vy, int vz) {
  const int ci = ((vx & 1) << 2) | ((vy & 1) << 1) | (vz & 1);
  return ((cb >> ci) & 1) != 0;
}

// t at which the ray leaves the current voxel (dist == 0) or the empty
// box [2c - 2(dist-1), 2c + 2 dist) (dist > 0) on one axis
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

__global__ void __launch_bounds__(kThreads)
march_packed_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max, int n,
                    const int32_t* __restrict__ words, int X, int Y, int Z,
                    int max_steps, uint8_t* __restrict__ hit_out,
                    float* __restrict__ t_out, int32_t* __restrict__ vox_out,
                    float* __restrict__ nrm_out,
                    int32_t* __restrict__ steps_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int cyd = Y / 2, czd = Z / 2;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tm = t_max ? t_max[i] : kBigT;

  const float ivx = inv_dir(dx), ivy = inv_dir(dy), ivz = inv_dir(dz);
  float a, b;
  a = (0.0f - ox) * ivx;
  b = ((float)X - ox) * ivx;
  const float nx = fminf(a, b), fx = fmaxf(a, b);
  a = (0.0f - oy) * ivy;
  b = ((float)Y - oy) * ivy;
  const float ny = fminf(a, b), fy = fmaxf(a, b);
  a = (0.0f - oz) * ivz;
  b = ((float)Z - oz) * ivz;
  const float nz = fminf(a, b), fz = fmaxf(a, b);
  const float t_enter = fmaxf(fmaxf(nx, ny), fmaxf(nz, 0.0f));
  const float t_exit = fminf(fminf(fx, fy), fz);
  const bool valid = t_enter <= t_exit;
  const float t_end = fminf(t_exit, tm);

  const int sgx = dx >= 0.0f ? 1 : -1;
  const int sgy = dy >= 0.0f ? 1 : -1;
  const int sgz = dz >= 0.0f ? 1 : -1;

  int vx = floor_clip(ox + (t_enter + kEps) * dx, X);
  int vy = floor_clip(oy + (t_enter + kEps) * dy, Y);
  int vz = floor_clip(oz + (t_enter + kEps) * dz, Z);
  int hit = 0, ax = 0, sg = 0, steps = 0;
  float t_hit = kBigT;
  if (valid) {
    int cell = ((vx >> 1) * cyd + (vy >> 1)) * czd + (vz >> 1);
    int w = __ldg(words + cell);
    if (child_bit(w & 255, vx, vy, vz) && t_enter <= tm) {
      // entry face: the axis with the largest near-slab t, ties toward
      // the lowest axis
      const float tn_max = fmaxf(fmaxf(nx, ny), nz);
      hit = 1;
      t_hit = t_enter;
      ax = nx >= tn_max ? 0 : (ny >= tn_max ? 1 : 2);
      sg = ax == 0 ? sgx : (ax == 1 ? sgy : sgz);
    } else {
      for (int it = 0; it < max_steps; ++it) {
        const int dist = w >> 8;
        const float tx = axis_t(vx, dist, ox, dx, ivx);
        const float ty = axis_t(vy, dist, oy, dy, ivy);
        const float tz = axis_t(vz, dist, oz, dz, ivz);
        const float t_new = fminf(fminf(tx, ty), tz);
        const bool mx = (tx <= ty) && (tx <= tz);
        const bool my = !mx && (ty <= tz);
        const bool mz = !mx && !my;

        const float px = ox + (t_new + kEps) * dx;
        const float py = oy + (t_new + kEps) * dy;
        const float pz = oz + (t_new + kEps) * dz;
        bool inside = px >= 0.0f && px < (float)X && py >= 0.0f &&
                      py < (float)Y && pz >= 0.0f && pz < (float)Z;
        int nvx = floor_clip(px, X);
        int nvy = floor_clip(py, Y);
        int nvz = floor_clip(pz, Z);
        if (nvx == vx && nvy == vy && nvz == vz) {
          // progress guard: rounding re-landed in the same voxel -> one
          // DDA step along the crossing axis
          const int fx_ = vx + sgx, fy_ = vy + sgy, fz_ = vz + sgz;
          if (mx) nvx = min(max(fx_, 0), X - 1);
          if (my) nvy = min(max(fy_, 0), Y - 1);
          if (mz) nvz = min(max(fz_, 0), Z - 1);
          inside = (mx && fx_ >= 0 && fx_ < X) || (my && fy_ >= 0 && fy_ < Y) ||
                   (mz && fz_ >= 0 && fz_ < Z);
        }
        vx = nvx;
        vy = nvy;
        vz = nvz;
        ++steps;
        if (!inside || t_new > t_end) break;
        // the word is a function of the cell: read it only on a change
        const int ncell = ((vx >> 1) * cyd + (vy >> 1)) * czd + (vz >> 1);
        if (ncell != cell) {
          cell = ncell;
          w = __ldg(words + cell);
        }
        if (child_bit(w & 255, vx, vy, vz)) {
          hit = 1;
          t_hit = t_new;
          ax = mx ? 0 : (my ? 1 : 2);
          sg = mx ? sgx : (my ? sgy : sgz);
          break;
        }
      }
    }
  }
  const float sgf = -(float)sg;
  hit_out[i] = hit ? 1 : 0;
  t_out[i] = t_hit;
  vox_out[3 * i] = vx;
  vox_out[3 * i + 1] = vy;
  vox_out[3 * i + 2] = vz;
  nrm_out[3 * i] = hit && ax == 0 ? sgf : 0.0f;
  nrm_out[3 * i + 1] = hit && ax == 1 ? sgf : 0.0f;
  nrm_out[3 * i + 2] = hit && ax == 2 ? sgf : 0.0f;
  steps_out[i] = steps;
}

}  // namespace

// Plain C entry point (loaded with ctypes): launches the kernel on `stream`
// and returns cudaGetLastError(); nothing here synchronises.
extern "C" int vx_march_packed(const float* o, const float* d,
                               const float* t_max, int n,
                               const int32_t* words, int X, int Y, int Z,
                               int max_steps, uint8_t* hit, float* t,
                               int32_t* vox, float* nrm, int32_t* steps,
                               cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  march_packed_kernel<<<blocks, kThreads, 0, stream>>>(
      o, d, t_max, n, words, X, Y, Z, max_steps, hit, t, vox, nrm, steps);
  return (int)cudaGetLastError();
}
