// Row-major DDA march kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of vxtpu/render/kernel_pallas.py:
//   march_packed_kernel  <- _march_kernel (via march_pallas): the DDA
//                           march over the row-major packed table, whose
//                           word is child_bits | D << 8, for any even dims.
//                           There is no shade epilogue: the composable
//                           pipeline shades in PyTorch (render/shade.py).
//
// What bounds it on this card: one thread per ray runs a divergent loop of
// a few iterations (about 4.4 a ray on the c3 frame), each some hundred
// instructions, and every change of coarse cell is a dependent table
// read. So the kernel is bound by instruction issue and latency, not by
// bandwidth: its byte bound (the ray I/O, 57-61 B a ray, at the HBM rate)
// is less than half its time. Tensor cores have no part in it: a DDA step
// is a compare-and-select on scalars whose next table address depends on
// the last, with no product of tiles anywhere to give them.
//
// What the design does about it:
//   * fewer instructions a step: the faces the ray leaves by are integers
//     (2c - 2(D-1), 2c + 2D, v, v + 1) formed as a masked voxel index plus
//     one of two offsets picked per step, not both ends of the box on
//     every axis; the voxel index is clamped in float and converted once
//     (no separate floor); the cell index is formed and the word read
//     only when a coordinate changes above its lowest bit;
//   * fewer live values: the slab values die after t_enter / t_exit but
//     for the three the entry face needs, the ray's signs are recomputed
//     from d, and the grid sizes are kernel parameters (constant memory),
//     so __launch_bounds__ holds the kernel to 40 registers and 6 blocks
//     of 256 threads fit an SM (the first port used 46: 5 blocks);
//   * the table: a 16-bit copy of the row-major words (every word is
//     child_bits | D << 8 <= 65,535) in bricks of 4x4x4 coarse cells, one
//     128-byte line each (world/packed.py:brick_words). A step to a
//     neighbouring cell stays in the line 3 times in 4 on every axis, and
//     the table is half the size: 4 MiB at 256^3, 32 MiB at 512^3, both
//     resident in the 50 MB L2. It is read through the read-only path;
//     the current cell's word stays in registers, and a cell with D > 0
//     jumps the ray across the whole provably-empty box [2c - 2(D-1),
//     2c + 2D).
// Tried on the card and dropped (numbers in PERF.md): ray I/O through
// shared memory with bulk async copies (a block's or a warp's slice of
// rays), and persistent blocks or warps pulling slices from a device
// counter. Every form of them was slower than plain coalesced I/O.
//
// The per-ray contract is vxtpu v1's (see render/kernel_packed.py): at most
// max_steps iterations, steps counts every live iteration (the exiting one
// included), the voxel follows the clipped next voxel on every live
// iteration, valid = t_enter <= t_exit, and the entry hit needs
// t_enter <= t_max.
//
// Floating point: built with -fmad=false and without fast math, so every
// add, multiply and divide rounds as the plain PyTorch version's
// element-wise ops do and DDA boundaries land on the same voxels. The
// faces are exact integers however they are formed, and the clamp-then-
// truncate gives the plain version's floor-then-clamp integer, so every
// output field equals the plain version's bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // threads a block, one ray each
constexpr int kMinBlocks = 6;    // blocks an SM must hold
constexpr float kEps = 1e-4f;    // reinit samples the voxel at t + EPS
constexpr float kBig = 3.0e30f;  // 1/d where |d| < 1e-12
constexpr float kBigT = 1e30f;   // t of a miss

// grid sizes, passed by value (kernel parameters live in constant memory,
// not in registers)
struct Grid {
  int X, Y, Z;             // fine dims
  float fX, fY, fZ;        // the same, as floats
  float fXm1, fYm1, fZm1;  // the largest voxel index on each axis
  int by, bz;              // bricks on the y and z axes
};

__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) < 1e-12f ? kBig : 1.0f / d;
}

// clamp to [0, m] in float, then convert (truncating): for a p in range
// that is floor(p), outside it 0 or m. The plain version floors first,
// then clamps and converts: the same integer for every p but NaN, which
// no valid ray reaches (here NaN gives 0, as the first port's did)
__device__ __forceinline__ int clip_floor(float p, float m) {
  return (int)fminf(fmaxf(p, 0.0f), m);
}

__device__ __forceinline__ bool child_bit(int cb, int vx, int vy, int vz) {
  const int ci = ((vx & 1) << 2) | ((vy & 1) << 1) | (vz & 1);
  return ((cb >> ci) & 1) != 0;
}

// t at which the ray reaches `face` (an integer) on one axis
__device__ __forceinline__ float face_t(float face, float o, float d,
                                        float iv) {
  const float t = (face - o) * iv;
  return fabsf(d) < 1e-12f ? kBig : t;
}

// the cell of voxel (vx, vy, vz) in the bricked table: 4x4x4 coarse cells
// a brick, bricks row-major over the padded coarse dims
__device__ __forceinline__ int cell_of(int vx, int vy, int vz, const Grid g) {
  const int cx = vx >> 1, cy = vy >> 1, cz = vz >> 1;
  return ((((cx >> 2) * g.by + (cy >> 2)) * g.bz + (cz >> 2)) << 6) |
         ((cx & 3) << 4) | ((cy & 3) << 2) | (cz & 3);
}

__device__ __forceinline__ float sgn(float d) {
  return d >= 0.0f ? 1.0f : -1.0f;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
march_packed_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max, int n,
                    const uint16_t* __restrict__ bricks, const Grid g,
                    int max_steps, uint8_t* __restrict__ hit_out,
                    float* __restrict__ t_out, int32_t* __restrict__ vox_out,
                    float* __restrict__ nrm_out,
                    int32_t* __restrict__ steps_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tm = t_max ? t_max[i] : kBigT;

  const float ivx = inv_dir(dx), ivy = inv_dir(dy), ivz = inv_dir(dz);
  float a, b;
  a = (0.0f - ox) * ivx;
  b = (g.fX - ox) * ivx;
  const float nx = fminf(a, b), fx = fmaxf(a, b);
  a = (0.0f - oy) * ivy;
  b = (g.fY - oy) * ivy;
  const float ny = fminf(a, b), fy = fmaxf(a, b);
  a = (0.0f - oz) * ivz;
  b = (g.fZ - oz) * ivz;
  const float nz = fminf(a, b), fz = fmaxf(a, b);
  const float t_enter = fmaxf(fmaxf(nx, ny), fmaxf(nz, 0.0f));
  const float t_exit = fminf(fminf(fx, fy), fz);
  const bool valid = t_enter <= t_exit;
  const float t_end = fminf(t_exit, tm);

  int vx = clip_floor(ox + (t_enter + kEps) * dx, g.fXm1);
  int vy = clip_floor(oy + (t_enter + kEps) * dy, g.fYm1);
  int vz = clip_floor(oz + (t_enter + kEps) * dz, g.fZm1);
  int hit = 0, ax = 0, steps = 0;
  float t_hit = kBigT, sg = 0.0f;
  if (valid) {
    int w = __ldg(bricks + cell_of(vx, vy, vz, g));
    if (child_bit(w & 255, vx, vy, vz) && t_enter <= tm) {
      // entry face: the axis with the largest near-slab t, ties toward
      // the lowest axis
      const float tn_max = fmaxf(fmaxf(nx, ny), nz);
      hit = 1;
      t_hit = t_enter;
      ax = nx >= tn_max ? 0 : (ny >= tn_max ? 1 : 2);
      sg = sgn(ax == 0 ? dx : (ax == 1 ? dy : dz));
    } else {
      for (int it = 0; it < max_steps; ++it) {
        // the faces the ray leaves by: of the empty box [2c - 2(D-1),
        // 2c + 2D) where D > 0, else of the voxel [v, v + 1). All are
        // integers, formed exactly: 2c or v, plus the offset of the face
        // the ray's direction picks
        const int dist = w >> 8;
        const bool big = dist > 0;
        const float df = (float)dist;
        const float hi = big ? 2.0f * df : 1.0f;
        const float lo = big ? 2.0f - 2.0f * df : 0.0f;
        const int base = big ? ~1 : ~0;
        const float tx = face_t((float)(vx & base) + (dx >= 0.0f ? hi : lo),
                                ox, dx, ivx);
        const float ty = face_t((float)(vy & base) + (dy >= 0.0f ? hi : lo),
                                oy, dy, ivy);
        const float tz = face_t((float)(vz & base) + (dz >= 0.0f ? hi : lo),
                                oz, dz, ivz);
        const float t_new = fminf(fminf(tx, ty), tz);
        const bool mx = (tx <= ty) && (tx <= tz);
        const bool my = !mx && (ty <= tz);
        const bool mz = !mx && !my;

        const float px = ox + (t_new + kEps) * dx;
        const float py = oy + (t_new + kEps) * dy;
        const float pz = oz + (t_new + kEps) * dz;
        bool inside = px >= 0.0f && px < g.fX && py >= 0.0f && py < g.fY &&
                      pz >= 0.0f && pz < g.fZ;
        int nvx = clip_floor(px, g.fXm1);
        int nvy = clip_floor(py, g.fYm1);
        int nvz = clip_floor(pz, g.fZm1);
        if (nvx == vx && nvy == vy && nvz == vz) {
          // progress guard: rounding re-landed in the same voxel -> one
          // DDA step along the crossing axis
          const int fx_ = vx + (dx >= 0.0f ? 1 : -1);
          const int fy_ = vy + (dy >= 0.0f ? 1 : -1);
          const int fz_ = vz + (dz >= 0.0f ? 1 : -1);
          if (mx) nvx = min(max(fx_, 0), g.X - 1);
          if (my) nvy = min(max(fy_, 0), g.Y - 1);
          if (mz) nvz = min(max(fz_, 0), g.Z - 1);
          inside = (mx && fx_ >= 0 && fx_ < g.X) ||
                   (my && fy_ >= 0 && fy_ < g.Y) ||
                   (mz && fz_ >= 0 && fz_ < g.Z);
        }
        // a new cell when a coordinate changes above its lowest bit
        const bool new_cell = ((nvx ^ vx) | (nvy ^ vy) | (nvz ^ vz)) > 1;
        vx = nvx;
        vy = nvy;
        vz = nvz;
        ++steps;
        if (!inside || t_new > t_end) break;
        // the word is a function of the cell: read it only on a change
        if (new_cell) w = __ldg(bricks + cell_of(vx, vy, vz, g));
        if (child_bit(w & 255, vx, vy, vz)) {
          hit = 1;
          t_hit = t_new;
          ax = mx ? 0 : (my ? 1 : 2);
          sg = sgn(mx ? dx : (my ? dy : dz));
          break;
        }
      }
    }
  }
  const float sgf = -sg;
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

// Plain C entry point (loaded with ctypes): launches the kernel on
// `stream` and returns cudaGetLastError(); nothing here synchronises.
// bricks: the bricked 16-bit table of the fine grid X x Y x Z.
extern "C" int vx_march_packed(const float* o, const float* d,
                               const float* t_max, int n,
                               const uint16_t* bricks, int X, int Y, int Z,
                               int max_steps, uint8_t* hit, float* t,
                               int32_t* vox, float* nrm, int32_t* steps,
                               cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const Grid g{X,
               Y,
               Z,
               (float)X,
               (float)Y,
               (float)Z,
               (float)(X - 1),
               (float)(Y - 1),
               (float)(Z - 1),
               (Y / 2 + 3) / 4,
               (Z / 2 + 3) / 4};
  march_packed_kernel<<<blocks, kThreads, 0, stream>>>(
      o, d, t_max, n, bricks, g, max_steps, hit, t, vox, nrm, steps);
  return (int)cudaGetLastError();
}

// Blocks of march_packed_kernel an SM holds at once (its occupancy, for
// the record); 0 if the query fails.
extern "C" int vx_march_packed_blocks_per_sm(void) {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, march_packed_kernel, kThreads, 0) != cudaSuccess)
    return 0;
  return blocks;
}
