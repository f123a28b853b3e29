// Hard-voxel DDA march + shade kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vxtpu/render/kernel_pallas_v2.py:
//   march_shade_kernel  <- _march_kernel (via march_pallas_v2): the DDA
//                          march over the Morton signed-word table, the
//                          optional per-light shadow marches in the same
//                          dispatch, and the _shade_epilogue;
//   shade_kernel        <- _shade_only_kernel (via shade_pallas_v2): the
//                          epilogue alone on a stored hit record plus
//                          per-light visibility;
//   march_resume_kernel <- _march_kernel in resume mode (resume=True,
//                          iter_budget, the extended done / dist outputs),
//                          the round kernel of march_pallas_v2_sorted: a
//                          march-only round capped at iter_cap iterations
//                          per ray that restarts from a stored (voxel,
//                          dist, steps) state.
//
// What bounds K1 on this card: one thread per ray runs a divergent loop of
// a few iterations (about 2.6 DDA steps a ray on the 512^3 1080p frames),
// each about a hundred instructions, and every change of coarse cell is a
// dependent read of the int16 Morton table (32 MiB at 512^3, resident in
// the 50 MB L2). Its byte bound (the ray I/O and the table words its rays
// touch, at the HBM rate) is about half its time or less: it is bound by
// instruction issue and by the latency of each ray's dependent chain of
// loads, not by bytes. Tensor cores have no part in it: a DDA step is a
// compare-and-select on scalars whose next table address depends on the
// last.
//
// What the design does about it:
//   * one instantiation per launch mode, march_shade_kernel<kMode,
//     kShadows> (march only; flat, lambert or full shading; lambert or
//     full with the in-kernel shadow marches), each carrying only the
//     code it runs, with its own __launch_bounds__ and no spills: 8
//     blocks of 256 threads an SM for the march-only and flat launches
//     (32 registers), 6 for lambert and full (at most 40), 5 with the
//     shadow marches (at most 48: the primary hit stays live across
//     them); the shadow visibility is one bit a light. The march-only and
//     lambert launches no longer carry the registers of the shadow march;
//   * fewer instructions a step: the faces the ray leaves by are
//     integers (2c - 2(D-1), 2c + 2D, v, v + 1), formed exactly as a
//     masked voxel index plus one of two offsets picked per step, one
//     face an axis, and converted once; the voxel index is clamped in
//     float and truncated once (no separate floor); the grid sizes are
//     kernel parameters (constant memory); the cell's word is read only
//     when a coordinate changes above its lowest bit;
//   * the Morton index of a cell from a dilation table in shared memory,
//     filled once a block (entry v: part1by2(v >> 1), max(X, Y, Z)
//     entries): three shared loads and two shifted ORs instead of three
//     part1by2 (about thirty integer instructions);
//   * the current cell's word stays in registers, so steps inside one
//     occupied 2x2x2 cell read nothing, and an empty cell's -D word jumps
//     the ray across the whole provably-empty box. The material / RGB8
//     word is read once per hit ray.
// Tried on the card and dropped (numbers in PERF.md): dilated coordinates
// carried in registers (stepped by dilated add or subtract, formed anew
// after a jump) instead of the table.
//
// The resume kernel (K1') shares the march (march_ray<true>) and the
// table: the same bound and design, one more read per resumed ray for its
// cell's word. The shade kernel (K2) shares the epilogue.
//
// Floating point: built with -fmad=false and without fast math, so every
// add, multiply, divide and sqrtf rounds as the plain PyTorch version's
// element-wise ops do and DDA boundaries land on the same voxels. The
// faces are exact integers however they are formed, and clamp-then-
// truncate gives floor-then-clamp's integer for every float but NaN, so
// every output field equals the plain version's bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

// Mirror of _ShadeParams in vxtpu_torch/render/kernel_march.py: the
// epilogue's constants, passed by value. The lights come as a device
// float[8][8] (row l: x, y, z, r, g, b, intensity, 0), so a frame never
// copies them to the host.
struct ShadeParams {
  int mode;  // 0 flat, 1 lambert, 2 full (lambert + Blinn-Phong)
  int shadows;  // in-kernel shadow marches (n_lights > 0, mode != flat)
  int rgb8;     // mats holds fine-voxel RGB8 words, else 3-bit material ids
  int fog;
  int n_lights;
  int use_vis;  // shade_kernel: per-light visibility is an input
  float ambient, specular_exp, specular_k, fog_density;
  float sky_top[3];
  float sky_horizon[3];
  float palette[8][3];
};

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-4f;        // reinit samples the voxel at t + EPS
constexpr float kBig = 3.0e30f;      // 1/d where |d| < 1e-12
constexpr float kBigT = 1e30f;       // t of a miss
constexpr float kShadowEps = 1e-3f;  // shadow-ray origin nudge

// The instantiations of march_shade_kernel are numbered by a variant id
// (render/kernel_march.py:K1_VARIANTS): 0 march only (kMode -1: no
// epilogue), 1 + mode for each shading mode, 3 + mode for the lit modes
// with their in-kernel shadow marches.

// blocks of kThreads an SM must hold (kMode -1: march only): 8, at most 32
// registers, where the kernel marches and at most shades flat; 6, at most
// 40, where it lights the hit; 5, at most 48, where it also marches to the
// lights (the primary hit stays live across the shadow march)
constexpr int min_blocks(int mode, bool shadows) {
  return shadows ? 5 : (mode < 1 ? 8 : 6);
}

// grid sizes, passed by value (kernel parameters live in constant memory,
// not in registers)
struct Grid {
  int X, Y, Z;             // fine dims
  float fX, fY, fZ;        // the same, as floats
  float fXm1, fYm1, fZm1;  // the largest voxel index on each axis
  int n_dil;               // entries of the dilation table: max(X, Y, Z)
};

struct MarchResult {
  int hit;
  float t;
  int vx, vy, vz;
  int ax, sg;  // face axis and DDA step sign of the hit
  int steps;
  // resume mode only: the ray ended (hit, left the grid, passed t_max, or
  // was dead); the dist channel (-2: the entry fetch is still pending)
  int done, dist;
};

// Resume-mode state of one ray (vxtpu's resume_state): the voxel, the dist
// channel (-1 a dead slot, -2 the entry fetch is pending, else the current
// cell's empty-box radius) and the steps of earlier rounds. given == 0
// starts the ray at the slab clip's entry voxel, as K1 does.
struct ResumeIn {
  int given;
  int vx, vy, vz, dist, steps;
};

__device__ __forceinline__ int part1by2(int v) {
  v &= 0x3FF;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

__device__ __forceinline__ int morton3(int x, int y, int z) {
  return part1by2(x) | (part1by2(y) << 1) | (part1by2(z) << 2);
}

// The block's dilation table, in shared memory: entry v is part1by2(v >> 1),
// the dilated coarse coordinate of fine voxel coordinate v, so the Morton
// index of a voxel's cell is three shared loads, two shifts and two ORs
// (not three part1by2). Every thread of the block must call this before
// any returns.
__device__ __forceinline__ void fill_dilation(int* dil, const Grid& g) {
  for (int v = threadIdx.x; v < g.n_dil; v += kThreads)
    dil[v] = part1by2(v >> 1);
  __syncthreads();
}

__device__ __forceinline__ int cell_index(const int* dil, int vx, int vy,
                                          int vz) {
  return dil[vx] | (dil[vy] << 1) | (dil[vz] << 2);
}

__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) < 1e-12f ? kBig : 1.0f / d;
}

// clamp to [0, m] in float, then convert (truncating): for a p in range
// that is floor(p), outside it 0 or m. The plain version floors first,
// then clamps and converts: the same integer for every p but NaN, which
// no valid ray reaches (here NaN gives 0, as floor-then-clamp did)
__device__ __forceinline__ int clip_floor(float p, float m) {
  return (int)fminf(fmaxf(p, 0.0f), m);
}

// the child bit of a voxel in its cell's word w (0 for an empty cell's -D)
__device__ __forceinline__ bool child_bit(int w, int vx, int vy, int vz) {
  const int ci = ((vx & 1) << 2) | ((vy & 1) << 1) | (vz & 1);
  return w > 0 && ((w >> ci) & 1) != 0;
}

// t at which the ray reaches `face` (an integer) on one axis
__device__ __forceinline__ float face_t(int face, float o, float d,
                                        float iv) {
  const float t = ((float)face - o) * iv;
  return fabsf(d) < 1e-12f ? kBig : t;
}

// The march of one ray (vxtpu's run_march closure, per ray): slab clip to
// [0,X]x[0,Y]x[0,Z] capped at t_max, an entry fetch at the entry voxel
// (not a step), then DDA advances until a hit, leaving the grid, passing
// t_max, or iter_cap iterations (the entry fetch counts as one).
//
// kResume (march_resume_kernel; K1 instantiates it false, and then none of
// the resume code exists): the ray starts from `rin` when it is given. A
// dead slot (dist -1) or an invalid ray is done at once; a pending one
// (dist -2) fetches its given voxel as the entry voxel, with the entry t
// and face of the slab clip; any other ray continues from (voxel, dist),
// its iteration count starting at 0 and its steps at rin.steps. A resumed
// ray has no word in registers yet, so it first reads its current cell's
// word (vxtpu's cbok carry): that read is neither a step nor an iteration.
// With iter_cap < 1 nothing runs, and a pending ray reports dist -2.
template <bool kResume>
__device__ __forceinline__ MarchResult
march_ray(float ox, float oy, float oz, float dx, float dy, float dz,
          float t_max, const int16_t* __restrict__ occ, const int* dil,
          const Grid& g, int iter_cap, ResumeIn rin = ResumeIn{}) {
  MarchResult r;
  r.hit = 0;
  r.t = kBigT;
  r.ax = 0;
  r.sg = 0;
  r.steps = 0;
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
  const float t_end = fminf(t_exit, t_max);
  const bool valid = (t_enter <= t_exit) && (t_enter <= t_end);

  int vx = clip_floor(ox + (t_enter + kEps) * dx, g.fXm1);
  int vy = clip_floor(oy + (t_enter + kEps) * dy, g.fYm1);
  int vz = clip_floor(oz + (t_enter + kEps) * dz, g.fZm1);
  bool entry = true;  // the first iteration fetches the entry voxel
  int it = 1;         // the entry fetch counts as an iteration
  if constexpr (kResume) {
    r.done = 1;
    r.dist = 0;
    if (rin.given) {
      vx = min(max(rin.vx, 0), g.X - 1);
      vy = min(max(rin.vy, 0), g.Y - 1);
      vz = min(max(rin.vz, 0), g.Z - 1);
      r.steps = rin.steps;
      r.dist = max(rin.dist, 0);
      entry = rin.dist == -2;
    }
    r.vx = vx;
    r.vy = vy;
    r.vz = vz;
    if (!valid || (rin.given && rin.dist == -1)) return r;
    r.done = 0;
    if (iter_cap < 1) {
      if (entry) r.dist = -2;
      return r;
    }
  } else {
    r.vx = vx;
    r.vy = vy;
    r.vz = vz;
    if (!valid) return r;
  }

  // entry fetch: the entry face is the axis with the largest near-slab t,
  // ties toward the lowest axis. w: the current cell's word (child bits,
  // or -D of an empty cell); dist: the empty-box radius the march uses
  int w = __ldg(occ + cell_index(dil, vx, vy, vz));
  int dist = max(-w, 0);
  if constexpr (kResume) {
    if (!entry) {  // a resumed ray: the word gave its cell's child bits
      dist = r.dist;
      it = 0;
    }
  }
  if (entry && child_bit(w, vx, vy, vz)) {
    const float tn_max = fmaxf(fmaxf(nx, ny), nz);
    r.hit = 1;
    r.t = t_enter;
    r.ax = nx >= tn_max ? 0 : (ny >= tn_max ? 1 : 2);
    r.sg = (r.ax == 0 ? dx : (r.ax == 1 ? dy : dz)) >= 0.0f ? 1 : -1;
    if constexpr (kResume) {
      r.done = 1;
      r.dist = dist;
    }
    return r;
  }

  for (; it < iter_cap; ++it) {
    // the faces the ray leaves by: of the empty box [2c - 2(dist-1),
    // 2c + 2 dist) where dist > 0, else of the voxel [v, v + 1). One face
    // an axis, the one the ray's direction picks, formed as an exact
    // integer: the voxel index with its low bit masked in a box, plus one
    // of two offsets
    const int base = ~min(dist, 1);
    const int hi = max(2 * dist, 1);
    const int lo = min(2 - 2 * dist, 0);
    const float tx = face_t((vx & base) + (dx >= 0.0f ? hi : lo), ox, dx, ivx);
    const float ty = face_t((vy & base) + (dy >= 0.0f ? hi : lo), oy, dy, ivy);
    const float tz = face_t((vz & base) + (dz >= 0.0f ? hi : lo), oz, dz, ivz);
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
      // progress guard: rounding re-landed in the same voxel -> one DDA
      // step along the crossing axis
      const int fx_ = vx + (dx >= 0.0f ? 1 : -1);
      const int fy_ = vy + (dy >= 0.0f ? 1 : -1);
      const int fz_ = vz + (dz >= 0.0f ? 1 : -1);
      if (mx) nvx = min(max(fx_, 0), g.X - 1);
      if (my) nvy = min(max(fy_, 0), g.Y - 1);
      if (mz) nvz = min(max(fz_, 0), g.Z - 1);
      inside = (mx && fx_ >= 0 && fx_ < g.X) || (my && fy_ >= 0 && fy_ < g.Y) ||
               (mz && fz_ >= 0 && fz_ < g.Z);
    }
    if (!inside || t_new > t_end) {
      if constexpr (kResume) r.done = 1;
      break;
    }

    // the word is a function of the cell: read it only when a coordinate
    // changes above its lowest bit (a step inside an occupied cell
    // resolves from the child bits already in registers)
    const bool new_cell = ((nvx ^ vx) | (nvy ^ vy) | (nvz ^ vz)) > 1;
    vx = nvx;
    vy = nvy;
    vz = nvz;
    ++r.steps;
    if (new_cell) {
      w = __ldg(occ + cell_index(dil, vx, vy, vz));
      dist = max(-w, 0);
    }
    if (child_bit(w, vx, vy, vz)) {
      r.hit = 1;
      r.t = t_new;
      r.ax = mx ? 0 : (my ? 1 : 2);
      r.sg = (mx ? dx : (my ? dy : dz)) >= 0.0f ? 1 : -1;
      if constexpr (kResume) r.done = 1;
      break;
    }
  }
  r.vx = vx;
  r.vy = vy;
  r.vz = vz;
  if constexpr (kResume) r.dist = dist;
  return r;
}

// Per-light visibility as the shade epilogue reads it: a row of the [N, L]
// input (shade_kernel; none: every light visible), or one bit a light set
// where the in-kernel shadow march hit (0)
struct VisRow {
  const float* p;  // null: every light visible
  __device__ float operator[](int li) const { return p ? p[li] : 1.0f; }
};
struct VisBits {
  unsigned bits;
  __device__ float operator[](int li) const {
    return (bits >> li) & 1u ? 0.0f : 1.0f;
  }
};

// The shade epilogue for one pixel (vxtpu's _shade_epilogue): albedo from
// the material word (3-bit child id -> palette) or the RGB8 word; flat,
// lambert or lambert + Blinn-Phong per light with attenuation
// I / (1 + 0.002 d^2) and visibility; fog; the sky gradient on a miss.
// mode: P.mode, or the instantiation's own where it is known at compile
// time (then only its branch is compiled).
template <class Vis>
__device__ __forceinline__ void shade_pixel(
    const ShadeParams& P, int mode, const float* __restrict__ lights,
    const int32_t* __restrict__ mats, int mats_len, bool hit, float t, int vx,
    int vy, int vz, float nx, float ny, float nz, float ox, float oy, float oz,
    float dx, float dy, float dz, Vis vis, float* out) {
  int w = 0;
  if (hit) {
    const int idx = P.rgb8 ? morton3(vx, vy, vz)
                           : morton3(vx >> 1, vy >> 1, vz >> 1);
    if (idx >= 0 && idx < mats_len) w = __ldg(mats + idx);
  }
  float pr, pg, pb;
  if (P.rgb8) {
    pr = (float)(w & 255) * (1.0f / 255.0f);
    pg = (float)((w >> 8) & 255) * (1.0f / 255.0f);
    pb = (float)((w >> 16) & 255) * (1.0f / 255.0f);
  } else {
    const int ci = ((vx & 1) << 2) | ((vy & 1) << 1) | (vz & 1);
    const int mid = (w >> (3 * ci)) & 7;
    pr = P.palette[mid][0];
    pg = P.palette[mid][1];
    pb = P.palette[mid][2];
  }
  if (!hit) {
    nx = ny = nz = 0.0f;
  }
  const float t_s = hit ? t : 0.0f;
  float ar, ag, ab;
  if (mode == 0) {
    float fw = 0.80f * fabsf(nx) + 0.68f * fabsf(ny) + 1.00f * fabsf(nz);
    if (nz < -0.5f) fw = 0.45f;
    ar = pr * fw;
    ag = pg * fw;
    ab = pb * fw;
  } else {
    const float px = ox + t_s * dx + nx * kShadowEps;
    const float py = oy + t_s * dy + ny * kShadowEps;
    const float pz = oz + t_s * dz + nz * kShadowEps;
    ar = pr * P.ambient;
    ag = pg * P.ambient;
    ab = pb * P.ambient;
    for (int li = 0; li < P.n_lights; ++li) {
      const float* L = lights + 8 * li;
      const float lvx = L[0] - px, lvy = L[1] - py, lvz = L[2] - pz;
      const float dist2 = lvx * lvx + lvy * lvy + lvz * lvz;
      const float rinv = 1.0f / sqrtf(fmaxf(dist2, 1e-12f));
      const float ldx = lvx * rinv, ldy = lvy * rinv, ldz = lvz * rinv;
      const float ndotl = fmaxf(nx * ldx + ny * ldy + nz * ldz, 0.0f);
      const float atten = L[6] / (1.0f + 0.002f * dist2);
      const float v = vis[li];
      const float diff = ndotl * atten * v;
      ar = ar + pr * diff * L[3];
      ag = ag + pg * diff * L[4];
      ab = ab + pb * diff * L[5];
      if (mode == 2) {
        const float hx = ldx - dx, hy = ldy - dy, hz = ldz - dz;
        const float hn = 1.0f / sqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-12f));
        const float ndoth = fmaxf((nx * hx + ny * hy + nz * hz) * hn, 0.0f);
        const float sp = P.specular_k * powf(ndoth, P.specular_exp) *
                         (ndotl > 0.0f ? 1.0f : 0.0f) * atten * v;
        ar = ar + sp * L[3];
        ag = ag + sp * L[4];
        ab = ab + sp * L[5];
      }
    }
  }
  const float u = fminf(fmaxf(dz * 0.5f + 0.5f, 0.0f), 1.0f);
  const float skr = P.sky_horizon[0] * (1.0f - u) + P.sky_top[0] * u;
  const float skg = P.sky_horizon[1] * (1.0f - u) + P.sky_top[1] * u;
  const float skb = P.sky_horizon[2] * (1.0f - u) + P.sky_top[2] * u;
  if (P.fog) {
    const float fog_f = hit ? 1.0f - expf(-P.fog_density * t_s) : 0.0f;
    ar = ar * (1.0f - fog_f) + skr * fog_f;
    ag = ag * (1.0f - fog_f) + skg * fog_f;
    ab = ab * (1.0f - fog_f) + skb * fog_f;
  }
  out[0] = fminf(fmaxf(hit ? ar : skr, 0.0f), 1.0f);
  out[1] = fminf(fmaxf(hit ? ag : skg, 0.0f), 1.0f);
  out[2] = fminf(fmaxf(hit ? ab : skb, 0.0f), 1.0f);
}

// One instantiation per launch mode, so that each carries only the code
// it runs: kMode -1 marches only (no epilogue, no material read); 0 flat,
// 1 lambert, 2 full shade in the kernel; kShadows adds one shadow march per
// light from the hit point (lit modes only).
template <int kMode, bool kShadows>
__global__ void __launch_bounds__(kThreads, min_blocks(kMode, kShadows))
march_shade_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_max, int n,
                   const int16_t* __restrict__ occ, const Grid g,
                   int iter_cap, const int32_t* __restrict__ mats,
                   int mats_len, const float* __restrict__ lights,
                   const ShadeParams P, uint8_t* __restrict__ hit_out,
                   float* __restrict__ t_out, int32_t* __restrict__ vox_out,
                   float* __restrict__ nrm_out,
                   int32_t* __restrict__ steps_out,
                   float* __restrict__ rgb_out) {
  extern __shared__ int dil[];
  fill_dilation(dil, g);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tm = t_max ? t_max[i] : kBigT;
  const MarchResult r =
      march_ray<false>(ox, oy, oz, dx, dy, dz, tm, occ, dil, g, iter_cap);
  const bool hit = r.hit != 0;
  const float sgf = -(float)r.sg;
  const float nx = hit && r.ax == 0 ? sgf : 0.0f;
  const float ny = hit && r.ax == 1 ? sgf : 0.0f;
  const float nz = hit && r.ax == 2 ? sgf : 0.0f;
  hit_out[i] = hit ? 1 : 0;
  t_out[i] = r.t;
  vox_out[3 * i] = r.vx;
  vox_out[3 * i + 1] = r.vy;
  vox_out[3 * i + 2] = r.vz;
  nrm_out[3 * i] = nx;
  nrm_out[3 * i + 1] = ny;
  nrm_out[3 * i + 2] = nz;
  steps_out[i] = r.steps;
  if constexpr (kShadows) {
    static_assert(kMode > 0, "shadow marches need a lit mode");
    // second march per light, from the hit point nudged off the face
    // toward the light, capped at dist - 2 eps; skipped for misses and
    // where n.l <= 0 (both light terms are zero there). A light whose
    // march hits sets its bit: visibility 0
    unsigned shadowed = 0;
    const float t_s = hit ? r.t : 0.0f;
    const float px = hit ? ox + t_s * dx + nx * kShadowEps : 0.0f;
    const float py = hit ? oy + t_s * dy + ny * kShadowEps : 0.0f;
    const float pz = hit ? oz + t_s * dz + nz * kShadowEps : 0.0f;
    for (int li = 0; li < P.n_lights; ++li) {
      const float* L = lights + 8 * li;
      const float lvx = L[0] - px, lvy = L[1] - py, lvz = L[2] - pz;
      const float ldist = sqrtf(lvx * lvx + lvy * lvy + lvz * lvz);
      const float dn = fmaxf(ldist, 1e-12f);
      const float ldx = lvx / dn, ldy = lvy / dn, ldz = lvz / dn;
      const float ndl = nx * ldx + ny * ldy + nz * ldz;
      if (hit && ndl > 0.0f) {
        const MarchResult s =
            march_ray<false>(px, py, pz, ldx, ldy, ldz,
                             ldist - 2.0f * kShadowEps, occ, dil, g, iter_cap);
        if (s.hit) shadowed |= 1u << li;
      }
    }
    shade_pixel(P, kMode, lights, mats, mats_len, hit, r.t, r.vx, r.vy, r.vz,
                nx, ny, nz, ox, oy, oz, dx, dy, dz, VisBits{shadowed},
                rgb_out + 3 * i);
  } else if constexpr (kMode >= 0) {
    shade_pixel(P, kMode, lights, mats, mats_len, hit, r.t, r.vx, r.vy, r.vz,
                nx, ny, nz, ox, oy, oz, dx, dy, dz, VisRow{nullptr},
                rgb_out + 3 * i);
  }
}

// One march-only round per ray (K1's march_ray in resume mode): the
// HitRecord plus done and the dist channel. rvox / rdist / rsteps are the
// resume state, or all null to start every ray at its entry voxel.
__global__ void __launch_bounds__(kThreads)
march_resume_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_max, int n,
                    const int32_t* __restrict__ rvox,
                    const int32_t* __restrict__ rdist,
                    const int32_t* __restrict__ rsteps,
                    const int16_t* __restrict__ occ, const Grid g,
                    int iter_cap, uint8_t* __restrict__ hit_out,
                    float* __restrict__ t_out, int32_t* __restrict__ vox_out,
                    float* __restrict__ nrm_out,
                    int32_t* __restrict__ steps_out,
                    uint8_t* __restrict__ done_out,
                    int32_t* __restrict__ dist_out) {
  extern __shared__ int dil[];
  fill_dilation(dil, g);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  ResumeIn rin = {0, 0, 0, 0, 0, 0};
  if (rvox != nullptr) {
    rin.given = 1;
    rin.vx = rvox[3 * i];
    rin.vy = rvox[3 * i + 1];
    rin.vz = rvox[3 * i + 2];
    rin.dist = rdist[i];
    rin.steps = rsteps[i];
  }
  const MarchResult r = march_ray<true>(
      o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i], d[3 * i + 1],
      d[3 * i + 2], t_max ? t_max[i] : kBigT, occ, dil, g, iter_cap, rin);
  const bool hit = r.hit != 0;
  const float sgf = -(float)r.sg;
  hit_out[i] = hit ? 1 : 0;
  t_out[i] = r.t;
  vox_out[3 * i] = r.vx;
  vox_out[3 * i + 1] = r.vy;
  vox_out[3 * i + 2] = r.vz;
  nrm_out[3 * i] = hit && r.ax == 0 ? sgf : 0.0f;
  nrm_out[3 * i + 1] = hit && r.ax == 1 ? sgf : 0.0f;
  nrm_out[3 * i + 2] = hit && r.ax == 2 ? sgf : 0.0f;
  steps_out[i] = r.steps;
  done_out[i] = r.done ? 1 : 0;
  dist_out[i] = r.dist;
}

__global__ void __launch_bounds__(kThreads)
shade_kernel(const float* __restrict__ o, const float* __restrict__ d,
             const uint8_t* __restrict__ hit, const float* __restrict__ t,
             const int32_t* __restrict__ vox, const float* __restrict__ nrm,
             const float* __restrict__ vis, int n,
             const int32_t* __restrict__ mats, int mats_len,
             const float* __restrict__ lights, ShadeParams P,
             float* __restrict__ rgb_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool h = hit[i] != 0;
  const float ti = t[i];
  const int vx = vox[3 * i], vy = vox[3 * i + 1], vz = vox[3 * i + 2];
  const float nx = nrm[3 * i], ny = nrm[3 * i + 1], nz = nrm[3 * i + 2];
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  shade_pixel(P, P.mode, lights, mats, mats_len, h, ti, vx, vy, vz, nx, ny, nz,
              ox, oy, oz, dx, dy, dz,
              VisRow{P.use_vis ? vis + (size_t)i * P.n_lights : nullptr},
              rgb_out + 3 * i);
}

// The instantiation of each variant id
const void* march_shade_variant(int variant) {
  switch (variant) {
    case 0: return (const void*)march_shade_kernel<-1, false>;
    case 1: return (const void*)march_shade_kernel<0, false>;
    case 2: return (const void*)march_shade_kernel<1, false>;
    case 3: return (const void*)march_shade_kernel<2, false>;
    case 4: return (const void*)march_shade_kernel<1, true>;
    case 5: return (const void*)march_shade_kernel<2, true>;
    default: return nullptr;
  }
}

Grid make_grid(int X, int Y, int Z) {
  return Grid{X,
              Y,
              Z,
              (float)X,
              (float)Y,
              (float)Z,
              (float)(X - 1),
              (float)(Y - 1),
              (float)(Z - 1),
              X > Y ? (X > Z ? X : Z) : (Y > Z ? Y : Z)};
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches its kernel on
// `stream` and returns cudaGetLastError(); nothing here synchronises.

// params null: march only; else the instantiation of its mode and shadows
// flag marches and shades (a mode outside 0..2 launches nothing and
// returns cudaErrorInvalidValue).
extern "C" int vx_march_shade(const float* o, const float* d,
                              const float* t_max, int n, const int16_t* occ,
                              int X, int Y, int Z, int iter_cap,
                              const int32_t* mats, const float* lights,
                              const ShadeParams* params, uint8_t* hit,
                              float* t, int32_t* vox, float* nrm,
                              int32_t* steps, float* rgb,
                              cudaStream_t stream) {
  ShadeParams P = {};
  int mats_len = 0;
  if (params != nullptr) {
    P = *params;
    if (P.mode < 0 || P.mode > 2) return (int)cudaErrorInvalidValue;
    const int cells = (X / 2) * (Y / 2) * (Z / 2);
    mats_len = P.rgb8 ? X * Y * Z : cells;
  }
  const void* fn =
      march_shade_variant(params ? (P.shadows ? 3 : 1) + P.mode : 0);
  Grid g = make_grid(X, Y, Z);
  void* args[] = {&o,    &d,      &t_max, &n,   &occ,   &g,
                  &iter_cap, &mats, &mats_len, &lights, &P, &hit,
                  &t,    &vox,    &nrm,   &steps, &rgb};
  const cudaError_t e = cudaLaunchKernel(
      fn, dim3((n + kThreads - 1) / kThreads), dim3(kThreads), args,
      sizeof(int) * g.n_dil, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// Blocks of a march_shade_kernel instantiation (by variant id) an SM holds
// at once with the dilation table of an X^3 grid (its occupancy, for the
// record); 0 for an unknown variant or a failed query.
extern "C" int vx_march_shade_blocks_per_sm(int variant, int X) {
  const void* fn = march_shade_variant(variant);
  int blocks = 0;
  if (fn == nullptr ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fn, kThreads, sizeof(int) * X) != cudaSuccess)
    return 0;
  return blocks;
}

extern "C" int vx_march_resume(const float* o, const float* d,
                               const float* t_max, int n,
                               const int32_t* rvox, const int32_t* rdist,
                               const int32_t* rsteps, const int16_t* occ,
                               int X, int Y, int Z, int iter_cap,
                               uint8_t* hit, float* t, int32_t* vox,
                               float* nrm, int32_t* steps, uint8_t* done,
                               int32_t* dist, cudaStream_t stream) {
  const Grid g = make_grid(X, Y, Z);
  const int blocks = (n + kThreads - 1) / kThreads;
  march_resume_kernel<<<blocks, kThreads, sizeof(int) * g.n_dil, stream>>>(
      o, d, t_max, n, rvox, rdist, rsteps, occ, g, iter_cap, hit, t, vox, nrm,
      steps, done, dist);
  return (int)cudaGetLastError();
}

extern "C" int vx_shade(const float* o, const float* d, const uint8_t* hit,
                        const float* t, const int32_t* vox, const float* nrm,
                        const float* vis, int n, const int32_t* mats,
                        int mats_len, const float* lights,
                        const ShadeParams* params, float* rgb,
                        cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  shade_kernel<<<blocks, kThreads, 0, stream>>>(o, d, hit, t, vox, nrm, vis,
                                                n, mats, mats_len, lights,
                                                *params, rgb);
  return (int)cudaGetLastError();
}

extern "C" const char* vx_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
