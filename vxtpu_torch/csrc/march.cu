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
// What bounds it on this card: one thread per ray runs a divergent loop
// whose every cell change is a dependent table read, so the march is
// latency-bound on those reads (one per step per ray), not on bandwidth
// or arithmetic. The design: the int16 Morton table (32 MB at 512^3) stays
// resident in the 50 MB L2 and is read with __ldg; the current coarse
// cell's child bits stay in registers, so steps inside one occupied 2x2x2
// cell read nothing; an empty cell's -D word jumps the ray across the whole
// provably-empty box. The material / RGB8 word is read once per hit ray.
//// The resume kernel shares the march (march_ray<true>): the same bound and
// design, one more read per resumed ray for its cell's child bits.
//
// Floating point: built with -fmad=false and without fast math, so every
// add, multiply, divide and sqrtf rounds as the plain PyTorch version's
// element-wise ops do and DDA boundaries land on the same voxels.

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
constexpr int kMaxLights = 8;
constexpr float kEps = 1e-4f;        // reinit samples the voxel at t + EPS
constexpr float kBig = 3.0e30f;      // 1/d where |d| < 1e-12
constexpr float kBigT = 1e30f;       // t of a miss
constexpr float kShadowEps = 1e-3f;  // shadow-ray origin nudge

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
// box [2c - 2(dist-1), 2c + 2 dist) of an empty cell (dist > 0) on one axis
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
// ray has no child bits in registers yet, so it first reads its current
// cell's word (vxtpu's cbok carry): that read is neither a step nor an
// iteration. With iter_cap < 1 nothing runs, and a pending ray reports
// dist -2.
template <bool kResume>
__device__ MarchResult march_ray(float ox, float oy, float oz, float dx,
                                 float dy, float dz, float t_max,
                                 const int16_t* __restrict__ occ, int X, int Y,
                                 int Z, int iter_cap,
                                 ResumeIn rin = ResumeIn{}) {
  MarchResult r;
  r.hit = 0;
  r.t = kBigT;
  r.ax = 0;
  r.sg = 0;
  r.steps = 0;
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
  const float t_end = fminf(t_exit, t_max);
  const bool valid = (t_enter <= t_exit) && (t_enter <= t_end);

  const int sgx = dx >= 0.0f ? 1 : -1;
  const int sgy = dy >= 0.0f ? 1 : -1;
  const int sgz = dz >= 0.0f ? 1 : -1;

  int vx = floor_clip(ox + (t_enter + kEps) * dx, X);
  int vy = floor_clip(oy + (t_enter + kEps) * dy, Y);
  int vz = floor_clip(oz + (t_enter + kEps) * dz, Z);
  bool entry = true;  // the first iteration fetches the entry voxel
  int it = 1;         // the entry fetch counts as an iteration
  if constexpr (kResume) {
    r.done = 1;
    r.dist = 0;
    if (rin.given) {
      vx = min(max(rin.vx, 0), X - 1);
      vy = min(max(rin.vy, 0), Y - 1);
      vz = min(max(rin.vz, 0), Z - 1);
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
  // ties toward the lowest axis
  int w = __ldg(occ + morton3(vx >> 1, vy >> 1, vz >> 1));
  int cb = max(w, 0);
  int dist = max(-w, 0);
  if constexpr (kResume) {
    if (!entry) {  // a resumed ray: the word gave its cell's child bits
      dist = r.dist;
      it = 0;
    }
  }
  if (entry && child_bit(cb, vx, vy, vz)) {
    const float tn_max = fmaxf(fmaxf(nx, ny), nz);
    r.hit = 1;
    r.t = t_enter;
    r.ax = nx >= tn_max ? 0 : (ny >= tn_max ? 1 : 2);
    r.sg = r.ax == 0 ? sgx : (r.ax == 1 ? sgy : sgz);
    if constexpr (kResume) {
      r.done = 1;
      r.dist = dist;
    }
    return r;
  }

  for (; it < iter_cap; ++it) {
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
      // progress guard: rounding re-landed in the same voxel -> one DDA
      // step along the crossing axis
      const int fx_ = vx + sgx, fy_ = vy + sgy, fz_ = vz + sgz;
      if (mx) nvx = min(max(fx_, 0), X - 1);
      if (my) nvy = min(max(fy_, 0), Y - 1);
      if (mz) nvz = min(max(fz_, 0), Z - 1);
      inside = (mx && fx_ >= 0 && fx_ < X) || (my && fy_ >= 0 && fy_ < Y) ||
               (mz && fz_ >= 0 && fz_ < Z);
    }
    if (!inside || t_new > t_end) {
      if constexpr (kResume) r.done = 1;
      break;
    }

    // a step inside the current occupied cell resolves from the child
    // bits already in registers; any other step reads the target's word
    const bool same_cell = (nvx >> 1) == (vx >> 1) &&
                           (nvy >> 1) == (vy >> 1) && (nvz >> 1) == (vz >> 1);
    if (!(same_cell && dist == 0)) {
      w = __ldg(occ + morton3(nvx >> 1, nvy >> 1, nvz >> 1));
      cb = max(w, 0);
      dist = max(-w, 0);
    }
    vx = nvx;
    vy = nvy;
    vz = nvz;
    ++r.steps;
    if (child_bit(cb, vx, vy, vz)) {
      r.hit = 1;
      r.t = t_new;
      r.ax = mx ? 0 : (my ? 1 : 2);
      r.sg = mx ? sgx : (my ? sgy : sgz);
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

// The shade epilogue for one pixel (vxtpu's _shade_epilogue): albedo from
// the material word (3-bit child id -> palette) or the RGB8 word; flat,
// lambert or lambert + Blinn-Phong per light with attenuation
// I / (1 + 0.002 d^2) and visibility; fog; the sky gradient on a miss.
__device__ void shade_pixel(const ShadeParams& P,
                            const float* __restrict__ lights,
                            const int32_t* __restrict__ mats, int mats_len,
                            bool hit, float t, int vx, int vy, int vz,
                            float nx, float ny, float nz, float ox, float oy,
                            float oz, float dx, float dy, float dz,
                            const float* vis, float* out) {
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
  if (P.mode == 0) {
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
      const float v = vis ? vis[li] : 1.0f;
      const float diff = ndotl * atten * v;
      ar = ar + pr * diff * L[3];
      ag = ag + pg * diff * L[4];
      ab = ab + pb * diff * L[5];
      if (P.mode == 2) {
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

__global__ void __launch_bounds__(kThreads)
march_shade_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ t_max, int n,
                   const int16_t* __restrict__ occ, int X, int Y, int Z,
                   int iter_cap, const int32_t* __restrict__ mats,
                   int mats_len, const float* __restrict__ lights,
                   ShadeParams P, int do_shade,
                   uint8_t* __restrict__ hit_out, float* __restrict__ t_out,
                   int32_t* __restrict__ vox_out, float* __restrict__ nrm_out,
                   int32_t* __restrict__ steps_out,
                   float* __restrict__ rgb_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float tm = t_max ? t_max[i] : kBigT;
  const MarchResult r =
      march_ray<false>(ox, oy, oz, dx, dy, dz, tm, occ, X, Y, Z, iter_cap);
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
  if (!do_shade) return;

  float vis[kMaxLights];
  if (P.shadows) {
    // second march per light, from the hit point nudged off the face
    // toward the light, capped at dist - 2 eps; skipped for misses and
    // where n.l <= 0 (both light terms are zero there)
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
      vis[li] = 1.0f;
      if (hit && ndl > 0.0f) {
        const MarchResult s = march_ray<false>(px, py, pz, ldx, ldy, ldz,
                                        ldist - 2.0f * kShadowEps, occ, X, Y,
                                        Z, iter_cap);
        if (s.hit) vis[li] = 0.0f;
      }
    }
  }
  shade_pixel(P, lights, mats, mats_len, hit, r.t, r.vx, r.vy, r.vz, nx, ny,
              nz, ox, oy, oz, dx, dy, dz, P.shadows ? vis : nullptr,
              rgb_out + 3 * i);
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
                    const int16_t* __restrict__ occ, int X, int Y, int Z,
                    int iter_cap, uint8_t* __restrict__ hit_out,
                    float* __restrict__ t_out, int32_t* __restrict__ vox_out,
                    float* __restrict__ nrm_out,
                    int32_t* __restrict__ steps_out,
                    uint8_t* __restrict__ done_out,
                    int32_t* __restrict__ dist_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
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
      d[3 * i + 2], t_max ? t_max[i] : kBigT, occ, X, Y, Z, iter_cap, rin);
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
  shade_pixel(P, lights, mats, mats_len, hit[i] != 0, t[i], vox[3 * i],
              vox[3 * i + 1], vox[3 * i + 2], nrm[3 * i], nrm[3 * i + 1],
              nrm[3 * i + 2], o[3 * i], o[3 * i + 1], o[3 * i + 2], d[3 * i],
              d[3 * i + 1], d[3 * i + 2],
              P.use_vis ? vis + (size_t)i * P.n_lights : nullptr,
              rgb_out + 3 * i);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches its kernel on
// `stream` and returns cudaGetLastError(); nothing here synchronises.

extern "C" int vx_march_shade(const float* o, const float* d,
                              const float* t_max, int n, const int16_t* occ,
                              int X, int Y, int Z, int iter_cap,
                              const int32_t* mats, const float* lights,
                              const ShadeParams* params, uint8_t* hit,
                              float* t, int32_t* vox, float* nrm,
                              int32_t* steps, float* rgb,
                              cudaStream_t stream) {
  ShadeParams P = {};
  int do_shade = 0;
  int mats_len = 0;
  if (params != nullptr) {
    P = *params;
    do_shade = 1;
    const int cells = (X / 2) * (Y / 2) * (Z / 2);
    mats_len = P.rgb8 ? X * Y * Z : cells;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  march_shade_kernel<<<blocks, kThreads, 0, stream>>>(
      o, d, t_max, n, occ, X, Y, Z, iter_cap, mats, mats_len, lights, P,
      do_shade, hit, t, vox, nrm, steps, rgb);
  return (int)cudaGetLastError();
}

extern "C" int vx_march_resume(const float* o, const float* d,
                               const float* t_max, int n,
                               const int32_t* rvox, const int32_t* rdist,
                               const int32_t* rsteps, const int16_t* occ,
                               int X, int Y, int Z, int iter_cap,
                               uint8_t* hit, float* t, int32_t* vox,
                               float* nrm, int32_t* steps, uint8_t* done,
                               int32_t* dist, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  march_resume_kernel<<<blocks, kThreads, 0, stream>>>(
      o, d, t_max, n, rvox, rdist, rsteps, occ, X, Y, Z, iter_cap, hit, t,
      vox, nrm, steps, done, dist);
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
