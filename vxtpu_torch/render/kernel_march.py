"""The hard-voxel march + shade kernel and its plain PyTorch version.

Counterpart of ``vxtpu/render/kernel_pallas_v2.py``: ``march`` replaces
``march_pallas_v2`` (the ``_march_kernel`` Pallas kernel: DDA march over
the Morton signed-word table, optional per-light shadow marches in the
same dispatch, shade epilogue) and ``shade`` replaces ``shade_pallas_v2``
(``_shade_only_kernel``: the epilogue alone, on a stored HitRecord plus
per-light visibility). Both kernels are hand-written CUDA C++ in
``vxtpu_torch/csrc/march.cu``, built for sm_90a at first use.

What bounds the kernel on an H100: one thread per ray marches a
divergent, data-dependent loop of about a hundred instructions a step,
and every step that leaves a 2x2x2 cell reads one table word, so the
march is bound by instruction issue and the latency of dependent table
reads, not by bandwidth. What the design does about it (the header of
``csrc/march.cu`` has the details): one instantiation of the kernel per
launch mode (``K1_VARIANTS``; ``k1_variant`` picks it from the
ShadeSpec), each with only the registers its own code needs; one integer
face per axis a step; the Morton index of a cell from a dilation table in
shared memory; the int16 Morton table (32 MiB at 512^3) read through the
read-only path from the 50 MB L2; a cell's child bits kept in registers,
so steps inside one occupied cell read nothing; empty space crossed in one
jump per empty box. The material or RGB8 word is read once per hit ray.
None of the TPU machinery (row windows, one-hot MXU fetch, bf16 casts,
[8,128] tiles, tuning knobs, per-tile iteration counters) carries over.

Resume mode (vxtpu's ``iter_budget``, ``resume_state`` and ``extended``
arguments of ``march_pallas_v2``) launches ``march_resume_kernel``, the
same march in a march-only round capped at a number of iterations per ray
that restarts from a stored (voxel, dist, steps) state. ``march_sorted``
replaces ``march_pallas_v2_sorted``: a capped round 0, then resume rounds
over the survivors sorted by Morton cell, until every ray is done.

On a CUDA tensor ``march`` and ``shade`` launch the kernel (or raise);
on a CPU tensor they run ``march_reference`` / ``shade_reference``, the
plain versions with the same per-ray semantics, including ``steps``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.render.shade import SHADOW_EPS, shade_albedo
from vxtpu_torch.render.types import HitRecord
from vxtpu_torch.world.grid import MATERIAL_RGB
from vxtpu_torch.world.lights import Lights
from vxtpu_torch.world.packed import (PackedMorton, build_packed_morton,
                                      morton3)

EPS = 1e-4          # reinit samples the voxel at t + EPS
BIG = 3.0e30        # stands in for 1/d where |d| < 1e-12
BIG_T = 1e30        # t of a miss
MAX_LIGHTS = 8

# Kernel launches since the last reset_launch_counts(), by kernel name.
# Each wrapper adds one where it launches its kernel, and nowhere else.
LAUNCHES = {"march_shade_kernel": 0, "shade_kernel": 0,
            "march_resume_kernel": 0}

# The instantiations of march_shade_kernel (csrc/march.cu), in the order of
# their variant id: march only, each shading mode, and the lit modes with
# their in-kernel shadow marches. vx_march_shade picks one from the shade
# parameters as k1_variant does from the ShadeSpec. VARIANT_LAUNCHES
# counts the launches of each; LAUNCHES["march_shade_kernel"] counts them
# all.
K1_VARIANTS = ("march", "flat", "lambert", "full", "lambert_shadows",
               "full_shadows")
VARIANT_LAUNCHES = dict.fromkeys(K1_VARIANTS, 0)


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, VARIANT_LAUNCHES):
        for k in counts:
            counts[k] = 0


_MODES = {"flat": 0, "lambert": 1, "full": 2}


@dataclasses.dataclass(frozen=True)
class ShadeSpec:
    """Static configuration of the shade epilogue (vxtpu's ``ShadeSpec``
    without its TPU window size). palette: 8 RGB rows."""

    mode: str = "lambert"            # 'flat' | 'lambert' | 'full'
    shadows: bool = False            # in-kernel per-light shadow marches
    rgb8: bool = False               # mats = per-voxel RGB8 fine-Morton
    fog: bool = False
    n_lights: int = 1
    use_vis: bool = False            # per-light visibility is an input
    ambient: float = 0.15
    specular_exp: float = 32.0
    specular_k: float = 0.35
    fog_density: float = 0.004
    sky_top: tuple = (0.35, 0.55, 0.85)
    sky_horizon: tuple = (0.80, 0.88, 0.95)
    palette: tuple = MATERIAL_RGB

    @staticmethod
    def from_settings(settings: RenderSettings, lights: Lights,
                      use_vis: bool = False, shadows: bool | None = None,
                      rgb8: bool = False) -> "ShadeSpec":
        if shadows is None:
            shadows = bool(settings.shadows) and not use_vis
        return ShadeSpec(
            mode=settings.shading if settings.shading in _MODES else "lambert",
            shadows=shadows, rgb8=rgb8, fog=settings.fog,
            n_lights=lights.count, use_vis=use_vis,
            ambient=settings.ambient, specular_exp=settings.specular_exp,
            specular_k=settings.specular_k, fog_density=settings.fog_density,
            sky_top=tuple(settings.sky_top),
            sky_horizon=tuple(settings.sky_horizon))

    @property
    def runs_shadow_marches(self) -> bool:
        return self.shadows and self.n_lights > 0 and self.mode != "flat"

    def settings(self) -> RenderSettings:
        return RenderSettings(
            shading=self.mode, fog=self.fog, ambient=self.ambient,
            specular_exp=self.specular_exp, specular_k=self.specular_k,
            fog_density=self.fog_density, sky_top=self.sky_top,
            sky_horizon=self.sky_horizon)


def k1_variant(spec: "ShadeSpec | None") -> int:
    """The variant id (an index of K1_VARIANTS) of the instantiation of
    march_shade_kernel that marches, and shades as ``spec`` says (None:
    march only)."""
    if spec is None:
        return 0
    if spec.runs_shadow_marches:
        return 3 + _MODES[spec.mode]
    return 1 + _MODES[spec.mode]


def pack_lights(lights: Lights) -> torch.Tensor:
    """Lights -> float32 [8, 8]: row l = [x, y, z, r, g, b, intensity, 0];
    unused rows are zero."""
    if lights.count > MAX_LIGHTS:
        raise ValueError(f"at most {MAX_LIGHTS} lights, got {lights.count}")
    arr = torch.zeros((MAX_LIGHTS, 8), dtype=torch.float32,
                      device=lights.pos.device)
    n = lights.count
    arr[:n, 0:3] = lights.pos
    arr[:n, 3:6] = lights.rgb
    arr[:n, 6] = lights.intensity
    return arr


def unpack_lights(lights_arr: torch.Tensor, n_lights: int) -> Lights:
    return Lights(pos=lights_arr[:n_lights, 0:3],
                  rgb=lights_arr[:n_lights, 3:6],
                  intensity=lights_arr[:n_lights, 6])


# --------------------------------------------------------------------------
# plain PyTorch versions


def _inv(d: torch.Tensor) -> torch.Tensor:
    tiny = d.abs() < 1e-12
    return torch.where(tiny, BIG, 1.0 / torch.where(tiny, 1.0, d))


def _floor_clip(p: torch.Tensor, n: int) -> torch.Tensor:
    # clamp before the int conversion, so that out-of-range values
    # saturate the same way on every backend
    return torch.clamp(torch.floor(p), 0.0, float(n - 1)).to(torch.int32)


def _childbit(cb, vx, vy, vz):
    ci = ((vx & 1) << 2) | ((vy & 1) << 1) | (vz & 1)
    return ((cb >> ci) & 1) == 1


def _fetch(words: torch.Tensor, vx, vy, vz):
    w = words[morton3(vx >> 1, vy >> 1, vz >> 1).to(torch.int64)]
    w = w.to(torch.int32)
    return torch.clamp(w, min=0), torch.clamp(-w, min=0)


def march_reference(o: torch.Tensor, d: torch.Tensor, accel: PackedMorton,
                    dims: tuple[int, int, int], max_steps: int,
                    t_max: torch.Tensor | None = None,
                    active: torch.Tensor | None = None,
                    iter_budget: int | None = None,
                    resume_state: tuple | None = None,
                    extended: bool = False):
    """Plain version of the march: a vectorised masked loop over all rays
    that compacts the live rays after every iteration.

    Per ray: slab clip to [0,X]x[0,Y]x[0,Z] capped at t_max; an entry
    fetch at the entry voxel (not a step); then DDA advances, each either
    one fine voxel or, from an empty cell (word -D), a jump to the exit of
    the empty box [2c - 2(D-1), 2c + 2D). A ray ends when it leaves the
    grid, passes t_max, hits, or reaches max_steps*8 + 1024 iterations
    (the entry fetch counts as one). ``active`` (bool [N]) marches only
    those rays; the rest miss at once.

    Resume mode, the plain version of ``march_resume_kernel``:
    ``iter_budget`` caps the iterations of each ray in this call;
    ``resume_state`` = (voxel int32 [N,3], dist int32 [N], steps int32
    [N]) restarts the rays: dist -1 marks a dead slot (done at once, a
    miss at the clipped given voxel with the given steps), -2 a ray whose
    entry fetch is pending (it fetches the clipped given voxel, with the
    entry t and face of the slab clip), anything else a ray that
    continues from (voxel, dist) with its steps going on from the given
    count and its iterations from 0. ``extended`` also returns
    {"done": bool [N], "dist": int32 [N]}, the state of the next round
    (dist -2 where a valid ray had no iteration).
    """
    X, Y, Z = dims
    n = o.shape[0]
    dev = o.device
    words = accel.words
    ox, oy, oz = [o[:, k].contiguous() for k in range(3)]
    dx, dy, dz = [d[:, k].contiguous() for k in range(3)]
    if t_max is None:
        t_max = torch.full((n,), BIG_T, dtype=torch.float32, device=dev)
    ivx, ivy, ivz = _inv(dx), _inv(dy), _inv(dz)

    def slab(o_, iv, dim):
        t0 = (0.0 - o_) * iv
        t1 = (dim - o_) * iv
        return torch.minimum(t0, t1), torch.maximum(t0, t1)

    nx, fx = slab(ox, ivx, float(X))
    ny, fy = slab(oy, ivy, float(Y))
    nz, fz = slab(oz, ivz, float(Z))
    t_enter = torch.maximum(torch.maximum(nx, ny), torch.clamp(nz, min=0.0))
    t_exit = torch.minimum(torch.minimum(fx, fy), fz)
    t_end = torch.minimum(t_exit, t_max)
    valid = (t_enter <= t_exit) & (t_enter <= t_end)
    if active is not None:
        valid = valid & active

    one = torch.ones((), dtype=torch.int32, device=dev)
    sgx = torch.where(dx >= 0, one, -one)
    sgy = torch.where(dy >= 0, one, -one)
    sgz = torch.where(dz >= 0, one, -one)
    tn_max = torch.maximum(torch.maximum(nx, ny), nz)
    eax = torch.where(nx >= tn_max, 0, torch.where(ny >= tn_max, 1, 2))
    eax = eax.to(torch.int32)
    esg = torch.where(eax == 0, sgx, torch.where(eax == 1, sgy, sgz))

    def reinit(ox, oy, oz, dx, dy, dz, t):
        px = ox + (t + EPS) * dx
        py = oy + (t + EPS) * dy
        pz = oz + (t + EPS) * dz
        inside = ((px >= 0) & (px < X) & (py >= 0) & (py < Y)
                  & (pz >= 0) & (pz < Z))
        return _floor_clip(px, X), _floor_clip(py, Y), _floor_clip(pz, Z), \
            inside

    vx, vy, vz, _ = reinit(ox, oy, oz, dx, dy, dz, t_enter)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    dist_out = torch.zeros(n, dtype=torch.int32, device=dev)
    live = valid
    fresh = valid                   # the first iteration is the entry fetch
    if resume_state is not None:
        rv, rd, rs = resume_state
        vx = torch.clamp(rv[:, 0], 0, X - 1)
        vy = torch.clamp(rv[:, 1], 0, Y - 1)
        vz = torch.clamp(rv[:, 2], 0, Z - 1)
        steps = rs.clone()
        dist_out = torch.clamp(rd, min=0)
        live = valid & (rd != -1)
        fresh = live & (rd == -2)
    iter_cap = max_steps * 8 + 1024
    if iter_budget is not None:
        iter_cap = min(iter_budget, iter_cap)
    done = ~live
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    t_hit = torch.full((n,), BIG_T, dtype=torch.float32, device=dev)
    rax = torch.zeros(n, dtype=torch.int32, device=dev)
    rsg = torch.zeros(n, dtype=torch.int32, device=dev)
    vox = torch.stack([vx, vy, vz], dim=-1)

    def result():
        rec = _hit_record(hit, t_hit, vox, rax, rsg, steps)
        return (rec, {"done": done, "dist": dist_out}) if extended else rec

    if iter_cap < 1:
        dist_out = torch.where(fresh, -2, dist_out)
        return result()

    # entry fetch at the entry voxel (the first loop iteration; no step);
    # a resumed ray keeps its given dist
    cb, dist = _fetch(words, vx, vy, vz)
    entry_hit = fresh & _childbit(cb, vx, vy, vz)
    hit |= entry_hit
    t_hit = torch.where(entry_hit, t_enter, t_hit)
    rax = torch.where(entry_hit, eax, rax)
    rsg = torch.where(entry_hit, esg, rsg)
    dist = torch.where(fresh, dist, dist_out)
    dist_out = dist
    done = done | entry_hit

    # live rays, compacted: constants and carry
    idx = torch.nonzero(live & ~entry_hit).squeeze(1)
    c = [x[idx] for x in (ox, oy, oz, dx, dy, dz, ivx, ivy, ivz,
                          sgx, sgy, sgz, t_end)]
    s = [x[idx] for x in (vx, vy, vz, cb, dist)]
    nstep = steps[idx]
    # a ray that fetched its entry voxel here has spent one iteration
    spent = fresh[idx]
    for k in range(iter_cap):
        if k == iter_cap - 1 and bool(spent.any()):
            # the rays that fetched an entry voxel reach the cap here
            fi = idx[spent]
            vox[fi] = torch.stack([x[spent] for x in s[:3]], dim=-1)
            steps[fi] = nstep[spent]
            dist_out[fi] = s[4][spent]
            keep = ~spent
            idx, nstep, spent = idx[keep], nstep[keep], spent[keep]
            c = [x[keep] for x in c]
            s = [x[keep] for x in s]
        if idx.numel() == 0:
            break
        (cox, coy, coz, cdx, cdy, cdz, civx, civy, civz,
         csgx, csgy, csgz, ct_end) = c
        cvx, cvy, cvz, ccb, cdist = s
        big = cdist > 0
        df = cdist.to(torch.float32)

        def axis_t(v, o_, d_, iv):
            vf = v.to(torch.float32)
            cf = (v >> 1).to(torch.float32)
            lo = torch.where(big, 2.0 * cf - 2.0 * (df - 1.0), vf)
            hi = torch.where(big, 2.0 * cf + 2.0 * df, vf + 1.0)
            t = (torch.where(d_ >= 0, hi, lo) - o_) * iv
            return torch.where(d_.abs() < 1e-12, BIG, t)

        tx = axis_t(cvx, cox, cdx, civx)
        ty = axis_t(cvy, coy, cdy, civy)
        tz = axis_t(cvz, coz, cdz, civz)
        t_new = torch.minimum(torch.minimum(tx, ty), tz)
        mx = (tx <= ty) & (tx <= tz)
        my = ~mx & (ty <= tz)
        mz = ~mx & ~my
        ax = torch.where(mx, 0, torch.where(my, 1, 2)).to(torch.int32)
        sg = torch.where(mx, csgx, torch.where(my, csgy, csgz))

        nvx, nvy, nvz, inside = reinit(cox, coy, coz, cdx, cdy, cdz, t_new)
        # progress guard: rounding re-landed in the same voxel -> one DDA
        # step along the crossing axis
        stuck = (nvx == cvx) & (nvy == cvy) & (nvz == cvz)
        fx_, fy_, fz_ = cvx + csgx, cvy + csgy, cvz + csgz
        nvx = torch.where(stuck & mx, torch.clamp(fx_, 0, X - 1), nvx)
        nvy = torch.where(stuck & my, torch.clamp(fy_, 0, Y - 1), nvy)
        nvz = torch.where(stuck & mz, torch.clamp(fz_, 0, Z - 1), nvz)
        f_in = ((mx & (fx_ >= 0) & (fx_ < X)) | (my & (fy_ >= 0) & (fy_ < Y))
                | (mz & (fz_ >= 0) & (fz_ < Z)))
        inside = torch.where(stuck, f_in, inside)

        adv = inside & ~(t_new > ct_end)
        ncb, ndist = _fetch(words, nvx, nvy, nvz)
        new_hit = adv & _childbit(ncb, nvx, nvy, nvz)
        cvx = torch.where(adv, nvx, cvx)
        cvy = torch.where(adv, nvy, cvy)
        cvz = torch.where(adv, nvz, cvz)
        nstep = nstep + adv.to(torch.int32)
        ndist = torch.where(adv, ndist, cdist)

        fin = new_hit | ~adv
        if bool(fin.any()):
            fi = idx[fin]
            hi_ = new_hit[fin]
            hit[fi] = hi_
            t_hit[fi] = torch.where(hi_, t_new[fin], t_hit[fi])
            rax[fi] = torch.where(hi_, ax[fin], rax[fi])
            rsg[fi] = torch.where(hi_, sg[fin], rsg[fi])
            vox[fi] = torch.stack([cvx[fin], cvy[fin], cvz[fin]], dim=-1)
            steps[fi] = nstep[fin]
            dist_out[fi] = ndist[fin]
            done[fi] = True
            keep = ~fin
            idx = idx[keep]
            c = [x[keep] for x in c]
            s = [x[keep] for x in (cvx, cvy, cvz, ncb, ndist)]
            nstep = nstep[keep]
            spent = spent[keep]
        else:
            s = [cvx, cvy, cvz, ncb, ndist]
    # rays still live at the iteration cap end where they stand, not done
    if idx.numel():
        vox[idx] = torch.stack(s[:3], dim=-1)
        steps[idx] = nstep
        dist_out[idx] = s[4]
    return result()


def _hit_record(hit, t_hit, vox, rax, rsg, steps) -> HitRecord:
    normal = torch.zeros(vox.shape, dtype=torch.float32, device=vox.device)
    normal.scatter_(1, rax.to(torch.int64)[:, None],
                    (-rsg).to(torch.float32)[:, None])
    normal = torch.where(hit[:, None], normal, 0.0)
    return HitRecord(hit=hit, t=t_hit, voxel=vox, normal=normal, steps=steps)


def shadow_rays(rec: HitRecord, o, d, light_pos: torch.Tensor):
    """Shadow rays toward one light: origin = hit point nudged SHADOW_EPS
    along the face normal (0 for a miss), unit direction, distance to the
    light, and whether the face looks at the light (hit and n.l > 0)."""
    p = o + rec.t[:, None] * d + rec.normal * SHADOW_EPS
    p = torch.where(rec.hit[:, None], p, 0.0)
    lvec = light_pos[None, :] - p
    lx, ly, lz = lvec.unbind(-1)
    dist = torch.sqrt(lx * lx + ly * ly + lz * lz)
    ldir = lvec / torch.clamp(dist, min=1e-12)[:, None]
    nrm = rec.normal
    ndl = (nrm[:, 0] * ldir[:, 0] + nrm[:, 1] * ldir[:, 1]
           + nrm[:, 2] * ldir[:, 2])
    return p, ldir.contiguous(), dist, rec.hit & (ndl > 0.0)


def fetch_albedo(rec: HitRecord, mats: torch.Tensor, spec: ShadeSpec):
    """Albedo [N,3] of each hit voxel from the material or RGB8 table
    (0 for a miss)."""
    v = rec.voxel
    if spec.rgb8:
        widx = morton3(v[:, 0], v[:, 1], v[:, 2])
    else:
        widx = morton3(v[:, 0] >> 1, v[:, 1] >> 1, v[:, 2] >> 1)
    widx = torch.where(rec.hit, widx, 0).to(torch.int64)
    w = torch.where(rec.hit, mats[widx], 0)
    if spec.rgb8:
        chans = [((w >> (8 * c)) & 255).to(torch.float32) * (1.0 / 255.0)
                 for c in range(3)]
        return torch.stack(chans, dim=-1)
    ci = ((v[:, 0] & 1) << 2) | ((v[:, 1] & 1) << 1) | (v[:, 2] & 1)
    mid = ((w >> (3 * ci)) & 7).to(torch.int64)
    pal = torch.tensor(spec.palette, dtype=torch.float32, device=v.device)
    return pal[mid]


def shade_reference(rec: HitRecord, o, d, vis, mats, lights_arr,
                    spec: ShadeSpec) -> torch.Tensor:
    """Plain version of the shade epilogue: render/shade.py's math on the
    albedo fetched from ``mats``. vis: [N, L] visibility or None (1)."""
    albedo = fetch_albedo(rec, mats, spec)
    lights = unpack_lights(lights_arr, spec.n_lights)
    return shade_albedo(rec, o, d, albedo, lights, spec.settings(),
                        shadow_vis=vis)


def shadow_visibility_reference(rec: HitRecord, o, d, accel, dims, max_steps,
                                light_pos) -> torch.Tensor:
    """Visibility [N] of one light, as the kernel's in-kernel shadow pass
    computes it: one march from the nudged hit point toward the light,
    capped at dist - 2 eps, only for rays whose face looks at the light;
    1 where nothing is in the way (and for misses)."""
    p, ldir, dist, facing = shadow_rays(rec, o, d, light_pos)
    tm = torch.where(rec.hit, dist - 2.0 * SHADOW_EPS, 0.0)
    srec = march_reference(p, ldir, accel, dims, max_steps, tm,
                           active=facing)
    return torch.where(srec.hit & rec.hit, 0.0, 1.0)


def march_shade_reference(o, d, accel, dims, max_steps, t_max, spec, mats,
                          lights_arr):
    """Plain version of ``march_shade_kernel``: march, then (with shadows)
    the per-light shadow marches, then shade. Returns the HitRecord, or
    (HitRecord, rgb) when ``spec`` is given."""
    rec = march_reference(o, d, accel, dims, max_steps, t_max)
    if spec is None:
        return rec
    vis = None
    if spec.runs_shadow_marches:
        vis = torch.stack([shadow_visibility_reference(
            rec, o, d, accel, dims, max_steps, lights_arr[li, 0:3])
            for li in range(spec.n_lights)], dim=-1)
    return rec, shade_reference(rec, o, d, vis, mats, lights_arr, spec)


# --------------------------------------------------------------------------
# kernel wrappers


class _ShadeParams(ctypes.Structure):
    """Mirror of ``ShadeParams`` in csrc/march.cu."""

    _fields_ = [
        ("mode", ctypes.c_int), ("shadows", ctypes.c_int),
        ("rgb8", ctypes.c_int), ("fog", ctypes.c_int),
        ("n_lights", ctypes.c_int), ("use_vis", ctypes.c_int),
        ("ambient", ctypes.c_float), ("specular_exp", ctypes.c_float),
        ("specular_k", ctypes.c_float), ("fog_density", ctypes.c_float),
        ("sky_top", ctypes.c_float * 3), ("sky_horizon", ctypes.c_float * 3),
        ("palette", ctypes.c_float * 24),
    ]


def _shade_params(spec: ShadeSpec) -> _ShadeParams:
    p = _ShadeParams()
    p.mode = _MODES[spec.mode]
    p.shadows = int(spec.runs_shadow_marches)
    p.rgb8, p.fog = int(spec.rgb8), int(spec.fog)
    p.n_lights, p.use_vis = spec.n_lights, int(spec.use_vis)
    p.ambient, p.specular_exp = spec.ambient, spec.specular_exp
    p.specular_k, p.fog_density = spec.specular_k, spec.fog_density
    p.sky_top[:] = list(spec.sky_top)
    p.sky_horizon[:] = list(spec.sky_horizon)
    p.palette[:] = [c for row in spec.palette for c in row]
    return p


def _check(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_spec(spec: ShadeSpec) -> None:
    if not 0 <= spec.n_lights <= MAX_LIGHTS:
        raise ValueError(f"the shade epilogue takes 0..{MAX_LIGHTS} lights, "
                         f"got {spec.n_lights}")
    if len(spec.palette) != 8:
        raise ValueError("the shade epilogue takes 8 palette rows")


def _check_tables(accel, dims, mats, spec, device):
    X, Y, Z = dims
    if not (X == Y == Z and X >= 2 and (X & (X - 1)) == 0):
        raise ValueError(f"dims must be a cubic power of two, got {dims}")
    cells = (X // 2) ** 3
    _check("accel.words", accel.words, torch.int16, (cells,), device)
    if spec is not None:
        _check("mats", mats, torch.int32,
               (X * Y * Z if spec.rgb8 else cells,), device)


def _device_kind(device: torch.device) -> str:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors on {device}: only cpu and cuda are taken")
    return device.type


def _ptr(x):
    return None if x is None else x.data_ptr()


def _check_resume_state(resume_state, n, device):
    """(voxel, dist[, steps]) -> (voxel, dist, steps), steps 0 where not
    given; raises on anything else."""
    if not isinstance(resume_state, (tuple, list)) or \
            len(resume_state) not in (2, 3):
        raise ValueError("resume_state: expected (voxel, dist[, steps])")
    rv, rd = resume_state[0], resume_state[1]
    _check("resume voxel", rv, torch.int32, (n, 3), device)
    _check("resume dist", rd, torch.int32, (n,), device)
    if len(resume_state) == 3:
        rs = resume_state[2]
        _check("resume steps", rs, torch.int32, (n,), device)
    else:
        rs = torch.zeros(n, dtype=torch.int32, device=device)
    return rv, rd, rs


def march(o: torch.Tensor, d: torch.Tensor, accel: PackedMorton,
          dims: tuple[int, int, int], max_steps: int,
          t_max: torch.Tensor | None = None,
          shade_spec: ShadeSpec | None = None,
          mats: torch.Tensor | None = None,
          lights_arr: torch.Tensor | None = None, *,
          iter_budget: int | None = None,
          resume_state: tuple | None = None,
          extended: bool = False):
    """March rays o, d (float32 [N, 3]) through the Morton table.

    Returns a HitRecord; with ``shade_spec`` (plus ``mats``, the material
    or RGB8 table, and ``lights_arr`` from ``pack_lights``) it returns
    (HitRecord, rgb [N, 3]), shading in the same kernel, after the
    per-light shadow marches when ``shade_spec.shadows`` is set.
    CUDA tensors launch the instantiation of ``march_shade_kernel`` that
    ``k1_variant(shade_spec)`` names; CPU tensors run the plain version.

    Resume mode, as ``march_pallas_v2`` takes it: ``iter_budget`` caps
    each ray's iterations in this call (the entry fetch counts as one;
    vxtpu caps a whole [8,128] tile, stalls included); ``resume_state`` =
    (voxel int32 [N,3], dist int32 [N][, steps int32 [N]]) restarts the
    rays (dist -1: a dead slot, -2: the entry fetch is pending; steps 0
    where not given); ``extended`` returns (HitRecord, {"done": bool [N],
    "dist": int32 [N]}), the state of the next round. With any of them
    set the call is march-only (a ``shade_spec`` raises ValueError) and
    CUDA tensors launch ``march_resume_kernel``; see ``march_reference``
    for the per-ray semantics."""
    device = o.device
    kind = _device_kind(device)
    n = o.shape[0]
    _check("o", o, torch.float32, (n, 3), device)
    _check("d", d, torch.float32, (n, 3), device)
    if t_max is not None:
        _check("t_max", t_max, torch.float32, (n,), device)
    _check_tables(accel, dims, mats, shade_spec, device)
    if iter_budget is not None or resume_state is not None or extended:
        if shade_spec is not None:
            raise ValueError("iter_budget, resume_state and extended march "
                             "only; a shade_spec takes a single round")
        if iter_budget is not None and (
                not isinstance(iter_budget, int) or iter_budget < 0):
            raise ValueError(f"iter_budget: expected an int >= 0, got "
                             f"{iter_budget!r}")
        if resume_state is not None:
            resume_state = _check_resume_state(resume_state, n, device)
        if kind == "cpu":
            return march_reference(o, d, accel, dims, max_steps, t_max,
                                   iter_budget=iter_budget,
                                   resume_state=resume_state,
                                   extended=extended)
        rec, ext = _march_resume(o, d, accel, dims, max_steps, t_max,
                                 iter_budget, resume_state)
        return (rec, ext) if extended else rec
    if shade_spec is not None:
        _check_spec(shade_spec)
        if shade_spec.use_vis:
            raise ValueError("march shades with in-kernel visibility only; "
                             "use shade() for a visibility input")
        _check("lights_arr", lights_arr, torch.float32, (MAX_LIGHTS, 8),
               device)
    if kind == "cpu":
        return march_shade_reference(o, d, accel, dims, max_steps, t_max,
                                     shade_spec, mats, lights_arr)

    from vxtpu_torch import _build

    lib = _build.load()
    X, Y, Z = dims
    i32 = dict(dtype=torch.int32, device=device)
    hit = torch.empty(n, dtype=torch.bool, device=device)
    t = torch.empty(n, dtype=torch.float32, device=device)
    voxel = torch.empty((n, 3), **i32)
    normal = torch.empty((n, 3), dtype=torch.float32, device=device)
    steps = torch.empty(n, **i32)
    rgb = None
    params = None
    if shade_spec is not None:
        rgb = torch.empty((n, 3), dtype=torch.float32, device=device)
        params = ctypes.byref(_shade_params(shade_spec))
    if n:
        rc = lib.vx_march_shade(
            _ptr(o), _ptr(d), _ptr(t_max), n, _ptr(accel.words), X, Y, Z,
            max_steps * 8 + 1024, _ptr(mats), _ptr(lights_arr), params,
            _ptr(hit), _ptr(t), _ptr(voxel), _ptr(normal), _ptr(steps),
            _ptr(rgb), torch.cuda.current_stream(device).cuda_stream)
        if rc:
            raise RuntimeError(f"march_shade_kernel launch failed: "
                               f"{_build.error_string(rc)}")
        LAUNCHES["march_shade_kernel"] += 1
        VARIANT_LAUNCHES[K1_VARIANTS[k1_variant(shade_spec)]] += 1
    rec = HitRecord(hit=hit, t=t, voxel=voxel, normal=normal, steps=steps)
    return rec if shade_spec is None else (rec, rgb)


def _march_resume(o, d, accel, dims, max_steps, t_max, iter_budget,
                  resume_state):
    """Launch ``march_resume_kernel``: (HitRecord, {"done", "dist"})."""
    from vxtpu_torch import _build

    lib = _build.load()
    device = o.device
    n = o.shape[0]
    X, Y, Z = dims
    iter_cap = max_steps * 8 + 1024
    if iter_budget is not None:
        iter_cap = min(iter_budget, iter_cap)
    rv, rd, rs = resume_state if resume_state is not None else (None,) * 3
    i32 = dict(dtype=torch.int32, device=device)
    hit = torch.empty(n, dtype=torch.bool, device=device)
    t = torch.empty(n, dtype=torch.float32, device=device)
    voxel = torch.empty((n, 3), **i32)
    normal = torch.empty((n, 3), dtype=torch.float32, device=device)
    steps = torch.empty(n, **i32)
    done = torch.empty(n, dtype=torch.bool, device=device)
    dist = torch.empty(n, **i32)
    if n:
        rc = lib.vx_march_resume(
            _ptr(o), _ptr(d), _ptr(t_max), n, _ptr(rv), _ptr(rd), _ptr(rs),
            _ptr(accel.words), X, Y, Z, iter_cap, _ptr(hit), _ptr(t),
            _ptr(voxel), _ptr(normal), _ptr(steps), _ptr(done), _ptr(dist),
            torch.cuda.current_stream(device).cuda_stream)
        if rc:
            raise RuntimeError(f"march_resume_kernel launch failed: "
                               f"{_build.error_string(rc)}")
        LAUNCHES["march_resume_kernel"] += 1
    rec = HitRecord(hit=hit, t=t, voxel=voxel, normal=normal, steps=steps)
    return rec, {"done": done, "dist": dist}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def march_sorted(o: torch.Tensor, d: torch.Tensor, accel: PackedMorton,
                 dims: tuple[int, int, int], max_steps: int,
                 t_max: torch.Tensor | None = None, round0_iters: int = 24,
                 survivor_frac: int = 8,
                 stats: dict | None = None) -> HitRecord:
    """Multi-round march with a mid-flight resort of the rays (vxtpu's
    ``march_pallas_v2_sorted`` without its TPU window, tile and image
    arguments). Round 0 marches every ray for at most ``round0_iters``
    iterations. Each resume round then keys the live rays by the Morton
    code of their current coarse cell (dead rays last), takes the first B
    = min(round_up(max(N // survivor_frac, 1024), 1024), N) of a stable
    argsort, resumes them (the slots that are not alive as dead) and
    scatters the alive ones back in place; rounds repeat while any ray is
    live, with one host sync a round. The march is memoryless given (o,
    d, voxel, dist), so the record equals the single-round march's, steps
    included, except for a ray still live at the single-round iteration
    cap (each round has that cap of its own).

    Every resumed ray finishes within its round's cap, so the rounds
    number ceil(survivors / B); one more raises RuntimeError. ``stats``,
    when given, receives: survivors (live after round 0), buffer (B),
    rounds (resume rounds), round0_steps and round0_done, and
    resume_steps, the steps each buffer slot took in each resume round
    (0 for dead slots), in the buffer's order."""
    n = o.shape[0]
    if t_max is None:
        t_max = torch.full((n,), BIG_T, dtype=torch.float32, device=o.device)
    rec, ext = march(o, d, accel, dims, max_steps, t_max=t_max,
                     iter_budget=round0_iters, extended=True)
    if not n:
        return rec
    B = min(_round_up(max(n // survivor_frac, 1024), 1024), n)
    # the state, with one more row: dead slots of a round scatter there
    state = [torch.cat([x, x[:1]]) for x in (
        rec.hit, rec.t, rec.voxel, rec.normal, rec.steps, ext["done"],
        ext["dist"])]
    survivors = int((~ext["done"]).sum())
    if stats is not None:
        stats.update(survivors=survivors, buffer=B, rounds=0,
                     round0_steps=rec.steps, round0_done=ext["done"],
                     resume_steps=[])
    max_rounds = -(-survivors // B)
    live, rounds = survivors, 0
    while live:
        if rounds == max_rounds:
            raise RuntimeError(
                f"march_sorted: {live} rays still live after {rounds} resume "
                f"rounds of {B}; a resumed ray did not finish within "
                f"{max_steps * 8 + 1024} iterations")
        _, _, voxel, _, steps, done, dist = state
        alive = ~done[:n]
        v = voxel[:n]
        key = torch.where(alive, morton3(v[:, 0] >> 1, v[:, 1] >> 1,
                                         v[:, 2] >> 1), 1 << 30)
        ids = torch.argsort(key, stable=True)[:B]
        sel = alive[ids]
        dist_in = torch.where(sel, dist[ids], -1)
        steps_in = torch.where(sel, steps[ids], 0)
        rec1, ext1 = march(o[ids], d[ids], accel, dims, max_steps,
                           t_max=t_max[ids],
                           resume_state=(v[ids], dist_in, steps_in),
                           extended=True)
        tgt = torch.where(sel, ids, n)
        for dst, src in zip(state, (rec1.hit, rec1.t, rec1.voxel,
                                    rec1.normal, rec1.steps, ext1["done"],
                                    ext1["dist"])):
            dst.index_copy_(0, tgt, src)
        rounds += 1
        if stats is not None:
            stats["rounds"] = rounds
            stats["resume_steps"].append(
                torch.where(sel, rec1.steps - steps_in, 0))
        live = int((~state[5][:n]).sum())
    hit, t, voxel, normal, steps = (x[:n] for x in state[:5])
    return HitRecord(hit=hit, t=t, voxel=voxel, normal=normal, steps=steps)


def shade(rec: HitRecord, o, d, vis, mats, lights_arr,
          spec: ShadeSpec) -> torch.Tensor:
    """Shade a stored HitRecord (+ per-light visibility [N, L] when
    ``spec.use_vis``) -> rgb [N, 3]. CUDA tensors launch
    ``shade_kernel``; CPU tensors run the plain version."""
    device = o.device
    kind = _device_kind(device)
    n = o.shape[0]
    _check("o", o, torch.float32, (n, 3), device)
    _check("d", d, torch.float32, (n, 3), device)
    _check("rec.hit", rec.hit, torch.bool, (n,), device)
    _check("rec.t", rec.t, torch.float32, (n,), device)
    _check("rec.voxel", rec.voxel, torch.int32, (n, 3), device)
    _check("rec.normal", rec.normal, torch.float32, (n, 3), device)
    _check("lights_arr", lights_arr, torch.float32, (MAX_LIGHTS, 8), device)
    if spec.use_vis:
        _check("vis", vis, torch.float32, (n, spec.n_lights), device)
    else:
        vis = None
    _check_spec(spec)
    if spec.shadows:
        raise ValueError("shade takes visibility as an input; "
                         "spec.shadows must be False")
    if not isinstance(mats, torch.Tensor) or mats.dim() != 1:
        raise ValueError("mats: expected a flat table")
    _check("mats", mats, torch.int32, tuple(mats.shape), device)
    if kind == "cpu":
        return shade_reference(rec, o, d, vis, mats, lights_arr, spec)

    from vxtpu_torch import _build

    lib = _build.load()
    rgb = torch.empty((n, 3), dtype=torch.float32, device=device)
    if n:
        params = _shade_params(spec)
        rc = lib.vx_shade(
            _ptr(o), _ptr(d), _ptr(rec.hit), _ptr(rec.t), _ptr(rec.voxel),
            _ptr(rec.normal), _ptr(vis), n, _ptr(mats), mats.shape[0],
            _ptr(lights_arr), ctypes.byref(params), _ptr(rgb),
            torch.cuda.current_stream(device).cuda_stream)
        if rc:
            raise RuntimeError(f"shade_kernel launch failed: "
                               f"{_build.error_string(rc)}")
        LAUNCHES["shade_kernel"] += 1
    return rgb


def make_march(occ_flat, dims, settings: RenderSettings, accel=None):
    """Pipeline march factory of ``march`` in march-only mode (vxtpu's
    ``make_march_pallas_v2`` without its TPU tiling arguments): returns
    ``march(o, d, t_max=None) -> HitRecord``. ``accel`` must be a
    PackedMorton; it is built from the grid when it is not."""
    if not isinstance(accel, PackedMorton):
        accel = build_packed_morton(occ_flat.reshape(dims))
    return functools.partial(march, accel=accel, dims=dims,
                             max_steps=settings.resolve_max_steps(dims))
