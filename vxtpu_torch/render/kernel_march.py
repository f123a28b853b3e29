"""The hard-voxel march + shade kernel and its plain PyTorch version.

Counterpart of ``vxtpu/render/kernel_pallas_v2.py``: ``march`` replaces
``march_pallas_v2`` (the ``_march_kernel`` Pallas kernel: DDA march over
the Morton signed-word table, optional per-light shadow marches in the
same dispatch, shade epilogue) and ``shade`` replaces ``shade_pallas_v2``
(``_shade_only_kernel``: the epilogue alone, on a stored HitRecord plus
per-light visibility). Both kernels are hand-written CUDA C++ in
``vxtpu_torch/csrc/march.cu``, built for sm_90a at first use.

What bounds the kernel on an H100: one thread per ray marches a
divergent, data-dependent loop, and every step that leaves a 2x2x2 cell
reads one table word, so the march is latency-bound on dependent table
reads, not on bandwidth or arithmetic. What the design does about it: the
occupancy table is int16 in Morton order (32 MB at 512^3), small enough to
stay resident in the 50 MB L2 and read through the read-only path; a
cell's child bits stay in registers, so steps inside one occupied cell
read nothing; empty space is crossed in one jump per empty box. The
material or RGB8 word is read once per hit ray. None of the TPU
machinery (row windows, one-hot MXU fetch, bf16 casts, [8,128] tiles,
tuning knobs, per-tile iteration counters) carries over.

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
LAUNCHES = {"march_shade_kernel": 0, "shade_kernel": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
                    active: torch.Tensor | None = None) -> HitRecord:
    """Plain version of the march: a vectorised masked loop over all rays
    that compacts the live rays after every iteration.

    Per ray: slab clip to [0,X]x[0,Y]x[0,Z] capped at t_max; an entry
    fetch at the entry voxel (not a step); then DDA advances, each either
    one fine voxel or, from an empty cell (word -D), a jump to the exit of
    the empty box [2c - 2(D-1), 2c + 2D). A ray ends when it leaves the
    grid, passes t_max, hits, or reaches max_steps*8 + 1024 iterations.
    ``active`` (bool [N]) marches only those rays; the rest miss at once.
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
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    t_hit = torch.full((n,), BIG_T, dtype=torch.float32, device=dev)
    rax = torch.zeros(n, dtype=torch.int32, device=dev)
    rsg = torch.zeros(n, dtype=torch.int32, device=dev)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    vox = torch.stack([vx, vy, vz], dim=-1)

    # entry fetch at the entry voxel (the first loop iteration; no step)
    cb, dist = _fetch(words, vx, vy, vz)
    entry_hit = valid & _childbit(cb, vx, vy, vz)
    hit |= entry_hit
    t_hit = torch.where(entry_hit, t_enter, t_hit)
    rax = torch.where(entry_hit, eax, rax)
    rsg = torch.where(entry_hit, esg, rsg)

    # live rays, compacted: constants and carry
    live = valid & ~entry_hit
    idx = torch.nonzero(live).squeeze(1)
    c = [x[idx] for x in (ox, oy, oz, dx, dy, dz, ivx, ivy, ivz,
                          sgx, sgy, sgz, t_end)]
    s = [x[idx] for x in (vx, vy, vz, cb, dist)]
    nstep = torch.zeros(idx.shape[0], dtype=torch.int32, device=dev)
    iter_cap = max_steps * 8 + 1024
    for _ in range(1, iter_cap):
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
            keep = ~fin
            idx = idx[keep]
            c = [x[keep] for x in c]
            s = [x[keep] for x in (cvx, cvy, cvz, ncb, ndist)]
            nstep = nstep[keep]
        else:
            s = [cvx, cvy, cvz, ncb, ndist]
    # rays still live at the iteration cap end as misses where they stand
    if idx.numel():
        vox[idx] = torch.stack(s[:3], dim=-1)
        steps[idx] = nstep
    return _hit_record(hit, t_hit, vox, rax, rsg, steps)


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


def march(o: torch.Tensor, d: torch.Tensor, accel: PackedMorton,
          dims: tuple[int, int, int], max_steps: int,
          t_max: torch.Tensor | None = None,
          shade_spec: ShadeSpec | None = None,
          mats: torch.Tensor | None = None,
          lights_arr: torch.Tensor | None = None):
    """March rays o, d (float32 [N, 3]) through the Morton table.

    Returns a HitRecord; with ``shade_spec`` (plus ``mats``, the material
    or RGB8 table, and ``lights_arr`` from ``pack_lights``) it returns
    (HitRecord, rgb [N, 3]), shading in the same kernel, after the
    per-light shadow marches when ``shade_spec.shadows`` is set.
    CUDA tensors launch ``march_shade_kernel``; CPU tensors run the plain
    version."""
    device = o.device
    kind = _device_kind(device)
    n = o.shape[0]
    _check("o", o, torch.float32, (n, 3), device)
    _check("d", d, torch.float32, (n, 3), device)
    if t_max is not None:
        _check("t_max", t_max, torch.float32, (n,), device)
    _check_tables(accel, dims, mats, shade_spec, device)
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
    rec = HitRecord(hit=hit, t=t, voxel=voxel, normal=normal, steps=steps)
    return rec if shade_spec is None else (rec, rgb)


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
