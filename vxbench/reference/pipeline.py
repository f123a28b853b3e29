"""Plain reference of the composable pipeline's frame: rays -> the
row-major march of vxtpu v1 over a ``child_bits | D << 8`` table -> one
shadow march per light, from every ray -> face-normal shading over
float32 per-voxel RGB (ambient, Lambert, Blinn-Phong), fog and sky.

A frozen copy of the per-ray semantics of vxtpu_torch's row-major march
(``render/kernel_packed.py:march_packed_reference``, which the CUDA
march K5 equals on every ray), its table (``world/packed.py:
build_packed``), the pipeline's shadow rays
(``render/pipeline.py:shadow_ray_batch``) and its shading
(``render/shade.py:shade``), with the float dtype a parameter. Where a
formula is the fused frame's, it is taken from ``reference/march.py``:
the coarse cells' chessboard distance and the shading. The v1 march
differs from the fused one in five places:

  1. at most ``max_steps`` loop iterations; a ray still live there misses;
  2. ``steps`` counts every iteration in which the ray is live, the one
     where it leaves the grid or passes t_end included;
  3. the voxel is the clipped next voxel of the last live iteration, so a
     miss reports the voxel it stepped to on leaving;
  4. a ray is valid when t_enter <= t_exit; the entry hit also needs
     t_enter <= t_max, so a valid ray with t_enter > t_max takes one
     iteration and stops with steps = 1;
  5. the word is child_bits | D << 8 (D = 0: the cell holds a solid
     voxel), row-major over the coarse cells.

It also counts a frame's work for ``k5_roofline`` and ``mfu.frame``:
rays, shadow rays, v1 steps, and the distinct table words each march
reads (the CUDA march reads the same words from a bricked 16-bit copy).
"""

from __future__ import annotations

import torch

from vxbench.reference.march import (BIG, BIG_T, EPS, SHADOW_EPS, _normal,
                                     cell_table, shade)


def packed_table(occ: torch.Tensor) -> torch.Tensor:
    """int32 [cx*cy*cz] row-major over 2x2x2 cells: child_bits | D << 8,
    D = 0 where the cell holds a solid voxel, else its chessboard distance
    in cells to the nearest such cell, capped at 64."""
    w = cell_table(occ)
    return torch.clamp(w, min=0) | (torch.clamp(-w, min=0) << 8)


class Counts:
    """The work of the marches of one frame: rays, shadow rays and
    iterations, and the distinct table words that each march read
    (``launch_words``, one entry a march) and that the frame read
    (``frame_words``)."""

    def __init__(self, n_cells: int, device):
        self.n_cells = n_cells
        self.device = device
        self.frame_touched = torch.zeros(n_cells, dtype=torch.bool,
                                         device=device)
        self.launch_words: list = []
        self.rays = 0
        self.shadow_rays = 0
        self.steps = 0

    def start(self) -> torch.Tensor:
        return torch.zeros(self.n_cells, dtype=torch.bool,
                           device=self.device)

    def end(self, touched: torch.Tensor, steps: torch.Tensor) -> None:
        self.launch_words.append(int(touched.sum()))
        self.frame_touched |= touched
        self.steps += int(steps.sum(dtype=torch.int64))

    @property
    def frame_words(self) -> int:
        return int(self.frame_touched.sum())


def march(o, d, words, dims, max_steps, t_max=None,
          counts: Counts | None = None):
    """(hit, t, voxel int32 [N, 3], axis, sign, steps) of each ray under
    the v1 contract: a vectorised masked loop over all rays that compacts
    the live rays after every iteration."""
    X, Y, Z = dims
    CY, CZ = Y // 2, Z // 2
    ft = o.dtype
    n = o.shape[0]
    dev = o.device
    touched = counts.start() if counts is not None else None
    ox, oy, oz = [o[:, k].contiguous() for k in range(3)]
    dx, dy, dz = [d[:, k].contiguous() for k in range(3)]
    if t_max is None:
        t_max = torch.full((n,), BIG_T, dtype=ft, device=dev)

    def inv(x):
        tiny = x.abs() < 1e-12
        return torch.where(tiny, BIG, 1.0 / torch.where(tiny, 1.0, x))

    def slab(o_, iv, dim):
        t0 = (0.0 - o_) * iv
        t1 = (dim - o_) * iv
        return torch.minimum(t0, t1), torch.maximum(t0, t1)

    def floor_clip(p, m):
        # in float32: a low precision cannot hold every voxel index
        return torch.clamp(torch.floor(p).float(), 0.0,
                           float(m - 1)).to(torch.int32)

    def fetch(vx, vy, vz):
        ci = (((vx >> 1) * CY + (vy >> 1)) * CZ + (vz >> 1)).to(torch.int64)
        if touched is not None:
            touched.index_fill_(0, ci, True)
        w = words[ci]
        return w & 255, w >> 8

    def childbit(cb, vx, vy, vz):
        ci = ((vx & 1) << 2) | ((vy & 1) << 1) | (vz & 1)
        return ((cb >> ci) & 1) == 1

    def reinit(ox, oy, oz, dx, dy, dz, t):
        px = ox + (t + EPS) * dx
        py = oy + (t + EPS) * dy
        pz = oz + (t + EPS) * dz
        inside = ((px >= 0) & (px < X) & (py >= 0) & (py < Y)
                  & (pz >= 0) & (pz < Z))
        return floor_clip(px, X), floor_clip(py, Y), floor_clip(pz, Z), \
            inside

    ivx, ivy, ivz = inv(dx), inv(dy), inv(dz)
    nx, fx = slab(ox, ivx, float(X))
    ny, fy = slab(oy, ivy, float(Y))
    nz, fz = slab(oz, ivz, float(Z))
    t_enter = torch.maximum(torch.maximum(nx, ny), torch.clamp(nz, min=0.0))
    t_exit = torch.minimum(torch.minimum(fx, fy), fz)
    valid = t_enter <= t_exit
    t_end = torch.minimum(t_exit, t_max)
    one = torch.ones((), dtype=torch.int32, device=dev)
    sgx = torch.where(dx >= 0, one, -one)
    sgy = torch.where(dy >= 0, one, -one)
    sgz = torch.where(dz >= 0, one, -one)

    vx, vy, vz, _ = reinit(ox, oy, oz, dx, dy, dz, t_enter)
    cb, dist = fetch(vx, vy, vz)
    first_hit = valid & childbit(cb, vx, vy, vz) & (t_enter <= t_max)
    # entry face: the axis whose near-slab t is largest, ties to the lowest
    tn_max = torch.maximum(torch.maximum(nx, ny), nz)
    eax = torch.where(nx >= tn_max, 0, torch.where(ny >= tn_max, 1, 2))
    eax = eax.to(torch.int32)
    esg = torch.where(eax == 0, sgx, torch.where(eax == 1, sgy, sgz))

    hit = first_hit.clone()
    t_hit = torch.where(first_hit, t_enter, BIG_T)
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    rax = torch.where(first_hit, eax, zero)
    rsg = torch.where(first_hit, esg, zero)
    steps = zero.clone()
    vox = torch.stack([vx, vy, vz], dim=-1)

    idx = torch.nonzero(valid & ~first_hit).squeeze(1)
    c = [x[idx] for x in (ox, oy, oz, dx, dy, dz, ivx, ivy, ivz,
                          sgx, sgy, sgz, t_end)]
    s = [x[idx] for x in (vx, vy, vz, cb, dist)]
    for it in range(max_steps):
        if idx.numel() == 0:
            break
        (cox, coy, coz, cdx, cdy, cdz, civx, civy, civz,
         csgx, csgy, csgz, ct_end) = c
        cvx, cvy, cvz, ccb, cdist = s
        big = cdist > 0
        df = cdist.to(ft)

        def axis_t(v, o_, d_, iv):
            vf = v.to(ft)
            cf = (v >> 1).to(ft)
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

        go_on = inside & ~(t_new > ct_end)
        ncb, ndist = fetch(nvx, nvy, nvz)
        new_hit = go_on & childbit(ncb, nvx, nvy, nvz)
        fin = new_hit | ~go_on
        if it + 1 == max_steps:
            fin = torch.ones_like(fin)      # the cap: live rays miss
        if bool(fin.any()):
            fi = idx[fin]
            hi_ = new_hit[fin]
            hit[fi] = hi_
            t_hit[fi] = torch.where(hi_, t_new[fin], t_hit[fi])
            rax[fi] = torch.where(hi_, ax[fin], rax[fi])
            rsg[fi] = torch.where(hi_, sg[fin], rsg[fi])
            vox[fi] = torch.stack([nvx[fin], nvy[fin], nvz[fin]], dim=-1)
            steps[fi] = it + 1
            keep = ~fin
            idx = idx[keep]
            c = [x[keep] for x in c]
            s = [x[keep] for x in (nvx, nvy, nvz, ncb, ndist)]
        else:
            s = [nvx, nvy, nvz, ncb, ndist]
    if counts is not None:
        counts.end(touched, steps)
    return hit, t_hit, vox, rax, rsg, steps


def shadow_batch(hit, t, normal, o, d, lpos):
    """Origins, unit directions and t_max of the shadow rays toward a
    light at lpos: from the hit point nudged SHADOW_EPS along the face
    normal, capped at the light's distance less 2 eps; a miss's ray starts
    at the origin with t_max = 0."""
    ft = o.dtype
    p = o + t[:, None] * d + normal * SHADOW_EPS
    p = torch.where(hit[:, None], p, 0.0)
    lvec = torch.tensor(lpos, dtype=ft, device=o.device)[None] - p
    lx, ly, lz = lvec.unbind(-1)
    dist = torch.sqrt(lx * lx + ly * ly + lz * lz)
    ldir = (lvec / torch.clamp(dist, min=1e-12)[:, None]).contiguous()
    return p, ldir, torch.where(hit, dist - 2.0 * SHADOW_EPS, 0.0)


def render(o, d, words, rgb, dims, lights: list, settings: dict,
           counts: Counts | None = None) -> torch.Tensor:
    """rgb [N, 3] of rays o, d (any float dtype; the table's words int32,
    ``rgb`` the float32 [X*Y*Z, 3] per-voxel colours): the v1 march, one
    v1 shadow march of every ray per light when shadows are on, shade."""
    if settings["shading"] == "flat":
        raise ValueError("the reference shades lit frames only")
    ft = o.dtype
    max_steps = sum(dims) + 2
    hit, t, vox, rax, rsg, _ = march(o, d, words, dims, max_steps,
                                     counts=counts)
    if counts is not None:
        counts.rays += o.shape[0]
    normal = _normal(hit, rax, rsg, ft)
    X, Y, Z = dims
    vi = (vox[:, 0].to(torch.int64) * Y + vox[:, 1]) * Z + vox[:, 2]
    alb = rgb[torch.clamp(vi, 0, rgb.shape[0] - 1)].to(ft)
    vis = None
    if settings["shadows"] and settings["shading"] != "flat" and lights:
        cols = []
        for lpos, _, _ in lights:
            p, ldir, tm = shadow_batch(hit, t, normal, o, d, lpos)
            shit = march(p, ldir, words, dims, max_steps, t_max=tm,
                         counts=counts)[0]
            if counts is not None:
                counts.shadow_rays += o.shape[0]
            cols.append(torch.where(shit & hit, 0.0, 1.0).to(ft))
        vis = torch.stack(cols, dim=-1)
    return shade(hit, t, normal, alb, o, d, lights, vis, settings)
