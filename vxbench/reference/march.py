"""Plain reference of the hard-voxel frame: rays -> DDA march over a
2x2x2-cell occupancy table with empty-space jumps -> one capped shadow
march per light from the hit point -> face-normal shading (ambient,
Lambert, Blinn-Phong), fog and sky.

A frozen copy of the per-ray semantics of vxtpu_torch's plain march
(``render/kernel_march.py:march_reference``, which the CUDA march K1
equals on every ray), its tables (``world/packed.py``) and its shading
(``render/shade.py``), with the float dtype a parameter. The cell table
is indexed row-major here (the program's is in Morton order: the same
words). It also counts the frame's work for ``mfu.frame``: rays, shadow
rays, DDA steps and the distinct table words the marches read.
"""

from __future__ import annotations

import torch

EPS = 1e-4           # re-entry samples the voxel at t + EPS
BIG = 3.0e30         # stands in for 1/d where |d| < 1e-12
BIG_T = 1e30         # t of a miss
SHADOW_EPS = 1e-3
CAP = 64             # cap of the coarse chessboard distance
CHUNK = 32           # march iterations between compactions of the rays
TAIL = 4096          # at most this many live rays: CUDA graph replays


def _dilate1(x: torch.Tensor) -> torch.Tensor:
    for ax in range(3):
        n = x.shape[ax]
        y = x.clone()
        y.narrow(ax, 1, n - 1).logical_or_(x.narrow(ax, 0, n - 1))
        y.narrow(ax, 0, n - 1).logical_or_(x.narrow(ax, 1, n - 1))
        x = y
    return x


def cell_table(occ: torch.Tensor) -> torch.Tensor:
    """int32 [cx*cy*cz] row-major over 2x2x2 cells: +child bits (bit
    (x&1)<<2 | (y&1)<<1 | (z&1)) where the cell holds a solid voxel, else
    -D, D = chessboard distance in cells to the nearest such cell, capped
    at CAP."""
    solid = (occ > 0).to(torch.int32)
    bits = torch.zeros_like(solid[0::2, 0::2, 0::2])
    for a in range(2):
        for b in range(2):
            for c in range(2):
                bits |= solid[a::2, b::2, c::2] << ((a << 2) | (b << 1) | c)
    covered = bits > 0
    dist = torch.where(covered, 0, CAP).to(torch.int32)
    for k in range(1, CAP):
        grown = _dilate1(covered)
        dist = torch.where(grown & ~covered, k, dist)
        covered = grown
    return torch.where(bits > 0, bits, -dist).reshape(-1)


def rgb8_albedo(rgb: torch.Tensor) -> torch.Tensor:
    """float32 [X*Y*Z, 3]: each voxel's colour as the program stores it,
    8 bits a channel."""
    q = torch.clamp(torch.round(rgb.reshape(-1, 3) * 255.0), 0, 255)
    return q.to(torch.int32).to(torch.float32) * (1.0 / 255.0)


class Counts:
    """The work of the marches of one frame."""

    def __init__(self, n_cells: int, device):
        # the table words read: one flag a cell, and a last slot that
        # takes the reads of rays that have ended
        self.touched = torch.zeros(n_cells + 1, dtype=torch.bool,
                                   device=device)
        self.steps = 0
        self.rays = 0
        self.shadow_rays = 0


def march(o, d, words, dims, max_steps, t_max=None, active=None,
          counts: Counts | None = None):
    """(hit, t, voxel int32 [N, 3], axis, sign, steps) of each ray."""
    X, Y, Z = dims
    CY, CZ = Y // 2, Z // 2
    ft = o.dtype
    n = o.shape[0]
    dev = o.device
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

    def fetch(vx, vy, vz, alive=None):
        ci = ((vx >> 1) * CY + (vy >> 1)) * CZ + (vz >> 1)
        ci = ci.to(torch.int64)
        if counts is not None:
            # the last slot takes the reads of rays that have ended (a
            # fill, not an assignment: no host value to copy in a graph)
            last = counts.touched.numel() - 1
            counts.touched.index_fill_(
                0, ci if alive is None else torch.where(alive, ci, last),
                True)
        w = words[ci]
        return torch.clamp(w, min=0), torch.clamp(-w, min=0)

    def childbit(cb, vx, vy, vz):
        ci = ((vx & 1) << 2) | ((vy & 1) << 1) | (vz & 1)
        return ((cb >> ci) & 1) == 1

    ivx, ivy, ivz = inv(dx), inv(dy), inv(dz)
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
        return floor_clip(px, X), floor_clip(py, Y), floor_clip(pz, Z), \
            inside

    vx, vy, vz, _ = reinit(ox, oy, oz, dx, dy, dz, t_enter)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    t_hit = torch.full((n,), BIG_T, dtype=ft, device=dev)
    rax = torch.zeros(n, dtype=torch.int32, device=dev)
    rsg = torch.zeros(n, dtype=torch.int32, device=dev)
    vox = torch.stack([vx, vy, vz], dim=-1)
    iter_cap = max_steps * 8 + 1024

    live_ids = torch.nonzero(valid).squeeze(1)
    cb, dist = fetch(vx[live_ids], vy[live_ids], vz[live_ids])
    entry_hit = childbit(cb, vx[live_ids], vy[live_ids], vz[live_ids])
    eh = live_ids[entry_hit]
    hit[eh] = True
    t_hit[eh] = t_enter[eh]
    rax[eh] = eax[eh]
    rsg[eh] = esg[eh]

    keep = ~entry_hit
    idx = live_ids[keep]
    c = [x[idx] for x in (ox, oy, oz, dx, dy, dz, ivx, ivy, ivz,
                          sgx, sgy, sgz, t_end)]

    def one(c, st):
        """One march iteration of every tracked ray. st: (vx, vy, vz, cb,
        dist, steps, alive, and the result of each ray that has ended:
        hit, t, axis, sign, voxel [m, 3], steps). A ray that has ended
        marches on unread."""
        (cox, coy, coz, cdx, cdy, cdz, civx, civy, civz,
         csgx, csgy, csgz, ct_end) = c
        (cvx, cvy, cvz, ccb, cdist, nstep, alive,
         r_hit, r_t, r_ax, r_sg, r_vox, r_steps) = st
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
        adv = inside & ~(t_new > ct_end)
        ccb, ndist = fetch(nvx, nvy, nvz, alive)
        new_hit = adv & childbit(ccb, nvx, nvy, nvz)
        cvx = torch.where(adv, nvx, cvx)
        cvy = torch.where(adv, nvy, cvy)
        cvz = torch.where(adv, nvz, cvz)
        nstep = nstep + adv.to(torch.int32)
        cdist = torch.where(adv, ndist, cdist)
        fin = (new_hit | ~adv) & alive
        hit_now = fin & new_hit
        return (cvx, cvy, cvz, ccb, cdist, nstep, alive & ~fin,
                r_hit | hit_now, torch.where(hit_now, t_new, r_t),
                torch.where(hit_now, ax, r_ax), torch.where(hit_now, sg, r_sg),
                torch.where(fin[:, None], torch.stack([cvx, cvy, cvz], -1),
                            r_vox),
                torch.where(fin, nstep, r_steps))

    def fresh(c, s, nstep):
        m = nstep.numel()
        return (*s, nstep, torch.ones(m, dtype=torch.bool, device=dev),
                torch.zeros(m, dtype=torch.bool, device=dev),
                torch.full((m,), BIG_T, dtype=ft, device=dev),
                torch.zeros(m, dtype=torch.int32, device=dev),
                torch.zeros(m, dtype=torch.int32, device=dev),
                torch.stack(s[:3], dim=-1), nstep)

    def store(idx, st, done):
        fi = idx[done]
        hit[fi] = st[7][done]
        t_hit[fi] = st[8][done]
        rax[fi] = st[9][done]
        rsg[fi] = st[10][done]
        vox[fi] = st[11][done]
        steps[fi] = st[12][done]

    st = fresh(c, [vx[idx], vy[idx], vz[idx], cb[keep], dist[keep]],
               steps[idx])
    k = 0
    # CHUNK iterations between two compactions of the live rays; the last
    # TAIL rays or fewer replay CHUNK iterations from a CUDA graph
    while idx.numel():
        if k >= iter_cap - 1:
            # the entry fetch spent one iteration of every ray's cap
            vox[idx] = torch.stack(st[:3], dim=-1)
            steps[idx] = st[5]
            break
        if dev.type == "cuda" and idx.numel() <= TAIL \
                and k + CHUNK <= iter_cap - 1:
            st, k = _replay(one, c, st, k, iter_cap)
        else:
            for _ in range(min(CHUNK, iter_cap - 1 - k)):
                st = one(c, st)
            k += min(CHUNK, iter_cap - 1 - k)
        alive = st[6]
        store(idx, st, ~alive)
        idx = idx[alive]
        c = [x[alive] for x in c]
        st = fresh(c, [x[alive] for x in st[:5]], st[5][alive])
    if counts is not None:
        counts.steps += int(steps.sum())
    return hit, t_hit, vox, rax, rsg, steps


def _replay(one, c, st, k, iter_cap):
    """CHUNK iterations of ``one`` captured once in a CUDA graph and
    replayed while a ray is live, CHUNK whole iterations at a time and not
    past iter_cap - 1; returns the state and the iterations done."""
    st = [x.clone() for x in st]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up outside the capture
        out = st
        for _ in range(CHUNK):
            out = one(c, out)
    torch.cuda.current_stream().wait_stream(side)
    for a, b in zip(st, out):
        a.copy_(b)
    k += CHUNK
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = st
        for _ in range(CHUNK):
            out = one(c, out)
        for a, b in zip(st, out):
            a.copy_(b)
    while bool(st[6].any()) and k + CHUNK <= iter_cap - 1:
        graph.replay()
        k += CHUNK
    return st, k


def _normal(hit, rax, rsg, ft):
    normal = torch.zeros((hit.shape[0], 3), dtype=ft, device=hit.device)
    normal.scatter_(1, rax.to(torch.int64)[:, None],
                    (-rsg).to(ft)[:, None])
    return torch.where(hit[:, None], normal, 0.0)


def sky(d, settings: dict):
    top = torch.tensor(settings["sky_top"], dtype=d.dtype, device=d.device)
    hor = torch.tensor(settings["sky_horizon"], dtype=d.dtype,
                       device=d.device)
    u = torch.clamp(d[..., 2] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    return hor * (1.0 - u) + top * u


def shade(hit, t, normal, albedo, o, d, lights: list, vis, settings: dict):
    """rgb [N, 3] in [0, 1]: ambient + per light (Lambert, Blinn-Phong
    when shading is 'full') x visibility, then fog and sky."""
    ft = o.dtype
    p = o + t[:, None] * d + normal * SHADOW_EPS
    acc = albedo * settings["ambient"]
    for li, (lpos, lrgb, inten) in enumerate(lights):
        lp = torch.tensor(lpos, dtype=ft, device=o.device)
        lc = torch.tensor(lrgb, dtype=ft, device=o.device)
        lvec = lp[None, :] - p
        lx, ly, lz = lvec.unbind(-1)
        dist2 = lx * lx + ly * ly + lz * lz
        rinv = 1.0 / torch.sqrt(torch.clamp(dist2, min=1e-12))
        ldir = lvec * rinv[:, None]
        ndotl = torch.clamp(normal[:, 0] * ldir[:, 0]
                            + normal[:, 1] * ldir[:, 1]
                            + normal[:, 2] * ldir[:, 2], min=0.0)
        atten = (torch.tensor(inten, dtype=ft, device=o.device)
                 / (1.0 + 0.002 * dist2))
        v = vis[:, li] if vis is not None else torch.ones_like(ndotl)
        diff = ndotl * atten * v
        acc = acc + albedo * (diff[:, None] * lc[None, :])
        if settings["shading"] == "full":
            h = ldir - d
            hx, hy, hz = h.unbind(-1)
            h = h * (1.0 / torch.sqrt(torch.clamp(hx * hx + hy * hy + hz * hz,
                                                  min=1e-12)))[:, None]
            ndoth = torch.clamp(normal[:, 0] * h[:, 0] + normal[:, 1] * h[:, 1]
                                + normal[:, 2] * h[:, 2], min=0.0)
            spec = settings["specular_k"] * torch.pow(
                ndoth, settings["specular_exp"])
            spec = spec * (ndotl > 0.0) * atten * v
            acc = acc + spec[:, None] * lc[None, :]
    rgb = acc
    if settings["fog"]:
        fog_f = 1.0 - torch.exp(-settings["fog_density"] * t)
        fog_f = torch.where(hit, fog_f, 0.0)[:, None]
        rgb = rgb * (1.0 - fog_f) + sky(d, settings) * fog_f
    rgb = torch.where(hit[:, None], rgb, sky(d, settings))
    return torch.clamp(rgb, 0.0, 1.0)


def render(o, d, words, albedo, dims, lights: list, settings: dict,
           counts: Counts | None = None) -> torch.Tensor:
    """rgb [N, 3] of rays o, d (any float dtype; the tables' words are
    int32, the albedo float32): march, per-light shadow marches when
    shadows are on, shade."""
    ft = o.dtype
    max_steps = sum(dims) + 2
    hit, t, vox, rax, rsg, _ = march(o, d, words, dims, max_steps,
                                     counts=counts)
    if counts is not None:
        counts.rays += o.shape[0]
    normal = _normal(hit, rax, rsg, ft)
    X, Y, Z = dims
    vi = ((vox[:, 0].to(torch.int64) * Y + vox[:, 1]) * Z + vox[:, 2])
    alb = torch.where(hit[:, None], albedo[torch.where(hit, vi, 0)], 0.0)
    alb = alb.to(ft)
    vis = None
    if settings["shadows"] and settings["shading"] != "flat" and lights:
        cols = []
        for lpos, _, _ in lights:
            p = o + t[:, None] * d + normal * SHADOW_EPS
            p = torch.where(hit[:, None], p, 0.0)
            lvec = torch.tensor(lpos, dtype=ft, device=o.device)[None] - p
            lx, ly, lz = lvec.unbind(-1)
            dist = torch.sqrt(lx * lx + ly * ly + lz * lz)
            ldir = (lvec / torch.clamp(dist, min=1e-12)[:, None]).contiguous()
            ndl = (normal[:, 0] * ldir[:, 0] + normal[:, 1] * ldir[:, 1]
                   + normal[:, 2] * ldir[:, 2])
            facing = hit & (ndl > 0.0)
            tm = torch.where(hit, dist - 2.0 * SHADOW_EPS, 0.0)
            shit = march(p, ldir, words, dims, max_steps, t_max=tm,
                         active=facing, counts=counts)[0]
            if counts is not None:
                counts.shadow_rays += int(facing.sum())
            cols.append(torch.where(shit & hit, 0.0, 1.0).to(ft))
        vis = torch.stack(cols, dim=-1)
    return shade(hit, t, normal, alb, o, d, lights, vis, settings)
