"""The row-major march kernel and its plain PyTorch version.

Counterpart of ``vxtpu/render/kernel_pallas.py``: ``march_packed``
replaces ``march_pallas`` (the ``_march_kernel`` Pallas kernel: the DDA
march over the row-major ``PackedAccel`` table, without a shade
epilogue) and ``make_march_packed`` replaces ``make_march_pallas``, the
factory of the composable pipeline (``render/pipeline.py``). The kernel,
``march_packed_kernel``, is hand-written CUDA C++ in
``vxtpu_torch/csrc/march_packed.cu``, built for sm_90a at first use.

What bounds it on an H100: one thread per ray runs a divergent loop of a
few iterations, some hundred instructions each, whose every change of
coarse cell is a dependent table read; the kernel is bound by
instruction issue and latency, and its byte bound (the ray I/O) is less
than half its time. What the design does about it: each step forms the
one face per axis the ray leaves by, as an exact integer, and reads the
table only when the ray changes cell; fewer live values let 6 blocks of
256 threads share an SM; and the kernel reads ``PackedAccel.bricks``, a
16-bit copy of the words in 4x4x4-cell bricks of one 128-byte line
(``world/packed.py``): 4 MiB at 256^3 and 32 MiB at 512^3, both
resident in the 50 MB L2 (the int32 table at 512^3, 64 MiB, is not).
The current cell's word stays in registers, so steps inside one 2x2x2
cell read nothing; empty space is crossed in one jump per empty box.

The per-ray contract is vxtpu v1's, which differs from the fused march
(``kernel_march.march_reference``) in five places:

  1. at most ``max_steps`` loop iterations; a ray still live there misses;
  2. ``steps`` counts every iteration in which the ray is live, the one
     where it leaves the grid or passes t_end included;
  3. the voxel is overwritten on every live iteration with the clipped
     next voxel, so a miss reports the voxel it stepped to on leaving;
  4. a ray is valid when t_enter <= t_exit; the entry hit also needs
     t_enter <= t_max, so a valid ray with t_enter > t_max takes one
     iteration and stops with steps = 1;
  5. the word is child_bits | D << 8 (D = 0: the cell is occupied), the
     cell index row-major over ``coarse_dims``, which need only be even
     (the kernel reads the same words from their bricked copy).

On a CUDA tensor ``march_packed`` launches the kernel (or raises); on a
CPU tensor it runs ``march_packed_reference``.
"""

from __future__ import annotations

import functools

import torch

from vxtpu_torch.render.kernel_march import (BIG, BIG_T, EPS, _check,
                                             _childbit, _device_kind,
                                             _floor_clip, _hit_record, _inv,
                                             _ptr)
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.render.types import HitRecord
from vxtpu_torch.world.packed import (BRICK, PackedAccel, brick_dims,
                                      build_packed, coarse_dims)

# Kernel launches since the last reset_launch_counts(). The wrapper adds
# one where it launches the kernel, and nowhere else.
LAUNCHES = {"march_packed_kernel": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _fetch(words, cd, vx, vy, vz):
    """(child bits, D) of the coarse cell holding voxel (vx, vy, vz)."""
    _, cyd, czd = cd
    cx, cy, cz = (vx >> 1).long(), (vy >> 1).long(), (vz >> 1).long()
    w = words[(cx * cyd + cy) * czd + cz]
    return w & 255, w >> 8


def march_packed_reference(o: torch.Tensor, d: torch.Tensor,
                           accel: PackedAccel, dims, max_steps: int,
                           t_max: torch.Tensor | None = None) -> HitRecord:
    """Plain version of the row-major march: a vectorised masked loop over
    all rays that compacts the live rays after every iteration, with the
    per-ray contract of the module docstring."""
    X, Y, Z = dims
    cd = coarse_dims(dims)
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
    valid = t_enter <= t_exit
    t_end = torch.minimum(t_exit, t_max)

    one = torch.ones((), dtype=torch.int32, device=dev)
    sgx = torch.where(dx >= 0, one, -one)
    sgy = torch.where(dy >= 0, one, -one)
    sgz = torch.where(dz >= 0, one, -one)

    def reinit(ox, oy, oz, dx, dy, dz, t):
        px = ox + (t + EPS) * dx
        py = oy + (t + EPS) * dy
        pz = oz + (t + EPS) * dz
        inside = ((px >= 0) & (px < X) & (py >= 0) & (py < Y)
                  & (pz >= 0) & (pz < Z))
        return _floor_clip(px, X), _floor_clip(py, Y), _floor_clip(pz, Z), \
            inside

    vx, vy, vz, _ = reinit(ox, oy, oz, dx, dy, dz, t_enter)
    cb, dist = _fetch(words, cd, vx, vy, vz)
    first_hit = valid & _childbit(cb, vx, vy, vz) & (t_enter <= t_max)
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

    # live rays, compacted: constants and carry
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

        go_on = inside & ~(t_new > ct_end)
        ncb, ndist = _fetch(words, cd, nvx, nvy, nvz)
        new_hit = go_on & _childbit(ncb, nvx, nvy, nvz)
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
    return _hit_record(hit, t_hit, vox, rax, rsg, steps)


def march_packed(o: torch.Tensor, d: torch.Tensor, accel: PackedAccel,
                 dims, max_steps: int,
                 t_max: torch.Tensor | None = None) -> HitRecord:
    """March rays o, d (float32 [N, 3]) through the row-major table;
    HitRecord [N]. CUDA tensors launch ``march_packed_kernel``; CPU
    tensors run the plain version."""
    device = o.device
    kind = _device_kind(device)
    n = o.shape[0]
    _check("o", o, torch.float32, (n, 3), device)
    _check("d", d, torch.float32, (n, 3), device)
    if t_max is not None:
        _check("t_max", t_max, torch.float32, (n,), device)
    cx, cy, cz = coarse_dims(dims)
    _check("accel.words", accel.words, torch.int32, (cx * cy * cz,), device)
    if kind == "cpu":
        return march_packed_reference(o, d, accel, dims, max_steps, t_max)

    bx, by, bz = brick_dims(dims)
    _check("accel.bricks", accel.bricks, torch.int16,
           (bx * by * bz * BRICK ** 3,), device)
    from vxtpu_torch import _build

    lib = _build.load()
    X, Y, Z = dims
    hit = torch.empty(n, dtype=torch.bool, device=device)
    t = torch.empty(n, dtype=torch.float32, device=device)
    voxel = torch.empty((n, 3), dtype=torch.int32, device=device)
    normal = torch.empty((n, 3), dtype=torch.float32, device=device)
    steps = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        rc = lib.vx_march_packed(
            _ptr(o), _ptr(d), _ptr(t_max), n, _ptr(accel.bricks), X, Y, Z,
            max_steps, _ptr(hit), _ptr(t), _ptr(voxel), _ptr(normal),
            _ptr(steps), torch.cuda.current_stream(device).cuda_stream)
        if rc:
            raise RuntimeError(f"march_packed_kernel launch failed: "
                               f"{_build.error_string(rc)}")
        LAUNCHES["march_packed_kernel"] += 1
    return HitRecord(hit=hit, t=t, voxel=voxel, normal=normal, steps=steps)


def make_march_packed(occ_flat, dims, settings: RenderSettings, accel=None):
    """Pipeline march factory: ``march(o, d, t_max=None) -> HitRecord``.
    ``accel`` must be a PackedAccel; it is built from the grid when it is
    not."""
    if not isinstance(accel, PackedAccel):
        accel = build_packed(occ_flat.reshape(dims))
    return functools.partial(march_packed, accel=accel, dims=dims,
                             max_steps=settings.resolve_max_steps(dims))
