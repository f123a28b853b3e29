"""The march-cost probes: a forced-iteration march kernel, its plain
PyTorch version, and the measurements that time it and the sorted march.

Counterpart of vxtpu's march-cost probes under ``tools/`` (nine
``pl.pallas_call`` sites in eight scripts). ``march_probe`` replaces their
kernels with one hand-written CUDA C++ kernel, ``march_probe_kernel`` in
``vxtpu_torch/csrc/probe.cu``: every ray runs exactly ``n_iters`` march
iterations from the clipped floor of its origin, whether it has hit
anything or not, with stages toggled by ``variant``:

- ``empty``: the loop alone (acc += 1 per iteration);
- ``nofetch``: the DDA / empty-box target math, no table read
  (acc += next x * 1e-9);
- ``nomath``: a naive diagonal step and the table read (acc += 1 per
  solid voxel visited);
- ``full``: the target math and the read (acc += 1 per solid voxel);
- ``static``: ``full`` with the read at one address per ray, the start
  voxel's cell, fixed before the loop (``probe_pallas2_fixed.py``'s static
  window).

``layout`` picks the table: ``morton16``, the int16 signed Morton words of
the fused march (K1); ``bricked16``, the 16-bit bricked ``child_bits | D
<< 8`` words of the pipeline's march (K5, ``PackedAccel.bricks``); or
``rowmajor32``, the int32 row-major words of the same march's plain
version (``PackedAccel.words``), which no kernel of the port reads any
more and which stays as the TPU probe's layout. The TPU probes' other
formulations of the read (one-hot MXU builds and extractions) have no
Hopper counterpart.

``step`` picks how the iteration is computed. ``k1`` (the default) is the
fused march's step as it is now: integer faces, one an axis; the voxel
index clamped in float and truncated once; the Morton index from a
dilation table; ``full`` reading the table only when a coordinate
changes above its lowest bit. ``tpu`` is the TPU probe's float form
(``tools/probe_pallas2_cost.py:73-133``): faces rebuilt in float, floor
then clamp, the Morton index bit by bit, a read every iteration. Both give
the same voxels and acc on every ray; only their cost differs. Both keep
the TPU probe's progress guard on x and y only (it has no z guard).

``threads`` is the block size. The ray order is the caller's:
``tile_order`` gives vxtpu's image-block order (``_tile_layout``), the
card's counterpart of the TPU probe's tile shape (``probe_r4_tile16.py``):
in ``block32x32`` a warp covers a 32x1 row of a 32x32 block and a block of
256 threads a 32x8 patch, in ``block4x8`` a warp covers a 4x8 patch.

``cost_probe`` (the counterpart of ``probe_pallas2_cost``, ``_fixed``,
``_r5_fetch*``, ``_r4_tune`` and ``_r4_tile16``) gives each step x order
x layout x variant x block size's device time and ns per ray-iteration;
``sorted_probe`` (``probe_pallas2_sorted``) times an argsort alone, the
single-round march and ``march_sorted``. Both measure on the GPU and
raise on the CPU.

On a CUDA tensor ``march_probe`` launches the kernel (or raises); on a CPU
tensor it runs ``march_probe_reference``.
"""

from __future__ import annotations

import functools
import sys
import time

import torch

from vxtpu_torch.device import resolve
from vxtpu_torch.render import kernel_march as km
from vxtpu_torch.world.packed import (BRICK, brick_dims, brick_words,
                                      coarse_dims, morton3, part1by2)

VARIANTS = ("empty", "nofetch", "nomath", "full", "static")
LAYOUTS = ("morton16", "rowmajor32", "bricked16")
STEPS = ("k1", "tpu")
# ray orders: name -> the image block whose pixels lie next to each other
# (None: scanline, the image's own row-major order)
ORDERS = {"scanline": None, "block32x32": (32, 32), "block4x8": (4, 8)}
THREADS = (128, 256, 512)
N_ITERS = 48
# the ray a padded slot of a block order gets (vxtpu's pack fill): outside
# the grid, looking down
PAD_O = (-10.0, -10.0, -10.0)
PAD_D = (0.0, 0.0, -1.0)

# Kernel launches since the last reset_launch_counts(). The wrapper adds
# one where it launches its kernel, and nowhere else.
LAUNCHES = {"march_probe_kernel": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _cell_index(cx, cy, cz, layout, dims):
    """Table index of coarse cell (cx, cy, cz)."""
    if layout == "morton16":
        return morton3(cx, cy, cz)
    if layout == "bricked16":
        _, bry, brz = brick_dims(dims)
        return ((((cx >> 2) * bry + (cy >> 2)) * brz + (cz >> 2)) << 6) \
            | ((cx & 3) << 4) | ((cy & 3) << 2) | (cz & 3)
    _, cyd, czd = coarse_dims(dims)
    return (cx * cyd + cy) * czd + cz


def _decode(w, layout):
    """(child bits, empty-box radius) of words read from the table."""
    w = w.to(torch.int32)
    if layout == "morton16":
        return torch.clamp(w, min=0), torch.clamp(-w, min=0)
    if layout == "bricked16":
        w = w & 0xFFFF          # the uint16 bit pattern
    return w & 255, w >> 8


def dilation_table(n: int, device) -> torch.Tensor:
    """int32 [n]: entry v is part1by2(v >> 1), the dilated coarse
    coordinate of fine coordinate v (the kernel's shared-memory table)."""
    return part1by2(torch.arange(n, dtype=torch.int32, device=device) >> 1)


def _axis_t(v, dist, o_, d_, iv):
    """The TPU probe's exit t on one axis: both faces rebuilt in float."""
    big = dist > 0
    df = dist.to(torch.float32)
    vf = v.to(torch.float32)
    cf = (v >> 1).to(torch.float32)
    lo = torch.where(big, 2.0 * cf - 2.0 * (df - 1.0), vf)
    hi = torch.where(big, 2.0 * cf + 2.0 * df, vf + 1.0)
    t = (torch.where(d_ >= 0, hi, lo) - o_) * iv
    return torch.where(d_.abs() < 1e-12, km.BIG, t)


def _face_t(v, dist, o_, d_, iv):
    """K1's exit t on one axis: the face the direction picks, formed as an
    exact integer (the voxel index, its low bit masked in a box, plus one
    of two offsets) and converted once."""
    base = ~torch.clamp(dist, max=1)
    hi = torch.clamp(2 * dist, min=1)
    lo = torch.clamp(2 - 2 * dist, max=0)
    face = (v & base) + torch.where(d_ >= 0, hi, lo)
    t = (face.to(torch.float32) - o_) * iv
    return torch.where(d_.abs() < 1e-12, km.BIG, t)


def _clip_floor(p, n: int):
    """K1's voxel index: clamped to [0, n - 1] in float, then truncated
    (floor-then-clamp's integer for every p but NaN)."""
    return torch.clamp(p, 0.0, float(n - 1)).to(torch.int32)


def march_probe_reference(o: torch.Tensor, d: torch.Tensor,
                          table: torch.Tensor, dims, n_iters: int = N_ITERS,
                          variant: str = "full", layout: str = "morton16",
                          step: str = "k1", stats: dict | None = None
                          ) -> torch.Tensor:
    """Plain version of ``march_probe_kernel``: acc float32 [N]. With a
    ``stats`` dict, stats["reads"] is int32 [N], the table reads of each
    ray, and stats["touched"] bool [table size], the words read."""
    X, Y, Z = dims
    k1 = step == "k1"
    clip = _clip_floor if k1 else km._floor_clip
    exit_t = _face_t if k1 else _axis_t
    ox, oy, oz = [o[:, k].contiguous() for k in range(3)]
    dx, dy, dz = [d[:, k].contiguous() for k in range(3)]
    ivx, ivy, ivz = km._inv(dx), km._inv(dy), km._inv(dz)
    one = torch.ones((), dtype=torch.int32, device=o.device)
    sgx = torch.where(dx >= 0, one, -one)
    sgy = torch.where(dy >= 0, one, -one)
    sgz = torch.where(dz >= 0, one, -one)
    vx, vy, vz = clip(ox, X), clip(oy, Y), clip(oz, Z)
    dil = dilation_table(max(dims), o.device)

    def cell(vx, vy, vz):
        if k1 and layout == "morton16":
            idx = dil[vx.long()] | (dil[vy.long()] << 1) \
                | (dil[vz.long()] << 2)
        else:
            idx = _cell_index(vx >> 1, vy >> 1, vz >> 1, layout, dims)
        return idx.long()

    dist = torch.zeros_like(vx)
    cb = torch.zeros_like(vx)
    acc = torch.zeros(o.shape[0], dtype=torch.float32, device=o.device)
    reads = torch.zeros_like(vx)
    fresh = torch.ones_like(vx, dtype=torch.bool)
    touched = torch.zeros(table.numel(), dtype=torch.bool, device=o.device)
    fixed = cell(vx, vy, vz)
    for _ in range(n_iters):
        if variant == "empty":
            acc = acc + 1.0
            continue
        if variant == "nomath":
            nvx = torch.clamp(vx + sgx, 0, X - 1)
            nvy = torch.clamp(vy + sgy, 0, Y - 1)
            nvz = torch.clamp(vz + sgz, 0, Z - 1)
        else:
            tx = exit_t(vx, dist, ox, dx, ivx)
            ty = exit_t(vy, dist, oy, dy, ivy)
            tz = exit_t(vz, dist, oz, dz, ivz)
            t_new = torch.minimum(torch.minimum(tx, ty), tz)
            mx = (tx <= ty) & (tx <= tz)
            my = ~mx & (ty <= tz)
            nvx = clip(ox + (t_new + km.EPS) * dx, X)
            nvy = clip(oy + (t_new + km.EPS) * dy, Y)
            nvz = clip(oz + (t_new + km.EPS) * dz, Z)
            stuck = (nvx == vx) & (nvy == vy) & (nvz == vz)
            # the TPU probe's guard: x and y only
            nvx = torch.where(stuck & mx, torch.clamp(vx + sgx, 0, X - 1),
                              nvx)
            nvy = torch.where(stuck & my, torch.clamp(vy + sgy, 0, Y - 1),
                              nvy)
        if variant == "nofetch":
            acc = acc + nvx.to(torch.float32) * 1e-9
        else:
            idx = fixed if variant == "static" else cell(nvx, nvy, nvz)
            ncb, ndist = _decode(table[idx], layout)
            if k1 and variant == "full":
                # the word of the cell in registers: read on a cell change
                read = fresh | (((nvx ^ vx) | (nvy ^ vy) | (nvz ^ vz)) > 1)
                cb = torch.where(read, ncb, cb)
                dist = torch.where(read, ndist, dist)
                fresh = torch.zeros_like(fresh)
            else:
                read = torch.ones_like(fresh)
                cb, dist = ncb, ndist
            reads = reads + read
            if stats is not None:
                touched[idx[read]] = True
            acc = acc + torch.where(km._childbit(cb, nvx, nvy, nvz), 1.0,
                                    0.0)
        vx, vy, vz = nvx, nvy, nvz
    if stats is not None:
        stats.update(reads=reads, touched=touched)
    return acc


def _check_table(table, dims, layout, device):
    if layout == "morton16":
        X, Y, Z = dims
        if not (X == Y == Z and X >= 2 and (X & (X - 1)) == 0):
            raise ValueError(f"morton16 needs a cubic power-of-two grid, "
                             f"got {tuple(dims)}")
        km._check("table", table, torch.int16, ((X // 2) ** 3,), device)
    elif layout == "rowmajor32":
        cx, cy, cz = coarse_dims(dims)
        km._check("table", table, torch.int32, (cx * cy * cz,), device)
    elif layout == "bricked16":
        bx, by, bz = brick_dims(dims)
        km._check("table", table, torch.int16, (bx * by * bz * BRICK ** 3,),
                  device)
    else:
        raise ValueError(f"layout: expected one of {LAYOUTS}, got {layout!r}")


def march_probe(o: torch.Tensor, d: torch.Tensor, table: torch.Tensor, dims,
                n_iters: int = N_ITERS, variant: str = "full",
                layout: str = "morton16", threads: int = 256,
                step: str = "k1") -> torch.Tensor:
    """Run every ray o, d (float32 [N, 3]) for ``n_iters`` probe iterations
    over ``table`` (the flat int16 Morton words for ``morton16``, the flat
    int32 row-major words for ``rowmajor32``, the int16 bricked words of
    ``world.packed.brick_words`` for ``bricked16``); returns acc float32
    [N]. CUDA tensors launch ``march_probe_kernel`` (its ``step`` form)
    with ``threads`` threads a block; CPU tensors run the plain version."""
    device = o.device
    kind = km._device_kind(device)
    n = o.shape[0]
    km._check("o", o, torch.float32, (n, 3), device)
    km._check("d", d, torch.float32, (n, 3), device)
    _check_table(table, dims, layout, device)
    if variant not in VARIANTS:
        raise ValueError(f"variant: expected one of {VARIANTS}, got "
                         f"{variant!r}")
    if step not in STEPS:
        raise ValueError(f"step: expected one of {STEPS}, got {step!r}")
    if not isinstance(n_iters, int) or n_iters < 0:
        raise ValueError(f"n_iters: expected an int >= 0, got {n_iters!r}")
    if threads not in range(32, 513, 32):
        raise ValueError(f"threads: expected a multiple of 32 in [32, 512], "
                         f"got {threads!r}")
    if kind == "cpu":
        return march_probe_reference(o, d, table, dims, n_iters, variant,
                                     layout, step)

    from vxtpu_torch import _build

    lib = _build.load()
    X, Y, Z = dims
    acc = torch.empty(n, dtype=torch.float32, device=device)
    if n:
        rc = lib.vx_march_probe(
            o.data_ptr(), d.data_ptr(), n, table.data_ptr(), X, Y, Z, n_iters,
            VARIANTS.index(variant), LAYOUTS.index(layout),
            STEPS.index(step), threads, acc.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
        if rc:
            raise RuntimeError(f"march_probe_kernel launch failed: "
                               f"{_build.error_string(rc)}")
        LAUNCHES["march_probe_kernel"] += 1
    return acc


def blocks_per_sm(variant: str, layout: str, step: str, threads: int,
                  dims) -> int:
    """Blocks of ``threads`` threads of one instantiation an SM holds at
    once (the CUDA occupancy API; GPU machines only)."""
    from vxtpu_torch import _build

    return _build.load().vx_march_probe_blocks_per_sm(
        VARIANTS.index(variant), LAYOUTS.index(layout), STEPS.index(step),
        threads, *dims)


def identity_table(layout: str, dims, device) -> torch.Tensor:
    """A table of known words (probe_r4_matfetch's known values): the word
    of coarse cell c is its row-major index mod 2^15 in the row-major
    layouts (``bricked16`` holds ``rowmajor32``'s words, bricked), its
    Morton index mod 2^15 in ``morton16``; in the layout's dtype."""
    if layout == "morton16":
        cells = (dims[0] // 2) ** 3
        return (torch.arange(cells, device=device) % (1 << 15)).to(
            torch.int16)
    cx, cy, cz = coarse_dims(dims)
    words = (torch.arange(cx * cy * cz, device=device) % (1 << 15)).to(
        torch.int32)
    return brick_words(words, dims) if layout == "bricked16" else words


def tile_order(image_shape, block_shape, device=None):
    """(order, inverse) of vxtpu's image-block ray order
    (``kernel_pallas_v2._tile_layout``): the image, padded at its bottom
    and right edges to whole ``bh x bw`` blocks, cut into blocks taken in
    row-major order, each block's pixels row-major and next to each other.
    order: int64 [Hp * Wp], the row-major pixel index of each slot, -1 at
    a padded slot; inverse: int64 [H * W], the slot of each pixel (so
    ``x[inverse]`` puts a result in slot order back in pixel order)."""
    device = resolve(device)
    H, W = image_shape
    bh, bw = block_shape
    Hp, Wp = H + (-H) % bh, W + (-W) % bw
    img = torch.full((Hp, Wp), -1, dtype=torch.int64, device=device)
    img[:H, :W] = torch.arange(H * W, device=device).view(H, W)
    order = img.view(Hp // bh, bh, Wp // bw, bw).permute(0, 2, 1, 3) \
        .reshape(-1)
    real = order >= 0
    inverse = torch.empty(H * W, dtype=torch.int64, device=device)
    inverse[order[real]] = torch.nonzero(real).squeeze(1)
    return order, inverse


def permute_rays(o: torch.Tensor, d: torch.Tensor, order: torch.Tensor):
    """o, d in ``order``'s slots; a padded slot (-1) gets vxtpu's pad ray
    (PAD_O, PAD_D), which no result in pixel order reads."""
    pad = order < 0
    idx = torch.where(pad, 0, order)
    po = torch.where(pad[:, None], o.new_tensor(PAD_O), o[idx])
    pd = torch.where(pad[:, None], d.new_tensor(PAD_D), d[idx])
    return po.contiguous(), pd.contiguous()


def ordered_rays(o, d, image_shape, order_name: str):
    """(o, d, inverse) of the rays of an ``image_shape`` frame in one of
    ORDERS (scanline: as given, inverse None)."""
    block = ORDERS[order_name]
    if block is None:
        return o, d, None
    order, inverse = tile_order(image_shape, block, o.device)
    return (*permute_rays(o, d, order), inverse)


# --------------------------------------------------------------------------
# measurements (GPU only)


def _require_cuda(device) -> None:
    if device.type != "cuda":
        raise RuntimeError("cost_probe and sorted_probe time the GPU: "
                           "pass CUDA tensors")


def _events_ms(fn, reps: int) -> float:
    """Mean ms per call of ``reps`` back-to-back calls after a warm-up,
    CUDA events around the run."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def launch_us(fn, reps: int, kernel: str) -> list:
    """Device time (us) of each launch of the kernels whose name holds
    ``kernel`` that torch.profiler recorded over ``reps`` calls after a
    warm-up, in the order they ran (it can drop some)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen = sorted((e.time_range.start, e.time_range.elapsed_us())
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA and kernel in e.name)
    return [us for _, us in seen]


# profiler windows device_ms takes at most before it gives up
_EMPTY_WINDOW_RETRIES = 6
# the clocks behind a time: the profiler's device time of the kernels, CUDA
# events around the calls, or the host's clock after a device sync
CLOCK_DEVICE = "profiler-device"
CLOCK_EVENTS = "events"
CLOCK_WALL = "wall+sync"


def device_ms(fn, reps: int, kernel: str,
              per_call: bool = False) -> tuple[float, str]:
    """(ms, clock): the device time per launch of the kernels whose name
    holds ``kernel`` ("" takes every kernel), from torch.profiler over
    ``reps`` calls after a warm-up (their summed device time over the
    launches it recorded; with ``per_call``, over ``reps``: all the
    device work of a call), and CLOCK_DEVICE. It can drop some launches,
    and now and then records none for several windows in a row: such a
    window is noted on stderr and taken again after a pause that grows by
    0.5 s with each empty one, _EMPTY_WINDOW_RETRIES windows at most. If
    none recorded one, the time is the CUDA events time of the same calls
    (``_events_ms``: back-to-back launches, an upper bound that includes
    the gaps between them) and the clock CLOCK_EVENTS."""
    for k in range(_EMPTY_WINDOW_RETRIES):
        us = launch_us(fn, reps, kernel)
        if us:
            return sum(us) / (reps if per_call else len(us)) / 1e3, \
                CLOCK_DEVICE
        print(f"device_ms: the profiler recorded no {kernel} in window "
              f"{k + 1} of {_EMPTY_WINDOW_RETRIES}", file=sys.stderr)
        time.sleep(0.5 * (k + 1))
    return _events_ms(fn, reps), CLOCK_EVENTS


def warp_coherence(*phases) -> float:
    """Sum of steps over the sum, over consecutive 32-ray groups in launch
    order, of 32 x the group's largest steps in each phase (a warp runs
    its phases, such as the primary march and then each shadow march,
    one after another, each as long as its longest lane): the share of a
    warp's iterations that its rays use (1 = no divergence tail)."""
    used = lanes = 0
    for steps in phases:
        s = steps.to(torch.int64)
        s = torch.cat([s, s.new_zeros((-s.numel()) % 32)]).view(-1, 32)
        used += int(s.sum())
        lanes += 32 * int(s.amax(1).sum())
    return used / lanes if lanes else 1.0


def cost_probe(o: torch.Tensor, d: torch.Tensor, tables: dict, dims,
               n_iters: int = N_ITERS, variants=VARIANTS, threads=THREADS,
               orders=("scanline",), image_shape=None, steps=("k1",),
               reps: int = 10) -> list:
    """Cost of a march iteration on the GPU, split into loop, target math
    and table read: for each ray order (ORDERS; the block orders need the
    frame's ``image_shape``) x step x layout (``tables``: layout -> table)
    x variant x block size, ``march_probe_kernel``'s device time per
    launch (``ms``, ``device_ms``; its clock ``clock``), the time by CUDA
    events around ``reps`` launches (``events_ms``, which includes the
    wrapper) and ``ns_per_ray_iter`` = ms / (N * n_iters) over the N rays
    given (``slots``: the rays launched, padding included). The rays are
    put in each order before the timing, outside it. Within one step,
    layout and variant, acc must be equal across orders once put back in
    pixel order, or it raises."""
    _require_cuda(o.device)
    n = o.shape[0]
    rows, first = [], {}
    for order in orders:
        if ORDERS[order] is not None and image_shape is None:
            raise ValueError(f"order {order!r} needs the image_shape")
        oo, dd, inverse = ordered_rays(o, d, image_shape, order)
        for step in steps:
            for layout, table in tables.items():
                for variant in variants:
                    acc = march_probe(oo, dd, table, dims, n_iters, variant,
                                      layout, threads[0], step)
                    if inverse is not None:
                        acc = acc[inverse]
                    key = (step, layout, variant)
                    if not torch.equal(first.setdefault(key, acc), acc):
                        raise AssertionError(
                            f"K6 {step} {layout} {variant}: acc in order "
                            f"{order} differs from order {orders[0]}")
                    for th in threads:
                        fn = functools.partial(march_probe, oo, dd, table,
                                               dims, n_iters, variant,
                                               layout, th, step)
                        ms, clock = device_ms(fn, reps, "march_probe_kernel")
                        rows.append(dict(
                            order=order, step=step, variant=variant,
                            layout=layout, threads=th, ms=ms, clock=clock,
                            slots=oo.shape[0],
                            events_ms=_events_ms(fn, reps),
                            ns_per_ray_iter=ms * 1e6 / max(n * n_iters, 1)))
    return rows


def sorted_probe(o: torch.Tensor, d: torch.Tensor, accel, dims,
                 max_steps: int, round0_iters=(8, 16, 24, 32),
                 survivor_frac: int = 8, reps: int = 5,
                 seed: int = 0) -> dict:
    """Does a Morton-sorted resume round pay on the GPU? CUDA-event times
    (ms per call, ``reps`` calls after a warm-up) of a stable argsort of N
    random int32 keys in [0, 2^17) alone, of the single-round march-only
    march (``single_ms``; ``single_device_ms`` its kernel's device time,
    ``single_device_clock`` that time's clock)
    and of ``march_sorted`` at each ``round0_iters`` (with its rounds and
    survivors)."""
    _require_cuda(o.device)
    n = o.shape[0]
    g = torch.Generator().manual_seed(seed)
    key = torch.randint(0, 1 << 17, (n,), generator=g,
                        dtype=torch.int32).to(o.device)
    single = functools.partial(km.march, o, d, accel, dims, max_steps)
    single_device = device_ms(single, reps, "march_shade_kernel")
    out = dict(n=n, argsort_ms=_events_ms(
        lambda: torch.argsort(key, stable=True), reps),
        single_ms=_events_ms(single, reps),
        single_device_ms=single_device[0],
        single_device_clock=single_device[1], sorted={})
    for r0 in round0_iters:
        stats = {}
        run = functools.partial(km.march_sorted, o, d, accel, dims,
                                max_steps, round0_iters=r0,
                                survivor_frac=survivor_frac)
        run(stats=stats)
        out["sorted"][r0] = dict(ms=_events_ms(run, reps),
                                 rounds=stats["rounds"],
                                 survivors=stats["survivors"])
    return out
