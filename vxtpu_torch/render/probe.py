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
the fused march (K1), or ``rowmajor32``, the int32 ``child_bits | D << 8``
row-major words of the pipeline's march (K5); the TPU probes' other
formulations of the read (one-hot MXU builds and extractions) have no
Hopper counterpart. ``threads`` is the block size (the TPU probe's tile
height). The step is the TPU probe's abridged one
(``tools/probe_pallas2_cost.py:73-133``), including its progress guard on
x and y only: the probe has no z guard, and the port keeps that, so that
it computes what the probe computes. The read is the exact word; the TPU
probe's one-hot read equals it only when its window covers the table.

``cost_probe`` (the counterpart of ``probe_pallas2_cost``, ``_fixed``,
``_r5_fetch*``, ``_r4_tune`` and ``_r4_tile16``) gives each variant x
layout x block size's device time and ns per ray-iteration;
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

from vxtpu_torch.render import kernel_march as km
from vxtpu_torch.world.packed import coarse_dims, morton3

VARIANTS = ("empty", "nofetch", "nomath", "full", "static")
LAYOUTS = ("morton16", "rowmajor32")
THREADS = (128, 256, 512)
N_ITERS = 48

# Kernel launches since the last reset_launch_counts(). The wrapper adds
# one where it launches its kernel, and nowhere else.
LAUNCHES = {"march_probe_kernel": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _cell_index(cx, cy, cz, layout, dims):
    if layout == "morton16":
        return morton3(cx, cy, cz)
    _, cyd, czd = coarse_dims(dims)
    return (cx * cyd + cy) * czd + cz


def _decode(w, layout):
    """(child bits, empty-box radius) of int32 words."""
    if layout == "morton16":
        return torch.clamp(w, min=0), torch.clamp(-w, min=0)
    return w & 255, w >> 8


def _axis_t(v, dist, o_, d_, iv):
    big = dist > 0
    df = dist.to(torch.float32)
    vf = v.to(torch.float32)
    cf = (v >> 1).to(torch.float32)
    lo = torch.where(big, 2.0 * cf - 2.0 * (df - 1.0), vf)
    hi = torch.where(big, 2.0 * cf + 2.0 * df, vf + 1.0)
    t = (torch.where(d_ >= 0, hi, lo) - o_) * iv
    return torch.where(d_.abs() < 1e-12, km.BIG, t)


def march_probe_reference(o: torch.Tensor, d: torch.Tensor,
                          table: torch.Tensor, dims, n_iters: int = N_ITERS,
                          variant: str = "full",
                          layout: str = "morton16") -> torch.Tensor:
    """Plain version of ``march_probe_kernel``: acc float32 [N]."""
    X, Y, Z = dims
    ox, oy, oz = [o[:, k].contiguous() for k in range(3)]
    dx, dy, dz = [d[:, k].contiguous() for k in range(3)]
    ivx, ivy, ivz = km._inv(dx), km._inv(dy), km._inv(dz)
    one = torch.ones((), dtype=torch.int32, device=o.device)
    sgx = torch.where(dx >= 0, one, -one)
    sgy = torch.where(dy >= 0, one, -one)
    sgz = torch.where(dz >= 0, one, -one)
    vx, vy, vz = km._floor_clip(ox, X), km._floor_clip(oy, Y), \
        km._floor_clip(oz, Z)
    dist = torch.zeros_like(vx)
    acc = torch.zeros(o.shape[0], dtype=torch.float32, device=o.device)
    fixed = _cell_index(vx >> 1, vy >> 1, vz >> 1, layout, dims).long()
    for _ in range(n_iters):
        if variant == "empty":
            acc = acc + 1.0
            continue
        if variant == "nomath":
            nvx = torch.clamp(vx + sgx, 0, X - 1)
            nvy = torch.clamp(vy + sgy, 0, Y - 1)
            nvz = torch.clamp(vz + sgz, 0, Z - 1)
        else:
            tx = _axis_t(vx, dist, ox, dx, ivx)
            ty = _axis_t(vy, dist, oy, dy, ivy)
            tz = _axis_t(vz, dist, oz, dz, ivz)
            t_new = torch.minimum(torch.minimum(tx, ty), tz)
            mx = (tx <= ty) & (tx <= tz)
            my = ~mx & (ty <= tz)
            nvx = km._floor_clip(ox + (t_new + km.EPS) * dx, X)
            nvy = km._floor_clip(oy + (t_new + km.EPS) * dy, Y)
            nvz = km._floor_clip(oz + (t_new + km.EPS) * dz, Z)
            stuck = (nvx == vx) & (nvy == vy) & (nvz == vz)
            # the TPU probe's guard: x and y only
            nvx = torch.where(stuck & mx, torch.clamp(vx + sgx, 0, X - 1),
                              nvx)
            nvy = torch.where(stuck & my, torch.clamp(vy + sgy, 0, Y - 1),
                              nvy)
        if variant == "nofetch":
            acc = acc + nvx.to(torch.float32) * 1e-9
        else:
            idx = fixed if variant == "static" else _cell_index(
                nvx >> 1, nvy >> 1, nvz >> 1, layout, dims).long()
            cb, dist = _decode(table[idx].to(torch.int32), layout)
            acc = acc + torch.where(km._childbit(cb, nvx, nvy, nvz), 1.0,
                                    0.0)
        vx, vy, vz = nvx, nvy, nvz
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
    else:
        raise ValueError(f"layout: expected one of {LAYOUTS}, got {layout!r}")


def march_probe(o: torch.Tensor, d: torch.Tensor, table: torch.Tensor, dims,
                n_iters: int = N_ITERS, variant: str = "full",
                layout: str = "morton16", threads: int = 256) -> torch.Tensor:
    """Run every ray o, d (float32 [N, 3]) for ``n_iters`` probe iterations
    over ``table`` (the flat int16 Morton words for ``morton16``, the flat
    int32 row-major words for ``rowmajor32``); returns acc float32 [N].
    CUDA tensors launch ``march_probe_kernel`` with ``threads`` threads a
    block; CPU tensors run the plain version."""
    device = o.device
    kind = km._device_kind(device)
    n = o.shape[0]
    km._check("o", o, torch.float32, (n, 3), device)
    km._check("d", d, torch.float32, (n, 3), device)
    _check_table(table, dims, layout, device)
    if variant not in VARIANTS:
        raise ValueError(f"variant: expected one of {VARIANTS}, got "
                         f"{variant!r}")
    if not isinstance(n_iters, int) or n_iters < 0:
        raise ValueError(f"n_iters: expected an int >= 0, got {n_iters!r}")
    if threads not in range(32, 513, 32):
        raise ValueError(f"threads: expected a multiple of 32 in [32, 512], "
                         f"got {threads!r}")
    if kind == "cpu":
        return march_probe_reference(o, d, table, dims, n_iters, variant,
                                     layout)

    from vxtpu_torch import _build

    lib = _build.load()
    X, Y, Z = dims
    acc = torch.empty(n, dtype=torch.float32, device=device)
    if n:
        rc = lib.vx_march_probe(
            o.data_ptr(), d.data_ptr(), n, table.data_ptr(), X, Y, Z, n_iters,
            VARIANTS.index(variant), LAYOUTS.index(layout), threads,
            acc.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
        if rc:
            raise RuntimeError(f"march_probe_kernel launch failed: "
                               f"{_build.error_string(rc)}")
        LAUNCHES["march_probe_kernel"] += 1
    return acc


def identity_table(layout: str, dims, device) -> torch.Tensor:
    """A table of known words (probe_r4_matfetch's known values): the word
    of cell i is i mod 2^15, in the layout's dtype."""
    if layout == "morton16":
        cells = (dims[0] // 2) ** 3
        dtype = torch.int16
    else:
        cx, cy, cz = coarse_dims(dims)
        cells = cx * cy * cz
        dtype = torch.int32
    return (torch.arange(cells, device=device) % (1 << 15)).to(dtype)


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
               reps: int = 10) -> list:
    """Cost of a march iteration on the GPU, split into loop, target math
    and table read: for each layout (``tables``: layout -> table) x
    variant x block size, ``march_probe_kernel``'s device time per launch
    (``ms``, ``device_ms``; its clock ``clock``), the time by CUDA events
    around ``reps``
    launches (``events_ms``, which includes the wrapper) and
    ``ns_per_ray_iter`` = ms / (N * n_iters)."""
    _require_cuda(o.device)
    n = o.shape[0]
    rows = []
    for layout, table in tables.items():
        for variant in variants:
            for th in threads:
                fn = functools.partial(march_probe, o, d, table, dims,
                                       n_iters, variant, layout, th)
                ms, clock = device_ms(fn, reps, "march_probe_kernel")
                rows.append(dict(
                    variant=variant, layout=layout, threads=th, ms=ms,
                    clock=clock,
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
