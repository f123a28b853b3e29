"""The benchmark on one GPU (counterpart of the repository's ``bench.py``
with ``tools/bench_train_masked.py`` and ``tools/bench_train_field.py``):

    python -m vxtpu_torch.bench [--wavefront-inside] [--skip-fused]
                                [--skip-train] [--details PATH]

Three sections, at bench.py's sizes, cameras, lights and seeds:

  forward  the 512^3 terrain (seed 7) with a cap-96 distance field, one
           1080x1920 lambert frame through the composable pipeline with
           the wavefront march (render/kernel_wavefront.py, its schedule
           sized by count_valid_rays), the march's exact counters
           (stats=True) and the floor: the table lanes it gathers at the
           device time per lane of a gather of B1 random indices from the
           field, plus one full-width int32 cumsum a round;
           ``--wavefront-inside`` adds the camera inside the rock;
  fused    the same scene through the fused kernel K1: march only, the
           lambert frame (the headline), full + shadows + fog, and the
           inside camera lambert; the march's total steps and warp
           coherence, and K1's device time in each launch mode;
  train    the config-5-shaped train steps at 128^3 (truth from seed 7,
           256x256 lit rays, the light at (25, -38, 180)) on a 1-rank
           process group through engine/sharding.make_sharded_train_step:
           S = 64 with the custom backward and 1 or 4 gradient buckets;
           the occupancy-masked step (S = 16, G = 4, from 0.8 x the
           truth, its bounds recomputed before each step); the field-
           kernel step (K3/K4 from zeros, S = 64, the camera refined: K4
           with ray cotangents and the ray sum).

Below the full size (the tests' small calls) the cameras and lights move
with the grid. Every time names its clock: ``wall+sync`` (the host's
clock around the calls, the device synchronised after them), ``events``
(CUDA events) or ``profiler-device`` (the kernels' own device time); a
time's key (``ms`` or ``<x>_ms``) has its clock beside it in
``<key>_clock``. The kernels' launch counts of each section (reset
before it, read after it) are in the details. vxtpu's in-jit K-fold
floor calibration and its subprocesses around the train steps work
around a TPU endpoint's dispatch noise and faults; here the floor is
timed on the device and the steps run in this process.

Prints the details as one JSON line (also written to ``--details PATH``),
then the headline as the last line. ``vs_baseline`` is the headline rate
over 1920 x 1080 x 60 rays/s: 1080p at 60 frames a second, a display
rate, not a figure of the card. ``--device cpu`` runs the plain versions
of the kernels (for tests); sizes are the functions' parameters.
"""

from __future__ import annotations

import argparse
import functools
import json
import shutil
import subprocess
import time

import torch

from vxtpu_torch.device import resolve
from vxtpu_torch.render import probe
from vxtpu_torch.render.probe import CLOCK_WALL

# 1080p at 60 frames a second, in Mrays/s (a display rate)
DISPLAY_MRAYS = 1920 * 1080 * 60 / 1e6
NOT_MEASURED = "not measured"

OUTSIDE = ((-360.0, 256.0, 560.0), (256.0, 256.0, 140.0))
INSIDE = ((256.0, 256.0, 120.0), (500.0, 400.0, 90.0))
LIGHT = (100.0, -150.0, 700.0)
TRAIN_CAM = ((-90.0, 64.0, 140.0), (64.0, 64.0, 35.0))
TRAIN_LIGHT = (25.0, -38.0, 180.0)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(row: dict, key: str, ms, clock: str) -> None:
    """row[key] = ms and row[key + "_clock"] = its clock."""
    row[key] = ms
    row[f"{key}_clock"] = clock


def wall_ms(fn, device, iters: int, warm: int = 1,
            sync_each: bool = False) -> float:
    """Mean ms a call of fn over ``iters`` calls after ``warm`` calls, on
    the host's clock with the device synchronised at the end (after each
    call with ``sync_each``)."""
    for _ in range(warm):
        fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        if sync_each:
            _sync(device)
    _sync(device)
    return (time.perf_counter() - t0) / iters * 1e3


def device_time(row: dict, key: str, fn, device, reps: int = 20,
                kernel: str = "", per_call: bool = False) -> str:
    """row[key] = render/probe.py:device_ms of fn on the GPU (None
    elsewhere) and row[key + "_clock"] = its clock ("not measured"
    elsewhere); returns "<ms> ms (<clock>)" for a printed line."""
    if device.type != "cuda":
        timed(row, key, None, NOT_MEASURED)
        return NOT_MEASURED
    timed(row, key, *probe.device_ms(fn, reps, kernel, per_call=per_call))
    return f"{row[key]:.4f} ms ({row[f'{key}_clock']})"


def times_without_clock(obj, path: str = "") -> list:
    """The time keys (``ms``, ``<x>_ms``) of a JSON object, at any depth,
    without a ``<key>_clock`` beside them."""
    out = []
    if isinstance(obj, dict):
        for k, v in obj.items():
            if (k == "ms" or k.endswith("_ms")) and f"{k}_clock" not in obj:
                out.append(path + k)
            out += times_without_clock(v, f"{path}{k}.")
    return out


def gpu_report() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


def scaled(p, scale: float) -> tuple:
    return tuple(x * scale for x in p)


def camera(pos_at, device, scale: float = 1.0):
    """bench.py's camera (a 55-degree field of view), its positions scaled
    with the grid (1 at the full size)."""
    from vxtpu_torch.camera.camera import Camera

    pos, at = (scaled(p, scale) for p in pos_at)
    return Camera.make(pos=pos, fov_y_deg=55.0, device=device).look_at(at)


def world(device, D: int = 512):
    """The forward and fused sections' scene: D^3 terrain, seed 7."""
    from vxtpu_torch.world import procgen

    return procgen.terrain((D,) * 3, seed=7, device=device)


def bench_forward(details: dict, device, grid=None, D: int = 512,
                  h: int = 1080, w: int = 1920, iters: int = 4,
                  inside: bool = False) -> dict:
    """The wavefront frame, its counters and its floor (see the module
    docstring); fills details["forward"], ["counters"], ["roofline"] (and
    ["forward_inside_camera"]). Returns the frame and the march's
    HitRecord."""
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render import kernel_wavefront as kw
    from vxtpu_torch.render.pipeline import render_image
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.world import distfield
    from vxtpu_torch.world.lights import Lights

    grid = world(device, D) if grid is None else grid
    dims = grid.dims
    t0 = time.perf_counter()
    accel = distfield.build(grid.occupancy, cap=96)
    _sync(device)
    setup_s = time.perf_counter() - t0
    settings = RenderSettings(shading="lambert", step_chunk=8)
    scale = dims[0] / 512
    lights = Lights.single(scaled(LIGHT, scale), intensity=2.0,
                           device=device)
    max_steps = settings.resolve_max_steps(dims)

    def frame_of(cam):
        o, d = generate_rays(cam, h, w)
        vc = kw.count_valid_rays(o, d, dims)   # outside the timed window
        factory = functools.partial(kw.make_march_wavefront, valid_count=vc)
        frame = functools.partial(render_image, factory, grid, cam, lights,
                                  settings, h, w, accel)
        return o, d, vc, frame

    o, d, vc, frame = frame_of(camera(OUTSIDE, device, scale))
    img = frame()                       # the warm-up
    dt = wall_ms(frame, device, iters, warm=0)
    fwd = dict(mrays=h * w / dt / 1e3, valid_rays=vc,
               schedule="adaptive(valid_count)", kernel="wavefront",
               distfield_cap96_build_s=setup_s)
    timed(fwd, "frame_ms", dt, CLOCK_WALL)
    details["forward"] = fwd
    if inside:
        _, _, vc_in, frame_in = frame_of(camera(INSIDE, device, scale))
        dt_in = wall_ms(frame_in, device, iters)
        inn = dict(mrays=h * w / dt_in / 1e3, valid_rays=vc_in,
                   schedule="adaptive(valid_count)", kernel="wavefront")
        timed(inn, "frame_ms", dt_in, CLOCK_WALL)
        details["forward_inside_camera"] = inn

    # the exact counters of the frame's march
    df_flat = accel.field.reshape(-1)
    rec, st = kw.march_wavefront(o, d, df_flat, dims, max_steps,
                                 valid_count=vc, stats=True)
    sched = st["schedule"]
    n_rounds = st["total_rounds"]
    lanes = st["gathered_lanes"]
    details["counters"] = dict(
        rays=h * w, valid=int(st["valid"]), schedule=sched,
        round_steps=st["round_steps"],
        round_counts=[int(c) for c in st["round_counts"]],
        drain_rounds=st["drain_rounds"],
        drain_steps_total=st["drain_steps_total"], gathered_lanes=lanes,
        useful_ray_steps=int(rec.steps.sum()), rounds_total=n_rounds,
        host_syncs=st["host_syncs"])

    # the floor: the device time per gathered lane and of one full-width
    # compaction scan (every device kernel of the call)
    g = torch.Generator().manual_seed(0)
    B1 = sched[0][0]
    idx = torch.randint(0, df_flat.shape[0], (B1,), generator=g).to(device)
    act = (torch.rand((h * w,), generator=g) < 0.5).to(device)
    roof = dict(gathered_lanes=lanes, gather_lanes=B1,
                note=("floor = the device time per gathered lane x the "
                      "exact gathered lanes + one full-width int32 cumsum "
                      "a round + 9 state lanes a buffer slot a round; 100% "
                      "= the frame costs only that memory traffic"))
    device_time(roof, "gather_ms", lambda: df_flat[idx], device,
                per_call=True)
    device_time(roof, "cumsum_full_width_ms",
                lambda: torch.cumsum(act.to(torch.int32), 0,
                                     dtype=torch.int32),
                device, per_call=True)
    timed(roof, "frame_ms", dt, CLOCK_WALL)
    if roof["gather_ms"] is not None:
        ns_per_lane = roof["gather_ms"] * 1e6 / B1
        state_io_lanes = 9.0 * sum(b for b, _ in sched)
        floor_ms = (lanes * ns_per_lane / 1e6
                    + n_rounds * roof["cumsum_full_width_ms"]
                    + state_io_lanes * ns_per_lane / 1e6)
        roof.update(ns_per_gathered_lane=ns_per_lane,
                    pct_of_endpoint_floor=100.0 * floor_ms / dt)
        timed(roof, "floor_ms", floor_ms,
              f"{roof['gather_ms_clock']} (derived)")
    else:
        roof.update(ns_per_gathered_lane=None, pct_of_endpoint_floor=None)
        timed(roof, "floor_ms", None, NOT_MEASURED)
    details["roofline"] = roof
    return dict(frame=img, rec=rec, mrays=fwd["mrays"], ms=dt,
                metric=f"Mrays/s/chip @ {dims[0]}^3 grid, {h}p forward")


def bench_fused(details: dict, device, grid=None, D: int = 512,
                h: int = 1080, w: int = 1920, iters: int = 3) -> dict:
    """The fused kernel K1's frames (see the module docstring); fills
    details["pallas2_march"], ["pallas2_512_1080p"],
    ["pallas2_512_1080p_full"], ["pallas2_inside_camera_frame"],
    ["pallas2_counters"] and ["launches_fused"]. Returns the lambert
    frame."""
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render import kernel_march as km
    from vxtpu_torch.render.fused import render_frame_fused, render_rays_fused
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.world.lights import Lights
    from vxtpu_torch.world.packed import (build_material_morton,
                                          build_packed_morton)

    grid = world(device, D) if grid is None else grid
    dims = grid.dims
    accel = build_packed_morton(grid.occupancy, cap=64)
    mats = build_material_morton(grid.occupancy)
    scale = dims[0] / 512
    cam = camera(OUTSIDE, device, scale)
    cam_in = camera(INSIDE, device, scale)
    lights = Lights.single(scaled(LIGHT, scale), intensity=2.0,
                           device=device)
    lambert = RenderSettings(shading="lambert")
    full = RenderSettings(shading="full", shadows=True, fog=True)
    max_steps = sum(dims) + 2
    o, d = generate_rays(cam, h, w)

    march = functools.partial(km.march, o, d, accel, dims, max_steps)
    # name -> (K1's launch mode, what the frame is, its camera, settings)
    frames = {
        "pallas2_512_1080p": ("lambert", "march + shade in one launch", cam,
                              lambert),
        "pallas2_512_1080p_full": (
            "full_shadows_fog", "march + per-light shadow marches + shade "
            "in one launch", cam, full),
        "pallas2_inside_camera_frame": ("lambert", "inside camera", cam_in,
                                        lambert)}
    frame_fns = {name: functools.partial(render_frame_fused, accel, mats,
                                         dims, c, lights, s, h, w)
                 for name, (_, _, c, s) in frames.items()}
    # the section's path, counted
    km.reset_launch_counts()
    rec = march()
    img = {name: fn() for name, fn in frame_fns.items()}["pallas2_512_1080p"]
    _sync(device)
    details["launches_fused"] = dict(km.LAUNCHES,
                                     variants=dict(km.VARIANT_LAUNCHES))

    # the march, then each frame; K1 alone in each launch mode on the
    # outside camera's rays
    row = dict(block="one thread a ray", table="int16 signed Morton words")
    timed(row, "ms", wall_ms(march, device, iters), CLOCK_WALL)
    row["mrays"] = h * w / row["ms"] / 1e3
    device_time(row, "kernel_device_ms", march, device,
                kernel="march_shade_kernel")
    details["pallas2_march"] = row
    for name, (mode, what, c, s) in frames.items():
        row = dict(frame=what, launch_mode=mode)
        timed(row, "ms", wall_ms(frame_fns[name], device, iters), CLOCK_WALL)
        row["mrays"] = h * w / row["ms"] / 1e3
        if c is cam:
            device_time(row, "kernel_device_ms", functools.partial(
                render_rays_fused, o, d, accel, mats, dims, lights, s),
                device, kernel="march_shade_kernel")
        details[name] = row
    details["pallas2_512_1080p"]["shade_overhead_ms"] = (
        details["pallas2_512_1080p"]["ms"] - details["pallas2_march"]["ms"])
    details["pallas2_512_1080p"]["shade_overhead_ms_clock"] = CLOCK_WALL
    details["pallas2_counters"] = dict(
        useful_ray_steps=int(rec.steps.sum()),
        warp_coherence=probe.warp_coherence(rec.steps))
    lam = details["pallas2_512_1080p"]
    return dict(frame=img, rec=rec, mrays=lam["mrays"], ms=lam["ms"])


def bench_train(details: dict, device, D: int = 128, h: int = 256,
                w: int = 256, S: int = 64, S_mask: int = 16, G: int = 4,
                iters: int = 2) -> dict:
    """The train steps (see the module docstring) on a 1-rank process
    group of this process (started and left here if there is none); fills
    details["train_step_b1"], ["train_step_b4"], ["train_step_masked"],
    ["train_step_field"] and ["launches_train_field"]."""
    import torch.distributed as dist

    from vxtpu_torch.engine import platform, sharding

    joined = not dist.is_initialized()
    platform.init_multihost(device=device)
    try:
        return _train_steps(details, device, sharding.make_mesh(1), D, h, w,
                            S, S_mask, G, iters)
    finally:
        if joined:
            platform.shutdown()


def train_scene(device, mesh, D: int = 128, h: int = 256, w: int = 256,
                S: int = 64) -> dict:
    """The train section's scene: the lit lambert settings, the light,
    the D^3 truth (terrain seed 7 with per-voxel RGB, sigma_solid 25),
    the camera, the h x w target rendered from the truth at S samples on
    ``mesh`` (flat [N, 3]) and the camera-frame rays o_c, d_c."""
    from vxtpu_torch.engine import sharding
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.render.soft import SoftGrid
    from vxtpu_torch.world import procgen
    from vxtpu_torch.world.lights import Lights

    dims = (D,) * 3
    settings = RenderSettings(shading="lambert")
    scale = D / 128
    lights = Lights.single(scaled(TRAIN_LIGHT, scale), intensity=2.0,
                           device=device)
    truth = SoftGrid.from_hard(procgen.terrain(dims, seed=7, with_rgb=True,
                                               device=device),
                               sigma_solid=25.0)
    cam = camera(TRAIN_CAM, device, scale)
    target = sharding.render_soft_image_sharded(
        truth, cam, settings, h, w, S, mesh, lights=lights).reshape(-1, 3)
    o_c, d_c = sharding.camera_frame_rays(cam, h, w)
    return dict(dims=dims, settings=settings, lights=lights, truth=truth,
                cam=cam, target=target, o_c=o_c, d_c=d_c)


def _train_steps(details, device, mesh, D, h, w, S, S_mask, G, iters):
    from vxtpu_torch.engine import sharding
    from vxtpu_torch.render import kernel_sample as ks
    from vxtpu_torch.render import occmask
    from vxtpu_torch.render.soft import SoftGrid
    from vxtpu_torch.render.soft_kernel import MortonSoftGrid

    sc = train_scene(device, mesh, D, h, w, S)
    dims, settings, lights, truth, cam, target, o_c, d_c = sc.values()
    del sc

    def time_step(step_fn, init_fn, model, bounds=None):
        """Two warm steps, then ``iters`` steps with a sync after each;
        (mean ms, the last loss)."""
        state = init_fn(model, cam)
        cur = [model, cam, None]

        def one():
            extra = bounds(cur[1]) if bounds is not None else ()
            cur[0], cur[1], _, cur[2] = step_fn(cur[0], cur[1], state, o_c,
                                                d_c, target, *extra)

        ms = wall_ms(one, device, iters, warm=2, sync_each=True)
        return ms, float(cur[2])

    base = dict(dims=list(dims), rays=h * w, lit=True)
    for buckets in (1, 4):
        init_fn, step_fn = sharding.make_sharded_train_step(
            settings, S, mesh, optimize_camera=True, grad_buckets=buckets,
            lights=lights, use_custom_vjp=True)
        ms, loss = time_step(step_fn, init_fn,
                             SoftGrid.zeros(dims, device=device))
        row = dict(base, samples=S, grad_buckets=buckets, custom_vjp=True,
                   loss=loss)
        timed(row, "ms", ms, CLOCK_WALL)
        details[f"train_step_b{buckets}"] = row

    warm = SoftGrid(sigma_raw=truth.sigma_raw * 0.8,
                    rgb_raw=truth.rgb_raw * 0.8)
    del truth
    mask = occmask.occupancy_mask_from_soft(warm, G, tau=0.01, dilate=1)
    mdf = occmask.mask_distance_field(mask)
    init_fn, step_fn = sharding.make_sharded_train_step(
        settings, S_mask, mesh, optimize_camera=True, lights=lights,
        use_custom_vjp=True, use_mask=True, mask_scale=G)
    ms, loss = time_step(step_fn, init_fn, warm, bounds=lambda c: (
        mask, *sharding.compute_mask_bounds(mask, mdf, c, o_c, d_c, G)))
    row = dict(base, samples=S_mask, mask_scale=G,
               mask_occupied_frac=float(mask.float().mean()),
               custom_vjp=True, loss=loss,
               note="the bounds are recomputed before each step, in the "
                    "timed window")
    timed(row, "ms", ms, CLOCK_WALL)
    row["speedup_vs_b1"] = details["train_step_b1"]["ms"] / ms
    details["train_step_masked"] = row
    del warm, mask, mdf

    # the field-kernel step, counted: K3, K4 with ray cotangents (the
    # camera is refined) and the ray sum
    init_fn, step_fn = sharding.make_sharded_train_step(
        settings, S, mesh, optimize_camera=True, grad_buckets=1,
        lights=lights, field_kernel=True)
    ks.reset_launch_counts()
    ms, loss = time_step(step_fn, init_fn, MortonSoftGrid.from_soft(
        SoftGrid.zeros(dims, device=device)))
    details["launches_train_field"] = dict(ks.LAUNCHES)
    row = dict(base, samples=S, field_kernel=True, loss=loss,
               steps_counted=2 + iters)
    timed(row, "ms", ms, CLOCK_WALL)
    row["speedup_vs_b1"] = details["train_step_b1"]["ms"] / ms
    details["train_step_field"] = row
    return details


def headline(details: dict, forward: dict, fused: dict | None) -> dict:
    """The last line: the faster of the wavefront and fused lambert
    frames, with bench.py's keys."""
    best, kern = forward, "wavefront"
    if fused is not None and fused["mrays"] > best["mrays"]:
        best, kern = fused, "fused (K1 march + shade, one launch)"
    line = {"metric": forward["metric"],
            "value": best["mrays"], "value_clock": CLOCK_WALL,
            "unit": "Mrays/s",
            "vs_baseline": best["mrays"] / DISPLAY_MRAYS,
            "baseline": "1920 x 1080 x 60 rays/s: 1080p at 60 fps, a "
                        "display rate",
            "kernel": kern, "fps": 1e3 / best["ms"], "fps_clock": CLOCK_WALL,
            "wavefront_mrays": forward["mrays"],
            "wavefront_mrays_clock": CLOCK_WALL,
            "wavefront_pct_of_endpoint_floor":
                details["roofline"]["pct_of_endpoint_floor"]}
    if fused is not None:
        line["pallas2_mrays"] = fused["mrays"]
        line["pallas2_mrays_clock"] = CLOCK_WALL
    for key, entry in (("train_step_ms", "train_step_b1"),
                       ("train_step_masked_ms", "train_step_masked"),
                       ("train_step_field_ms", "train_step_field")):
        if entry in details:
            timed(line, key, details[entry]["ms"], details[entry]["ms_clock"])
    return line


def run(device, wavefront_inside: bool = False, skip_fused: bool = False,
        skip_train: bool = False, sizes: dict | None = None) -> tuple:
    """(details, headline) of the three sections; ``sizes`` passes the
    sections' size parameters (keys forward, fused, train)."""
    sizes = sizes or {}
    details = {"gpu": gpu_report(), "device": str(device),
               "torch": torch.__version__}
    D = sizes.get("forward", {}).get("D", 512)
    grid = world(device, D)
    t0 = time.perf_counter()
    forward = bench_forward(details, device, grid, inside=wavefront_inside,
                            **sizes.get("forward", {}))
    details["forward"]["section_s"] = time.perf_counter() - t0
    fused = None
    if not skip_fused:
        t0 = time.perf_counter()
        fused = bench_fused(details, device, grid, **sizes.get("fused", {}))
        details["pallas2_512_1080p"]["section_s"] = time.perf_counter() - t0
    del grid
    if not skip_train:
        t0 = time.perf_counter()
        bench_train(details, device, **sizes.get("train", {}))
        details["train_step_b1"]["section_s"] = time.perf_counter() - t0
    return details, headline(details, forward, fused)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vxtpu_torch.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) runs the CUDA kernels; cpu their "
                        "plain versions (for tests)")
    p.add_argument("--wavefront-inside", action="store_true",
                   help="also time the wavefront frame from the camera "
                        "inside the rock")
    p.add_argument("--skip-fused", action="store_true",
                   help="leave out the fused-kernel section")
    p.add_argument("--skip-train", action="store_true",
                   help="leave out the train section")
    p.add_argument("--details", default=None, metavar="PATH",
                   help="also write the details JSON there")
    args = p.parse_args(argv)
    details, line = run(resolve(args.device), args.wavefront_inside,
                        args.skip_fused, args.skip_train)
    text = json.dumps(details, default=str)
    if args.details:
        with open(args.details, "w") as f:
            f.write(text + "\n")
    print(text)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
