"""Frames of a hard-voxel scene through the port's fused frame function,
along a camera path: one viewer, the next frame after the last
(``app/run.py:cmd_animate``'s loop, without its frame sink).

Set-up: the terrain from the seed (``world.py``), the program's tables
(``build_packed_morton``, ``build_rgb8_morton``), its light and settings,
its path function (``camera/paths.py``) and frame function
(``render/fused.py:render_frame_fused``, as ``app/run.py:make_frame``
builds it for ``--kernel fused``); then the warm-up frames. The scene is
the configuration's (``scene_seed``); frame i shows camera time (phase +
i) / fps, the phase drawn from the seed, and the window closes at the
first end of a whole loop of the path after ``--seconds``: every seed
renders the same poses, from another start.

A frame is timed from the start of its pose to the synchronise after the
frame function returns. After the window, a sample of the window's frames
drawn from the seed is compared pixel by pixel with the plain reference
(``reference/march.py``), which works the pose, the rays and the tables
out again from the inputs.
"""

from __future__ import annotations

import random
import time

import torch

from vxbench import camera, world
from vxbench.drivers import Clock, Outcome, Run, check, log, peak_bytes, sync
from vxbench.reference import march as ref
from vxbench.trace import Window


def _sizes(r: Run):
    c = r.cell.config
    dims = tuple(r.sizes.get("dims", c["dims"]))
    return dims, r.sizes.get("height", c["height"]), \
        r.sizes.get("width", c["width"])


def _lights(cfg: dict, dims) -> list:
    """[(pos, rgb, intensity)] in world units."""
    return [(tuple(p * n for p, n in zip(li["pos"], dims)),
             tuple(li["rgb"]), float(li["intensity"]))
            for li in cfg["lights"]]


def run(r: Run) -> Outcome:
    clock = Clock(r.t_start)
    from vxtpu_torch.camera import paths
    from vxtpu_torch.render.fused import render_frame_fused
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.world.grid import VoxelGrid
    from vxtpu_torch.world.lights import Lights
    from vxtpu_torch.world.packed import build_packed_morton, build_rgb8_morton
    clock.mark("import")

    cfg, tr, dev = r.cell.config, r.cell.traffic, r.device
    dims, h, w = _sizes(r)
    occ, rgb = world.terrain(dims, cfg["scene_seed"], dev)
    top = world.top_height(occ)
    clock.mark("scene")

    acc = build_packed_morton(occ, cap=cfg["table_cap"])
    mats = build_rgb8_morton(VoxelGrid(occupancy=occ, rgb=rgb))
    lights_l = _lights(cfg, dims)
    lights = Lights.make([p for p, _, _ in lights_l],
                         [c for _, c, _ in lights_l],
                         [i for _, _, i in lights_l], device=dev)
    settings = RenderSettings(**cfg["settings"])
    args = camera.path_args(tr, dims, top)
    if tr["path"] == "orbit":
        cam_at = paths.orbit(center=args["center"], radius=args["radius"],
                             height=args["height"], period=args["period"],
                             fov_y_deg=args["fov_y_deg"], device=dev)
    else:
        cam_at = paths.flythrough(args["waypoints"], args["look_at"],
                                  period=args["period"],
                                  fov_y_deg=args["fov_y_deg"], device=dev)

    def frame(c):
        return render_frame_fused(acc, mats, dims, c, lights, settings, h, w,
                                  rgb8=True)

    if "answer_altered" in r.faults:
        clean = frame

        def frame(c):
            img = clean(c).clone()
            img[: max(1, h // 4)] = 0.0
            return img
    clock.mark("tables")

    fps = float(tr["fps"])
    loop = r.sizes.get("loop", int(round(float(tr["period_s"]) * fps)))
    phase = r.seed % loop
    i0 = r.sizes.get("warm_frames", int(tr["warm_frames"]))
    for i in range(i0):
        frame(cam_at((phase + i) / fps))
    sync(dev)
    clock.mark("warm")
    setup_s = time.perf_counter() - r.t_start

    rng = random.Random(r.seed)
    keep_n = int(cfg["check"]["frames"])
    kept: list = []                     # (i, camera time, image)
    times, host_ms = [], []
    n_traced = int(tr["traced_frames"]) if r.trace else 0
    win = Window() if r.trace else None
    i = 0
    w0 = time.perf_counter()
    if win is not None:
        win.__enter__()
    while True:
        t_cam = (phase + i0 + i) / fps
        a = time.perf_counter()
        if win is not None and i < n_traced:
            with torch.profiler.record_function(f"vxbench.frame.{i}"):
                img = frame(cam_at(t_cam))
                b = time.perf_counter()
                sync(dev)
        else:
            img = frame(cam_at(t_cam))
            b = time.perf_counter()
            sync(dev)
        e = time.perf_counter()
        times.append(e - a)
        host_ms.append((b - a) * 1e3)
        # reservoir sample of the window's frames, kept between frames
        if len(kept) < keep_n:
            kept.append((i, t_cam, img.clone()))
        else:
            j = rng.randrange(i + 1)
            if j < keep_n:
                kept[j] = (i, t_cam, img.clone())
        i += 1
        if win is not None and i == n_traced:
            win.__exit__(None, None, None)
        # the window holds whole loops of the path, so that every seed
        # renders the same poses, from another start
        if e - w0 >= r.seconds and i % loop == 0:
            break
    sync(dev)
    window_s = time.perf_counter() - w0
    frames = i
    peak = peak_bytes(dev)
    del acc, mats, img
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    from vxbench.harness import percentile
    pixels = h * w
    half = len(host_ms) // 2
    log(f"frames {frames} in {window_s!r} s: ms median "
        f"{percentile(times, 50) * 1e3!r} p95 {percentile(times, 95) * 1e3!r}"
        f" max {max(times) * 1e3!r}; host ms median, each half of the "
        f"window {percentile(host_ms[:half], 50)!r} "
        f"{percentile(host_ms[half:], 50)!r}")
    metrics = {"frame_mrays": frames * pixels / window_s / 1e6,
               "frame_p95_ms": percentile(times, 95) * 1e3,
               "setup_s": setup_s}

    # the plain reference, after the window
    dtype = getattr(torch, cfg["check"]["dtype"])
    words = ref.cell_table(occ)
    albedo = ref.rgb8_albedo(rgb)
    rs = dict(cfg["settings"])

    def reference(t_cam, counts=None):
        pos, yaw, pitch, fov = camera.pose(tr, dims, top, t_cam, dev)
        o, d = camera.rays(pos, yaw, pitch, fov, h, w)
        return ref.render(o.to(dtype), d.to(dtype), words, albedo, dims,
                          lights_l, rs, counts=counts).float()

    t_ref = time.perf_counter()
    tol = float(cfg["check"]["pixel_tol"])
    off = failed = 0
    worst = 0.0
    for _, t_cam, img in sorted(kept, key=lambda x: x[0]):
        diff = (img.reshape(-1, 3) - reference(t_cam)).abs().amax(dim=-1)
        n_off = int((diff > tol).sum())
        worst = max(worst, float(diff.max()))
        off += n_off
        failed += n_off / pixels > cfg["limits"]["px_off_share"]
    log(f"frames compared {sorted(k[0] for k in kept)}; largest pixel "
        f"gap {worst!r}; reference {time.perf_counter() - t_ref!r} s")
    checks = {"px_off_share": check(off / (pixels * len(kept)),
                                    cfg["limits"]["px_off_share"])}

    ctx = None
    if win is not None:
        ctx = dict(kind="frame", window=win, host_ms=host_ms[:n_traced],
                   frames=n_traced, pixels=pixels, frame_work=[])
        spans = {n: (s, e) for n, s, e in win.spans}
        for k in sorted({0, n_traced // 2, n_traced - 1})[
                :int(tr["counted_frames"])]:
            s, e = spans[f"vxbench.frame.{k}"]
            counts = ref.Counts(words.numel(), dev)
            reference((phase + i0 + k) / fps, counts)
            ctx["frame_work"].append((
                int(counts.touched[:-1].sum()), counts.rays,
                counts.shadow_rays,
                counts.steps, win.device_s(s, e)))
    return Outcome(metrics=metrics, checks=checks, attempted=frames,
                   failed=failed, memory_peak_bytes=peak, layer_ctx=ctx,
                   window=win, setup_split=clock.split)
