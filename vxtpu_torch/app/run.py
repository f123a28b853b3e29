r"""Command line (counterpart of ``vxtpu/app/run.py``):

  render   one frame of a named config -> PNG
  animate  N frames along an orbit -> PNGs (+ an fps JSON line)
  train    the config-4 inverse-rendering fit
  config5  the animated, sharded per-frame fit of config 5
  bench    Mrays/s as a JSON line
  scaling  rays/s and parallel efficiency on 1, 2, 4, ... ranks
  info     the platform report as JSON

``--kernel`` picks the march: ``fused`` (the default: march + shadows +
shade in one CUDA kernel, ``render/fused.py``), or one of the composable
pipeline's (``render/pipeline.py``): ``xla`` (vxtpu's default: the
batched lock-step march in PyTorch tensor ops over ``--accel distfield``
or ``pyramid``, ``render/kernel_xla.py``), ``wavefront`` (the distance-
field march with compaction rounds, ``render/kernel_wavefront.py``; a
cap-96 field is built when ``--accel`` is not ``distfield``), ``ref``
(the per-ray reference march, ``render/kernel_ref.py``), ``pallas`` (the
row-major march kernel) or ``pallas2`` (the fused kernel in march-only
mode). vxtpu's ``pallas-interpret`` (the TPU kernel interpreter) has no
counterpart and raises: ``--kernel pallas --device cpu`` runs the plain
version of the row-major march. ``train --occmask`` fits the
occupancy-masked soft model (``render/occmask.py``).

  python -m vxtpu_torch render --config c3_256_shadows --kernel pallas \
      --out f.png
  python -m vxtpu_torch render --config c1_64_flat --kernel pallas \
      --device cpu --out f.png
  python -m vxtpu_torch render --config c3_256_shadows --kernel xla \
      --accel pyramid --out f.png
  python -m vxtpu_torch render --config c3_256_shadows --kernel wavefront \
      --out f.png
  python -m vxtpu_torch render --config c1_64_flat --kernel ref --out f.png
  python -m vxtpu_torch animate --config c1_64_flat --kernel pallas \
      --frames 24 --out anim
  python -m vxtpu_torch bench --config c3_256_shadows --kernel pallas
  python -m vxtpu_torch train --field-kernel --dims 0 --height 0 --width 0 \
      --samples 0 --steps 5 --out fit      # c4_512_diff at full size
  python -m vxtpu_torch train --field-kernel --occmask --samples 64 \
      --dims 0 --height 0 --width 0 --steps 5 --out fit
  python -m vxtpu_torch config5 --frames 3 --out c5    # 512^3, 1080p
  torchrun --nproc_per_node=N -m vxtpu_torch config5 --multihost
  python -m vxtpu_torch scaling --config c3_256_shadows --kernel fused

``config5``, ``scaling`` and ``info`` work in a ``torch.distributed``
process group (``engine/platform.init_multihost``): started by
``torchrun`` (NCCL, one card a rank), or, with no launcher, a group of
this process alone.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from vxtpu_torch.app.configs import CONFIGS, SceneConfig
from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.device import DEFAULT, resolve
from vxtpu_torch.render.fused import render_frame_fused
from vxtpu_torch.utils import save_png
from vxtpu_torch.world import procgen
from vxtpu_torch.world.lights import Lights
from vxtpu_torch.world.packed import (build_material_morton,
                                      build_packed_morton, build_rgb8_morton)

# configs whose frame is the soft differentiable renderer's
_SOFT_ONLY = ("c4_512_diff",)

# vxtpu's --kernel choices without a counterpart here, and why
_NOT_PORTED = {
    "pallas-interpret": "it runs vxtpu's TPU kernel in the Pallas "
                        "interpreter; --kernel pallas --device cpu runs the "
                        "plain version of the row-major march",
}
KERNELS = ["xla", "wavefront", "ref", "pallas", "pallas2", "fused",
           "pallas-interpret"]
# the one table kind a pipeline kernel marches (its factory builds this
# kind from the grid when it is handed another, in every frame)
_MARCHED_ACCEL = {"pallas": "packed", "pallas2": "morton"}


def marched_accel(kernel: str, accel_kind: str) -> str:
    """The table kind to build at set-up for ``kernel``: the kind it
    marches where it marches one kind only, else ``accel_kind``."""
    return _MARCHED_ACCEL.get(kernel, accel_kind)


def build_scene(cfg: SceneConfig, dims=None, accel_kind="none",
                device=DEFAULT):
    """World, acceleration table, camera and light of a config (vxtpu's
    ``_build_scene``). accel_kind: 'distfield' (DistanceField, cap 24),
    'pyramid' (OccupancyPyramid of the config's levels, at least 2),
    'packed' (row-major table), 'morton' (Morton table) or 'none'."""
    device = resolve(device)
    dims = dims or cfg.dims
    grid = procgen.terrain(dims, seed=cfg.seed, with_rgb=cfg.with_rgb,
                           device=device)
    if accel_kind == "distfield":
        from vxtpu_torch.world import distfield

        accel = distfield.build(grid.occupancy, cap=24)
    elif accel_kind == "pyramid":
        from vxtpu_torch.world.pyramid import build_pyramid

        accel = build_pyramid(grid.occupancy,
                              max(cfg.settings.pyramid_levels, 2))
    elif accel_kind == "packed":
        from vxtpu_torch.world.packed import build_packed

        accel = build_packed(grid.occupancy)
    elif accel_kind == "morton":
        accel = build_packed_morton(grid.occupancy, cap=64)
    else:
        accel = None
    X, Y, Z = dims
    cam = Camera.make(pos=(-0.7 * X, 0.5 * Y, 1.1 * Z), fov_y_deg=55.0,
                      device=device).look_at((0.5 * X, 0.5 * Y, 0.27 * Z))
    if cfg.lights > 0:
        lights = Lights.single((0.2 * X, -0.3 * Y, 1.4 * Z), intensity=2.0,
                               device=device)
    else:
        lights = Lights.none(device=device)
    return grid, accel, cam, lights


def _fused_tables(grid):
    """(Morton occupancy table, mats table, rgb8 flag) of the fused kernel:
    per-voxel-RGB scenes shade from the RGB8 table, palette scenes from the
    material table."""
    rgb8 = grid.rgb is not None
    mats = build_rgb8_morton(grid) if rgb8 else \
        build_material_morton(grid.occupancy)
    return build_packed_morton(grid.occupancy, cap=64), mats, rgb8


def render_config(cfg: SceneConfig, dims=None, height=0, width=0,
                  device=DEFAULT) -> torch.Tensor:
    """One fused frame [H, W, 3] of a config."""
    if cfg.name in _SOFT_ONLY:
        raise NotImplementedError(
            f"config {cfg.name} renders soft voxel densities, not a hard "
            f"frame; fit it with the train command")
    dims = dims or cfg.dims
    frame, cam = make_frame(cfg, dims, height or cfg.height,
                            width or cfg.width, resolve(device), "fused")
    return frame(cam)


def kernel_factory(name: str):
    """The pipeline's march factory for a --kernel name."""
    if name in _NOT_PORTED:
        raise NotImplementedError(f"--kernel {name} has no counterpart in "
                                  f"vxtpu_torch: {_NOT_PORTED[name]}")
    if name == "xla":
        from vxtpu_torch.render.kernel_xla import make_march_xla

        return make_march_xla
    if name == "wavefront":
        from vxtpu_torch.render.kernel_wavefront import make_march_wavefront

        return make_march_wavefront
    if name == "ref":
        from vxtpu_torch.render.kernel_ref import make_march_ref

        return make_march_ref
    if name == "pallas":
        from vxtpu_torch.render.kernel_packed import make_march_packed

        return make_march_packed
    if name == "pallas2":
        from vxtpu_torch.render.kernel_march import make_march

        return make_march
    raise ValueError(f"--kernel {name}: the fused kernel has no factory")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_frame(cfg, dims, h, w, device, kernel, accel_kind="none",
               atlas=None):
    """(frame(cam) -> [H, W, 3] through ``kernel``, the scene's camera).
    The fused kernel marches the Morton table and shades in the kernel;
    the pipeline kernels take the ``accel_kind`` table (``pallas`` and
    ``pallas2`` the one kind each marches, whatever ``accel_kind`` says)
    and shade in PyTorch, with face textures from ``atlas`` when it is
    given. Every table is built here, once."""
    fused = kernel == "fused"
    if not fused:
        factory = kernel_factory(kernel)
    grid, accel, cam, lights = build_scene(
        cfg, dims, "none" if fused else marched_accel(kernel, accel_kind),
        device)
    if fused:
        acc, mats, rgb8 = _fused_tables(grid)

        def frame(c):
            return render_frame_fused(acc, mats, dims, c, lights,
                                      cfg.settings, h, w, rgb8=rgb8)
    else:
        from vxtpu_torch.render.pipeline import render_image

        def frame(c):
            return render_image(factory, grid, c, lights, cfg.settings, h, w,
                                accel, atlas=atlas)
    return frame, cam


def _scene_args(args):
    cfg = CONFIGS[args.config]
    dims = (args.dims,) * 3 if args.dims else cfg.dims
    return (cfg, dims, args.height or cfg.height, args.width or cfg.width,
            resolve(args.device))


def cmd_render(args) -> int:
    from vxtpu_torch.obs.log import get_logger

    log = get_logger()
    cfg, dims, h, w, device = _scene_args(args)
    if args.kernel == "fused":
        if args.atlas:
            print("note: --kernel fused shades per-voxel colours (rgb8) or "
                  "the material palette; --atlas face textures are only "
                  "honoured by the pipeline kernels (pallas, pallas2)")
        img = render_config(cfg, dims, h, w, device)
    else:
        atlas = None
        if args.atlas:
            from vxtpu_torch.world.atlas import build_procedural_atlas

            atlas = build_procedural_atlas(tex_size=args.atlas_size,
                                           device=device)
            log.info("face-texture atlas enabled (%d materials, %dx%d "
                     "texels)", atlas.num_materials, args.atlas_size,
                     args.atlas_size)
        frame, cam = make_frame(cfg, dims, h, w, device, args.kernel,
                                args.accel, atlas)
        img = frame(cam)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_png(args.out, img)
    log.info("wrote %s [%dx%d] config=%s kernel=%s", args.out, h, w,
             cfg.name, args.kernel)
    print(f"wrote {args.out} [{h}x{w}] config={cfg.name} "
          f"kernel={args.kernel} device={device.type}")
    return 0


def _save_png_pil(path: str, img) -> None:
    from PIL import Image

    arr = (np.clip(img.detach().cpu().numpy(), 0.0, 1.0) * 255
           ).astype(np.uint8)
    Image.fromarray(arr).save(path)


def cmd_animate(args) -> int:
    from vxtpu_torch.camera import paths
    from vxtpu_torch.native.framesink import FrameSink, framesink_available

    cfg, dims, h, w, device = _scene_args(args)
    frame, _ = make_frame(cfg, dims, h, w, device, args.kernel, args.accel)
    X, Y, Z = dims
    cam_at = paths.orbit(center=(0.5 * X, 0.5 * Y, 0.3 * Z),
                         radius=0.9 * X, height=1.1 * Z,
                         period=args.frames / 24.0, device=device)
    os.makedirs(args.out, exist_ok=True)
    # PNG encoding and disk writes run on the native C++ worker pool, off
    # the render loop; PIL where there is no C++ compiler
    sink = FrameSink(workers=2) if framesink_available() else None
    t_render = 0.0
    try:
        for i in range(args.frames):
            t0 = time.perf_counter()
            img = frame(cam_at(i / 24.0))
            _sync(device)
            if i > 0:  # the first frame carries first-use costs
                t_render += time.perf_counter() - t0
            path = os.path.join(args.out, f"frame_{i:04d}.png")
            if sink is not None:
                sink.submit(path, img)
            else:
                _save_png_pil(path, img)
    finally:
        if sink is not None:
            failed = sink.flush()
            sink.close()
            if failed:
                raise IOError(f"{failed} frames failed to write")
    steady = args.frames - 1
    if steady > 0 and t_render > 0:
        print(json.dumps({"metric": "fps", "value": round(steady / t_render,
                                                          2),
                          "frames": args.frames, "res": [h, w],
                          "sink": "native" if sink is not None else "pil"}))
    print(f"wrote {args.frames} frames to {args.out}/")
    return 0


def cmd_bench(args) -> int:
    from vxtpu_torch.obs.metrics import MetricsSink, mrays_per_s

    cfg, dims, h, w, device = _scene_args(args)
    frame, cam = make_frame(cfg, dims, h, w, device, args.kernel,
                            args.accel)
    sink = MetricsSink()
    frame(cam)                              # first-use costs
    _sync(device)
    prof = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    with prof as p:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            frame(cam)
        _sync(device)
        dt = (time.perf_counter() - t0) / args.iters
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        p.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    sink.emit(metric=f"Mrays/s/chip @ {cfg.name} {dims[0]}^3 {h}x{w}",
              value=round(mrays_per_s(h, w, dt), 3), unit="Mrays/s",
              fps=round(1.0 / dt, 2), kernel=args.kernel,
              device=device.type, profile=args.profile or None)
    return 0


def cmd_train(args) -> int:
    """Config 4: fit a soft grid to rendered target views (vxtpu's
    ``cmd_train``: the same flags, checkpoint and final JSON line)."""
    from vxtpu_torch.camera import paths
    from vxtpu_torch.render.soft import SoftGrid, render_soft_image
    from vxtpu_torch.render.soft_kernel import MortonSoftGrid
    from vxtpu_torch.train.checkpoint import (load_checkpoint,
                                              load_opt_state,
                                              save_checkpoint)
    from vxtpu_torch.train.loop import (TrainConfig, fit_soft,
                                        fit_soft_views, init_opt_state,
                                        state_params)

    device = resolve(args.device)
    cfg = CONFIGS[args.config]
    if not cfg.soft:
        raise SystemExit(f"config {cfg.name} is not a soft/differentiable "
                         "config; use c4_512_diff or c5_1080p_pod")
    dims = (args.dims,) * 3 if args.dims else cfg.dims
    h = args.height or cfg.height
    w = args.width or cfg.width
    samples = args.samples or cfg.num_samples
    settings = cfg.settings
    X, Y, Z = dims
    truth = SoftGrid.from_hard(procgen.terrain(dims, seed=cfg.seed,
                                               with_rgb=True, device=device))

    def train_config(steps, seed):
        return TrainConfig(steps=steps, num_samples=samples,
                           ray_batch=args.ray_batch, seed=seed,
                           use_custom_vjp=args.custom_vjp,
                           occ_mask=args.occmask,
                           field_kernel=args.field_kernel)

    tc = train_config(args.steps, cfg.seed)
    start_step = 0
    soft = SoftGrid.zeros(dims, device=device)
    opt_state = None
    if args.resume:
        soft, _, start_step, _ = load_checkpoint(args.resume, device)
        tc = train_config(max(args.steps - start_step, 0),
                          cfg.seed + start_step)
        # the field-kernel fit optimises the Morton table: its moments
        # are stored as vxtpu's planar tables
        model = MortonSoftGrid.from_soft(soft) if args.field_kernel else soft
        tmpl = init_opt_state([state_params(model)])
        opt_state = load_opt_state(args.resume, tmpl, device)

    def log(i, loss):
        print(f"step {start_step + i:5d}  loss {loss:.6f}")

    with torch.no_grad():
        if args.views > 1:
            cams = paths.orbit_views(
                center=(0.5 * X, 0.5 * Y, 0.3 * Z), radius=0.9 * X,
                height=1.1 * Z, n=args.views, fov_y_deg=55.0, device=device)
            target = torch.stack([render_soft_image(truth, c, settings, h, w,
                                                    samples) for c in cams])
        else:
            cam_out = Camera.make(pos=(-0.7 * X, 0.5 * Y, 1.1 * Z),
                                  device=device).look_at(
                                      (0.5 * X, 0.5 * Y, 0.27 * Z))
            target = render_soft_image(truth, cam_out, settings, h, w,
                                       samples)[None]
    del truth
    if args.views > 1:
        soft, losses, opt_state = fit_soft_views(
            soft, cams, target, settings, tc, log_fn=log, opt_state=opt_state)
        cam_out = cams[0]
    else:
        soft, cam_out, losses, opt_state = fit_soft(
            soft, cam_out, target[0], settings, tc, log_fn=log,
            opt_state=opt_state)

    os.makedirs(args.out, exist_ok=True)
    # zlib over the GBs of a 512^3 fit (grid and Adam moments) would take
    # minutes: grids beyond 128^3 are saved uncompressed
    save_checkpoint(os.path.join(args.out, "ckpt.npz"), soft, cam_out,
                    step=start_step + tc.steps,
                    extra={"losses": losses}, opt_state=opt_state,
                    compress=X * Y * Z <= 128 ** 3)
    with torch.no_grad():
        final = render_soft_image(soft, cam_out, settings, h, w, samples)
    save_png(os.path.join(args.out, "target.png"), target[0])
    save_png(os.path.join(args.out, "fit.png"), final)
    print(json.dumps({"metric": "final_loss",
                      "value": losses[-1] if losses else None,
                      "steps": start_step + tc.steps, "views": args.views}))
    return 0


def cmd_config5(args) -> int:
    """Config 5: the animated scene, rays sharded over the process group,
    camera-pose and voxel gradient descent every frame (vxtpu's
    ``cmd_config5``: the same flags and final JSON line). Every rank runs
    this same command; ``--multihost`` joins the group ``torchrun``
    started (without it, or without a launcher, a 1-rank group)."""
    from vxtpu_torch.engine.platform import init_multihost, validate_platform
    from vxtpu_torch.engine.sharding import make_mesh
    from vxtpu_torch.obs.metrics import MetricsSink
    from vxtpu_torch.train.config5 import Config5, run_config5

    device = resolve(args.device)
    if not args.multihost and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        raise SystemExit("config5: launched as one of several ranks; pass "
                         "--multihost (each rank alone would train its own "
                         "copy)")
    init_multihost(device=device)
    cfg5 = Config5(
        dims=(args.dims,) * 3 if args.dims else (512, 512, 512),
        height=args.height or 1080, width=args.width or 1920,
        num_samples=args.samples or 192, frames=args.frames,
        steps_per_frame=args.steps_per_frame)
    settings = CONFIGS["c5_1080p_pod"].settings
    mesh = make_mesh()
    validate_platform(mesh_devices=mesh.size, device=mesh.device)
    sink = MetricsSink(path=os.path.join(args.out, "metrics.jsonl")
                       if args.out else None)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    res = run_config5(cfg5, settings, mesh=mesh, out_dir=args.out,
                      resume=args.resume, sink=sink,
                      save_frames=args.save_frames)
    if mesh.rank == 0:
        print(json.dumps({
            "metric": "config5_final_psnr", "value": res["psnrs"][-1],
            "frames": cfg5.frames, "final_loss": res["losses"][-1],
            "yaw_err": res["yaw_err"], "pitch_err": res["pitch_err"]}))
    return 0


def cmd_scaling(args) -> int:
    """Rays/s on sub-groups of 1, 2, 4, ... ranks of the process group
    (and the whole group) with the parallel efficiency against 1 rank,
    one JSON line each (vxtpu's ``cmd_scaling``). Each sub-group renders
    the config's frame with rays sharded over it; the other ranks wait.
    One process alone measures 1 rank."""
    import torch.distributed as dist

    from vxtpu_torch.engine.platform import init_multihost, rank_device
    from vxtpu_torch.engine.sharding import (make_mesh,
                                             render_frame_fused_sharded,
                                             render_image_sharded)
    from vxtpu_torch.obs.metrics import MetricsSink, mrays_per_s

    init_multihost(device=resolve(args.device))
    device = rank_device()
    cfg, dims, h, w, _ = _scene_args(args)
    fused = args.kernel == "fused"
    grid, accel, cam, lights = build_scene(
        cfg, dims, "none" if fused else marched_accel(args.kernel,
                                                      args.accel), device)
    if fused:
        acc, mats, rgb8 = _fused_tables(grid)

        def frame(mesh):
            return render_frame_fused_sharded(acc, mats, dims, cam, lights,
                                              cfg.settings, h, w, mesh,
                                              rgb8=rgb8)
    else:
        factory = kernel_factory(args.kernel)

        def frame(mesh):
            return render_image_sharded(factory, grid, cam, lights,
                                        cfg.settings, h, w, mesh, accel)
    world = dist.get_world_size()
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= world]
    if counts[-1] != world:
        counts.append(world)
    sink = MetricsSink()
    base = None
    for n in counts:
        mesh = make_mesh(n)
        rate = torch.zeros(1, dtype=torch.float64, device=device)
        if mesh.member:
            frame(mesh)                     # first-use costs
            _sync(device)
            dist.barrier(group=mesh.group)
            t0 = time.perf_counter()
            for _ in range(args.iters):
                frame(mesh)
            _sync(device)
            rate[0] = mrays_per_s(h, w, (time.perf_counter() - t0)
                                  / args.iters)
        # rank 0 is in every sub-group: its rate is the sub-group's
        dist.broadcast(rate, src=0)
        mrays = float(rate[0])
        if base is None:
            base = mrays
        sink.emit(metric="scaling", devices=n, mrays=round(mrays, 3),
                  efficiency=round(mrays / (base * n), 4),
                  fps=round(mrays * 1e6 / (h * w), 2), kernel=args.kernel,
                  res=[h, w])
    return 0


def cmd_info(args) -> int:
    from vxtpu_torch.engine.platform import platform_report

    print(json.dumps(platform_report(resolve(args.device)), indent=2,
                     default=str))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vxtpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="cuda runs the CUDA kernels; cpu their plain "
                             "versions")

    def common(sp):
        sp.add_argument("--config", default="c1_64_flat",
                        choices=sorted(CONFIGS))
        sp.add_argument("--dims", type=int, default=0,
                        help="override grid side length (cube)")
        sp.add_argument("--height", type=int, default=0)
        sp.add_argument("--width", type=int, default=0)
        sp.add_argument("--accel",
                        choices=["distfield", "pyramid", "packed", "morton",
                                 "none"], default="distfield",
                        help="table handed to the pipeline's march factory "
                             "(pallas and pallas2 take the kind they march, "
                             "packed and morton, whatever is given)")
        sp.add_argument("--kernel", choices=KERNELS, default="fused")
        device_arg(sp)

    sp = sub.add_parser("render", help="render one frame to PNG")
    common(sp)
    sp.add_argument("--atlas", action="store_true",
                    help="face-texture hits from a procedural atlas "
                         "(pipeline kernels)")
    sp.add_argument("--atlas-size", type=int, default=16,
                    help="atlas texels per voxel face edge")
    sp.add_argument("--out", default="frame.png")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("animate", help="render an orbit animation")
    common(sp)
    sp.add_argument("--frames", type=int, default=24)
    sp.add_argument("--out", default="anim")
    sp.set_defaults(fn=cmd_animate)

    sp = sub.add_parser("bench", help="throughput benchmark")
    common(sp)
    sp.add_argument("--iters", type=int, default=4)
    sp.add_argument("--profile", default=None, metavar="DIR",
                    help="trace the timed frames with torch.profiler into "
                         "DIR/trace.json")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("train", help="inverse-rendering fit (config 4)")
    sp.add_argument("--config", default="c4_512_diff", choices=sorted(CONFIGS))
    sp.add_argument("--dims", type=int, default=48,
                    help="override grid side (0 = config's full dims)")
    sp.add_argument("--height", type=int, default=96)
    sp.add_argument("--width", type=int, default=96)
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--samples", type=int, default=96,
                    help="0 = config's num_samples")
    sp.add_argument("--ray-batch", type=int, default=0)
    sp.add_argument("--views", type=int, default=1,
                    help=">1: multi-view orbit capture")
    sp.add_argument("--occmask", action="store_true",
                    help="train the occupancy-masked soft model: samples "
                         "only each ray's occupied band (cut --samples to "
                         "match)")
    sp.add_argument("--custom-vjp", action="store_true",
                    help="render through the O(N+grid) custom backward "
                         "(render/vjp.py)")
    sp.add_argument("--field-kernel", action="store_true",
                    help="train through the CUDA field-sampling kernels "
                         "(Morton scene layout)")
    sp.add_argument("--resume", default=None, help="checkpoint .npz to resume")
    sp.add_argument("--device", default="cuda",
                    help="cuda runs the CUDA kernels; cpu their plain "
                         "versions")
    sp.add_argument("--out", default="fit")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("config5", help="animated sharded per-frame "
                                        "optimisation (config 5)")
    sp.add_argument("--dims", type=int, default=0,
                    help="override grid side (0 = 512)")
    sp.add_argument("--height", type=int, default=0)
    sp.add_argument("--width", type=int, default=0)
    sp.add_argument("--samples", type=int, default=0)
    sp.add_argument("--frames", type=int, default=24)
    sp.add_argument("--steps-per-frame", type=int, default=2)
    sp.add_argument("--multihost", action="store_true",
                    help="join the process group torchrun started "
                         "(RANK, WORLD_SIZE, MASTER_ADDR, LOCAL_RANK)")
    sp.add_argument("--resume", default=None, help="checkpoint .npz to resume")
    sp.add_argument("--save-frames", action="store_true")
    sp.add_argument("--out", default="c5")
    device_arg(sp)
    sp.set_defaults(fn=cmd_config5)

    sp = sub.add_parser("scaling",
                        help="rays/s at 1..N ranks + parallel efficiency")
    common(sp)
    sp.add_argument("--iters", type=int, default=4)
    sp.set_defaults(fn=cmd_scaling)

    sp = sub.add_parser("info", help="platform report")
    device_arg(sp)
    sp.set_defaults(fn=cmd_info)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
