r"""Command line (counterpart of ``vxtpu/app/run.py``):

  render   one frame of a named config -> PNG
  animate  N frames along an orbit -> PNGs (+ an fps JSON line)
  train    the config-4 inverse-rendering fit
  bench    Mrays/s as a JSON line

``--kernel`` picks the march: ``fused`` (the default: march + shadows +
shade in one CUDA kernel, ``render/fused.py``), or one of the composable
pipeline's (``render/pipeline.py``): ``xla`` (vxtpu's default: the
batched lock-step march in PyTorch tensor ops over ``--accel distfield``
or ``pyramid``, ``render/kernel_xla.py``), ``pallas`` (the row-major
march kernel) or ``pallas2`` (the fused kernel in march-only mode).
vxtpu's ``ref``, ``wavefront`` and ``pallas-interpret`` have no
counterpart and raise. ``train --occmask`` fits the occupancy-masked
soft model (``render/occmask.py``).

  python -m vxtpu_torch render --config c3_256_shadows --kernel pallas \
      --out f.png
  python -m vxtpu_torch render --config c1_64_flat --kernel pallas \
      --device cpu --out f.png
  python -m vxtpu_torch render --config c3_256_shadows --kernel xla \
      --accel pyramid --out f.png
  python -m vxtpu_torch animate --config c1_64_flat --kernel pallas \
      --frames 24 --out anim
  python -m vxtpu_torch bench --config c3_256_shadows --kernel pallas
  python -m vxtpu_torch train --field-kernel --dims 0 --height 0 --width 0 \
      --samples 0 --steps 5 --out fit      # c4_512_diff at full size
  python -m vxtpu_torch train --field-kernel --occmask --samples 64 \
      --dims 0 --height 0 --width 0 --steps 5 --out fit
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

# vxtpu's --kernel choices without a counterpart here, and where
# ROADMAP.md records them
_NOT_PORTED = {
    "ref": "ROADMAP.md queue 1 #18 (render/kernel_ref is not ported)",
    "wavefront": "ROADMAP.md queue 1 #18 (render/kernel_wavefront is not "
                 "ported)",
    "pallas-interpret": "ROADMAP.md queue 1 #18 (a TPU interpreter; "
                        "--kernel pallas --device cpu runs the plain "
                        "version)",
}
KERNELS = ["xla", "wavefront", "ref", "pallas", "pallas2", "fused",
           "pallas-interpret"]


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
                                  f"vxtpu_torch yet: {_NOT_PORTED[name]}")
    if name == "xla":
        from vxtpu_torch.render.kernel_xla import make_march_xla

        return make_march_xla
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
    the pipeline kernels take the ``accel_kind`` table and shade in
    PyTorch, with face textures from ``atlas`` when it is given."""
    fused = kernel == "fused"
    if not fused:
        factory = kernel_factory(kernel)
    grid, accel, cam, lights = build_scene(
        cfg, dims, "none" if fused else accel_kind, device)
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
                             "(a factory builds its own kind when it is "
                             "another)")
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
                    help="vxtpu's custom-VJP scan (not ported)")
    sp.add_argument("--field-kernel", action="store_true",
                    help="train through the CUDA field-sampling kernels "
                         "(Morton scene layout)")
    sp.add_argument("--resume", default=None, help="checkpoint .npz to resume")
    sp.add_argument("--device", default="cuda",
                    help="cuda runs the CUDA kernels; cpu their plain "
                         "versions")
    sp.add_argument("--out", default="fit")
    sp.set_defaults(fn=cmd_train)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
