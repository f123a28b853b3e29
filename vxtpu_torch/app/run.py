"""Command line (counterpart of ``vxtpu/app/run.py``). Ported so far:
``render`` through the fused kernel path (vxtpu's ``--kernel fused``) and
``train``, the config-4 inverse-rendering fit.

  python -m vxtpu_torch render --config c5_1080p_pod --out frame.png
  python -m vxtpu_torch render --config c1_64_flat --device cpu --out f.png
  python -m vxtpu_torch train --field-kernel --dims 0 --height 0 --width 0 \
      --samples 0 --steps 5 --out fit      # c4_512_diff at full size
  python -m vxtpu_torch train --device cpu --dims 16 --height 16 \
      --width 16 --samples 8 --steps 3 --field-kernel --out /tmp/fit
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

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


def build_scene(cfg: SceneConfig, dims=None, device=DEFAULT):
    """World, camera and light of a config (vxtpu's ``_build_scene``)."""
    device = resolve(device)
    dims = dims or cfg.dims
    grid = procgen.terrain(dims, seed=cfg.seed, with_rgb=cfg.with_rgb,
                           device=device)
    X, Y, Z = dims
    cam = Camera.make(pos=(-0.7 * X, 0.5 * Y, 1.1 * Z), fov_y_deg=55.0,
                      device=device).look_at((0.5 * X, 0.5 * Y, 0.27 * Z))
    if cfg.lights > 0:
        lights = Lights.single((0.2 * X, -0.3 * Y, 1.4 * Z), intensity=2.0,
                               device=device)
    else:
        lights = Lights.none(device=device)
    return grid, cam, lights


def render_config(cfg: SceneConfig, dims=None, height=0, width=0,
                  device=DEFAULT) -> torch.Tensor:
    """One fused frame [H, W, 3] of a config; per-voxel-RGB scenes shade
    from the RGB8 table, palette scenes from the material table."""
    if cfg.name in _SOFT_ONLY:
        raise NotImplementedError(
            f"config {cfg.name} renders soft voxel densities, not a hard "
            f"frame; fit it with the train command")
    dims = dims or cfg.dims
    grid, cam, lights = build_scene(cfg, dims, device)
    accel = build_packed_morton(grid.occupancy, cap=64)
    rgb8 = grid.rgb is not None
    mats = build_rgb8_morton(grid) if rgb8 else \
        build_material_morton(grid.occupancy)
    return render_frame_fused(accel, mats, dims, cam, lights, cfg.settings,
                              height or cfg.height, width or cfg.width,
                              rgb8=rgb8)


def cmd_render(args) -> int:
    cfg = CONFIGS[args.config]
    dims = (args.dims,) * 3 if args.dims else None
    img = render_config(cfg, dims, args.height, args.width,
                        torch.device(args.device))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_png(args.out, img)
    h, w, _ = img.shape
    print(f"wrote {args.out} [{h}x{w}] config={cfg.name} device={args.device}")
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
                                        fit_soft_views, init_opt_state)

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
        # the field-kernel fit optimises Morton tables: its moments have
        # their shapes
        model = MortonSoftGrid.from_soft(soft) if args.field_kernel else soft
        tmpl = init_opt_state([[getattr(model, f.name)
                                for f in dataclasses.fields(model)]])
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
    save_checkpoint(os.path.join(args.out, "ckpt.npz"), soft, cam_out,
                    step=start_step + tc.steps,
                    extra={"losses": losses}, opt_state=opt_state)
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
    sp = sub.add_parser("render", help="render one frame to PNG")
    sp.add_argument("--config", default="c1_64_flat", choices=sorted(CONFIGS))
    sp.add_argument("--dims", type=int, default=0,
                    help="override grid side length (cube)")
    sp.add_argument("--height", type=int, default=0)
    sp.add_argument("--width", type=int, default=0)
    sp.add_argument("--device", default="cuda",
                    help="cuda runs the CUDA kernels; cpu their plain "
                         "versions")
    sp.add_argument("--out", default="frame.png")
    sp.set_defaults(fn=cmd_render)

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
                    help="occupancy-mask sample skipping (not ported yet)")
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
