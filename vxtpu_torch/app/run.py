"""Command line (counterpart of ``vxtpu/app/run.py``). Ported so far:
``render`` through the fused kernel path (vxtpu's ``--kernel fused``).

  python -m vxtpu_torch render --config c5_1080p_pod --out frame.png
  python -m vxtpu_torch render --config c1_64_flat --device cpu --out f.png
"""

from __future__ import annotations

import argparse
import os

import torch

from vxtpu_torch.app.configs import CONFIGS, SceneConfig
from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.render.fused import render_frame_fused
from vxtpu_torch.utils import save_png
from vxtpu_torch.world import procgen
from vxtpu_torch.world.lights import Lights
from vxtpu_torch.world.packed import (build_material_morton,
                                      build_packed_morton, build_rgb8_morton)

# configs whose frame is the soft differentiable renderer's
_SOFT_ONLY = ("c4_512_diff",)


def build_scene(cfg: SceneConfig, dims=None, device=None):
    """World, camera and light of a config (vxtpu's ``_build_scene``)."""
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
                  device=None) -> torch.Tensor:
    """One fused frame [H, W, 3] of a config; per-voxel-RGB scenes shade
    from the RGB8 table, palette scenes from the material table."""
    if cfg.name in _SOFT_ONLY:
        raise NotImplementedError(
            f"config {cfg.name} renders soft voxel densities; the soft "
            f"renderer is not ported to vxtpu_torch yet")
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
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
