"""Fused hard-voxel frames: march and shade in the kernel (counterpart of
``vxtpu/render/fused.py``).

Two compositions:

  * in-kernel (the default, and the only one without shadows): ONE
    kernel launch marches, runs one capped shadow march per light from
    the hit point when shadows are on, and shades;
  * ``inkernel_shadows=False`` with shadows: primary march -> one capped
    shadow march per light -> the shade kernel with the visibility as
    input. Kept as the oracle of the in-kernel shadows: both give the
    same image.

Palette scenes shade from the Morton material table; per-voxel-RGB
scenes pass ``rgb8=True`` with the fine-Morton RGB8 table.
"""

from __future__ import annotations

import torch

from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.camera.rays import generate_rays
from vxtpu_torch.render.kernel_march import (ShadeSpec, march, pack_lights,
                                             shade, shadow_rays)
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.render.shade import SHADOW_EPS
from vxtpu_torch.world.lights import Lights
from vxtpu_torch.world.packed import PackedMorton


def render_rays_fused(o, d, accel: PackedMorton, mats, dims, lights: Lights,
                      settings: RenderSettings,
                      inkernel_shadows: bool = True, rgb8: bool = False):
    """Rays [N,3] -> (rgb [N,3], HitRecord)."""
    max_steps = settings.resolve_max_steps(dims)
    lights_arr = pack_lights(lights)
    shadowed = (settings.shadows and settings.shading != "flat"
                and lights.count > 0)
    if not shadowed or inkernel_shadows:
        spec = ShadeSpec.from_settings(settings, lights, use_vis=False,
                                       shadows=shadowed, rgb8=rgb8)
        rec, rgb = march(o, d, accel, dims, max_steps, shade_spec=spec,
                         mats=mats, lights_arr=lights_arr)
        return rgb, rec

    rec = march(o, d, accel, dims, max_steps)
    vis_cols = []
    for li in range(lights.count):
        # a face turned away from the light gets t_max = 0: both light
        # terms are zero there, so its visibility is never read
        p, ldir, dist, facing = shadow_rays(rec, o, d, lights.pos[li])
        tm = torch.where(facing, dist - 2.0 * SHADOW_EPS, 0.0)
        srec = march(p, ldir, accel, dims, max_steps, t_max=tm)
        vis_cols.append(torch.where(srec.hit & rec.hit, 0.0, 1.0))
    vis = torch.stack(vis_cols, dim=-1)
    spec = ShadeSpec.from_settings(settings, lights, use_vis=True,
                                   shadows=False, rgb8=rgb8)
    return shade(rec, o, d, vis, mats, lights_arr, spec), rec


def render_frame_fused(accel: PackedMorton, mats, dims, cam: Camera,
                       lights: Lights, settings: RenderSettings, height: int,
                       width: int, inkernel_shadows: bool = True,
                       rgb8: bool = False) -> torch.Tensor:
    """Full frame [H, W, 3] float32 through the fused kernel path."""
    o, d = generate_rays(cam, height, width)
    rgb, _ = render_rays_fused(o, d, accel, mats, dims, lights, settings,
                               inkernel_shadows=inkernel_shadows, rgb8=rgb8)
    return rgb.reshape(height, width, 3)
