"""The composable render pipeline: primary march -> one shadow march per
light -> shade -> image (counterpart of ``vxtpu/render/pipeline.py``).

Every march plugs in through the same closure,
``march(o, d, t_max=None) -> HitRecord``, made by a factory
``factory(occ_flat, dims, settings, accel)``: ``make_march_packed`` (the
row-major kernel, the CLI's ``--kernel pallas``) or
``kernel_march.make_march`` (the fused kernel in march-only mode,
``--kernel pallas2``). Shading runs in PyTorch (``render/shade.py``).

A frame records one ``torch.profiler`` span a stage: ``SPAN + "rays"``
(``generate_rays``), ``"march"`` (the primary march), ``"shadows"`` (the
shadow rays toward one light and their march, once a light) and
``"shade"`` (albedo gather, lighting, fog, sky, clamp), while a profiler
runs; without one a frame opens no span, since an idle span still costs
two dispatcher calls of host time in a frame bound by its host.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.camera.rays import generate_rays
from vxtpu_torch.render.kernel_march import shadow_rays
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.render.shade import SHADOW_EPS, shade
from vxtpu_torch.world.grid import VoxelGrid
from vxtpu_torch.world.lights import Lights

SPAN = "vxtpu_torch.pipeline."


def _span(stage: str):
    """The profiler span of one stage, or none when no profiler runs."""
    if torch.autograd._profiler_enabled():
        return record_function(SPAN + stage)
    return contextlib.nullcontext()


def shadow_ray_batch(rec, o, d, light_pos):
    """Origins, unit directions and t_max of the shadow rays toward one
    light: from the hit point nudged SHADOW_EPS along the face normal,
    capped at the light's distance less 2 eps. A miss's ray starts at the
    origin with t_max = 0 (vxtpu starts it at o + 1e30 d, where the
    arithmetic overflows); its visibility is 1 either way."""
    p, ldir, dist, _ = shadow_rays(rec, o, d, light_pos)
    return p, ldir, torch.where(rec.hit, dist - 2.0 * SHADOW_EPS, 0.0)


def shadow_visibility(march, rec, o, d, lights: Lights) -> torch.Tensor:
    """[N, L] visibility: 1 where the path from the hit point to each light
    is unoccluded, and for misses (they are sky, never lit)."""
    cols = []
    for li in range(lights.count):
        with _span("shadows"):
            p, ldir, tm = shadow_ray_batch(rec, o, d, lights.pos[li])
            srec = march(p, ldir, t_max=tm)
            cols.append(torch.where(srec.hit & rec.hit, 0.0, 1.0))
    if not cols:
        return torch.ones((o.shape[0], 0), dtype=torch.float32,
                          device=o.device)
    return torch.stack(cols, dim=-1)


def render_rays(march, o, d, albedo_src, dims, lights: Lights,
                settings: RenderSettings, atlas=None, material_ids=None):
    """Rays [N, 3] -> (rgb [N, 3], HitRecord) through the march closure."""
    with _span("march"):
        rec = march(o, d)
    vis = None
    if settings.shadows and settings.shading != "flat" and lights.count > 0:
        vis = shadow_visibility(march, rec, o, d, lights)
    with _span("shade"):
        rgb = shade(rec, o, d, albedo_src, dims, lights, settings,
                    shadow_vis=vis, atlas=atlas, material_ids=material_ids)
    return rgb, rec


def render_image(march_factory, grid: VoxelGrid, cam: Camera,
                 lights: Lights, settings: RenderSettings, height: int,
                 width: int, accel=None, atlas=None) -> torch.Tensor:
    """Full frame [H, W, 3] float32 in [0, 1]. ``accel`` goes to the
    factory (a factory builds its own table when it is not the kind it
    marches); ``atlas`` is an optional TextureAtlas (face-textured
    hits)."""
    dims = grid.dims
    occ_flat = grid.occupancy.reshape(-1)
    march = march_factory(occ_flat, dims, settings, accel)
    with _span("rays"):
        o, d = generate_rays(cam, height, width)
    rgb, _ = render_rays(march, o, d, grid.albedo(), dims, lights, settings,
                         atlas=atlas, material_ids=occ_flat)
    return rgb.reshape(height, width, 3)
