"""Shading after the march hit: face-normal lighting, shadow visibility,
face textures, fog and sky (counterpart of ``vxtpu/render/shade.py``).

``shade`` is vxtpu's full dispatch: it fetches each hit voxel's albedo
from an ``Albedo`` source (or a face texture from a ``TextureAtlas``) and
shades it; the composable pipeline (``render/pipeline.py``) calls it.
``shade_albedo`` is the same math on an albedo already fetched: the plain
version of the fused kernels' shade epilogue (``render/kernel_march.py``).
"""

from __future__ import annotations

import torch

from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.render.types import HitRecord
from vxtpu_torch.world.grid import linear_index
from vxtpu_torch.world.lights import Lights

SHADOW_EPS = 1e-3


def sky_color(d: torch.Tensor, settings: RenderSettings) -> torch.Tensor:
    """Vertical gradient sky: d [N,3] -> rgb [N,3]."""
    top = torch.tensor(settings.sky_top, dtype=torch.float32, device=d.device)
    hor = torch.tensor(settings.sky_horizon, dtype=torch.float32,
                       device=d.device)
    u = torch.clamp(d[..., 2] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    return hor * (1.0 - u) + top * u


def flat_shade(albedo: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Albedo scaled by a per-face brightness (x 0.80, y 0.68, z 1.00;
    bottom faces 0.45)."""
    a = normal.abs()
    w = 0.80 * a[..., 0] + 0.68 * a[..., 1] + 1.00 * a[..., 2]
    w = torch.where(normal[..., 2] < -0.5, 0.45, w)
    return albedo * w[..., None]


def lit_shade(albedo, p, normal, view_dir, lights: Lights, shadow_vis,
              settings: RenderSettings):
    """Ambient + diffuse (+ Blinn-Phong specular when shading='full') from
    L point lights. p: hit points [N,3]; shadow_vis: [N,L] or None."""
    acc = albedo * settings.ambient
    if lights.count == 0:
        return acc
    lvec = lights.pos[None, :, :] - p[:, None, :]                 # [N,L,3]
    lx, ly, lz = lvec.unbind(-1)
    dist2 = lx * lx + ly * ly + lz * lz                           # [N,L]
    rinv = 1.0 / torch.sqrt(torch.clamp(dist2, min=1e-12))
    ldir = lvec * rinv[..., None]
    n = normal[:, None, :]
    ndotl = torch.clamp(n[..., 0] * ldir[..., 0] + n[..., 1] * ldir[..., 1]
                        + n[..., 2] * ldir[..., 2], min=0.0)
    atten = lights.intensity[None, :] / (1.0 + 0.002 * dist2)
    vis = shadow_vis if shadow_vis is not None else torch.ones_like(ndotl)
    diff = ndotl * atten * vis
    acc = acc + albedo * torch.sum(diff[..., None] * lights.rgb[None], dim=1)
    if settings.shading == "full":
        h = ldir - view_dir[:, None, :]
        hx, hy, hz = h.unbind(-1)
        h = h * (1.0 / torch.sqrt(torch.clamp(hx * hx + hy * hy + hz * hz,
                                              min=1e-12)))[..., None]
        ndoth = torch.clamp(n[..., 0] * h[..., 0] + n[..., 1] * h[..., 1]
                            + n[..., 2] * h[..., 2], min=0.0)
        spec = settings.specular_k * torch.pow(ndoth, settings.specular_exp)
        spec = spec * (ndotl > 0.0) * atten * vis
        acc = acc + torch.sum(spec[..., None] * lights.rgb[None], dim=1)
    return acc


def apply_fog(rgb, t, d, hit, settings: RenderSettings):
    """Exponential distance fog toward the sky colour of each ray."""
    fog_f = 1.0 - torch.exp(-settings.fog_density * t)
    fog_f = torch.where(hit, fog_f, 0.0)[..., None]
    return rgb * (1.0 - fog_f) + sky_color(d, settings) * fog_f


def shade_albedo(rec: HitRecord, o, d, albedo, lights: Lights,
                 settings: RenderSettings, shadow_vis=None) -> torch.Tensor:
    """HitRecord [N] + albedo [N,3] -> rgb [N,3] in [0, 1]."""
    if settings.shading == "flat":
        rgb = flat_shade(albedo, rec.normal)
    else:
        p = o + rec.t[..., None] * d + rec.normal * SHADOW_EPS
        rgb = lit_shade(albedo, p, rec.normal, d, lights, shadow_vis,
                        settings)
    if settings.fog:
        rgb = apply_fog(rgb, rec.t, d, rec.hit, settings)
    rgb = torch.where(rec.hit[..., None], rgb, sky_color(d, settings))
    return torch.clamp(rgb, 0.0, 1.0)


def shade(rec: HitRecord, o, d, albedo_src, dims, lights: Lights,
          settings: RenderSettings, shadow_vis=None, atlas=None,
          material_ids=None) -> torch.Tensor:
    """Full shading dispatch: HitRecord [N] -> rgb [N,3] in [0, 1].

    albedo_src: a ``world.grid.Albedo``. atlas: an optional
    ``world.atlas.TextureAtlas``; with it a hit's colour is its face
    texture at the hit point, looked up by material id (``material_ids``,
    uint8 [X*Y*Z], default ``albedo_src.ids``)."""
    idx = torch.clamp(linear_index(rec.voxel.to(torch.int64), dims), 0,
                      albedo_src.size - 1)
    albedo = albedo_src.at(idx)
    if atlas is not None:
        from vxtpu_torch.world.atlas import sample_atlas

        ids_flat = material_ids if material_ids is not None else \
            albedo_src.ids
        if ids_flat is None:
            raise ValueError("atlas shading needs material ids "
                             "(palette-mode albedo or material_ids=)")
        p_hit = o + rec.t[..., None] * d
        albedo = torch.where(rec.hit[..., None],
                             sample_atlas(atlas, ids_flat[idx], p_hit,
                                          rec.normal),
                             albedo)
    return shade_albedo(rec, o, d, albedo, lights, settings, shadow_vis)
