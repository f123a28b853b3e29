"""The five capability configs (counterpart of ``vxtpu/app/configs.py``)."""

from __future__ import annotations

import dataclasses

from vxtpu_torch.render.settings import RenderSettings


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    name: str
    dims: tuple[int, int, int]
    height: int
    width: int
    settings: RenderSettings
    with_rgb: bool = False          # per-voxel RGB attributes
    soft: bool = False              # differentiable soft-density mode
    animated: bool = False          # per-frame camera/light animation
    sharded: bool = False           # rays sharded over devices
    num_samples: int = 192          # soft-mode samples per ray
    lights: int = 1
    seed: int = 7


CONFIGS: dict[str, SceneConfig] = {
    # 64^3 grid, 256x256, flat-shaded DDA march
    "c1_64_flat": SceneConfig(
        name="c1_64_flat", dims=(64, 64, 64), height=256, width=256,
        settings=RenderSettings(shading="flat"), lights=0,
    ),
    # 128^3 grid with per-voxel RGB, diffuse lighting, 512x512
    "c2_128_lit": SceneConfig(
        name="c2_128_lit", dims=(128, 128, 128), height=512, width=512,
        settings=RenderSettings(shading="lambert"), with_rgb=True,
    ),
    # 256^3 grid, 2-level empty-space skipping, shadow rays, 1024x1024
    "c3_256_shadows": SceneConfig(
        name="c3_256_shadows", dims=(256, 256, 256), height=1024, width=1024,
        settings=RenderSettings(shading="full", shadows=True, fog=True,
                                pyramid_levels=2),
        with_rgb=True,
    ),
    # 512^3 differentiable soft-voxel densities fitted to targets
    "c4_512_diff": SceneConfig(
        name="c4_512_diff", dims=(512, 512, 512), height=256, width=256,
        settings=RenderSettings(), soft=True, num_samples=256,
    ),
    # 512^3 animated scene at 1920x1080, rays sharded, per-frame gradient
    # descent on camera pose and voxels
    "c5_1080p_pod": SceneConfig(
        name="c5_1080p_pod", dims=(512, 512, 512), height=1080, width=1920,
        settings=RenderSettings(shading="full", shadows=True, fog=True,
                                pyramid_levels=3),
        with_rgb=True, animated=True, sharded=True, soft=True,
    ),
}
