"""Per-material face textures sampled at the hit point (counterpart of
``vxtpu/world/atlas.py``).

The atlas is three float32 [M * T * T] planes (r, g, b). Sampling is
nearest-texel: the face axis comes from the hit normal, the in-face UV
from the fractional hit-point coordinates on the two tangent axes, so
textures are anchored to the world and need no per-face UV tables.

``build_procedural_atlas`` draws its texel noise from a seeded
``torch.Generator``; vxtpu draws it with ``jax.random``, so the two give
different texels from the same seed. The parity tests carry vxtpu's atlas
across (``convert.atlas_from_numpy``).
"""

from __future__ import annotations

import dataclasses

import torch

from vxtpu_torch.device import DEFAULT, resolve
from vxtpu_torch.world.grid import material_rgb

# face axis -> (u axis, v axis)
_AXIS_TANGENTS = ((1, 2), (0, 2), (0, 1))


@dataclasses.dataclass(frozen=True)
class TextureAtlas:
    """channels: three float32 [M * T * T] planes (r, g, b); tex_size = T."""

    channels: tuple
    tex_size: int

    @property
    def num_materials(self) -> int:
        return self.channels[0].shape[0] // (self.tex_size * self.tex_size)


def build_procedural_atlas(num_materials: int | None = None,
                           tex_size: int = 16, seed: int = 0,
                           palette: torch.Tensor | None = None,
                           device=DEFAULT) -> TextureAtlas:
    """Per-material texel patterns modulating the palette colour: noise
    brightness in [0.75, 1.25) times a subtle 2x2-texel checker."""
    device = resolve(device)
    palette = material_rgb(device) if palette is None else \
        palette.to(device=device, dtype=torch.float32)
    M = palette.shape[0] if num_materials is None else num_materials
    if M > palette.shape[0]:
        raise ValueError(
            f"build_procedural_atlas: num_materials={M} exceeds the "
            f"palette's {palette.shape[0]} rows; pass a larger palette= "
            "or fewer materials")
    T = tex_size
    gen = torch.Generator().manual_seed(seed)
    noise = (0.75 + 0.5 * torch.rand((M, T, T), generator=gen)).to(device)
    iu = torch.arange(T, device=device)
    checker = ((iu[:, None] // 2 + iu[None, :] // 2) % 2).to(torch.float32)
    mod = noise * (0.92 + 0.16 * checker)[None, :, :]
    base = palette[:M][:, None, None, :]                     # [M,1,1,3]
    tex = torch.clamp(base * mod[..., None], 0.0, 1.0)       # [M,T,T,3]
    return TextureAtlas(channels=tuple(tex[..., c].reshape(-1).contiguous()
                                       for c in range(3)), tex_size=T)


def sample_atlas(atlas: TextureAtlas, material_id: torch.Tensor,
                 p: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Texel colour [N, 3] for hits at world points p [N, 3] on faces with
    axis-aligned normals [N, 3] of voxels with material ids [N]."""
    T = atlas.tex_size
    ax = torch.argmax(normal.abs(), dim=-1)                  # face axis [N]
    tang = torch.tensor(_AXIS_TANGENTS, dtype=torch.int64,
                        device=p.device)[ax]                 # [N, 2]
    pu = torch.gather(p, 1, tang[:, 0:1])[:, 0]
    pv = torch.gather(p, 1, tang[:, 1:2])[:, 0]
    # world-anchored UV: fractional position inside the voxel face
    tu = torch.clamp((pu - torch.floor(pu)) * T, 0.0, T - 1.0).to(torch.int64)
    tv = torch.clamp((pv - torch.floor(pv)) * T, 0.0, T - 1.0).to(torch.int64)
    # out-of-range ids read row 0 (the empty material)
    m = material_id.to(torch.int64)
    m = torch.where((m < 0) | (m >= atlas.num_materials), 0, m)
    idx = (m * T + tu) * T + tv
    return torch.stack([c[idx] for c in atlas.channels], dim=-1)
