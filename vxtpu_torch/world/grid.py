"""Voxel world as tensors (counterpart of ``vxtpu/world/grid.py``).

Coordinate convention (shared by every kernel in ``render/``):
  * grid shape ``(X, Y, Z)``; voxel ``(i, j, k)`` occupies the world-space
    unit cube ``[i, i+1) x [j, j+1) x [k, k+1)``;
  * the whole grid spans ``[0,X] x [0,Y] x [0,Z]``; Z is up for terrain;
  * material id 0 means empty; ids >= 1 index ``MATERIAL_RGB``.
"""

from __future__ import annotations

import dataclasses

import torch

from vxtpu_torch.device import DEFAULT, resolve

# Material palette (id 0 = empty and never shaded): water, sand, grass,
# stone, snow and two accents. Float32 values equal vxtpu's.
MATERIAL_RGB = (
    (0.00, 0.00, 0.00),  # 0 empty
    (0.13, 0.33, 0.80),  # 1 water
    (0.86, 0.79, 0.46),  # 2 sand
    (0.22, 0.63, 0.25),  # 3 grass
    (0.52, 0.50, 0.48),  # 4 stone
    (0.95, 0.95, 0.97),  # 5 snow
    (0.80, 0.25, 0.20),  # 6 accent (lights/markers in test scenes)
    (0.92, 0.75, 0.20),  # 7 accent 2
)


def material_rgb(device=DEFAULT) -> torch.Tensor:
    """The palette as a float32 [8, 3] tensor on ``device``."""
    return torch.tensor(MATERIAL_RGB, dtype=torch.float32,
                        device=resolve(device))


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """occupancy: uint8 [X, Y, Z], 0 = empty, >0 = material id.
    rgb: float32 [X, Y, Z, 3] per-voxel albedo, or None (palette mode)."""

    occupancy: torch.Tensor
    rgb: torch.Tensor | None = None

    @property
    def dims(self) -> tuple[int, int, int]:
        return tuple(self.occupancy.shape)  # type: ignore[return-value]

    def albedo_flat(self) -> torch.Tensor:
        """float32 [X*Y*Z, 3] albedo of every voxel."""
        if self.rgb is not None:
            return self.rgb.reshape(-1, 3)
        occ = self.occupancy.reshape(-1).to(torch.int64)
        return material_rgb(self.occupancy.device)[torch.clamp(occ, max=7)]

    def albedo(self) -> "Albedo":
        """The colour source of the shading pipeline."""
        if self.rgb is not None:
            return Albedo(channels=tuple(self.rgb[..., c].reshape(-1)
                                         for c in range(3)))
        return Albedo(ids=self.occupancy.reshape(-1),
                      palette=material_rgb(self.occupancy.device))


@dataclasses.dataclass(frozen=True)
class Albedo:
    """Per-hit-voxel colour source; exactly one mode is set:
      * ids uint8 [X*Y*Z] material ids + palette float32 [M, 3];
      * channels: three float32 [X*Y*Z] planes (per-voxel RGB)."""

    ids: torch.Tensor | None = None
    palette: torch.Tensor | None = None
    channels: tuple | None = None

    def at(self, idx: torch.Tensor) -> torch.Tensor:
        """Albedo [N, 3] at in-range linear voxel indices idx [N]."""
        idx = idx.to(torch.int64)
        if self.channels is not None:
            return torch.stack([c[idx] for c in self.channels], dim=-1)
        ids = self.ids[idx].to(torch.int64)
        return self.palette[torch.clamp(ids, max=self.palette.shape[0] - 1)]

    @property
    def size(self) -> int:
        return (self.ids.shape[0] if self.ids is not None
                else self.channels[0].shape[0])


def linear_index(v: torch.Tensor, dims) -> torch.Tensor:
    """Row-major linear index of integer voxel coords v[..., 3] (no bounds
    check)."""
    _, Y, Z = dims
    return (v[..., 0] * Y + v[..., 1]) * Z + v[..., 2]


def in_bounds(v: torch.Tensor, dims) -> torch.Tensor:
    """Bool [...]: all three coords inside the grid."""
    return ((v >= 0).all(dim=-1) & (v[..., 0] < dims[0])
            & (v[..., 1] < dims[1]) & (v[..., 2] < dims[2]))


def occupancy_at(grid_occ_flat: torch.Tensor, v: torch.Tensor,
                 dims) -> torch.Tensor:
    """Occupancy at integer coords v[..., 3] of the flat uint8 [X*Y*Z]
    grid; out-of-bounds reads give 0."""
    ok = in_bounds(v, dims)
    idx = torch.where(ok, linear_index(v, dims), 0).to(torch.int64)
    val = grid_occ_flat[idx]
    return torch.where(ok, val, torch.zeros_like(val))
