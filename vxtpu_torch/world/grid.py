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
