"""Capped Chebyshev distance field (counterpart of
``vxtpu/world/distfield.py``).

    dfield[v] = 0                                  if voxel v is solid
              = min(L_inf distance to nearest solid, cap)   otherwise

One read of the field answers both march questions: a value of 0 is a
hit, and every voxel within L_inf distance dfield[v] - 1 of v is empty, so
the batched march (``render/kernel_xla.march_xla_df``) can jump to the
exit of that box. Built by iterated separable 3-tap dilation: after k
rounds ``covered`` is the set of voxels within L_inf distance k of a
solid voxel, so the first round that covers a voxel assigns its exact
distance. Cells shifted in from outside the grid are empty, not wrapped.
"""

from __future__ import annotations

import dataclasses

import torch

from vxtpu_torch.world.grid import in_bounds, linear_index


@dataclasses.dataclass(frozen=True)
class DistanceField:
    """The march's acceleration structure: the uint8 field [X, Y, Z]."""

    field: torch.Tensor

    @property
    def dims(self) -> tuple[int, int, int]:
        return tuple(self.field.shape)  # type: ignore[return-value]


def _dilate1(x: torch.Tensor) -> torch.Tensor:
    """3-tap max filter along each axis of a bool [X, Y, Z] tensor."""
    for ax in range(3):
        n = x.shape[ax]
        y = x.clone()
        y.narrow(ax, 1, n - 1).logical_or_(x.narrow(ax, 0, n - 1))
        y.narrow(ax, 0, n - 1).logical_or_(x.narrow(ax, 1, n - 1))
        x = y
    return x


def build_distance_field(occupancy: torch.Tensor, cap: int = 24) -> torch.Tensor:
    """uint8 [X,Y,Z]: 0 where solid, else min(L_inf dist to solid, cap)."""
    covered = occupancy > 0
    dist = torch.where(covered, 0, cap).to(torch.uint8)
    for k in range(1, cap):
        covered_k = _dilate1(covered)
        dist = torch.where(covered_k & ~covered, k, dist)
        covered = covered_k
    return dist


def build(occupancy: torch.Tensor, cap: int = 24) -> DistanceField:
    """The DistanceField of a grid's occupancy."""
    return DistanceField(field=build_distance_field(occupancy, cap))


def distfield_fetch(df_flat: torch.Tensor, v: torch.Tensor,
                    dims) -> torch.Tensor:
    """uint8 [N] field value at integer voxel coords v [N, 3] of the flat
    field; out-of-bounds reads give 255 (empty: never a hit)."""
    ok = in_bounds(v, dims)
    idx = torch.where(ok, linear_index(v, dims), 0).to(torch.int64)
    val = df_flat[idx]
    return torch.where(ok, val, torch.full_like(val, 255))
