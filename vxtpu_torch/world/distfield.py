"""Capped Chebyshev distance field (counterpart of
``vxtpu/world/distfield.py:build_distance_field``).

    dfield[v] = 0                                  if voxel v is solid
              = min(L_inf distance to nearest solid, cap)   otherwise

Built by iterated separable 3-tap dilation: after k rounds ``covered`` is
the set of voxels within L_inf distance k of a solid voxel, so the first
round that covers a voxel assigns its exact distance. Cells shifted in
from outside the grid are empty, not wrapped.
"""

from __future__ import annotations

import torch


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
