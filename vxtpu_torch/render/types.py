"""Per-ray march result shared by the kernel and its plain version
(counterpart of ``vxtpu/render/types.py``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class HitRecord:
    """Leading dims are the ray batch.

    hit:    bool    [N]    ray hit a solid voxel.
    t:      float32 [N]    entry t of the hit voxel; 1e30 on a miss.
    voxel:  int32   [N, 3] hit voxel; the last voxel reached on a miss.
    normal: float32 [N, 3] outward unit normal of the entered face; 0 on
                           a miss.
    steps:  int32   [N]    march cost: DDA advances after the entry fetch
                           (the fused march), or loop iterations (the
                           row-major march, ``kernel_packed``).
    """

    hit: torch.Tensor
    t: torch.Tensor
    voxel: torch.Tensor
    normal: torch.Tensor
    steps: torch.Tensor
