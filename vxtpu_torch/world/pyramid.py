"""Dense occupancy mipmap for empty-space skipping (counterpart of
``vxtpu/world/pyramid.py``): level k is the factor-2^(k+1) max-pool of the
occupancy, so a level-k cell is nonzero iff any fine voxel inside its
2^(k+1)-cube is occupied. A lookup shifts the voxel coordinates; the
batched march (``render/kernel_xla.march_xla``) skips a whole coarse cell
wherever a level says it is empty.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from vxtpu_torch.device import device_const


@dataclasses.dataclass(frozen=True)
class OccupancyPyramid:
    """levels: tuple of bool tensors; levels[i] has shape
    ceil(dims / 2^(i+1)) (cell size 2^(i+1)). The fine grid itself is not
    held; an empty tuple means plain DDA."""

    levels: tuple

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def cell_size(self, i: int) -> int:
        return 2 ** (i + 1)


def _maxpool2(occ: torch.Tensor) -> torch.Tensor:
    """Factor-2 max-pool of a bool [X, Y, Z] tensor; odd sizes are padded
    with empty cells."""
    X, Y, Z = occ.shape
    occ = F.pad(occ, (0, (-Z) % 2, 0, (-Y) % 2, 0, (-X) % 2))
    X2, Y2, Z2 = occ.shape
    r = occ.reshape(X2 // 2, 2, Y2 // 2, 2, Z2 // 2, 2)
    return r.any(dim=5).any(dim=3).any(dim=1)


def build_pyramid(occupancy: torch.Tensor,
                  num_levels: int) -> OccupancyPyramid:
    """``num_levels`` coarse levels above the fine occupancy."""
    levels = []
    cur = occupancy > 0
    for _ in range(num_levels):
        cur = _maxpool2(cur)
        levels.append(cur)
    return OccupancyPyramid(levels=tuple(levels))


def pyramid_lookup(pyr: OccupancyPyramid, level: int,
                   v: torch.Tensor) -> torch.Tensor:
    """Bool [...]: occupancy of the level-``level`` cell holding fine voxel
    v [..., 3] (int32); out-of-bounds coordinates read False (empty)."""
    arr = pyr.levels[level]
    c = v >> (level + 1)
    dims = arr.shape
    ok = ((c[..., 0] >= 0) & (c[..., 0] < dims[0])
          & (c[..., 1] >= 0) & (c[..., 1] < dims[1])
          & (c[..., 2] >= 0) & (c[..., 2] < dims[2]))
    hi = device_const(tuple(n - 1 for n in dims), c.dtype, c.device)
    cc = torch.minimum(torch.clamp(c, min=0), hi)
    idx = ((cc[..., 0] * dims[1] + cc[..., 1]) * dims[2]
           + cc[..., 2]).to(torch.int64)
    return arr.reshape(-1)[idx] & ok
