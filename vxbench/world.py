"""The benchmark's inputs: the procedural terrain and the soft truth made
from it, on the device from a seed.

A frozen copy of the formulas of ``vxtpu_torch/world/procgen.py:terrain``
and ``render/soft.py:SoftGrid.from_hard`` (operation for operation, so
the same seed gives the same grid on the same device), kept here so that
a change to the program cannot change what is measured. Plain tensors
only: the drivers wrap them in the program's own types.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF

# material palette (id 0 empty): water, sand, grass, stone, snow, accents
PALETTE = (
    (0.00, 0.00, 0.00), (0.13, 0.33, 0.80), (0.86, 0.79, 0.46),
    (0.22, 0.63, 0.25), (0.52, 0.50, 0.48), (0.95, 0.95, 0.97),
    (0.80, 0.25, 0.20), (0.92, 0.75, 0.20),
)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash2(ix, iy, seed: int) -> torch.Tensor:
    h = (_mul32(ix.to(torch.int64) & _M32, 0x85EBCA6B)
         ^ _mul32(iy.to(torch.int64) & _M32, 0xC2B2AE35)
         ^ (seed * 0x9E3779B9 & _M32))
    h = _mul32(h ^ (h >> 15), 0x2C1B3C6D)
    h = _mul32(h ^ (h >> 12), 0x297A2D39)
    return h ^ (h >> 15)


def _noise2(x: torch.Tensor, y: torch.Tensor, seed: int) -> torch.Tensor:
    x0, y0 = torch.floor(x), torch.floor(y)
    ix0, iy0 = x0.to(torch.int32), y0.to(torch.int32)
    fx, fy = x - x0, y - y0
    u = fx * fx * fx * (fx * (fx * 6.0 - 15.0) + 10.0)
    v = fy * fy * fy * (fy * (fy * 6.0 - 15.0) + 10.0)

    def dot_corner(ox, oy):
        ang = (_hash2(ix0 + ox, iy0 + oy, seed) & 7).to(torch.float32) \
            * (math.pi / 4.0)
        return torch.cos(ang) * (fx - ox) + torch.sin(ang) * (fy - oy)

    n00, n10 = dot_corner(0, 0), dot_corner(1, 0)
    n01, n11 = dot_corner(0, 1), dot_corner(1, 1)
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    return (nx0 + v * (nx1 - nx0)) * 1.4142


def _fractal2(x, y, seed: int, octaves: int) -> torch.Tensor:
    total = torch.zeros_like(x)
    amp, freq, norm = 1.0, 1.0, 0.0
    for o in range(octaves):
        total = total + amp * _noise2(x * freq, y * freq, seed + o * 131)
        norm += amp
        amp *= 0.5
        freq *= 2.0
    return total / norm


def terrain(dims, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(occupancy uint8 [X, Y, Z], rgb float32 [X, Y, Z, 3]): heightmap
    terrain with material bands and per-voxel tinted colour."""
    X, Y, Z = dims
    f32 = dict(dtype=torch.float32, device=device)
    xs = (torch.arange(X, **f32) + 0.5) / X
    ys = (torch.arange(Y, **f32) + 0.5) / Y
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    k = 0.25 * X
    h = _fractal2(gx * k / X * 8.0, gy * k / X * 8.0, seed, octaves=5)
    height = (0.5 + 0.35 * h) * Z
    zi = torch.arange(Z, **f32)[None, None, :]
    hcol = height[:, :, None]
    below = zi < hcol
    water_level = 0.22 * Z
    mat = torch.where(hcol < water_level + 1.5, 2, 3).to(torch.uint8)
    mat = torch.where(zi < hcol - 3.0, 4, mat)
    mat = torch.where((hcol > 0.75 * Z) & (zi > hcol - 2.0), 5, mat)
    occ = torch.where(below, mat, 0)
    occ = torch.where(~below & (zi < water_level), 1, occ).to(torch.uint8)
    pal = torch.tensor(PALETTE, **f32)
    base = pal[torch.clamp(occ.to(torch.int64), max=7)]
    tint = 0.9 + 0.2 * _noise2((gx * 37.0)[:, :, None].expand(X, Y, Z),
                               zi * 0.37 + (gy * 37.0)[:, :, None],
                               seed + 7777)
    return occ, base * tint[..., None]


def top_height(occ: torch.Tensor) -> int:
    """One above the highest solid voxel of any column (0 if none)."""
    solid_z = (occ > 0).any(dim=0).any(dim=0).nonzero()
    return int(solid_z.max()) + 1 if solid_z.numel() else 0


def soft_truth(occ: torch.Tensor, rgb: torch.Tensor,
               sigma_solid: float = 40.0):
    """(sigma_raw [X, Y, Z], rgb_raw [3, X, Y, Z]) of the hard grid:
    solid voxels get a high density, empty ones the mean colour of their
    solid neighbours over two dilation passes, as logits."""
    solid = occ > 0
    sigma_raw = torch.where(solid, sigma_solid, -6.0).to(torch.float32)
    w = solid.to(torch.float32)
    cols = [rgb[..., c] * w for c in range(3)]
    for _ in range(2):
        wsum = torch.zeros_like(w)
        csums = [torch.zeros_like(c) for c in cols]
        for ax in range(3):
            for sh in (1, -1):
                wsum = wsum + torch.roll(w, sh, dims=ax)
                csums = [cs + torch.roll(c, sh, dims=ax)
                         for cs, c in zip(csums, cols)]
        filled = wsum > 0
        denom = torch.clamp(wsum, min=1.0)
        cols = [torch.where(w > 0, c, torch.where(filled, cs / denom, c))
                for c, cs in zip(cols, csums)]
        w = torch.maximum(w, filled.to(torch.float32))
    logit = [torch.log(torch.clamp(c, 1e-3, 1.0 - 1e-3))
             - torch.log1p(-torch.clamp(c, 1e-3, 1.0 - 1e-3)) for c in cols]
    return sigma_raw, torch.stack(logit)


def part1by2(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3(x, y, z) -> torch.Tensor:
    """Interleaved Morton code, x in bit 0."""
    return part1by2(x) | (part1by2(y) << 1) | (part1by2(z) << 2)


def morton_index(dim: int, device) -> torch.Tensor:
    """int64 [dim^3]: the Morton code of each voxel in row-major order."""
    r = torch.arange(dim, dtype=torch.int64, device=device)
    return morton3(r[:, None, None], r[None, :, None],
                   r[None, None, :]).reshape(-1)
