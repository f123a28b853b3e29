"""Procedural terrain and test scenes (counterpart of
``vxtpu/world/procgen.py``): hash-gradient value noise with fractal
octaves over the [X, Y] plane, compared against the z index to give
occupancy. Same (seed, dims) -> same grid as vxtpu, up to voxels where a
last-ulp difference in cos/sin moves a column height across an integer.
"""

from __future__ import annotations

import math

import torch

from vxtpu_torch.device import DEFAULT, resolve
from vxtpu_torch.world.grid import VoxelGrid, material_rgb

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32) and a 32-bit constant c,
    without int64 overflow (torch has no complete uint32 arithmetic)."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash2(ix: torch.Tensor, iy: torch.Tensor, seed: int) -> torch.Tensor:
    """Integer lattice hash -> uint32 value held in int64."""
    h = (_mul32(ix.to(torch.int64) & _M32, 0x85EBCA6B)
         ^ _mul32(iy.to(torch.int64) & _M32, 0xC2B2AE35)
         ^ (seed * 0x9E3779B9 & _M32))
    h = _mul32(h ^ (h >> 15), 0x2C1B3C6D)
    h = _mul32(h ^ (h >> 12), 0x297A2D39)
    return h ^ (h >> 15)


def _grad2(ix, iy, seed):
    """Unit gradient per lattice point: one of 8 directions by hash."""
    ang = (_hash2(ix, iy, seed) & 7).to(torch.float32) * (math.pi / 4.0)
    return torch.cos(ang), torch.sin(ang)


def gradient_noise2(x: torch.Tensor, y: torch.Tensor, seed: int) -> torch.Tensor:
    """Perlin-style gradient noise in roughly [-1, 1]; x, y float32."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    ix0 = x0.to(torch.int32)
    iy0 = y0.to(torch.int32)
    fx = x - x0
    fy = y - y0
    u = fx * fx * fx * (fx * (fx * 6.0 - 15.0) + 10.0)
    v = fy * fy * fy * (fy * (fy * 6.0 - 15.0) + 10.0)

    def dot_corner(ox, oy):
        gx, gy = _grad2(ix0 + ox, iy0 + oy, seed)
        return gx * (fx - ox) + gy * (fy - oy)

    n00 = dot_corner(0, 0)
    n10 = dot_corner(1, 0)
    n01 = dot_corner(0, 1)
    n11 = dot_corner(1, 1)
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    return (nx0 + v * (nx1 - nx0)) * 1.4142


def fractal_noise2(x, y, seed: int, octaves: int = 4, lacunarity: float = 2.0,
                   gain: float = 0.5):
    """Fractal Brownian motion over gradient_noise2; roughly [-1, 1]."""
    total = torch.zeros_like(x)
    amp, freq, norm = 1.0, 1.0, 0.0
    for o in range(octaves):
        total = total + amp * gradient_noise2(x * freq, y * freq, seed + o * 131)
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / norm


def terrain(dims: tuple[int, int, int], seed: int = 0,
            feature_scale: float = 0.25, water_frac: float = 0.22,
            with_rgb: bool = False, device=DEFAULT) -> VoxelGrid:
    """Heightmap terrain with material bands by altitude (water, sand,
    grass, stone, snow)."""
    device = resolve(device)
    X, Y, Z = dims
    f32 = dict(dtype=torch.float32, device=device)
    xs = (torch.arange(X, **f32) + 0.5) / X
    ys = (torch.arange(Y, **f32) + 0.5) / Y
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    k = feature_scale * X
    h = fractal_noise2(gx * k / X * 8.0, gy * k / X * 8.0, seed, octaves=5)
    height = (0.5 + 0.35 * h) * Z  # [X, Y]

    zi = torch.arange(Z, **f32)[None, None, :]
    hcol = height[:, :, None]
    below = zi < hcol
    water_level = water_frac * Z
    mat = torch.where(hcol < water_level + 1.5, 2, 3).to(torch.uint8)
    mat = torch.where(zi < hcol - 3.0, 4, mat)
    mat = torch.where((hcol > 0.75 * Z) & (zi > hcol - 2.0), 5, mat)
    occ = torch.where(below, mat, 0)
    occ = torch.where(~below & (zi < water_level), 1, occ).to(torch.uint8)

    rgb = None
    if with_rgb:
        base = material_rgb(device)[torch.clamp(occ.to(torch.int64), max=7)]
        tint = 0.9 + 0.2 * gradient_noise2(
            (gx * 37.0)[:, :, None].expand(X, Y, Z),
            zi * 0.37 + (gy * 37.0)[:, :, None],
            seed + 7777,
        )
        rgb = base * tint[..., None]
    return VoxelGrid(occupancy=occ, rgb=rgb)


def shell_sphere(dims: tuple[int, int, int], material: int = 4,
                 device=DEFAULT) -> VoxelGrid:
    """A hollow sphere test scene."""
    device = resolve(device)
    X, Y, Z = dims
    f32 = dict(dtype=torch.float32, device=device)
    r = 0.35 * min(dims)
    ii = (torch.arange(X, **f32) + 0.5 - X / 2)[:, None, None]
    jj = (torch.arange(Y, **f32) + 0.5 - Y / 2)[None, :, None]
    kk = (torch.arange(Z, **f32) + 0.5 - Z / 2)[None, None, :]
    dist = torch.sqrt(ii * ii + jj * jj + kk * kk)
    occ = ((dist <= r) & (dist >= r - 2.0)).to(torch.uint8) * material
    return VoxelGrid(occupancy=occ)


def solid_box(dims: tuple[int, int, int], lo, hi, material: int = 3,
              device=DEFAULT) -> VoxelGrid:
    """Axis-aligned solid box [lo, hi)."""
    occ = torch.zeros(dims, dtype=torch.uint8, device=resolve(device))
    occ[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = material
    return VoxelGrid(occupancy=occ)
