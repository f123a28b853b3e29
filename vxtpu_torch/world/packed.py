"""Coarse-cell tables for the march kernels (counterpart of
``vxtpu/world/packed.py``).

Row-major (``build_packed``, the table of the row-major march kernel):
cell c = 2x2x2 fine voxels, word[c] = child_bits | (D << 8), D = 0 iff
the cell holds a solid voxel, else its coarse chessboard distance to the
nearest occupied cell (capped). The cell's linear index is
``(cx * cyd + cy) * czd + cz`` over ``coarse_dims`` (any even dims). The
table is int32 [cx*cy*cz] (8 MB at 256^3), the layout the plain march and
the comparisons with vxtpu read. A word reaches 65,535 (D <= 255), so a
``uint16`` holds every word: ``brick_words`` makes the 16-bit copy the
CUDA kernel reads, in bricks of 4x4x4 coarse cells, one 128-byte line
each (4 MiB at 256^3, 32 MiB at 512^3). ``packed_accel`` pairs the two;
``build_packed`` and ``convert.packed_accel_from_numpy`` both go through
it.

Morton (``build_packed_morton``, the table of the fused march kernel):
    cell c = 2x2x2 fine voxels; its signed occupancy word is
        +child_bits (1..255)  if the cell holds a solid voxel
                                (bit (x&1)<<2 | (y&1)<<1 | (z&1))
        -D          (-1..-cap) if empty, D = coarse chessboard distance to
                                the nearest occupied cell.

Every fine voxel of any cell within chessboard distance D-1 of an empty
cell c is empty, so a ray in c may jump to the exit of the fine-space box
[2c - 2(D-1), 2c + 2D). The cell's linear index is ``morton3(cx, cy, cz)``.

vxtpu stores these tables as float32 [rows, 128] because its TPU kernel
fetches by one-hot matmul. On the GPU a table is flat, in Morton order:
the occupancy word as int16 [S^3] (S = D/2; 32 MB at 512^3, resident in
the H100's 50 MB L2), the material word as int32 [S^3] and the RGB8 word
as int32 [D^3]. ``rows128_f32`` rebuilds vxtpu's layout, padding and all,
for comparisons only.
"""

from __future__ import annotations

import dataclasses

import torch

from vxtpu_torch.world.distfield import build_distance_field

LANES = 128


def part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v to every third bit."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Interleaved 3-D Morton code (x gets bit 0); a bijection of a
    2^k-sided cube onto [0, 2^(3k)). Broadcasts like ``x | y | z``."""
    return part1by2(x) | (part1by2(y) << 1) | (part1by2(z) << 2)


def _require_cubic_pow2(dims) -> None:
    X, Y, Z = dims
    if not (X == Y == Z and X >= 2 and (X & (X - 1)) == 0):
        raise ValueError(f"morton tables need a cubic power-of-two grid, "
                         f"got {tuple(dims)}")


def _morton_order(cube: torch.Tensor) -> torch.Tensor:
    """[S, S, S] tensor -> flat [S^3] with element (i, j, k) at
    morton3(i, j, k)."""
    S = cube.shape[0]
    r = torch.arange(S, dtype=torch.int64, device=cube.device)
    mi = morton3(r[:, None, None], r[None, :, None], r[None, None, :])
    flat = torch.empty(S * S * S, dtype=cube.dtype, device=cube.device)
    flat[mi.reshape(-1)] = cube.reshape(-1)
    return flat


def _child_bits(occupancy: torch.Tensor) -> torch.Tensor:
    """int32 [cx, cy, cz]: fine occupancy of each cell's 8 children."""
    solid = (occupancy > 0).to(torch.int32)
    bits = torch.zeros_like(solid[0::2, 0::2, 0::2])
    for a in range(2):
        for b in range(2):
            for c in range(2):
                bits |= solid[a::2, b::2, c::2] << ((a << 2) | (b << 1) | c)
    return bits


def coarse_dims(dims) -> tuple[int, int, int]:
    """Coarse (2x2x2-cell) grid shape of even fine dims; raises on odd."""
    if any(int(n) % 2 for n in dims):
        raise ValueError(f"packed tables need even dims, got {tuple(dims)}")
    return tuple(int(n) // 2 for n in dims)  # type: ignore[return-value]


def _packed_words(occupancy: torch.Tensor, cap: int) -> torch.Tensor:
    """int32 [cx, cy, cz]: child_bits | (coarse chessboard D << 8)."""
    coarse_dims(occupancy.shape)
    bits = _child_bits(occupancy)
    d = build_distance_field(bits > 0, cap=min(cap, 255)).to(torch.int32)
    return bits | (d << 8)


BRICK = 4     # coarse cells a brick spans on each axis


def brick_dims(dims) -> tuple[int, int, int]:
    """Bricks of the bricked table on each axis: the coarse dims of even
    fine dims, padded up to multiples of BRICK, over BRICK."""
    return tuple(-(-n // BRICK) for n in coarse_dims(dims))  # type: ignore


def brick_words(words: torch.Tensor, dims) -> torch.Tensor:
    """The bricked 16-bit copy of a row-major word table: int16 [BX*BY*BZ
    * 64] holding each word's uint16 bit pattern, the word of coarse cell
    (cx, cy, cz) at ``brick(cx>>2, cy>>2, cz>>2) * 64 + ((cx&3) << 4 |
    (cy&3) << 2 | (cz&3))``, bricks row-major over ``brick_dims``. The
    padding cells hold 0 and no march reads them."""
    cx, cy, cz = coarse_dims(dims)
    bx, by, bz = brick_dims(dims)
    pad = torch.zeros((bx * BRICK, by * BRICK, bz * BRICK),
                      dtype=torch.int32, device=words.device)
    pad[:cx, :cy, :cz] = words.reshape(cx, cy, cz)
    b = pad.reshape(bx, BRICK, by, BRICK, bz, BRICK).permute(0, 2, 4, 1, 3, 5)
    # the uint16 bit pattern as int16: 32768..65535 -> -32768..-1
    return (((b.reshape(-1) + 32768) & 0xFFFF) - 32768).to(torch.int16)


@dataclasses.dataclass(frozen=True)
class PackedAccel:
    """words: int32 [cx*cy*cz], child_bits | D << 8 of each coarse cell in
    row-major order, which the plain march and the comparisons with vxtpu
    read; bricks: the same words as ``brick_words`` lays them out, which
    the CUDA kernel reads. Make both with ``packed_accel``."""

    words: torch.Tensor
    bricks: torch.Tensor

    def to_rows128_f32(self) -> torch.Tensor:
        """vxtpu's ``PackedAccel.words`` layout (comparisons only)."""
        return rows128_f32(self.words)


def packed_accel(words: torch.Tensor, dims) -> PackedAccel:
    """The PackedAccel of a flat int32 row-major word table of fine grid
    ``dims``: the words and their bricked 16-bit copy."""
    return PackedAccel(words=words, bricks=brick_words(words, dims))


def build_packed(occupancy: torch.Tensor, cap: int = 64) -> PackedAccel:
    """Row-major word table of a uint8 occupancy grid [X, Y, Z] (even
    dims), with its bricked copy."""
    return packed_accel(_packed_words(occupancy, cap).reshape(-1),
                        occupancy.shape)


@dataclasses.dataclass(frozen=True)
class PackedMorton:
    """words: int16 [S^3], the signed occupancy word of each coarse cell
    in Morton order."""

    words: torch.Tensor

    def to_rows128_f32(self) -> torch.Tensor:
        """vxtpu's ``PackedMorton.words`` layout (comparisons only)."""
        return rows128_f32(self.words)


def build_packed_morton(occupancy: torch.Tensor, cap: int = 64) -> PackedMorton:
    """Signed Morton word table of a uint8 occupancy grid [X, Y, Z]
    (X == Y == Z, a power of two)."""
    _require_cubic_pow2(occupancy.shape)
    word = _packed_words(occupancy, cap)
    cb, dist = word & 255, word >> 8
    signed = torch.where(cb > 0, cb, -dist).to(torch.int16)
    return PackedMorton(words=_morton_order(signed))


def build_material_morton(occupancy: torch.Tensor) -> torch.Tensor:
    """int32 [S^3] Morton table of per-cell material words: the 8 child
    material ids, 3 bits each at bit 3*child_index (ids clipped to 7)."""
    _require_cubic_pow2(occupancy.shape)
    ids = torch.clamp(occupancy.to(torch.int32), max=7)
    word = torch.zeros_like(ids[0::2, 0::2, 0::2])
    for a in range(2):
        for b in range(2):
            for c in range(2):
                ci = (a << 2) | (b << 1) | c
                word |= ids[a::2, b::2, c::2] << (3 * ci)
    return _morton_order(word)


def build_rgb8_morton(grid) -> torch.Tensor:
    """int32 [X*Y*Z] fine-voxel Morton table of per-voxel RGB8 words:
    r8 | g8 << 8 | b8 << 16, each channel round(c * 255) clipped to
    [0, 255]."""
    if grid.rgb is None:
        raise ValueError("build_rgb8_morton needs a grid with per-voxel rgb")
    _require_cubic_pow2(grid.dims)
    word = torch.zeros(grid.dims, dtype=torch.int32,
                       device=grid.occupancy.device)
    for c in range(3):
        q = torch.clamp(torch.round(grid.rgb[..., c] * 255.0), 0, 255)
        word |= q.to(torch.int32) << (8 * c)
    return _morton_order(word)


def rows128_f32(flat: torch.Tensor) -> torch.Tensor:
    """vxtpu's float32 [rows, 128] layout of a flat table; a short last
    row is padded with 255.0. For comparing with vxtpu only."""
    n = flat.shape[0]
    rows = -(-n // LANES)
    out = torch.full((rows * LANES,), 255.0, dtype=torch.float32,
                     device=flat.device)
    out[:n] = flat.to(torch.float32)
    return out.reshape(rows, LANES)
