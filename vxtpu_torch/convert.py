"""State carried across from the JAX package: vxtpu's arrays, given as
numpy arrays, into this package's tensors and layouts. Lets the tests feed
both packages the same world, camera, lights, soft grids and optimizer
state. Every function makes its tensors on ``device``, the GPU unless
asked otherwise (``vxtpu_torch.device``)."""

from __future__ import annotations

import numpy as np
import torch

from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.device import DEFAULT, resolve
from vxtpu_torch.world.lights import Lights
from vxtpu_torch.world.packed import (PackedAccel, PackedMorton, coarse_dims,
                                      packed_accel)


def occupancy_from_numpy(occ: np.ndarray, device=DEFAULT) -> torch.Tensor:
    """uint8 [X, Y, Z] occupancy."""
    return torch.as_tensor(np.array(occ, np.uint8), device=resolve(device))


def _flat_words(rows128: np.ndarray, n: int, dtype: torch.dtype,
                device) -> torch.Tensor:
    """vxtpu's float32 [rows, 128] table -> flat [n] integer tensor; the
    padding of a short last row is dropped. Raises if a word is not an
    integer that ``dtype`` holds exactly."""
    flat = np.asarray(rows128, np.float32).reshape(-1)
    if flat.shape[0] < n:
        raise ValueError(f"table holds {flat.shape[0]} words, need {n}")
    flat = flat[:n]
    info = torch.iinfo(dtype)
    ints = flat.astype(np.int64)
    if not (np.all(ints == flat) and ints.min(initial=0) >= info.min
            and ints.max(initial=0) <= info.max):
        raise ValueError(f"table words do not fit {dtype} exactly")
    return torch.as_tensor(ints, device=resolve(device)).to(dtype)


def packed_morton_from_numpy(words_f32_rows128: np.ndarray, dims,
                             device=DEFAULT) -> PackedMorton:
    """vxtpu ``PackedMorton.words`` -> int16 [S^3] signed words."""
    cells = (dims[0] // 2) * (dims[1] // 2) * (dims[2] // 2)
    return PackedMorton(words=_flat_words(words_f32_rows128, cells,
                                          torch.int16, device))


def packed_accel_from_numpy(words_f32_rows128: np.ndarray, dims,
                            device=DEFAULT) -> PackedAccel:
    """vxtpu ``PackedAccel.words`` (row-major) -> int32 [cx*cy*cz], with
    its bricked 16-bit copy."""
    cx, cy, cz = coarse_dims(dims)
    return packed_accel(_flat_words(words_f32_rows128, cx * cy * cz,
                                    torch.int32, device), dims)


def resume_state_from_numpy(voxel, dist, steps, done,
                            device=DEFAULT) -> tuple:
    """vxtpu's round outputs (``rec.voxel`` [N, 3], ``ext["dist"]``,
    ``rec.steps``, ``ext["done"]`` of ``march_pallas_v2(...,
    extended=True)``) -> the port's ``resume_state`` (voxel, dist, steps),
    int32; the rays that are done become dead slots (dist -1)."""
    device = resolve(device)
    dist = np.where(np.asarray(done).astype(bool), -1, np.asarray(dist))
    return tuple(torch.as_tensor(np.array(x, np.int32), device=device)
                 for x in (voxel, dist, steps))


def atlas_from_numpy(channels, tex_size: int, device=DEFAULT):
    """vxtpu ``TextureAtlas`` (three float32 [M*T*T] planes) ->
    TextureAtlas."""
    from vxtpu_torch.world.atlas import TextureAtlas

    device = resolve(device)
    return TextureAtlas(
        channels=tuple(torch.tensor(np.asarray(c, np.float32), device=device)
                       for c in channels), tex_size=int(tex_size))


def material_morton_from_numpy(mats_f32_rows128: np.ndarray, dims,
                               device=DEFAULT) -> torch.Tensor:
    """vxtpu ``build_material_morton`` table -> int32 [S^3]."""
    cells = (dims[0] // 2) * (dims[1] // 2) * (dims[2] // 2)
    return _flat_words(mats_f32_rows128, cells, torch.int32, device)


def rgb8_morton_from_numpy(rgb8_f32_rows128: np.ndarray, dims,
                           device=DEFAULT) -> torch.Tensor:
    """vxtpu ``build_rgb8_morton`` table -> int32 [X*Y*Z]."""
    return _flat_words(rgb8_f32_rows128, dims[0] * dims[1] * dims[2],
                       torch.int32, device)


def camera_from_numpy(pos, yaw, pitch, fov_y, device=DEFAULT) -> Camera:
    """vxtpu ``Camera`` fields (fov_y in radians, as vxtpu stores it)."""
    f32 = dict(dtype=torch.float32, device=resolve(device))
    return Camera(pos=torch.tensor(np.asarray(pos, np.float32), **f32),
                  yaw=torch.as_tensor(np.float32(yaw), **f32),
                  pitch=torch.as_tensor(np.float32(pitch), **f32),
                  fov_y=torch.as_tensor(np.float32(fov_y), **f32))


def lights_from_numpy(pos, rgb, intensity, device=DEFAULT) -> Lights:
    """vxtpu ``Lights`` fields -> Lights."""
    f32 = dict(dtype=torch.float32, device=resolve(device))
    return Lights(
        pos=torch.tensor(np.asarray(pos, np.float32).reshape(-1, 3), **f32),
        rgb=torch.tensor(np.asarray(rgb, np.float32).reshape(-1, 3), **f32),
        intensity=torch.tensor(
            np.asarray(intensity, np.float32).reshape(-1), **f32))


def soft_grid_from_numpy(sigma_raw, rgb_raw, device=DEFAULT):
    """vxtpu ``SoftGrid`` fields (sigma [X,Y,Z], rgb [3,X,Y,Z])."""
    from vxtpu_torch.render.soft import SoftGrid

    device = resolve(device)
    return SoftGrid(
        sigma_raw=torch.tensor(np.asarray(sigma_raw, np.float32),
                               device=device),
        rgb_raw=torch.tensor(np.asarray(rgb_raw, np.float32), device=device))


def morton_soft_grid_from_numpy(sigma_tab_rows128, rgb_tab, device=DEFAULT):
    """vxtpu ``MortonSoftGrid`` tables ([rows, 128] and [3, rows, 128])
    -> the channel-interleaved Morton table [D^3, 4]."""
    from vxtpu_torch.render.kernel_sample import interleave_tables
    from vxtpu_torch.render.soft_kernel import MortonSoftGrid

    device = resolve(device)
    return MortonSoftGrid(tab=interleave_tables(
        torch.tensor(np.asarray(sigma_tab_rows128, np.float32),
                     device=device),
        torch.tensor(np.asarray(rgb_tab, np.float32), device=device)))


def adam_state_from_optax_leaves(leaves, template, device=DEFAULT):
    """optax adam state leaves (``jax.tree_util.tree_leaves`` of vxtpu's
    opt_state, as numpy arrays) -> the port's optimizer state, shaped like
    ``template`` (``train.loop.init_opt_state`` of
    ``train.loop.state_params`` of the fit's model)."""
    from vxtpu_torch.train.checkpoint import opt_state_from_leaves

    return opt_state_from_leaves([np.asarray(x) for x in leaves], template,
                                 device)
