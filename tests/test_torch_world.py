"""Parity: vxtpu_torch's world tables and procedural scenes against
vxtpu's, on the same occupancy (handed over as numpy arrays)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vxtpu.world import distfield as jdistfield
from vxtpu.world import packed as jpacked
from vxtpu.world import procgen as jprocgen
from vxtpu_torch import convert
from vxtpu_torch.world import distfield, packed, procgen
from vxtpu_torch.world.grid import VoxelGrid

DIMS = (32, 32, 32)
CPU = torch.device("cpu")


def jax_scenes(dims=DIMS):
    return {
        "box": jprocgen.solid_box(dims, (8, 8, 8), (24, 24, 20)),
        "sphere": jprocgen.shell_sphere(dims),
        "terrain": jprocgen.terrain(dims, seed=11, with_rgb=True),
    }


def _torch_grid(jgrid):
    occ = convert.occupancy_from_numpy(np.asarray(jgrid.occupancy),
                                       device=CPU)
    rgb = None if jgrid.rgb is None else torch.tensor(np.asarray(jgrid.rgb))
    return VoxelGrid(occupancy=occ, rgb=rgb)


@pytest.mark.parametrize("scene", ["box", "sphere", "terrain"])
def test_tables_equal_vxtpu(scene):
    jg = jax_scenes()[scene]
    g = _torch_grid(jg)
    want = jpacked.build_packed_morton(jg.occupancy, cap=64).words
    got = packed.build_packed_morton(g.occupancy, cap=64)
    assert got.words.dtype == torch.int16
    assert torch.equal(got.words,
                       convert.packed_morton_from_numpy(np.asarray(want),
                                                        DIMS,
                                                        device=CPU).words)
    np.testing.assert_array_equal(got.to_rows128_f32().numpy(),
                                  np.asarray(want))

    want_m = jpacked.build_material_morton(jg.occupancy)
    got_m = packed.build_material_morton(g.occupancy)
    assert got_m.dtype == torch.int32
    assert torch.equal(got_m, convert.material_morton_from_numpy(
        np.asarray(want_m), DIMS, device=CPU))
    np.testing.assert_array_equal(packed.rows128_f32(got_m).numpy(),
                                  np.asarray(want_m))

    want_d = jdistfield.build_distance_field(jg.occupancy, cap=24)
    got_d = distfield.build_distance_field(g.occupancy, cap=24)
    assert got_d.dtype == torch.uint8
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_rgb8_table_equal_vxtpu():
    jg = jax_scenes()["terrain"]
    want = jpacked.build_rgb8_morton(jg)
    got = packed.build_rgb8_morton(_torch_grid(jg))
    assert torch.equal(got, convert.rgb8_morton_from_numpy(np.asarray(want),
                                                           DIMS, device=CPU))


def test_short_table_padding_stripped():
    """A 8^3 grid has 64 coarse cells: vxtpu pads its one row with 255,
    the flat table has exactly 64 words and the rows view restores it."""
    jg = jprocgen.shell_sphere((8, 8, 8))
    want = np.asarray(jpacked.build_packed_morton(jg.occupancy).words)
    got = packed.build_packed_morton(_torch_grid(jg).occupancy)
    assert got.words.shape == (64,)
    np.testing.assert_array_equal(got.to_rows128_f32().numpy(), want)
    assert torch.equal(
        convert.packed_morton_from_numpy(want, (8, 8, 8), device=CPU).words,
        got.words)


def test_morton_is_bijection():
    S = 16
    r = torch.arange(S)
    m = packed.morton3(r[:, None, None], r[None, :, None], r[None, None, :])
    assert sorted(m.reshape(-1).tolist()) == list(range(S ** 3))
    jm = jpacked.morton3(*jnp.meshgrid(jnp.arange(S), jnp.arange(S),
                                       jnp.arange(S), indexing="ij"))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


def test_terrain_matches_vxtpu():
    want = np.asarray(jprocgen.terrain(DIMS, seed=11, with_rgb=True).occupancy)
    got = procgen.terrain(DIMS, seed=11, with_rgb=True, device=CPU)
    differ = int((got.occupancy.numpy() != want).sum())
    print(f"terrain(seed=11) at 32^3: {differ} of {want.size} voxels differ")
    assert differ <= 0.001 * want.size


def test_terrain_rgb_matches_vxtpu():
    jg = jprocgen.terrain(DIMS, seed=3, with_rgb=True)
    g = procgen.terrain(DIMS, seed=3, with_rgb=True, device=CPU)
    np.testing.assert_allclose(g.rgb.numpy(), np.asarray(jg.rgb), atol=1e-6)


def test_sphere_and_box_exact():
    np.testing.assert_array_equal(
        procgen.shell_sphere(DIMS, device=CPU).occupancy.numpy(),
        np.asarray(jprocgen.shell_sphere(DIMS).occupancy))
    np.testing.assert_array_equal(
        procgen.solid_box(DIMS, (8, 8, 8), (24, 24, 20),
                          device=CPU).occupancy.numpy(),
        np.asarray(jprocgen.solid_box(DIMS, (8, 8, 8),
                                      (24, 24, 20)).occupancy))
