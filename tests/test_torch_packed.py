"""Parity: vxtpu_torch's row-major table and march (on CPU tensors: the
plain version of ``march_packed_kernel``) against vxtpu's ``build_packed``
and ``march_pallas`` (the Pallas kernel in interpret mode), on the same
world and rays.

Contract: the table's words are byte-equal; hit, voxel, normal and steps
equal on every ray; t within atol 1e-5 (both sides compute the same
float32 operations; the margin covers XLA's rounding)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vxtpu.camera.camera import Camera as JCamera
from vxtpu.camera.rays import generate_rays as jgenerate_rays
from vxtpu.render.kernel_pallas import march_pallas
from vxtpu.world import packed as jpacked
from vxtpu.world import procgen as jprocgen
from vxtpu_torch import convert
from vxtpu_torch import kernel_check as kc
from vxtpu_torch.render import kernel_packed
from vxtpu_torch.render.kernel_packed import make_march_packed, march_packed
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.world import packed, procgen

CPU = torch.device("cpu")
DIMS = (32, 32, 32)
FLAT = (64, 64, 32)


@functools.cache
def jax_scene(name, dims=DIMS):
    """vxtpu's scene (built once per file: its eager terrain takes ~3 s)."""
    X, Y, Z = dims
    return {
        "box": lambda: jprocgen.solid_box(dims, (X // 4, Y // 4, Z // 4),
                                          (3 * X // 4, 3 * Y // 4,
                                           5 * Z // 8)),
        "sphere": lambda: jprocgen.shell_sphere(dims),
        "terrain": lambda: jprocgen.terrain(dims, seed=11),
    }[name]()


@functools.cache
def jax_table(name, dims=DIMS):
    return jpacked.build_packed(jax_scene(name, dims).occupancy)


def jax_camera(name, dims=DIMS):
    X, Y, Z = dims
    if name == "outside":
        return JCamera.make(pos=(-0.625 * X, 0.5 * Y, 1.25 * Z)).look_at(
            (0.5 * X, 0.5 * Y, 0.375 * Z))
    return JCamera.make(pos=(0.5 * X, 0.5 * Y, 0.875 * Z), yaw=2.2,
                        pitch=-0.5)


@pytest.mark.parametrize("scene,dims", [("box", DIMS), ("sphere", DIMS),
                                        ("terrain", DIMS), ("terrain", FLAT)])
def test_build_packed_equals_vxtpu(scene, dims):
    jg = jax_scene(scene, dims)
    want = np.asarray(jax_table(scene, dims).words)
    occ = convert.occupancy_from_numpy(np.asarray(jg.occupancy), device=CPU)
    got = packed.build_packed(occ)
    assert got.words.dtype == torch.int32
    assert got.words.shape == (dims[0] * dims[1] * dims[2] // 8,)
    np.testing.assert_array_equal(got.to_rows128_f32().numpy(), want)
    conv = convert.packed_accel_from_numpy(want, dims, device=CPU)
    assert torch.equal(got.words, conv.words)
    assert torch.equal(got.bricks, conv.bricks)


def _brick_readback(bricks, dims):
    """Every coarse cell's word read back from a bricked table, in
    row-major cell order, through the brick index written out here from
    its definition: brick(cx>>2, cy>>2, cz>>2) * 64 + ((cx&3) << 4 |
    (cy&3) << 2 | (cz&3)), bricks row-major over the coarse dims padded
    up to multiples of 4. The uint16 bit patterns as int32."""
    cx, cy, cz = (n // 2 for n in dims)
    by, bz = -(-cy // 4), -(-cz // 4)
    c = torch.arange(cx * cy * cz)
    x, y, z = c // (cy * cz), (c // cz) % cy, c % cz
    idx = ((((x >> 2) * by + (y >> 2)) * bz + (z >> 2)) * 64
           + ((x & 3) << 4 | (y & 3) << 2 | (z & 3)))
    return bricks.to(torch.int32)[idx] & 0xFFFF


# 64^3, 48x80x32, and coarse dims 18x22x10, none a multiple of 4
BRICK_DIMS = [(64, 64, 64), (48, 80, 32), (36, 44, 20)]


@pytest.mark.parametrize("dims", BRICK_DIMS,
                         ids=["x".join(map(str, d)) for d in BRICK_DIMS])
def test_bricked_copy_of_vxtpu_words(dims):
    """convert's PackedAccel of vxtpu's row-major words carries the bricked
    16-bit copy the CUDA kernel reads: every cell's word, read back
    through the brick index, equals words & 0xFFFF (and every word fits
    16 bits); build_packed makes the same copy."""
    want = np.asarray(jax_table("box", dims).words)
    acc = convert.packed_accel_from_numpy(want, dims, device=CPU)
    nb = 1
    for n in dims:
        nb *= -(-n // 8)
    assert acc.bricks.dtype == torch.int16
    assert acc.bricks.shape == (nb * 64,)
    assert torch.equal(_brick_readback(acc.bricks, dims), acc.words & 0xFFFF)
    assert torch.equal(acc.words & 0xFFFF, acc.words)
    occ = convert.occupancy_from_numpy(
        np.asarray(jax_scene("box", dims).occupancy), device=CPU)
    assert torch.equal(packed.build_packed(occ).bricks, acc.bricks)


def test_bricked_copy_keeps_all_16_bits():
    """Words at and above 32768 (D >= 128) keep their bit pattern in the
    int16 copy."""
    dims = (36, 44, 20)
    n = 18 * 22 * 10
    words = torch.from_numpy(np.random.default_rng(3).integers(
        0, 65536, n).astype(np.int32))
    words[:2] = torch.tensor([32768, 65535], dtype=torch.int32)
    got = _brick_readback(packed.brick_words(words, dims), dims)
    assert torch.equal(got, words)


def test_odd_dims_raise():
    occ = torch.zeros((32, 31, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        packed.build_packed(occ)
    with pytest.raises(AssertionError):
        jpacked.build_packed(jnp.zeros((32, 31, 32), jnp.uint8))
    with pytest.raises(ValueError):
        convert.packed_accel_from_numpy(np.zeros((8, 128), np.float32),
                                        (32, 31, 32), device=CPU)


@functools.cache
def _jax_march(dims, max_steps):
    return jax.jit(functools.partial(march_pallas, dims=dims,
                                     max_steps=max_steps, interpret=True))


def _both(scene, cam, h, w, dims=DIMS, t_max=None):
    jacc = jax_table(scene, dims)
    o, d = jgenerate_rays(jax_camera(cam, dims), h, w)
    ms = sum(dims) + 2
    jrec = _jax_march(dims, ms)(o, d, jacc, t_max=t_max)
    acc = convert.packed_accel_from_numpy(np.asarray(jacc.words), dims,
                                          device=CPU)
    tm = None if t_max is None else torch.tensor(np.asarray(t_max))
    rec = march_packed(torch.tensor(np.asarray(o)),
                       torch.tensor(np.asarray(d)), acc, dims, ms, t_max=tm)
    return jrec, rec


def _check_exact(jrec, rec):
    hit = np.asarray(jrec.hit)
    for k in ("hit", "voxel", "steps"):
        want, got = np.asarray(getattr(jrec, k)), getattr(rec, k).numpy()
        bad = (want != got).reshape(want.shape[0], -1).any(-1)
        assert not bad.any(), f"{k} differs on {int(bad.sum())} rays"
    np.testing.assert_array_equal(rec.normal.numpy(), np.asarray(jrec.normal))
    np.testing.assert_allclose(rec.t.numpy(), np.asarray(jrec.t), rtol=0,
                               atol=1e-5)
    return hit


CASES = {
    # name: (scene, camera, h, w, dims, t_max of the odd rays)
    "terrain32-outside-tmax40": ("terrain", "outside", 32, 32, DIMS, 40.0),
    "sphere32-inside-n117": ("sphere", "inside", 9, 13, DIMS, None),
    "terrain64x64x32-outside": ("terrain", "outside", 16, 16, FLAT, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_march_packed_matches_vxtpu(case):
    """With tm, the odd rays are capped at t_max = tm (shadow-ray
    semantics) and the even ones run free, in one call."""
    scene, cam, h, w, dims, tm = CASES[case]
    t_max = None
    if tm is not None:
        t_max = jnp.where(jnp.arange(h * w) % 2 == 1, tm, 1e30).astype(
            jnp.float32)
    jrec, rec = _both(scene, cam, h, w, dims, t_max)
    hit = _check_exact(jrec, rec)
    assert hit.any() and not hit.all()
    assert rec.hit.shape == (h * w,) and rec.voxel.dtype == torch.int32
    assert rec.steps.dtype == torch.int32 and rec.t.dtype == torch.float32
    if tm is not None:
        capped = np.arange(h * w) % 2 == 1
        assert (rec.t.numpy()[hit & capped] <= tm).all()
        assert (rec.t.numpy()[hit & ~capped] > tm).any()
        # point 2: a capped ray that passes t_end stops on that iteration
        assert (rec.steps.numpy()[~hit & capped] >= 1).any()


def test_march_packed_matches_golden_checksums():
    """The plain version on the fixed rays of the JAX cross-check against
    vxtpu's march_pallas checksums (vxtpu_torch/data/packed_seed7.json)."""
    import json
    from pathlib import Path

    gold = json.loads((Path(kc.__file__).parent / "data" /
                       "packed_seed7.json").read_text())["march"]
    D = gold["D"]
    dims = (D,) * 3
    o, d, t_max = kc.golden_march_inputs(D, gold["n"], gold["seed"])
    grid = procgen.terrain(dims, seed=gold["terrain_seed"], device=CPU)
    rec = march_packed(torch.from_numpy(o), torch.from_numpy(d),
                       packed.build_packed(grid.occupancy), dims,
                       gold["max_steps"], t_max=torch.from_numpy(t_max))
    got = kc.march_checksums(rec.hit, rec.t, rec.voxel, rec.normal,
                             rec.steps, dims)
    want = gold["checksums"]
    for k in ("hits", "steps", "voxel_index_sum", "normal_sum"):
        assert got[k] == want[k], k
    assert abs(got["t_sum"] - want["t_sum"]) <= 1e-6 * abs(want["t_sum"])


def test_factory_builds_table_and_cpu_launches_nothing():
    grid = procgen.shell_sphere((16, 16, 16), device=CPU)
    occ_flat = grid.occupancy.reshape(-1)
    kernel_packed.reset_launch_counts()
    march = make_march_packed(occ_flat, (16, 16, 16), RenderSettings(),
                              accel=None)
    o = torch.full((4, 3), 8.0)
    d = torch.nn.functional.normalize(torch.ones((4, 3)), dim=1)
    rec = march(o, d)
    assert rec.hit.all()       # inside the sphere's hollow, facing its shell
    assert kernel_packed.LAUNCHES == {"march_packed_kernel": 0}
    acc = packed.build_packed(grid.occupancy)
    same = make_march_packed(occ_flat, (16, 16, 16), RenderSettings(),
                             accel=acc)(o, d)
    assert torch.equal(same.voxel, rec.voxel)


def test_march_packed_rejects_bad_inputs():
    acc = packed.build_packed(torch.zeros((8, 8, 8), dtype=torch.uint8))
    o, d = torch.zeros((4, 3)), torch.ones((4, 3))
    with pytest.raises(TypeError):
        march_packed(o.double(), d, acc, (8, 8, 8), 26)
    with pytest.raises(ValueError):
        march_packed(o, d, acc, (8, 8, 16), 26)
    with pytest.raises(ValueError):
        march_packed(o, d, acc, (8, 8, 7), 26)
    with pytest.raises(TypeError):
        march_packed(o, d, packed.PackedAccel(acc.words.to(torch.int16),
                                              acc.bricks), (8, 8, 8), 26)
