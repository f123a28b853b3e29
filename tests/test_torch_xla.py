"""Parity: vxtpu_torch's batched march (render/kernel_xla.py), its
distance field, occupancy pyramid and DDA primitives, against vxtpu's on
the same numpy inputs.

Tolerances: table builders and lookups equal; the DDA primitives equal,
t within 1e-6; the marches at tests/test_distfield.py's limits (hit
agreement > 0.998, t within rtol 1e-4 / atol 1e-3 where both hit, voxel
> 0.998, normal > 0.995) and steps equal on >= 0.998 of the rays; a
``--kernel xla`` frame within 1/255 on >= 99.5% of its pixels."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vxtpu.camera.camera import Camera as JCamera
from vxtpu.camera.rays import generate_rays as jgenerate_rays
from vxtpu.render import dda as jdda
from vxtpu.render import kernel_xla as jxla
from vxtpu.render.pipeline import render_image as jrender_image
from vxtpu.render.settings import RenderSettings as JSettings
from vxtpu.world import distfield as jdistfield
from vxtpu.world import procgen as jprocgen
from vxtpu.world import pyramid as jpyramid
from vxtpu.world.lights import Lights as JLights
from vxtpu_torch import convert
from vxtpu_torch.render import dda, kernel_xla
from vxtpu_torch.render.pipeline import render_image
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.world import distfield, pyramid
from vxtpu_torch.world.grid import VoxelGrid

CPU = torch.device("cpu")
DIMS = (32, 32, 32)
MAX_STEPS = sum(DIMS) + 2


def t(x):
    return torch.tensor(np.asarray(x))


@functools.cache
def jax_scene(name):
    """tests/test_distfield.py's scenes, made by vxtpu once each."""
    return {"box": lambda: jprocgen.solid_box(DIMS, (8, 8, 8), (24, 24, 20)),
            "sphere": lambda: jprocgen.shell_sphere(DIMS),
            "terrain": lambda: jprocgen.terrain(DIMS, seed=11)}[name]()


def jax_camera(name):
    if name == "outside":
        return JCamera.make(pos=(-20.0, 16.0, 40.0)).look_at(
            (16.0, 16.0, 12.0))
    return JCamera.make(pos=(16.0, 16.0, 28.0), yaw=2.2, pitch=-0.5)


def random_rays(n, seed, dims=DIMS):
    """Origins in and around the grid, unit directions with some zero and
    some tiny components (axis-aligned and degenerate axes)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8.0, np.asarray(dims) + 8.0, size=(n, 3))
    d = rng.normal(size=(n, 3))
    d[: n // 8, 1:] = 0.0
    d[n // 8: n // 4, 0] = 0.0
    d[n // 4: n // 4 + 4, 2] = 1e-13
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("scene", ["box", "sphere", "terrain"])
def test_distance_field_build_and_fetch(scene):
    occ = np.asarray(jax_scene(scene).occupancy)
    want = jdistfield.build(jnp.asarray(occ), cap=12)
    got = distfield.build(t(occ), cap=12)
    assert isinstance(got, distfield.DistanceField)
    assert got.dims == DIMS and got.field.dtype == torch.uint8
    np.testing.assert_array_equal(got.field.numpy(), np.asarray(want.field))
    v = np.random.default_rng(1).integers(-3, 35, size=(4096, 3)).astype(
        np.int32)
    np.testing.assert_array_equal(
        distfield.distfield_fetch(got.field.reshape(-1), t(v), DIMS).numpy(),
        np.asarray(jdistfield.distfield_fetch(want.field.reshape(-1),
                                              jnp.asarray(v), DIMS)))


@pytest.mark.parametrize("dims,levels", [((32, 32, 32), 2), ((13, 9, 7), 3),
                                         ((5, 16, 11), 4)])
def test_pyramid_build_and_lookup(dims, levels):
    """Odd sizes pad with empty cells; out-of-bounds lookups read False."""
    rng = np.random.default_rng(sum(dims))
    occ = (rng.random(dims) < 0.04).astype(np.uint8) * 3
    want = jpyramid.build_pyramid(jnp.asarray(occ), levels)
    got = pyramid.build_pyramid(t(occ), levels)
    assert got.num_levels == levels and got.cell_size(1) == 4
    v = rng.integers(-5, max(dims) + 5, size=(4096, 3)).astype(np.int32)
    for li in range(levels):
        np.testing.assert_array_equal(got.levels[li].numpy(),
                                      np.asarray(want.levels[li]))
        np.testing.assert_array_equal(
            pyramid.pyramid_lookup(got, li, t(v)).numpy(),
            np.asarray(jpyramid.pyramid_lookup(want, li, jnp.asarray(v))))


def test_dda_primitives_match_vxtpu():
    o, d = random_rays(2048, 2)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    te, _, _ = jdda.ray_grid_clip(jo, jd, DIMS)
    ts = np.asarray(te) + np.random.default_rng(3).uniform(
        0.0, 20.0, size=te.shape).astype(np.float32)
    want = jdda.dda_init(jo, jd, jnp.asarray(ts), DIMS)
    got = dda.dda_init(t(o), t(d), t(ts), DIMS)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    # ties included: whole-number t_next
    tn = np.random.default_rng(4).integers(0, 3, size=(512, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(dda.dda_step_mask(t(tn)).numpy(),
                                  np.asarray(jdda.dda_step_mask(
                                      jnp.asarray(tn))))
    v, tnext, tdelta, step = got
    jv, jtnext, jtdelta, jstep = want
    adv = dda.dda_advance(v, tnext, tdelta, step)
    jadv = jdda.dda_advance(jv, jtnext, jtdelta, jstep)
    for a, b in zip(adv, jadv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    mask = dda.entry_face_mask(t(o), t(d), DIMS)
    jmask = jdda.entry_face_mask(jo, jd, DIMS)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(dda.face_normal(mask, step).numpy(),
                                  np.asarray(jdda.face_normal(jmask, jstep)))


def _compare_records(got, want, steps_frac=0.998):
    hit, jhit = got.hit.numpy(), np.asarray(want.hit)
    assert (hit == jhit).mean() > 0.998
    both = hit & jhit
    np.testing.assert_allclose(got.t.numpy()[both], np.asarray(want.t)[both],
                               rtol=1e-4, atol=1e-3)
    assert (got.voxel.numpy()[both]
            == np.asarray(want.voxel)[both]).all(axis=-1).mean() > 0.998
    assert (np.abs(got.normal.numpy()[both] - np.asarray(want.normal)[both])
            < 1e-6).all(axis=-1).mean() > 0.995
    assert (got.steps.numpy() == np.asarray(want.steps)).mean() >= steps_frac


@pytest.mark.parametrize("accel", ["distfield", "pyramid", "none"])
@pytest.mark.parametrize("cam", ["outside", "inside"])
@pytest.mark.parametrize("scene", ["box", "sphere", "terrain"])
def test_march_matches_vxtpu(scene, cam, accel):
    jg = jax_scene(scene)
    o, d = (np.asarray(x) for x in jgenerate_rays(jax_camera(cam), 48, 48))
    occ = np.asarray(jg.occupancy)
    if accel == "distfield":
        want = jxla.march_xla_df(
            jnp.asarray(o), jnp.asarray(d),
            jdistfield.build(jg.occupancy, cap=12).field.reshape(-1), DIMS,
            MAX_STEPS)
        got = kernel_xla.march_xla_df(
            t(o), t(d), distfield.build(t(occ), cap=12).field.reshape(-1),
            DIMS, MAX_STEPS)
    else:
        lv = 2 if accel == "pyramid" else 0
        want = jxla.march_xla(
            jnp.asarray(o), jnp.asarray(d), jg.occupancy.reshape(-1), DIMS,
            MAX_STEPS, jpyramid.build_pyramid(jg.occupancy, lv) if lv
            else None)
        got = kernel_xla.march_xla(
            t(o), t(d), t(occ).reshape(-1), DIMS, MAX_STEPS,
            pyramid.build_pyramid(t(occ), lv) if lv else None)
    _compare_records(got, want)


def test_march_t_max_and_random_rays():
    """Rays from anywhere, axis-aligned ones included, capped at t_max
    (the shadow-ray contract), through both accelerations."""
    jg = jax_scene("terrain")
    occ = np.asarray(jg.occupancy)
    o, d = random_rays(2048, 5)
    tm = np.random.default_rng(6).uniform(0.0, 40.0, 2048).astype(np.float32)
    jdf = jdistfield.build(jg.occupancy, cap=12).field.reshape(-1)
    tdf = distfield.build(t(occ), cap=12).field.reshape(-1)
    _compare_records(
        kernel_xla.march_xla_df(t(o), t(d), tdf, DIMS, MAX_STEPS, 8, t(tm)),
        jxla.march_xla_df(jnp.asarray(o), jnp.asarray(d), jdf, DIMS,
                          MAX_STEPS, 8, jnp.asarray(tm)))
    _compare_records(
        kernel_xla.march_xla(t(o), t(d), t(occ).reshape(-1), DIMS, MAX_STEPS,
                             pyramid.build_pyramid(t(occ), 3), 8, t(tm)),
        jxla.march_xla(jnp.asarray(o), jnp.asarray(d),
                       jg.occupancy.reshape(-1), DIMS, MAX_STEPS,
                       jpyramid.build_pyramid(jg.occupancy, 3), 8,
                       jnp.asarray(tm)))


def test_march_stops_after_its_chunks():
    """A budget of max_steps runs ceil(max_steps / step_chunk) chunks, so
    rays still live then stay unfinished, as in vxtpu."""
    o, d = (np.asarray(x) for x in jgenerate_rays(jax_camera("outside"), 16,
                                                  16))
    occ = np.zeros(DIMS, np.uint8)
    rec = kernel_xla.march_xla(t(o), t(d), t(occ).reshape(-1), DIMS, 5,
                               step_chunk=2)
    want = jxla.march_xla(jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(occ).reshape(-1), DIMS, 5,
                          step_chunk=2)
    assert int(rec.steps.max()) == 6 and not rec.hit.any()
    np.testing.assert_array_equal(rec.steps.numpy(), np.asarray(want.steps))


def test_make_march_xla_dispatch():
    occ = t(np.asarray(jax_scene("box").occupancy))
    flat = occ.reshape(-1)
    df = distfield.build(occ, cap=12)
    pyr = pyramid.build_pyramid(occ, 2)
    s2 = RenderSettings(pyramid_levels=2, step_chunk=8, max_steps=40)
    m = kernel_xla.make_march_xla(flat, DIMS, s2, df)
    assert m.func is kernel_xla.march_xla_df and m.keywords["step_chunk"] == 8
    assert m.keywords["max_steps"] == 40
    m = kernel_xla.make_march_xla(flat, DIMS, s2, pyr)
    assert m.func is kernel_xla.march_xla and m.keywords["pyramid"] is pyr
    m = kernel_xla.make_march_xla(flat, DIMS, RenderSettings(), pyr)
    assert m.keywords["pyramid"] is None and m.keywords["max_steps"] == 98
    m = kernel_xla.make_march_xla(flat, DIMS, s2, None)
    assert m.func is kernel_xla.march_xla and m.keywords["pyramid"] is None


@functools.cache
def jax_rgb_terrain():
    return jprocgen.terrain(DIMS, seed=3, with_rgb=True)


@pytest.mark.parametrize("accel", ["distfield", "pyramid"])
def test_render_image_xla_matches_vxtpu(accel):
    """c3 cut to 32^3 (terrain seed 3, per-voxel RGB, full + shadows +
    fog, 2 pyramid levels), 32 x 48, through each package's XLA march."""
    jg = jax_rgb_terrain()
    g = VoxelGrid(occupancy=t(jg.occupancy), rgb=t(jg.rgb))
    jc = JCamera.make(pos=(-22.4, 16.0, 35.2), fov_y_deg=55.0).look_at(
        (16.0, 16.0, 8.64))
    tc = convert.camera_from_numpy(np.asarray(jc.pos), jc.yaw, jc.pitch,
                                   jc.fov_y, device=CPU)
    jl = JLights.single((6.4, -9.6, 44.8), intensity=2.0)
    tl = convert.lights_from_numpy(np.asarray(jl.pos), np.asarray(jl.rgb),
                                   np.asarray(jl.intensity), device=CPU)
    kw = dict(shading="full", shadows=True, fog=True, pyramid_levels=2)
    if accel == "distfield":
        ja, ta = jdistfield.build(jg.occupancy), distfield.build(g.occupancy)
    else:
        ja = jpyramid.build_pyramid(jg.occupancy, 2)
        ta = pyramid.build_pyramid(g.occupancy, 2)
    want = np.asarray(jrender_image(jxla.make_march_xla, jg, jc, jl,
                                    JSettings(**kw), 32, 48, ja))
    got = render_image(kernel_xla.make_march_xla, g, tc, tl,
                       RenderSettings(**kw), 32, 48, ta)
    assert got.shape == (32, 48, 3) and torch.isfinite(got).all()
    close = (np.abs(got.numpy() - want) <= 1.0 / 255).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
