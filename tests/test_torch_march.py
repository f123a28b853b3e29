"""Parity: vxtpu_torch's march (on CPU tensors: its plain version, with the
kernel's per-ray semantics) against vxtpu's Pallas march kernel
(``march_pallas_v2``, interpret mode), on the same world and rays.

Contract as in tests/test_pallas_v2.py: hit agreement >= 0.998; t within
rtol 1e-4 / atol 1e-3 where both hit; voxel > 0.998; normal > 0.995;
and steps equal on >= 0.99 of the rays."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vxtpu.camera.camera import Camera as JCamera
from vxtpu.camera.rays import generate_rays as jgenerate_rays
from vxtpu.render.kernel_pallas_v2 import march_pallas_v2
from vxtpu.world import procgen as jprocgen
from vxtpu.world.packed import build_packed_morton as jbuild_packed_morton
from vxtpu_torch import convert
from vxtpu_torch.render import kernel_march
from vxtpu_torch.render.kernel_march import march

DIMS = (32, 32, 32)
MAX_STEPS = sum(DIMS) + 2
CPU = torch.device("cpu")


def jax_scenes():
    return {
        "box": jprocgen.solid_box(DIMS, (8, 8, 8), (24, 24, 20)),
        "sphere": jprocgen.shell_sphere(DIMS),
        "terrain": jprocgen.terrain(DIMS, seed=11),
    }


def jax_cameras():
    return {
        "outside": JCamera.make(pos=(-20.0, 16.0, 40.0)).look_at(
            (16.0, 16.0, 12.0)),
        "inside": JCamera.make(pos=(16.0, 16.0, 28.0), yaw=2.2, pitch=-0.5),
    }


@functools.cache
def _jax_march(image_shape):
    return jax.jit(functools.partial(
        march_pallas_v2, dims=DIMS, max_steps=MAX_STEPS,
        image_shape=image_shape, interpret=True))


def _both(scene, o, d, t_max=None, image_shape=None):
    """(vxtpu HitRecord as numpy dict, vxtpu_torch HitRecord)."""
    jacc = jbuild_packed_morton(jax_scenes()[scene].occupancy, cap=64)
    jrec = _jax_march(image_shape)(o, d, jacc, t_max=t_max)
    acc = convert.packed_morton_from_numpy(np.asarray(jacc.words), DIMS,
                                           device=CPU)
    tm = None if t_max is None else torch.tensor(np.asarray(t_max))
    rec = march(torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)),
                acc, DIMS, MAX_STEPS, t_max=tm)
    want = {k: np.asarray(getattr(jrec, k))
            for k in ("hit", "t", "voxel", "normal", "steps")}
    return want, rec


def _check(want, rec, min_agree=0.998):
    hit_r, hit_f = want["hit"], rec.hit.numpy()
    assert (hit_r == hit_f).mean() >= min_agree
    both = hit_r & hit_f
    np.testing.assert_allclose(rec.t.numpy()[both], want["t"][both],
                               rtol=1e-4, atol=1e-3)
    same_vox = (rec.voxel.numpy()[both] == want["voxel"][both]).all(axis=-1)
    assert same_vox.mean() > 0.998
    same_n = (np.abs(rec.normal.numpy()[both] - want["normal"][both])
              < 1e-6).all(axis=-1)
    assert same_n.mean() > 0.995
    steps_eq = (rec.steps.numpy() == want["steps"]).mean()
    assert steps_eq >= 0.99, steps_eq


@pytest.mark.parametrize("scene", ["box", "sphere", "terrain"])
@pytest.mark.parametrize("cam_name", ["outside", "inside"])
def test_march_matches_pallas_v2(scene, cam_name):
    o, d = jgenerate_rays(jax_cameras()[cam_name], 32, 32)
    want, rec = _both(scene, o, d, image_shape=(32, 32))
    assert rec.hit.any()
    _check(want, rec)
    # types and layouts of vxtpu's HitRecord
    assert rec.hit.dtype == torch.bool and rec.t.dtype == torch.float32
    assert rec.voxel.dtype == torch.int32 and rec.voxel.shape == (1024, 3)
    assert rec.steps.dtype == torch.int32
    assert rec.normal.shape == (1024, 3)
    assert (rec.t.numpy()[~rec.hit.numpy()] == np.float32(1e30)).all()
    assert (rec.normal.numpy()[~rec.hit.numpy()] == 0).all()


def test_march_tmax_shadow_semantics():
    """Rays capped at t_max = 40 stop there: fewer hits, same contract."""
    o, d = jgenerate_rays(jax_cameras()["outside"], 32, 32)
    tm = jnp.full((o.shape[0],), 40.0, jnp.float32)
    want, rec = _both("terrain", o, d, t_max=tm, image_shape=(32, 32))
    _check(want, rec)
    free, _ = _both("terrain", o, d, image_shape=(32, 32))
    assert 0 < want["hit"].sum() < free["hit"].sum()
    assert (rec.t.numpy()[rec.hit.numpy()] <= 40.0).all()


def test_march_ragged_ray_count():
    """N = 1000 is no multiple of vxtpu's 1024-ray tile (it pads; the port
    takes any N)."""
    o, d = jgenerate_rays(jax_cameras()["outside"], 25, 40)
    want, rec = _both("sphere", o, d)
    assert rec.hit.shape == (1000,)
    _check(want, rec)


def test_march_cpu_launches_no_kernel():
    kernel_march.reset_launch_counts()
    o, d = jgenerate_rays(jax_cameras()["outside"], 8, 8)
    _both("box", o, d)
    assert kernel_march.LAUNCHES == {"march_shade_kernel": 0,
                                     "shade_kernel": 0,
                                     "march_resume_kernel": 0}
    assert kernel_march.VARIANT_LAUNCHES == dict.fromkeys(
        kernel_march.K1_VARIANTS, 0)


def test_march_rejects_bad_inputs():
    acc = convert.packed_morton_from_numpy(
        np.asarray(jbuild_packed_morton(jax_scenes()["box"].occupancy).words),
        DIMS, device=CPU)
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    with pytest.raises(TypeError):
        march(o.double(), d, acc, DIMS, MAX_STEPS)
    with pytest.raises(ValueError):
        march(o[:, :2], d, acc, DIMS, MAX_STEPS)
    with pytest.raises(ValueError):
        march(o, d.t().contiguous().t(), acc, DIMS, MAX_STEPS)
    with pytest.raises(ValueError):
        march(o, d, acc, (32, 32, 16), MAX_STEPS)
    with pytest.raises(ValueError):
        march(o, d, acc, DIMS, MAX_STEPS, t_max=torch.zeros(3))


@pytest.mark.parametrize("spec, variant", [
    (None, "march"),
    (kernel_march.ShadeSpec(mode="flat"), "flat"),
    (kernel_march.ShadeSpec(mode="flat", shadows=True), "flat"),
    (kernel_march.ShadeSpec(mode="lambert"), "lambert"),
    (kernel_march.ShadeSpec(mode="lambert", rgb8=True, fog=True), "lambert"),
    (kernel_march.ShadeSpec(mode="lambert", shadows=True), "lambert_shadows"),
    (kernel_march.ShadeSpec(mode="lambert", shadows=True, n_lights=0),
     "lambert"),
    (kernel_march.ShadeSpec(mode="full", fog=True), "full"),
    (kernel_march.ShadeSpec(mode="full", shadows=True, fog=True,
                            n_lights=2), "full_shadows"),
])
def test_k1_variant_from_shade_spec(spec, variant):
    """The wrapper's choice of march_shade_kernel instantiation, and the
    shade parameters it passes beside it agree as the C entry demands
    (its mode, and shadows exactly for the shadow variants)."""
    v = kernel_march.k1_variant(spec)
    assert kernel_march.K1_VARIANTS[v] == variant
    if spec is None:
        return
    p = kernel_march._shade_params(spec)
    assert p.shadows == int(v >= 4)
    assert p.mode == (v - 3 if v >= 4 else v - 1)
