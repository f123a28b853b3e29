"""Parity: vxtpu_torch's occupancy mask (render/occmask.py), the bounds
pass (engine/sharding.py) and the masked fit (train/loop.py) against
vxtpu's, and the masked model's own checks on the port alone.

Tolerances: masks equal byte for byte (the wrap of ``jnp.roll`` at the
borders included, and the Morton table's mask equal to the planar
grid's); band bounds within 1e-4 where both packages find a band, and the
same empty bands (kernel_check.BOUNDS_CASES' edge cases too, which on
the CPU run the batched path and never load the CUDA library); a masked
four-step fit's losses within rel 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vxtpu.camera.camera import Camera as JCamera
from vxtpu.camera.rays import generate_rays as jgenerate_rays
from vxtpu.engine import sharding as jsharding
from vxtpu.render import occmask as jocc
from vxtpu.render import soft as jsoft
from vxtpu.render.settings import RenderSettings as JSettings
from vxtpu.train import loop as jloop
from vxtpu.world import procgen as jprocgen
from vxtpu_torch import _build, convert
from vxtpu_torch import kernel_check as kc
from vxtpu_torch.engine import sharding
from vxtpu_torch.render import dda, kernel_bounds, occmask, soft
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.render.soft_kernel import MortonSoftGrid
from vxtpu_torch.train import loop

CPU = torch.device("cpu")
DIMS = (32, 32, 32)
G = 4


def t(x):
    return torch.tensor(np.asarray(x))


@functools.cache
def scene():
    """tests/test_occmask.py's scene: 32^3 terrain seed 7 -> from_hard
    (sigma 25), 24 x 24 rays."""
    jg = jprocgen.terrain(DIMS, seed=7, with_rgb=True)
    js = jsoft.SoftGrid.from_hard(jg, sigma_solid=25.0)
    jc = JCamera.make(pos=(-22.0, 16.0, 36.0)).look_at((16.0, 16.0, 9.0))
    o, d = jgenerate_rays(jc, 24, 24)
    ts = soft.SoftGrid(t(js.sigma_raw), t(js.rgb_raw))
    return js, ts, jc, np.asarray(o), np.asarray(d)


def _border_soft(seed=0):
    """Random densities with occupied cells on every border, so that the
    dilation wraps around."""
    rng = np.random.default_rng(seed)
    sig = np.full(DIMS, -6.0, np.float32)
    pts = rng.integers(0, 32, size=(60, 3))
    pts[:6] = [[0, 5, 9], [31, 7, 2], [4, 0, 30], [9, 31, 3], [1, 2, 0],
               [30, 29, 31]]
    sig[tuple(pts.T)] = rng.uniform(-4.7, 3.0, 60)   # around tau's edge
    return sig, rng.normal(size=(3,) + DIMS).astype(np.float32)


@pytest.mark.parametrize("dilate", [0, 1, 2])
@pytest.mark.parametrize("case", ["terrain", "borders"])
def test_occupancy_mask_byte_equal(case, dilate):
    if case == "terrain":
        js, ts = scene()[:2]
        sig, rgb = np.asarray(js.sigma_raw), np.asarray(js.rgb_raw)
    else:
        sig, rgb = _border_soft()
        js = jsoft.SoftGrid(jnp.asarray(sig), jnp.asarray(rgb))
        ts = soft.SoftGrid(t(sig), t(rgb))
    want = np.asarray(jocc.occupancy_mask_from_soft(js, G, 0.01, dilate))
    got = occmask.occupancy_mask_from_soft(ts, G, 0.01, dilate)
    assert got.dtype == torch.uint8 and got.shape == (8, 8, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    # the field-kernel model's mask, read from its Morton table
    got_m = occmask.occupancy_mask_from_soft(MortonSoftGrid.from_soft(ts), G,
                                             0.01, dilate)
    np.testing.assert_array_equal(got_m.numpy(), want)


def test_mask_all_ones_mask_at_and_distance_field():
    js, ts = scene()[:2]
    np.testing.assert_array_equal(
        occmask.mask_all_ones(DIMS, G, CPU).numpy(),
        np.asarray(jocc.mask_all_ones(DIMS, G)))
    m = np.asarray(jocc.occupancy_mask_from_soft(js, G, 0.01, 1))
    p = np.random.default_rng(2).uniform(-6.0, 38.0, size=(4096, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        occmask.mask_at(t(m), G, t(p)).numpy(),
        np.asarray(jocc.mask_at(jnp.asarray(m), G, jnp.asarray(p))))
    assert occmask.mask_at is soft.mask_at
    np.testing.assert_array_equal(
        occmask.mask_distance_field(t(m)).numpy(),
        np.asarray(jocc.mask_distance_field(jnp.asarray(m))))


def _compare_bounds(got, want):
    t0, t1 = (x.numpy() for x in got)
    w0, w1 = (np.asarray(x) for x in want)
    empty, wempty = t0 == t1, w0 == w1
    assert (empty == wempty).all()
    band = ~empty
    np.testing.assert_allclose(t0[band], w0[band], atol=1e-4, rtol=0)
    np.testing.assert_allclose(t1[band], w1[band], atol=1e-4, rtol=0)
    return band.mean()


@pytest.mark.parametrize("dilate", [0, 1])
def test_mask_segment_bounds_match_vxtpu(dilate):
    js, ts, _, o, d = scene()
    m = np.asarray(jocc.occupancy_mask_from_soft(js, G, 0.01, dilate))
    want = jocc.mask_segment_bounds(jnp.asarray(m), G, jnp.asarray(o),
                                    jnp.asarray(d))
    got = occmask.mask_segment_bounds(t(m), G, t(o), t(d))
    assert 0.2 < _compare_bounds(got, want) < 1.0


@pytest.mark.parametrize("name", kc.BOUNDS_CASES)
def test_bounds_cases_match_vxtpu(name, monkeypatch):
    """kernel_check.BOUNDS_CASES at 32^3 (30^3 at G = 3; 576 rays): the port's bounds pass
    on CPU tensors, the batched path, against vxtpu's within 1e-4 and the
    same empty bands, with the bands the case expects; it never loads the
    CUDA library nor counts a kernel launch."""
    def no_library():
        raise AssertionError("the CPU bounds pass loaded the CUDA library")

    monkeypatch.setattr(_build, "load", no_library)
    kernel_bounds.reset_launch_counts()
    mask, G, df, o, d = kc.bounds_inputs(name, CPU, D=32, n=576)
    got = occmask.mask_segment_bounds(mask, G, o, d, df_flat=df)
    assert kernel_bounds.LAUNCHES["mask_bounds_kernel"] == 0
    want = jocc.mask_segment_bounds(jnp.asarray(mask.numpy()), G,
                                    jnp.asarray(o.numpy()),
                                    jnp.asarray(d.numpy()))
    band = _compare_bounds(got, want)
    mkind, rkind, _ = name.split("-")
    assert (band > 0) == (mkind != "empty" and rkind != "miss")


def test_compute_mask_bounds_matches_vxtpu():
    js, ts, jc, _, _ = scene()
    m = np.asarray(jocc.occupancy_mask_from_soft(js, G, 0.01, 1))
    jo, jd = jsharding.camera_frame_rays(jc, 24, 24)
    cam = convert.camera_from_numpy(np.asarray(jc.pos), jc.yaw, jc.pitch,
                                    jc.fov_y, device=CPU)
    o_c, d_c = sharding.camera_frame_rays(cam, 24, 24)
    np.testing.assert_allclose(d_c.numpy(), np.asarray(jd), atol=1e-6)
    assert not o_c.any()
    want = jsharding.compute_mask_bounds(
        jnp.asarray(m), jocc.mask_distance_field(jnp.asarray(m)), jc, jo, jd)
    got = sharding.compute_mask_bounds(
        t(m), occmask.mask_distance_field(t(m)), cam, o_c, d_c)
    _compare_bounds(got, want)


def _full_segment_samples(o, d, S=256):
    te, tx, valid = dda.ray_grid_clip(o, d, DIMS)
    ts = te[:, None] + (tx - te)[:, None] * (
        (torch.arange(S) + 0.5) / S)[None, :]
    return ts, valid


def test_bounds_are_conservative():
    """Every mask-occupied sample of the full segment lies in [t0, t1]
    (tests/test_occmask.py's check, on the port alone)."""
    _, ts, _, o, d = scene()
    m = occmask.occupancy_mask_from_soft(ts, G, tau=0.01, dilate=1)
    o, d = t(o), t(d)
    t0, t1 = occmask.mask_segment_bounds(m, G, o, d)
    tt, valid = _full_segment_samples(o, d)
    p = o[:, None, :] + tt[..., None] * d[:, None, :]
    occ = occmask.mask_at(m, G, p) > 0
    inside = (tt >= t0[:, None] - 1e-3) & (tt <= t1[:, None] + 1e-3)
    assert int((occ & ~inside & valid[:, None]).sum()) == 0
    assert bool((t1 >= t0).all())


def test_bounded_few_samples_match_full_many_samples():
    """S = 64 inside [t0, t1] against S = 256 over the whole segment, both
    masked: mean |d rgb| < 0.015 (the speed-up's quadrature claim)."""
    _, ts, _, o, d = scene()
    o, d = t(o), t(d)
    m = occmask.occupancy_mask_from_soft(ts, G, tau=0.01, dilate=1)
    bounds = occmask.mask_segment_bounds(m, G, o, d)
    full, _ = soft.render_soft_rays(ts, o, d, RenderSettings(), 256, mask=m,
                                    mask_scale=G)
    few, _ = soft.render_soft_rays(ts, o, d, RenderSettings(), 64, mask=m,
                                   mask_scale=G, seg_bounds=bounds)
    assert float((full - few).abs().mean()) < 0.015


MASKED_FIT = dict(steps=4, num_samples=8, seed=7, occ_mask=True,
                  mask_refresh=2, tv_sigma=0.0, tv_rgb=0.0)


@functools.cache
def vxtpu_masked_fit():
    """vxtpu's masked fit at 16^3: c4's scene (terrain seed 7 -> from_hard,
    one 16 x 16 target at S = 8), four full-image steps from zeros, the
    mask rebuilt before step 2; (camera, target, losses)."""
    D = 16
    dims = (D,) * 3
    settings = JSettings()
    truth = jsoft.SoftGrid.from_hard(jprocgen.terrain(dims, seed=7,
                                                      with_rgb=True))
    jc = JCamera.make(pos=(-0.7 * D, 0.5 * D, 1.1 * D)).look_at(
        (0.5 * D, 0.5 * D, 0.27 * D))
    target = jsoft.render_soft_image(truth, jc, settings, 16, 16, 8)
    jax.clear_caches()
    _, _, losses, _ = jloop.fit_soft(jsoft.SoftGrid.zeros(dims), jc, target,
                                     settings,
                                     jloop.TrainConfig(**MASKED_FIT))
    return jc, np.asarray(target), losses


@pytest.mark.parametrize("field_kernel", [False, True])
def test_masked_fit_matches_vxtpu(field_kernel):
    """The port's masked fit, through its plain soft renderer or its
    sampling path (the kernels' plain versions here), against vxtpu's
    masked fit through its XLA renderer: both minimise the same masked
    loss with the TV terms off (the Morton TV prior is held against
    vxtpu in test_torch_layout.py). vxtpu's own field-kernel masked fit
    is not the reference here: in a process that has run other jitted
    programs it can pick up a stale compiled program for its bounds pass
    ("Execution supplied 4 buffers but compiled program expected 16")."""
    jc, target, want = vxtpu_masked_fit()
    cam = convert.camera_from_numpy(jc.pos, jc.yaw, jc.pitch, jc.fov_y,
                                    device=CPU)
    _, _, got, _ = loop.fit_soft(
        soft.SoftGrid.zeros((16, 16, 16), device=CPU), cam, t(target),
        RenderSettings(),
        loop.TrainConfig(field_kernel=field_kernel, **MASKED_FIT))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
