"""Parity: vxtpu_torch's fused frame (march + in-kernel shadows + shade;
on CPU tensors the kernels' plain versions) against vxtpu's fused Pallas
path (``render_rays_fused``, interpret mode), on the same world, rays and
lights.

Tolerance: |rgb difference| <= 2e-5 on >= 99.8% of pixels, and every
pixel outside it must be one where the two hit masks differ."""

import numpy as np
import pytest
import torch

from vxtpu.app.configs import CONFIGS as JCONFIGS
from vxtpu.app.run import _build_scene as jbuild_scene
from vxtpu.camera.camera import Camera as JCamera
from vxtpu.camera.rays import generate_rays as jgenerate_rays
from vxtpu.render.fused import render_frame_fused as jrender_frame_fused
from vxtpu.render.fused import render_rays_fused as jrender_rays_fused
from vxtpu.render.settings import MarchTuning
from vxtpu.render.settings import RenderSettings as JSettings
from vxtpu.world import packed as jpacked
from vxtpu.world import procgen as jprocgen
from vxtpu.world.lights import Lights as JLights
from vxtpu_torch import convert
from vxtpu_torch.app.configs import CONFIGS
from vxtpu_torch.app.run import render_config
from vxtpu_torch.render import kernel_march
from vxtpu_torch.render.fused import render_rays_fused
from vxtpu_torch.render.settings import RenderSettings

D = 32
DIMS = (D, D, D)
CPU = torch.device("cpu")

LIGHTS = {
    0: ([], [], []),
    1: ([(25.0, -10.0, 60.0)], [(1.0, 1.0, 1.0)], [2.0]),
    2: ([(25.0, -10.0, 60.0), (40.0, 48.0, 50.0)],
        [(1.0, 0.9, 0.8), (0.4, 0.5, 1.0)], [2.0, 1.2]),
}

CASES = {  # the cases of tests/test_fused_shade.py
    "flat": (dict(shading="flat"), 0),
    "lambert": (dict(shading="lambert"), 1),
    "full_fog": (dict(shading="full", fog=True), 2),
    "lambert_nolights": (dict(shading="lambert"), 0),
}


def _world(seed, with_rgb=False):
    jg = jprocgen.terrain(DIMS, seed=seed, with_rgb=with_rgb)
    jacc = jpacked.build_packed_morton(jg.occupancy, cap=64)
    jmats = (jpacked.build_rgb8_morton(jg) if with_rgb
             else jpacked.build_material_morton(jg.occupancy))
    acc = convert.packed_morton_from_numpy(np.asarray(jacc.words), DIMS,
                                           device=CPU)
    conv = (convert.rgb8_morton_from_numpy if with_rgb
            else convert.material_morton_from_numpy)
    return jacc, jmats, acc, conv(np.asarray(jmats), DIMS, device=CPU)


def _lights(spec):
    pos, rgb, inten = spec
    return (JLights.make(pos, rgb, inten) if pos else JLights.none(),
            convert.lights_from_numpy(pos, rgb, inten, device=CPU))


def _check_image(got, want, hit_got, hit_want, atol=2e-5):
    got = got.numpy().reshape(-1, 3)
    want = np.asarray(want).reshape(-1, 3)
    hit_diff = hit_got.numpy().reshape(-1) != np.asarray(hit_want).reshape(-1)
    bad = (np.abs(got - want) > atol).any(axis=-1)
    print(f"{int(bad.sum())} of {bad.size} pixels outside atol {atol}; "
          f"hit masks differ on {int(hit_diff.sum())}")
    assert bad.mean() <= 0.002
    assert not (bad & ~hit_diff).any()


def _run_both(seed, jcam, h, w, light_spec, settings_kw, rgb8=False,
              inkernel_shadows=True):
    jacc, jmats, acc, mats = _world(seed, with_rgb=rgb8)
    jlights, lights = _lights(light_spec)
    o, d = jgenerate_rays(jcam, h, w)
    want, jrec = jrender_rays_fused(
        o, d, jacc, jmats, DIMS, jlights,
        JSettings(tuning=MarchTuning(window=64), **settings_kw),
        image_shape=(h, w), inkernel_shadows=inkernel_shadows, rgb8=rgb8,
        interpret=True)
    got, rec = render_rays_fused(
        torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)), acc, mats,
        DIMS, lights, RenderSettings(**settings_kw),
        inkernel_shadows=inkernel_shadows, rgb8=rgb8)
    assert got.shape == (h * w, 3) and got.dtype == torch.float32
    return got, want, rec.hit, jrec.hit


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_matches_vxtpu(case):
    settings_kw, n_lights = CASES[case]
    jcam = JCamera.make(pos=(-20.0, 16.0, 40.0)).look_at((16.0, 16.0, 12.0))
    got, want, hit, jhit = _run_both(11, jcam, 32, 32, LIGHTS[n_lights],
                                     settings_kw)
    assert hit.any() and not hit.all()
    _check_image(got, want, hit, jhit)


SHADOW_SCENE = dict(
    seed=3, h=32, w=64,
    light_spec=([(5.0, -10.0, 45.0), (40.0, 30.0, 50.0)],
                [(1.0, 0.9, 0.8), (0.4, 0.5, 1.0)], [2.0, 1.0]),
    settings_kw=dict(shading="full", shadows=True, fog=True))


def _shadow_cam():
    return JCamera.make(pos=(-20.0, 16.0, 36.0),
                        fov_y_deg=55.0).look_at((16.0, 16.0, 8.0))


@pytest.mark.parametrize("inkernel", [True, False])
def test_fused_shadows_matches_vxtpu(inkernel):
    """Full + shadows + fog with two lights, in both compositions: shadow
    marches inside the march kernel, or march -> shadow marches -> shade
    kernel."""
    got, want, hit, jhit = _run_both(jcam=_shadow_cam(),
                                     inkernel_shadows=inkernel,
                                     **SHADOW_SCENE)
    _check_image(got, want, hit, jhit)


def test_inkernel_shadows_equal_composed():
    _, jmats, acc, mats = _world(3)
    _, lights = _lights(SHADOW_SCENE["light_spec"])
    o, d = jgenerate_rays(_shadow_cam(), 32, 64)
    o, d = torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d))
    settings = RenderSettings(**SHADOW_SCENE["settings_kw"])
    a, _ = render_rays_fused(o, d, acc, mats, DIMS, lights, settings,
                             inkernel_shadows=True)
    b, _ = render_rays_fused(o, d, acc, mats, DIMS, lights, settings,
                             inkernel_shadows=False)
    assert torch.equal(a, b)
    # shadows darken some lit pixels
    c, _ = render_rays_fused(o, d, acc, mats, DIMS, lights,
                             RenderSettings(shading="full", fog=True))
    assert (a < c - 1e-3).any(dim=-1).sum() > 0


def test_fused_rgb8_matches_vxtpu():
    jcam = _shadow_cam()
    got, want, hit, jhit = _run_both(3, jcam, 32, 64, LIGHTS[1],
                                     dict(shading="lambert"), rgb8=True)
    _check_image(got, want, hit, jhit)


def test_render_path_end_to_end_matches_vxtpu():
    """The slice end to end: world, tables, camera, light and fused frame
    through each package's render command path, config c5 (full +
    shadows + fog, per-voxel RGB) cut to 32^3 and 32x64."""
    kernel_march.reset_launch_counts()
    img = render_config(CONFIGS["c5_1080p_pod"], DIMS, 32, 64,
                        torch.device("cpu"))
    assert img.shape == (32, 64, 3)
    assert torch.isfinite(img).all()
    # no kernel launches on CPU tensors
    assert kernel_march.LAUNCHES == {"march_shade_kernel": 0,
                                     "shade_kernel": 0,
                                     "march_resume_kernel": 0}

    jcfg = JCONFIGS["c5_1080p_pod"]
    jg, _, jcam, jlights = jbuild_scene(jcfg, DIMS, "none")
    want = jrender_frame_fused(
        jpacked.build_packed_morton(jg.occupancy, cap=64),
        jpacked.build_rgb8_morton(jg), DIMS, jcam, jlights, jcfg.settings,
        32, 64, rgb8=True, interpret=True)
    diff = np.abs(img.numpy() - np.asarray(want)).max(axis=-1)
    print(f"end to end: {int((diff > 2e-5).sum())} of {diff.size} pixels "
          f"outside atol 2e-5, max diff {diff.max():.3g}")
    assert (diff > 2e-5).mean() <= 0.002
