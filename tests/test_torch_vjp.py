"""Parity: vxtpu_torch's custom-backward soft render (render/vjp.py)
against vxtpu's ``render_soft_rays_fast`` and against ``jax.grad`` of
vxtpu's ``render_soft_rays``, on the same inputs made by numpy from a
seed.

Tolerances: the forward within rtol 1e-5 / atol 1e-6; the sigma, rgb, o,
d (and lights') gradients within rtol 2e-4 / atol 2e-5 x max|g| (vxtpu's
own custom-VJP-against-autodiff tolerance, tests/test_vjp.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vxtpu.camera.camera import Camera as JCamera
from vxtpu.camera.rays import generate_rays as jgenerate_rays
from vxtpu.render import soft as jsoft
from vxtpu.render import vjp as jvjp
from vxtpu.render.settings import RenderSettings as JSettings
from vxtpu.train import loop as jloop
from vxtpu.world import procgen as jprocgen
from vxtpu.world.lights import Lights as JLights
from vxtpu_torch import convert
from vxtpu_torch.render import soft, vjp
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.train import loop

CPU = torch.device("cpu")
DIMS = (12, 12, 12)
S = 24
H, W = 9, 7
LIGHT = ((2.0, -4.0, 20.0), (1.0, 0.9, 0.8), 2.0)


def _inputs(seed=3):
    """A 12^3 shell sphere with noisy densities and its rays, as numpy."""
    rng = np.random.default_rng(seed)
    base = jsoft.SoftGrid.from_hard(jprocgen.shell_sphere(DIMS),
                                    sigma_solid=12.0)
    sig = (np.asarray(base.sigma_raw)
           + 0.3 * rng.normal(size=DIMS)).astype(np.float32)
    rgb = (np.asarray(base.rgb_raw)
           + 0.2 * rng.normal(size=(3,) + DIMS)).astype(np.float32)
    jcam = JCamera.make(pos=(-9.0, 6.0, 7.0)).look_at((6.0, 6.0, 6.0))
    o, d = jgenerate_rays(jcam, H, W)
    tgt = rng.uniform(size=(H * W, 3)).astype(np.float32)
    return sig, rgb, np.asarray(o), np.asarray(d), tgt


def _settings(shading):
    return (JSettings(shading=shading), RenderSettings(shading=shading))


def _jlights(lit):
    return JLights.single(*LIGHT) if lit else None


def _tlights(lit):
    if not lit:
        return None
    from vxtpu_torch.world.lights import Lights

    return Lights.single(*LIGHT, device=CPU)


def _bounds(o, d):
    """Per-ray (t0, t1) inside the grid clip, from numpy: a band."""
    from vxtpu.render import dda as jdda

    te, tx, _ = jdda.ray_grid_clip(jnp.asarray(o), jnp.asarray(d), DIMS)
    te, tx = np.asarray(te), np.asarray(tx)
    return ((te + 0.25 * (tx - te)).astype(np.float32),
            (te + 0.8 * (tx - te)).astype(np.float32))


def _mask():
    m = np.ones((3, 3, 3), np.uint8)
    m[1, 1, 1] = 0
    m[0, 2, 0] = 0
    return m


CASES = {
    # name: (shading, lit, masked with bounds)
    "unlit": ("flat", False, False),
    "lit_full": ("full", True, False),
    "masked_bounds": ("flat", False, True),
}


def _jax_run(case, fn):
    shading, lit, masked = CASES[case]
    sig, rgb, o, d, tgt = _inputs()
    jst, _ = _settings(shading)
    jl = _jlights(lit)
    kw = {}
    if masked:
        kw = dict(mask=jnp.asarray(_mask()), mask_scale=4,
                  seg_bounds=tuple(map(jnp.asarray, _bounds(o, d))))

    def loss(sr, rr, o_, d_, lp, lc, li):
        lights = JLights(pos=lp, rgb=lc, intensity=li) if lit else None
        s = jsoft.SoftGrid(sigma_raw=sr, rgb_raw=rr)
        if fn == "fast":
            pred = jvjp.render_soft_rays_fast(s, o_, d_, jst, S, lights,
                                              **kw)
        else:
            pred, _ = jsoft.render_soft_rays(s, o_, d_, jst, S, lights,
                                             **kw)
        return jnp.mean((pred - jnp.asarray(tgt)) ** 2), pred

    lt = (jl.pos, jl.rgb, jl.intensity) if lit else (
        jnp.zeros((1, 3)), jnp.zeros((1, 3)), jnp.zeros((1,)))
    (lv, pred), g = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(7)), has_aux=True))(
        jnp.asarray(sig), jnp.asarray(rgb), jnp.asarray(o), jnp.asarray(d),
        *lt)
    return float(lv), np.asarray(pred), [np.asarray(x) for x in g]


def _torch_run(case):
    shading, lit, masked = CASES[case]
    sig, rgb, o, d, tgt = _inputs()
    _, st = _settings(shading)
    leaves = [torch.tensor(x, requires_grad=True) for x in (sig, rgb, o, d)]
    lights = _tlights(lit)
    if lit:
        lights = type(lights)(*(x.clone().requires_grad_(True)
                                for x in (lights.pos, lights.rgb,
                                          lights.intensity)))
    kw = {}
    if masked:
        kw = dict(mask=torch.tensor(_mask()), mask_scale=4,
                  seg_bounds=tuple(map(torch.tensor, _bounds(o, d))))
    pred = vjp.render_soft_rays_fast(soft.SoftGrid(leaves[0], leaves[1]),
                                     leaves[2], leaves[3], st, S, lights,
                                     **kw)
    lv = torch.mean((pred - torch.tensor(tgt)) ** 2)
    lv.backward()
    grads = [x.grad.numpy() for x in leaves]
    if lit:
        grads += [x.grad.numpy() for x in (lights.pos, lights.rgb,
                                           lights.intensity)]
    return float(lv.detach()), pred.detach().numpy(), grads


NAMES = ("sigma", "rgb", "origins", "dirs", "light pos", "light rgb",
         "light intensity")


def _close(got, want, name):
    scale = max(float(np.max(np.abs(want))), 1e-8)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5 * scale,
                               err_msg=f"grad mismatch: {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_fast_render_matches_vxtpu_fast_and_autodiff(case):
    _, lit, _ = CASES[case]
    lv, pred, grads = _torch_run(case)
    for ref in ("fast", "autodiff"):
        jl, jpred, jgrads = _jax_run(case, ref)
        np.testing.assert_allclose(pred, jpred, rtol=1e-5, atol=1e-6)
        assert lv == pytest.approx(jl, rel=1e-5)
        n = 7 if lit else 4
        for got, want, name in zip(grads[:n], jgrads[:n], NAMES):
            _close(got, want, f"{name} vs vxtpu {ref}")
    assert np.abs(grads[0]).max() > 0 and np.abs(grads[1]).max() > 0


def test_fast_forward_matches_plain_renderer():
    sig, rgb, o, d, _ = _inputs()
    st = RenderSettings(shading="lambert")
    s = soft.SoftGrid(torch.tensor(sig), torch.tensor(rgb))
    lights = _tlights(True)
    want, _ = soft.render_soft_rays(s, torch.tensor(o), torch.tensor(d), st,
                                    S, lights)
    got = vjp.render_soft_rays_fast(s, torch.tensor(o), torch.tensor(d), st,
                                    S, lights)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_camera_pose_chain_matches_vxtpu():
    """Pose gradients through generate_rays (vxtpu's
    test_camera_pose_grad_chain, against its custom-VJP path, which that
    test holds to its autodiff)."""
    sig, rgb, _, _, _ = _inputs()
    js = jsoft.SoftGrid(sigma_raw=jnp.asarray(sig), rgb_raw=jnp.asarray(rgb))
    jst, st = _settings("lambert")
    jcam = JCamera.make(pos=(-9.0, 6.0, 7.0)).look_at((6.0, 6.0, 6.0))
    jl = JLights.single(*LIGHT)
    target = jax.jit(jsoft.render_soft_image, static_argnums=(2, 3, 4, 5))(
        js, jcam, jst, 8, 8, S, jl)

    def jloss(c):
        img = jvjp.render_soft_image_fast(js, c, jst, 8, 8, S, jl)
        return jnp.mean((img - target + 0.01) ** 2)

    cam = convert.camera_from_numpy(jcam.pos, jcam.yaw, jcam.pitch,
                                    jcam.fov_y, device=CPU)
    leaves = [getattr(cam, f).clone().requires_grad_(True)
              for f in ("pos", "yaw", "pitch", "fov_y")]
    tcam = type(cam)(*leaves)
    s = soft.SoftGrid(torch.tensor(sig), torch.tensor(rgb))
    img = vjp.render_soft_image_fast(s, tcam, st, 8, 8, S, _tlights(True))
    torch.mean((img - torch.tensor(np.asarray(target)) + 0.01) ** 2
               ).backward()
    g = jax.jit(jax.grad(jloss))(jcam)
    for name, leaf in zip(("pos", "yaw", "pitch"), leaves):
        np.testing.assert_allclose(
            leaf.grad.numpy(), np.asarray(getattr(g, name)), rtol=3e-4,
            atol=1e-7, err_msg=f"cam grad {name}")


def test_grads_bitwise_repeatable_on_cpu():
    """index_add_ sums in a fixed order on the CPU: two runs, the same
    bits (vxtpu's test_grad_determinism_bitwise)."""
    a = _torch_run("lit_full")[2]
    b = _torch_run("lit_full")[2]
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_fit_soft_custom_vjp_matches_vxtpu():
    """fit_soft(use_custom_vjp=True) at 16^3 against vxtpu's (rtol 1e-4,
    as test_torch_train.py holds the other fits), and against the port's
    own autograd fit (rtol 1e-6)."""
    D = 16
    dims = (D, D, D)
    jst, st = _settings("flat")
    truth = jsoft.SoftGrid.from_hard(jprocgen.terrain(dims, seed=7,
                                                      with_rgb=True))
    jcam = JCamera.make(pos=(-0.7 * D, 0.5 * D, 1.1 * D)).look_at(
        (0.5 * D, 0.5 * D, 0.27 * D))
    target = jax.jit(jsoft.render_soft_image, static_argnums=(2, 3, 4, 5))(
        truth, jcam, jst, 8, 8, 8)
    jcfg = jloop.TrainConfig(steps=3, num_samples=8, use_custom_vjp=True,
                             tv_sigma=0.0, tv_rgb=0.0, seed=7)
    _, _, want, _ = jloop.fit_soft(jsoft.SoftGrid.zeros(dims), jcam, target,
                                   jst, jcfg)
    cam = convert.camera_from_numpy(jcam.pos, jcam.yaw, jcam.pitch,
                                    jcam.fov_y, device=CPU)
    got = {}
    for custom in (True, False):
        cfg = loop.TrainConfig(steps=3, num_samples=8,
                               use_custom_vjp=custom, tv_sigma=0.0,
                               tv_rgb=0.0, seed=7)
        got[custom] = loop.fit_soft(soft.SoftGrid.zeros(dims, device=CPU),
                                    cam, torch.tensor(np.asarray(target)),
                                    st, cfg)[2]
    print(f"losses vxtpu {want}, vxtpu_torch {got}")
    np.testing.assert_allclose(got[True], want, rtol=1e-4)
    np.testing.assert_allclose(got[True], got[False], rtol=1e-6)
    assert got[True][-1] < got[True][0]
