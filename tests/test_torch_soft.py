"""Parity: vxtpu_torch's soft renderer (render/dda.py, render/soft.py; plain
PyTorch and autograd) against vxtpu's XLA soft renderer (render/soft.py,
jax autodiff), on the same fields and rays made with numpy from a seed.

Tolerance: values and gradients within atol 1e-5 (plus rtol 1e-5 for
gradients, which sum many float32 terms in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vxtpu.render import dda as jdda
from vxtpu.render import soft as jsoft
from vxtpu.render.settings import RenderSettings as JSettings
from vxtpu.world import procgen as jprocgen
from vxtpu.world.lights import Lights as JLights
from vxtpu_torch import convert
from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.render import dda, soft
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.world.grid import VoxelGrid

CPU = torch.device("cpu")
D = 16
DIMS = (D, D, D)
LIGHT = ([(0.2 * D, -0.3 * D, 1.4 * D)], [(1.0, 0.9, 0.8)], [2.0])


def rays(n, seed=0, dim=D):
    """Rays from outside and inside the grid toward random points in it,
    a few axis-aligned, a few missing the grid."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.6 * dim, 1.6 * dim, (n, 3)).astype(np.float32)
    o[: n // 4] = rng.uniform(0.1 * dim, 0.9 * dim, (n // 4, 3))  # inside
    tgt = rng.uniform(0.05 * dim, 0.95 * dim, (n, 3))
    d = tgt - o
    d[n // 4: n // 4 + 8, 1:] = 0.0              # axis-aligned
    d[n // 4 + 8: n // 4 + 16] = -d[n // 4 + 8: n // 4 + 16]  # some miss
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o.astype(np.float32), d


def fields(seed=1, dim=D):
    rng = np.random.default_rng(seed)
    sigma = (rng.normal(size=(dim,) * 3) * 2.0 - 1.0).astype(np.float32)
    rgb = rng.normal(size=(3,) + (dim,) * 3).astype(np.float32)
    return sigma, rgb


def t(x):
    return torch.tensor(np.asarray(x))


def test_ray_grid_clip_matches_vxtpu():
    o, d = rays(512)
    te, tx, v = jdda.ray_grid_clip(jnp.asarray(o), jnp.asarray(d), DIMS)
    te2, tx2, v2 = dda.ray_grid_clip(t(o), t(d), DIMS)
    np.testing.assert_array_equal(v2.numpy(), np.asarray(v))
    assert v2.any() and not v2.all()
    np.testing.assert_allclose(te2.numpy(), np.asarray(te), rtol=1e-6)
    np.testing.assert_allclose(tx2.numpy(), np.asarray(tx), rtol=1e-6)


@pytest.mark.parametrize("with_rgb", [True, False])
def test_from_hard_matches_vxtpu(with_rgb):
    jg = jprocgen.terrain(DIMS, seed=7, with_rgb=with_rgb)
    want = jsoft.SoftGrid.from_hard(jg)
    g = VoxelGrid(occupancy=convert.occupancy_from_numpy(
        np.asarray(jg.occupancy), device=CPU),
        rgb=t(jg.rgb) if with_rgb else None)
    got = soft.SoftGrid.from_hard(g)
    np.testing.assert_array_equal(got.sigma_raw.numpy(),
                                  np.asarray(want.sigma_raw))
    np.testing.assert_allclose(got.rgb_raw.numpy(), np.asarray(want.rgb_raw),
                               atol=1e-5)


def test_zeros_matches_vxtpu():
    got = soft.SoftGrid.zeros(DIMS, device=CPU)
    want = jsoft.SoftGrid.zeros(DIMS)
    np.testing.assert_array_equal(got.sigma_raw.numpy(),
                                  np.asarray(want.sigma_raw))
    np.testing.assert_array_equal(got.rgb_raw.numpy(),
                                  np.asarray(want.rgb_raw))


def _points(n, seed=3):
    """Points inside the grid, in the half-voxel shells at both faces, and
    outside it."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.0, D, (n, 3))
    p[:32] = rng.uniform(0.0, 0.5, (32, 3))           # low-face shell
    p[32:64] = rng.uniform(D - 0.5, D, (32, 3))       # high-face shell
    p[64:96] = rng.uniform(-3.0, D + 3.0, (32, 3))    # outside too
    return p.astype(np.float32)


def test_trilinear_and_grad_match_vxtpu():
    sigma, rgb = fields()
    p = _points(1024).reshape(32, 32, 3)
    for vals in (sigma, rgb):
        want = jsoft.trilinear(jnp.asarray(vals), jnp.asarray(p), DIMS)
        got = soft.trilinear(t(vals), t(p), DIMS)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want = jsoft.trilinear_grad(jnp.asarray(sigma), jnp.asarray(p), DIMS)
    got = soft.trilinear_grad(t(sigma), t(p), DIMS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_trilinear_corner_clamp_shell():
    """In the half-voxel shell at a low face the sample mixes voxels 0 and
    1 with f = q - floor(q) in [0.5, 1): it is not voxel 0's value."""
    vals = torch.zeros(DIMS)
    vals[0, 0, 0], vals[1, 0, 0] = 1.0, 3.0
    got = soft.trilinear(vals, torch.tensor([[0.25, 0.5, 0.5]]), DIMS)
    # q = -0.25: floor -1 -> i0 = 0, i1 = 1, f = 0.75
    assert float(got[0]) == pytest.approx(0.25 * 1.0 + 0.75 * 3.0)


CASES = {
    "unlit": dict(lit=False, shading="lambert", mask=False),
    "lit_lambert": dict(lit=True, shading="lambert", mask=False),
    "lit_full": dict(lit=True, shading="full", mask=False),
    "masked": dict(lit=False, shading="lambert", mask=True),
}


def _jax_render(sigma, rgb, o, d, cot, case, S, mask):
    """vxtpu's render and its vjp, run eagerly: under jit XLA contracts
    o + t * d into one rounding, and a sample that lands on a voxel
    centre at a low face (q = 0) then reads the other side of the
    corner-clamp step (see test_trilinear_corner_clamp_shell)."""
    lights = JLights.make(*LIGHT) if case["lit"] else None
    settings = JSettings(shading=case["shading"])

    def f(sig, col, o_, d_):
        out, _ = jsoft.render_soft_rays(
            jsoft.SoftGrid(sigma_raw=sig, rgb_raw=col), o_, d_, settings, S,
            lights=lights, mask=mask, mask_scale=4)
        return out

    out, vjp = jax.vjp(f, jnp.asarray(sigma), jnp.asarray(rgb),
                       jnp.asarray(o), jnp.asarray(d))
    return (np.asarray(out),) + tuple(np.asarray(g) for g in vjp(cot))


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_soft_rays_and_grads_match_vxtpu(case):
    c = CASES[case]
    S = 16
    sigma, rgb = fields()
    o, d = rays(256)
    cot = np.random.default_rng(5).normal(size=(256, 3)).astype(np.float32)
    mask = None
    if c["mask"]:
        mask = (np.random.default_rng(6).uniform(size=(4, 4, 4)) > 0.4
                ).astype(np.uint8)
    want = _jax_render(sigma, rgb, o, d, jnp.asarray(cot), c, S,
                       None if mask is None else jnp.asarray(mask))

    lights = convert.lights_from_numpy(*LIGHT, device=CPU) if c["lit"] \
        else None
    args = [t(x).requires_grad_(True) for x in (sigma, rgb, o, d)]
    out, aux = soft.render_soft_rays(
        soft.SoftGrid(sigma_raw=args[0], rgb_raw=args[1]), args[2], args[3],
        RenderSettings(shading=c["shading"]), S, lights=lights,
        mask=None if mask is None else t(mask), mask_scale=4)
    assert aux["weights"].shape == (256, S)
    grads = torch.autograd.grad(out, args, t(cot))
    np.testing.assert_allclose(out.detach().numpy(), want[0], atol=1e-5)
    for name, g, w in zip(("sigma", "rgb", "o", "d"), grads, want[1:]):
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)


def test_render_soft_image_pose_gradient_flows():
    sigma, rgb = fields()
    grid = soft.SoftGrid(sigma_raw=t(sigma), rgb_raw=t(rgb))
    cam = Camera.make(pos=(-10.0, 8.0, 20.0), device=CPU).look_at(
        (8.0, 8.0, 6.0))
    yaw = cam.yaw.clone().requires_grad_(True)
    img = soft.render_soft_image(grid, dataclasses.replace(cam, yaw=yaw),
                                 RenderSettings(), 8, 8, 8)
    assert img.shape == (8, 8, 3) and torch.isfinite(img).all()
    (g,) = torch.autograd.grad(img.sum(), yaw)
    assert torch.isfinite(g) and float(g) != 0.0
