"""The Morton TV prior's wrapper (train/kernel_tv.py) on the CPU, where it
runs the plain version, against vxtpu: ``tv_sigma * tv_loss_morton(
sigma_tab) + tv_rgb * tv_loss_morton(rgb_tab)`` on the two planar Morton
tables of the same fields, and ``jax.grad`` of it, in each of
kernel_check.TV_CASES. Its kernel pair is held to the plain version in
the same cases on the card (tests/test_torch_cuda.py).

Tolerances: the value within rel 1e-5, its gradient within rtol 1e-5 /
atol 1e-6 x max|g| (float32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vxtpu.render import soft as jsoft
from vxtpu.render import soft_pallas as jsp
from vxtpu.train import loss as jloss
from vxtpu_torch import kernel_check as kc
from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.render import kernel_sample as ks
from vxtpu_torch.render import soft
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.train import kernel_tv, loop



def _fields(D, seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(D,) * 3) * 2.0).astype(np.float32),
            rng.normal(size=(3,) + (D,) * 3).astype(np.float32))


@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("case", list(kc.TV_CASES))
def test_tv_prior_wrapper_matches_vxtpu(case, D):
    w_s, w_rgb, up, accumulate = kc.TV_CASES[case]
    sig, rgb = _fields(D, seed=D + len(case))
    jm = jsp.MortonSoftGrid.from_soft(jsoft.SoftGrid(jnp.asarray(sig),
                                                     jnp.asarray(rgb)))

    def f(s_, c_):
        return up * (w_s * jloss.tv_loss_morton(s_)
                     + w_rgb * jloss.tv_loss_morton(c_))

    want = float(f(jm.sigma_tab, jm.rgb_tab))
    gs, gc = jax.grad(f, argnums=(0, 1))(jm.sigma_tab, jm.rgb_tab)
    wg = ks.interleave_tables(torch.tensor(np.asarray(gs)),
                              torch.tensor(np.asarray(gc)))
    tab = ks.build_interleaved_morton(torch.tensor(sig), torch.tensor(rgb))
    tab.requires_grad_(True)
    before = torch.zeros_like(tab)
    if accumulate:
        before = torch.tensor(np.random.default_rng(9).normal(
            size=tab.shape).astype(np.float32)) * 1e-6
        tab.grad = before.clone()
    prior = kernel_tv.tv_prior(tab, w_s, w_rgb)
    assert prior.shape == () and prior.dtype == torch.float32
    assert float(up * prior.detach()) == pytest.approx(want, rel=1e-5)
    (up * prior).backward()
    got = tab.grad - before
    scale = float(wg.abs().max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), wg.numpy(), rtol=1e-5,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("bad", ["non_contiguous", "not_pow2", "float64",
                                 "three_channels", "one_voxel"])
def test_tv_prior_wrapper_refuses(bad):
    tab = torch.zeros((16 ** 3, 4))
    make = {"non_contiguous": lambda: torch.zeros((4, 16 ** 3)).t(),
            "not_pow2": lambda: torch.zeros((12 ** 3, 4)),
            "float64": lambda: tab.double(),
            "three_channels": lambda: torch.zeros((16 ** 3, 3)),
            "one_voxel": lambda: torch.zeros((1, 4))}
    err = TypeError if bad == "float64" else ValueError
    with pytest.raises(err):
        kernel_tv.tv_prior(make[bad]().requires_grad_(True), 1e-4, 1e-5)


def test_field_kernel_loss_goes_through_the_wrapper(monkeypatch):
    """_loss_fn with field_kernel takes its prior from kernel_tv.tv_prior
    (on the CPU the plain version), once a step, and not at all when both
    weights are 0."""
    calls = []
    real = loop.tv_prior

    def counted(tab, w_s, w_rgb):
        calls.append((tuple(tab.shape), w_s, w_rgb))
        return real(tab, w_s, w_rgb)

    monkeypatch.setattr(loop, "tv_prior", counted)
    D = 8
    truth = soft.SoftGrid(torch.zeros((D,) * 3), torch.zeros((3,) + (D,) * 3))
    cam = Camera.make(pos=(-6.0, 4.0, 9.0),
                      device=torch.device("cpu")).look_at((4.0, 4.0, 2.0))
    target = torch.full((8, 8, 3), 0.5)
    for w, n in ((1e-4, 2), (0.0, 0)):
        calls.clear()
        loop.fit_soft(truth, cam, target, RenderSettings(shading="flat"),
                      loop.TrainConfig(steps=2, num_samples=4, tv_sigma=w,
                                       tv_rgb=w, field_kernel=True))
        assert calls == [((D ** 3, 4), w, w)] * n
