"""Parity: vxtpu_torch's training (train/loss.py, train/loop.py,
train/checkpoint.py, camera/paths.py, the train command) against vxtpu's,
and the device default.

Tolerances: losses within rtol 1e-5 (the loss functions) or rtol 1e-4 (a
three-step fit, which renders through another path of each package);
Adam's parameters within 1e-4 of a step of optax's."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vxtpu.camera import paths as jpaths
from vxtpu.camera.camera import Camera as JCamera
from vxtpu.render import soft as jsoft
from vxtpu.render import soft_pallas as jsp
from vxtpu.render.settings import RenderSettings as JSettings
from vxtpu.train import checkpoint as jckpt
from vxtpu.train import loop as jloop
from vxtpu.train import loss as jloss
from vxtpu.world import procgen as jprocgen
from vxtpu_torch import convert
from vxtpu_torch.app import run
from vxtpu_torch.camera import paths
from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.render import kernel_sample as ks
from vxtpu_torch.render import soft
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.render.soft_kernel import MortonSoftGrid
from vxtpu_torch.train import checkpoint, loop, loss
from vxtpu_torch.world import procgen

CPU = torch.device("cpu")
D = 16
DIMS = (D, D, D)


def t(x):
    return torch.tensor(np.asarray(x))


def grids(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=DIMS).astype(np.float32),
            rng.normal(size=(3,) + DIMS).astype(np.float32))


def test_losses_match_vxtpu():
    sig, rgb = grids()
    a, b = rgb[0, :4], rgb[1, :4]
    assert float(loss.mse(t(a), t(b))) == pytest.approx(
        float(jloss.mse(jnp.asarray(a), jnp.asarray(b))), rel=1e-5)
    assert float(loss.psnr(t(a), t(b))) == pytest.approx(
        float(jloss.psnr(jnp.asarray(a), jnp.asarray(b))), rel=1e-5)
    for vol in (sig, rgb):
        assert float(loss.tv_loss(t(vol))) == pytest.approx(
            float(jloss.tv_loss(jnp.asarray(vol))), rel=1e-5)
    m = MortonSoftGrid.from_soft(soft.SoftGrid(t(sig), t(rgb)))
    for tab in (m.sigma_tab, m.rgb_tab):
        rows = tab.numpy().reshape(tab.shape[:-1] + (-1, 128))
        assert float(loss.tv_loss_morton(tab)) == pytest.approx(
            float(jloss.tv_loss_morton(jnp.asarray(rows))), rel=1e-5)


def _c4_scene(h=16, w=16, S=8):
    """c4's fit cut to 16^3: terrain seed 7 -> from_hard truth -> one
    target view, rendered by vxtpu."""
    settings = JSettings()
    truth = jsoft.SoftGrid.from_hard(jprocgen.terrain(DIMS, seed=7,
                                                      with_rgb=True))
    jcam = JCamera.make(pos=(-0.7 * D, 0.5 * D, 1.1 * D)).look_at(
        (0.5 * D, 0.5 * D, 0.27 * D))
    target = jsoft.render_soft_image(truth, jcam, settings, h, w, S)
    cam = convert.camera_from_numpy(jcam.pos, jcam.yaw, jcam.pitch,
                                    jcam.fov_y, device=CPU)
    return settings, jcam, cam, target


def _torch_scene(h, w, S):
    """The same scene made by vxtpu_torch alone (for tests that need no
    comparison with vxtpu)."""
    truth = soft.SoftGrid.from_hard(procgen.terrain(
        DIMS, seed=7, with_rgb=True, device=CPU))
    cam = Camera.make(pos=(-0.7 * D, 0.5 * D, 1.1 * D), device=CPU).look_at(
        (0.5 * D, 0.5 * D, 0.27 * D))
    with torch.no_grad():
        target = soft.render_soft_image(truth, cam, RenderSettings(), h, w,
                                        S)
    return cam, target


def test_fit_soft_kernel_matches_vxtpu():
    """Three steps through the sampling path (the kernels' plain versions
    here) against vxtpu's XLA fit; with the TV terms off both minimise
    the same loss."""
    S = 8
    settings, jcam, cam, target = _c4_scene(S=S)
    jcfg = jloop.TrainConfig(steps=3, num_samples=S, tv_sigma=0.0,
                             tv_rgb=0.0, seed=7)
    _, _, want, _ = jloop.fit_soft(jsoft.SoftGrid.zeros(DIMS), jcam, target,
                                   settings, jcfg)
    cfg = loop.TrainConfig(steps=3, num_samples=S, tv_sigma=0.0, tv_rgb=0.0,
                           seed=7, field_kernel=True)
    ks.reset_launch_counts()
    fitted, _, got, state = loop.fit_soft(
        soft.SoftGrid.zeros(DIMS, device=CPU), cam, t(target),
        RenderSettings(), cfg)
    print(f"losses vxtpu {want}, vxtpu_torch {got}")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    assert fitted.sigma_raw.shape == DIMS and state[0].count == 3
    assert not any(ks.LAUNCHES.values())


def test_adam_matches_optax():
    sig, rgb = grids(1)
    rng = np.random.default_rng(2)
    grads = [(rng.normal(size=sig.shape).astype(np.float32),
              rng.normal(size=rgb.shape).astype(np.float32) * 1e-3)
             for _ in range(3)]
    opt = optax.adam(5e-2)
    jp = (jnp.asarray(sig), jnp.asarray(rgb))
    js = opt.init(jp)
    for g in grads:
        upd, js = opt.update(tuple(map(jnp.asarray, g)), js, jp)
        jp = optax.apply_updates(jp, upd)
    ps = [t(sig).requires_grad_(True), t(rgb).requires_grad_(True)]
    topt = loop.make_optimizer(loop.TrainConfig(), ps)
    for g in grads:
        for p, gi in zip(ps, g):
            p.grad = t(gi)
        topt.step()
    # the libraries round the bias corrections differently: within 1e-4
    # of one step's size (lr = 5e-2)
    for p, w in zip(ps, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=5e-6)
    leaves = checkpoint.opt_state_leaves(loop.read_opt_state(topt))
    want = jax.tree_util.tree_leaves(js)
    assert len(leaves) == len(want) == 5
    for a, w in zip(leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a, w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()))


def test_camera_group_leaf_order_matches_optax():
    """With the pose optimised, optax.multi_transform keeps the 'cam'
    group's leaves before 'soft''s; the port's state lists them alike."""
    sig, rgb = grids()
    jcam = JCamera.make(pos=(1.0, 2.0, 3.0))
    want = jax.tree_util.tree_leaves(jloop.make_optimizer(
        jloop.TrainConfig(optimize_camera=True)).init(
            (jsoft.SoftGrid(jnp.asarray(sig), jnp.asarray(rgb)), jcam)))
    cam = [torch.zeros(3), torch.zeros(()), torch.zeros(()), torch.zeros(())]
    got = checkpoint.opt_state_leaves(loop.init_opt_state(
        [cam, [t(sig), t(rgb)]]))
    assert [np.shape(x) for x in got] == [np.shape(x) for x in want]


def _jax_morton_state(sig, rgb, steps=2):
    jgrid = jsoft.SoftGrid(jnp.asarray(sig), jnp.asarray(rgb))
    m = jsp.MortonSoftGrid.from_soft(jgrid)
    opt = optax.adam(5e-2)
    state = opt.init(m)
    rng = np.random.default_rng(4)
    for _ in range(steps):
        g = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), m)
        _, state = opt.update(g, state, m)
    return jgrid, state


def test_checkpoint_from_vxtpu_loads_here(tmp_path):
    sig, rgb = grids()
    jgrid, state = _jax_morton_state(sig, rgb)
    jcam = JCamera.make(pos=(-11.0, 8.0, 17.0)).look_at((8.0, 8.0, 4.0))
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, jgrid, jcam, step=2,
                          extra={"losses": np.array([0.5, 0.25])},
                          opt_state=state)
    got, cam, step, extra = checkpoint.load_checkpoint(path, device=CPU)
    np.testing.assert_array_equal(got.sigma_raw.numpy(), sig)
    np.testing.assert_array_equal(got.rgb_raw.numpy(), rgb)
    np.testing.assert_array_equal(cam.pos.numpy(), np.asarray(jcam.pos))
    assert float(cam.yaw) == float(jcam.yaw) and step == 2
    np.testing.assert_array_equal(extra["losses"], [0.5, 0.25])
    m = MortonSoftGrid.from_soft(got)
    tmpl = loop.init_opt_state([[m.sigma_tab, m.rgb_tab]])
    ostate = checkpoint.load_opt_state(path, tmpl, device=CPU)
    assert ostate[0].count == 2
    want = jax.tree_util.tree_leaves(state)
    for a, w in zip(ostate[0].mu + ostate[0].nu, want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w).reshape(
            a.shape))
    # the convert entry point gives the same state
    conv = convert.adam_state_from_optax_leaves(
        [np.asarray(x) for x in want], tmpl, device=CPU)
    assert torch.equal(conv[0].nu[1], ostate[0].nu[1])
    mg = convert.morton_soft_grid_from_numpy(
        np.asarray(jsp.MortonSoftGrid.from_soft(jgrid).sigma_tab),
        np.asarray(jsp.MortonSoftGrid.from_soft(jgrid).rgb_tab), device=CPU)
    assert torch.equal(mg.sigma_tab, m.sigma_tab)
    sg = convert.soft_grid_from_numpy(sig, rgb, device=CPU)
    assert torch.equal(sg.rgb_raw, got.rgb_raw)


def test_checkpoint_from_here_loads_in_vxtpu(tmp_path):
    cam, target = _torch_scene(8, 8, 4)
    cfg = loop.TrainConfig(steps=2, num_samples=4, field_kernel=True)
    fitted, cam_out, losses, state = loop.fit_soft(
        soft.SoftGrid.zeros(DIMS, device=CPU), cam, target,
        RenderSettings(), cfg)
    path = str(tmp_path / "torch.npz")
    checkpoint.save_checkpoint(path, fitted, cam_out, step=2,
                               extra={"losses": losses}, opt_state=state)
    jgrid, jc, step, extra = jckpt.load_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(jgrid.sigma_raw),
                                  fitted.sigma_raw.numpy())
    assert step == 2 and float(jc.pitch) == float(cam_out.pitch)
    tmpl = optax.adam(cfg.lr).init(jsp.MortonSoftGrid.from_soft(jgrid))
    jstate = jckpt.load_opt_state(path, tmpl)
    leaves = jax.tree_util.tree_leaves(jstate)
    assert int(leaves[0]) == 2
    np.testing.assert_array_equal(np.asarray(leaves[3]).reshape(-1),
                                  state[0].nu[0].numpy())


def test_resume_continues_the_trajectory(tmp_path):
    """Two steps, a checkpoint, one resumed step == three steps."""
    cam, tgt = _torch_scene(8, 8, 4)
    cfg = loop.TrainConfig(steps=3, num_samples=4, field_kernel=True)
    zeros = soft.SoftGrid.zeros(DIMS, device=CPU)
    full, _, want, _ = loop.fit_soft(zeros, cam, tgt, RenderSettings(), cfg)
    part, _, first, state = loop.fit_soft(
        zeros, cam, tgt, RenderSettings(), loop.TrainConfig(
            steps=2, num_samples=4, field_kernel=True))
    path = str(tmp_path / "c.npz")
    checkpoint.save_checkpoint(path, part, cam, 2, opt_state=state)
    back, _, _, _ = checkpoint.load_checkpoint(path, device=CPU)
    m = MortonSoftGrid.from_soft(back)
    st = checkpoint.load_opt_state(path, loop.init_opt_state(
        [[m.sigma_tab, m.rgb_tab]]), device=CPU)
    res, _, last, _ = loop.fit_soft(back, cam, tgt, RenderSettings(),
                                    loop.TrainConfig(steps=1, num_samples=4,
                                                     field_kernel=True),
                                    opt_state=st)
    np.testing.assert_allclose(first + last, want, rtol=1e-6)
    np.testing.assert_allclose(res.sigma_raw.numpy(), full.sigma_raw.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_fit_soft_views_and_orbit():
    jcams = jpaths.orbit_views(center=(8.0, 8.0, 5.0), radius=14.0,
                               height=18.0, n=3, fov_y_deg=55.0)
    cams = paths.orbit_views(center=(8.0, 8.0, 5.0), radius=14.0,
                             height=18.0, n=3, fov_y_deg=55.0, device=CPU)
    for jc, c in zip(jcams, cams):
        for f in ("pos", "yaw", "pitch", "fov_y"):
            np.testing.assert_allclose(getattr(c, f).numpy(),
                                       np.asarray(getattr(jc, f)), atol=1e-5)
    truth = soft.SoftGrid.from_hard(procgen.terrain(DIMS, seed=7,
                                                    with_rgb=True,
                                                    device=CPU))
    with torch.no_grad():
        tgt = torch.stack([soft.render_soft_image(truth, c,
                                                  RenderSettings(), 8, 8, 4)
                           for c in cams])
    fitted, losses, state = loop.fit_soft_views(
        soft.SoftGrid.zeros(DIMS, device=CPU), cams, tgt, RenderSettings(),
        loop.TrainConfig(steps=3, num_samples=4, ray_batch=64,
                         field_kernel=True))
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert state[0].count == 3


def test_unported_options_and_nan_guard():
    """Every TrainConfig option runs now: use_custom_vjp (render/vjp.py)
    gives the autograd path's loss; a NaN target trips the guard."""
    cam, tgt = _torch_scene(4, 4, 2)
    zeros = soft.SoftGrid.zeros(DIMS, device=CPU)
    losses = [loop.fit_soft(zeros, cam, tgt, RenderSettings(),
                            loop.TrainConfig(steps=2, num_samples=2,
                                             use_custom_vjp=custom))[2]
              for custom in (True, False)]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    with pytest.raises(FloatingPointError):
        loop.fit_soft(zeros, cam, torch.full_like(tgt, float("nan")),
                      RenderSettings(), loop.TrainConfig(steps=1,
                                                         num_samples=2))


def test_train_command_on_cpu(tmp_path, capsys):
    out = tmp_path / "fit"
    rc = run.main(["train", "--device", "cpu", "--dims", "16", "--height",
                   "8", "--width", "8", "--samples", "4", "--steps", "2",
                   "--field-kernel", "--out", str(out)])
    assert rc == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["metric"] == "final_loss" and last["steps"] == 2
    assert (out / "ckpt.npz").exists() and (out / "fit.png").exists()


def test_train_command_custom_vjp_on_cpu(tmp_path, capsys):
    out = tmp_path / "fit"
    assert run.main(["train", "--device", "cpu", "--dims", "16", "--height",
                     "8", "--width", "8", "--samples", "4", "--steps", "2",
                     "--custom-vjp", "--out", str(out)]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["metric"] == "final_loss" and np.isfinite(last["value"])
    assert (out / "ckpt.npz").exists()


def test_train_command_occmask_on_cpu(tmp_path, capsys):
    """train --occmask --field-kernel: the masked fit, its mask rebuilt
    never in two steps (mask_refresh 50), the loss finite."""
    out = tmp_path / "fit"
    assert run.main(["train", "--device", "cpu", "--dims", "16", "--height",
                     "8", "--width", "8", "--samples", "4", "--steps", "2",
                     "--field-kernel", "--occmask", "--out", str(out)]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["steps"] == 2 and np.isfinite(last["value"])
    assert (out / "ckpt.npz").exists()


def test_entry_points_default_to_the_gpu():
    """Without ``device`` an entry point makes its tensors on the GPU, and
    where there is none it raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    with pytest.raises(RuntimeError, match="device=torch.device"):
        procgen.terrain((8, 8, 8))
    with pytest.raises(RuntimeError):
        soft.SoftGrid.zeros((8, 8, 8))
    with pytest.raises(RuntimeError):
        convert.occupancy_from_numpy(np.zeros((2, 2, 2), np.uint8))
    assert procgen.terrain((8, 8, 8), device=CPU).occupancy.device == CPU
