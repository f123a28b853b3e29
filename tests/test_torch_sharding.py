"""vxtpu_torch's ray sharding over torch.distributed (engine/sharding.py)
on gloo ranks spawned here (engine/platform.run_local, a file:// store in
a temporary directory): 2 and 4 ranks against this process's 1-rank
group, and 2 ranks against vxtpu's make_sharded_train_step on a 2-device
mesh.

The frames of the hard renderers equal the 1-rank frame on every pixel,
also for a ray count that no rank count divides; the soft frame and the
steps (loss, updated tables and camera, Adam's first moments) are
allclose: rtol 1e-5 / atol 1e-6 x max|x| within the port, rtol 2e-4 /
atol 2e-5 x max|x| against vxtpu (its custom-VJP tolerance). The worker
functions are module-level and import no JAX, so the spawned ranks
start quickly."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from vxtpu_torch.engine import platform

CPU = torch.device("cpu")
D = 16
FH, FW = 11, 15          # frame rays: 165, divisible by neither 2 nor 4
SH, SW = 16, 16          # step rays: 256
S = 12
LIGHT = ((4.0, -6.0, 28.0), (1.0, 1.0, 1.0), 2.0)


def _inputs():
    """Seeded numpy inputs: soft grid, camera, target."""
    rng = np.random.default_rng(5)
    sig = (rng.normal(size=(D, D, D)) * 2.0).astype(np.float32)
    rgb = rng.normal(size=(3, D, D, D)).astype(np.float32)
    tgt = rng.uniform(size=(SH * SW, 3)).astype(np.float32)
    return sig, rgb, tgt


def _camera():
    from vxtpu_torch.camera.camera import Camera

    return Camera.make(pos=(-0.7 * D, 0.45 * D, 1.1 * D), fov_y_deg=55.0,
                       device=CPU).look_at((0.5 * D, 0.5 * D, 0.27 * D))


def _step_cases():
    # name: make_sharded_train_step options
    return {"autodiff": dict(use_custom_vjp=False),
            "custom_vjp": dict(use_custom_vjp=True),
            "custom_vjp_b4": dict(use_custom_vjp=True, grad_buckets=4),
            "field_kernel": dict(field_kernel=True, optimize_camera=False),
            "masked": dict(use_custom_vjp=True, use_mask=True)}


def _checks(tmp: str) -> dict:
    """Everything one rank computes; numpy out."""
    import torch.distributed as dist

    from vxtpu_torch.app.run import kernel_factory
    from vxtpu_torch.engine import sharding
    from vxtpu_torch.render import occmask
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.render.soft import SoftGrid
    from vxtpu_torch.render.soft_kernel import MortonSoftGrid
    from vxtpu_torch.train.checkpoint import save_checkpoint
    from vxtpu_torch.world import procgen
    from vxtpu_torch.world.lights import Lights
    from vxtpu_torch.world.packed import (build_material_morton,
                                          build_packed_morton)

    mesh = sharding.make_mesh()
    out = {}
    cam = _camera()
    lights = Lights.single(*LIGHT, device=CPU)
    grid = procgen.terrain((D, D, D), seed=7, device=CPU)
    full = RenderSettings(shading="full", shadows=True, fog=True)
    out["frame"] = sharding.render_image_sharded(
        kernel_factory("xla"), grid, cam, lights, full, FH, FW, mesh).numpy()
    out["fused"] = sharding.render_frame_fused_sharded(
        build_packed_morton(grid.occupancy),
        build_material_morton(grid.occupancy), (D, D, D), cam, lights, full,
        FH, FW, mesh).numpy()
    sig, rgb, tgt = _inputs()
    soft = SoftGrid(torch.tensor(sig), torch.tensor(rgb))
    lam = RenderSettings(shading="lambert")
    out["soft"] = sharding.render_soft_image_sharded(
        soft, cam, lam, FH, FW, S, mesh, lights=lights).numpy()

    o_c, d_c = sharding.camera_frame_rays(cam, SH, SW)
    target = torch.tensor(tgt)
    mask = occmask.occupancy_mask_from_soft(soft, 4, tau=0.5, dilate=0)
    b0, b1 = sharding.compute_mask_bounds(
        mask, occmask.mask_distance_field(mask), cam, o_c, d_c, 4)
    for name, opts in _step_cases().items():
        opts = dict(opts)
        model = MortonSoftGrid.from_soft(soft) if opts.get(
            "field_kernel") else soft
        init_fn, step_fn = sharding.make_sharded_train_step(
            lam, S, mesh, lr=5e-2, cam_lr=1e-2, lights=lights, **opts)
        state = init_fn(model, cam)
        margs = (mask, b0, b1) if opts.get("use_mask") else ()
        m2, c2, state, loss = step_fn(model, cam, state, o_c, d_c, target,
                                      *margs)
        out[name] = dict(
            loss=float(loss),
            params=[getattr(m2, f.name).numpy().copy()
                    for f in dataclasses.fields(m2)],
            cam=[getattr(c2, f).numpy().copy()
                 for f in ("pos", "yaw", "pitch")],
            mu=[m.numpy() for g in state.opt_state() for m in g.mu])

    # only rank 0 writes a checkpoint
    rank = dist.get_rank()
    save_checkpoint(os.path.join(tmp, f"ckpt_from_rank{rank}.npz"), soft,
                    cam, step=1)
    dist.barrier()
    out["ckpts"] = sorted(f for f in os.listdir(tmp) if f.endswith(".npz"))
    return out


def _one_rank(tmp) -> dict:
    platform.init_multihost(device=CPU)
    try:
        return _checks(str(tmp))
    finally:
        platform.shutdown()


def _close(got, want, rtol, atol_rel, what):
    want = np.asarray(want)
    atol = atol_rel * max(float(np.max(np.abs(want))), 1e-12)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_equals_one_rank(world, tmp_path):
    ref = _one_rank(tmp_path / "one")
    (tmp_path / "many").mkdir()
    outs = platform.run_local(world, _checks, backend="gloo", device="cpu",
                              timeout=60, args=(str(tmp_path / "many"),))
    for r, out in enumerate(outs):
        for key in ("frame", "fused"):
            assert np.array_equal(out[key], ref[key]), (key, r)
        _close(out["soft"], ref["soft"], 1e-5, 1e-6, f"soft frame rank {r}")
        for name in _step_cases():
            a, b = out[name], ref[name]
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-5), name
            for x, y in zip(a["params"] + a["cam"] + a["mu"],
                            b["params"] + b["cam"] + b["mu"], strict=True):
                _close(x, y, 1e-5, 1e-6, f"{name} rank {r}")
        assert out["ckpts"] == ["ckpt_from_rank0.npz"]
    # B = 4 buckets against B = 1
    a, b = outs[0]["custom_vjp_b4"], outs[0]["custom_vjp"]
    assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    for x, y in zip(a["mu"], b["mu"], strict=True):
        _close(x, y, 1e-5, 1e-6, "4 buckets vs 1")
    # every rank holds the same state
    for out in outs[1:]:
        for name in _step_cases():
            for x, y in zip(out[name]["params"], outs[0][name]["params"]):
                assert np.array_equal(x, y)


def _vxtpu_twin(tmp: str) -> dict:
    """The port's half of the vxtpu comparison: the lit custom-VJP step
    with the camera, 2 buckets, after one step."""
    from vxtpu_torch.engine import sharding
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.render.soft import SoftGrid
    from vxtpu_torch.world.lights import Lights

    mesh = sharding.make_mesh()
    sig, rgb, tgt = _inputs()
    soft = SoftGrid(torch.tensor(sig), torch.tensor(rgb))
    cam = _camera()
    init_fn, step_fn = sharding.make_sharded_train_step(
        RenderSettings(shading="lambert"), S, mesh, lr=5e-2, cam_lr=1e-2,
        grad_buckets=2, lights=Lights.single(*LIGHT, device=CPU),
        use_custom_vjp=True)
    state = init_fn(soft, cam)
    o_c, d_c = sharding.camera_frame_rays(cam, SH, SW)
    _, c2, state, loss = step_fn(soft, cam, state, o_c, d_c,
                                 torch.tensor(tgt))
    return dict(loss=float(loss), mu=[m.numpy() for g in state.opt_state()
                                      for m in g.mu],
                cam=[getattr(c2, f).numpy().copy()
                     for f in ("pos", "yaw", "pitch")])


def test_two_ranks_match_vxtpu_two_device_step(tmp_path):
    """Loss, Adam's first moments (0.1 x the all-reduced gradients) and
    the updated camera after one step, against vxtpu's step on a 2-device
    mesh."""
    import jax
    import jax.numpy as jnp

    from vxtpu.camera.camera import Camera as JCamera
    from vxtpu.engine import sharding as jsharding
    from vxtpu.render.settings import RenderSettings as JSettings
    from vxtpu.render.soft import SoftGrid as JSoftGrid
    from vxtpu.world.lights import Lights as JLights

    outs = platform.run_local(2, _vxtpu_twin, backend="gloo", device="cpu",
                              timeout=60, args=(str(tmp_path),))
    sig, rgb, tgt = _inputs()
    cam = _camera()
    jcam = JCamera(pos=jnp.asarray(cam.pos.numpy()),
                   yaw=jnp.asarray(cam.yaw.numpy()),
                   pitch=jnp.asarray(cam.pitch.numpy()),
                   fov_y=jnp.asarray(cam.fov_y.numpy()))
    mesh = jsharding.make_mesh(2)
    init_fn, step_fn = jsharding.make_sharded_train_step(
        JSettings(shading="lambert"), S, mesh, lr=5e-2, cam_lr=1e-2,
        grad_buckets=2, lights=JLights.single(*LIGHT), use_custom_vjp=True)
    js = JSoftGrid(sigma_raw=jnp.asarray(sig), rgb_raw=jnp.asarray(rgb))
    opt = init_fn(js, jcam)
    o_c, d_c = jsharding.camera_frame_rays(jcam, SH, SW)
    _, c2, opt, loss = step_fn(js, jcam, opt, o_c, d_c, jnp.asarray(tgt))
    s_state, c_state = opt
    want_mu = [s_state[0].mu.sigma_raw, s_state[0].mu.rgb_raw,
               c_state[0].mu.pos, c_state[0].mu.yaw, c_state[0].mu.pitch,
               c_state[0].mu.fov_y]
    for out in outs:
        assert out["loss"] == pytest.approx(float(loss), rel=2e-4)
        for got, want in zip(out["mu"], want_mu, strict=True):
            _close(got, np.asarray(want), 2e-4, 2e-5, "first moments")
        for got, name in zip(out["cam"], ("pos", "yaw", "pitch")):
            _close(got, np.asarray(getattr(c2, name)), 2e-4, 2e-5,
                   f"camera {name}")
    assert jax.device_count() >= 2
