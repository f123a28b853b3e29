"""``dryrun_multichip(n)`` (counterpart of ``__graft_entry__.py``'s): on
n local ranks, three animated frames of config 5's composition at tiny
shapes (sharded target render, sharded train step with bucketed
gradient all-reduce, per-frame pose correction), then the masked step
with its bounds pass, the sharded fused frame (K1) and the sharded
field-kernel step (K3/K4)."""

from __future__ import annotations

import math

import torch

from vxtpu_torch.device import DEFAULT, resolve


def _check(name: str, value: float) -> float:
    if not math.isfinite(value):
        raise FloatingPointError(f"dryrun_multichip: {name} is {value}")
    return value


def _rank_dryrun() -> dict:
    """One rank's part: every rank runs the same code on its rays."""
    import torch.distributed as dist

    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.engine import sharding
    from vxtpu_torch.render.occmask import (mask_distance_field,
                                            occupancy_mask_from_soft)
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.render.soft import SoftGrid
    from vxtpu_torch.render.soft_kernel import MortonSoftGrid
    from vxtpu_torch.train.config5 import Config5, run_config5
    from vxtpu_torch.world import procgen
    from vxtpu_torch.world.lights import Lights
    from vxtpu_torch.world.packed import (build_material_morton,
                                          build_packed_morton)

    n = dist.get_world_size()
    mesh = sharding.make_mesh(n)
    dev = mesh.device
    # width 8n: H*W divides the mesh and each shard splits into the 4
    # default gradient buckets
    cfg = Config5(dims=(16, 16, 16), height=16, width=8 * n, num_samples=16,
                  frames=3, steps_per_frame=2, pose_error=0.02, ckpt_every=0)
    res = run_config5(cfg, RenderSettings(), mesh=mesh)
    losses = [_check("config5 loss", v) for v in res["losses"]]

    D, H, W, G = 16, 8, 8 * n, 4
    settings = RenderSettings(shading="lambert")
    lights = Lights.single((0.0, 8.0, 30.0), intensity=2.0, device=dev)
    truth = SoftGrid.from_hard(procgen.shell_sphere((D, D, D), device=dev),
                               sigma_solid=20.0)
    cam = Camera.make(pos=(-10.0, 8.0, 8.0), device=dev).look_at(
        (8.0, 8.0, 8.0))
    target = sharding.render_soft_image_sharded(
        truth, cam, settings, H, W, 8, mesh, lights=lights).reshape(-1, 3)
    o_c, d_c = sharding.camera_frame_rays(cam, H, W)

    # (a) the masked step, its bounds a separate pass before it
    soft = SoftGrid(sigma_raw=truth.sigma_raw * 0.8,
                    rgb_raw=truth.rgb_raw * 0.8)
    mask = occupancy_mask_from_soft(soft, G, tau=0.01, dilate=1)
    mdf = mask_distance_field(mask)
    init_fn, step_fn = sharding.make_sharded_train_step(
        settings, 8, mesh, optimize_camera=True, lights=lights,
        use_custom_vjp=True, use_mask=True, mask_scale=G)
    state = init_fn(soft, cam)
    b0, b1 = sharding.compute_mask_bounds(mask, mdf, cam, o_c, d_c, G)
    _, _, _, loss_m = step_fn(soft, cam, state, o_c, d_c, target, mask, b0,
                              b1)
    loss_m = _check("masked loss", float(loss_m))

    # (b) the fused kernel (march + in-kernel shadow + shade), sharded
    hard = procgen.terrain((32, 32, 32), seed=5, device=dev)
    accel = build_packed_morton(hard.occupancy)
    mats = build_material_morton(hard.occupancy)
    fs = RenderSettings(shading="full", shadows=True, fog=True)
    fcam = Camera.make(pos=(-20.0, 16.0, 36.0), fov_y_deg=55.0,
                       device=dev).look_at((16.0, 16.0, 8.0))
    img = sharding.render_frame_fused_sharded(
        accel, mats, (32, 32, 32), fcam, lights, fs, 8, 16 * n, mesh)
    if not bool(torch.isfinite(img).all()):
        raise FloatingPointError("dryrun_multichip: fused sharded frame")

    # (c) the field-kernel train step (K3/K4 on each rank's rays)
    finit, fstep = sharding.make_sharded_train_step(
        settings, 4, mesh, optimize_camera=False, lights=lights,
        field_kernel=True)
    msoft = MortonSoftGrid.from_soft(SoftGrid.zeros((D, D, D), device=dev))
    fstate = finit(msoft, cam)
    _, _, _, loss_f = fstep(msoft, cam, fstate, o_c, d_c, target)
    loss_f = _check("field-kernel loss", float(loss_f))
    return dict(losses=losses, final_psnr=res["psnrs"][-1],
                masked_loss=loss_m, field_loss=loss_f,
                frame_sum=float(img.double().sum()))


def dryrun_multichip(n_devices: int, device=DEFAULT) -> dict:
    """Run the dry run on ``n_devices`` local ranks
    (``engine.platform.run_local``) and print one line. The backend is
    gloo on the CPU; on the GPU it is NCCL when every rank has a card of
    its own, else gloo (NCCL cannot put two ranks on one card). Raises if
    any rank fails or the ranks disagree. Returns rank 0's summary."""
    from vxtpu_torch.engine.platform import run_local

    dev = resolve(device)
    backend = ("nccl" if dev.type == "cuda"
               and n_devices <= torch.cuda.device_count() else "gloo")
    outs = run_local(n_devices, _rank_dryrun, backend=backend,
                     device=dev.type, timeout=300.0)
    if any(o != outs[0] for o in outs[1:]):
        raise AssertionError(f"dryrun_multichip: ranks disagree: {outs}")
    res = outs[0]
    print(f"dryrun_multichip({n_devices}): ok ({backend}, {dev.type}), "
          f"losses={res['losses']}, final_psnr={res['final_psnr']:.2f}, "
          f"masked_loss={res['masked_loss']:.4f}, "
          f"field_loss={res['field_loss']:.4f}, fused_frame=finite")
    return res
