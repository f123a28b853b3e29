"""Config 5's end-to-end run (counterpart of ``vxtpu/train/config5.py``): an
animated scene whose frames are rendered with rays sharded over the
process group while the camera pose and the voxels descend every frame.

  camera/paths.orbit            the animated true camera
  engine/sharding.py            the sharded target render and train step
                                (gradients all-reduced in buckets)
  train/checkpoint.py           periodic save (rank 0) and resume
  obs/metrics.MetricsSink       per-frame loss, PSNR and pose errors

A known "truth" grid is filmed by the moving camera; the optimiser sees
each target frame once and descends the replicated soft grid and its
deliberately wrong camera-pose estimate, whose error is carried from
frame to frame. Every rank runs this same code (``engine/platform.py``:
``init_multihost``).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from vxtpu_torch.camera import paths
from vxtpu_torch.device import DEFAULT
from vxtpu_torch.engine.platform import init_multihost
from vxtpu_torch.engine.sharding import (camera_frame_rays, make_mesh,
                                         make_sharded_train_step,
                                         render_soft_image_sharded)
from vxtpu_torch.obs.log import get_logger, process_rank
from vxtpu_torch.obs.metrics import MetricsSink
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.render.soft import SoftGrid
from vxtpu_torch.train.checkpoint import (load_checkpoint, load_opt_state,
                                          save_checkpoint)
from vxtpu_torch.train.loss import psnr
from vxtpu_torch.world import procgen
from vxtpu_torch.world.lights import Lights


@dataclasses.dataclass(frozen=True)
class Config5:
    dims: tuple[int, int, int] = (512, 512, 512)
    height: int = 1080
    width: int = 1920
    num_samples: int = 192
    frames: int = 24
    steps_per_frame: int = 2
    fps: float = 24.0
    lr: float = 5e-2
    cam_lr: float = 2e-3
    pose_error: float = 0.03        # initial yaw/pitch error (radians)
    seed: int = 7
    ckpt_every: int = 8             # frames between checkpoint saves
    sigma_solid: float = 25.0
    grad_buckets: int = 4           # all-reduce of each bucket overlapped
    lit: bool = True                # lit soft mode (density-gradient normals)
    use_custom_vjp: bool = True     # O(N + grid) backward (render/vjp.py)


def run_config5(cfg: Config5, settings: RenderSettings, mesh=None,
                out_dir: str | None = None, resume: str | None = None,
                sink: MetricsSink | None = None, save_frames: bool = False,
                end_frame: int | None = None, device=DEFAULT):
    """Run the animated sharded per-frame optimisation on ``mesh`` (by
    default the whole process group, a 1-rank group of this process if
    there is none: ``init_multihost`` on ``device``).

    ``end_frame`` stops after the frames before it: the first frames of
    the cfg.frames-frame animation, on its orbit (by default all of
    them). Returns a dict with the per-frame losses and PSNRs, the final
    pose errors and the final (soft, cam)."""
    log = get_logger(log_dir=out_dir)
    if mesh is None:
        init_multihost(device=device)
        mesh = make_mesh()
    device = mesh.device
    if sink is None:
        sink = MetricsSink(echo=False)
    log.info("config5: %d ranks, dims=%s, %dx%d, %d samples, lit=%s, "
             "custom_vjp=%s, resume=%s", mesh.size, cfg.dims, cfg.height,
             cfg.width, cfg.num_samples, cfg.lit, cfg.use_custom_vjp,
             resume or "no")
    if (cfg.height * cfg.width) % mesh.size:
        raise ValueError(f"H*W={cfg.height * cfg.width} must divide evenly "
                         f"over {mesh.size} ranks (padding rays would "
                         f"perturb the mean loss)")

    X, Y, Z = cfg.dims
    truth = SoftGrid.from_hard(
        procgen.terrain(cfg.dims, seed=cfg.seed, with_rgb=True,
                        device=device), sigma_solid=cfg.sigma_solid)
    # targets and optimisation renders share one light
    lights = (Lights.single((0.2 * X, -0.3 * Y, 1.4 * Z), intensity=2.0,
                            device=device)
              if cfg.lit and settings.shading != "flat" else None)
    cam_path = paths.orbit(
        center=(0.5 * X, 0.5 * Y, 0.3 * Z), radius=0.9 * X, height=1.1 * Z,
        period=cfg.frames / cfg.fps, fov_y_deg=55.0, device=device)

    start_frame = 0
    soft = SoftGrid.zeros(cfg.dims, device=device)
    cam_off = torch.tensor([cfg.pose_error, -cfg.pose_error],
                           dtype=torch.float32, device=device)
    if resume:
        soft, _, start_frame, extra = load_checkpoint(resume, device)
        if "cam_off" in extra:
            cam_off = torch.as_tensor(extra["cam_off"], device=device)

    # a bucketed all-reduce only pays where there is a collective to
    # overlap with the backward: on a 1-rank mesh, one bucket
    buckets = cfg.grad_buckets if mesh.size > 1 else 1
    init_fn, step_fn = make_sharded_train_step(
        settings, cfg.num_samples, mesh, lr=cfg.lr, cam_lr=cfg.cam_lr,
        optimize_camera=True, grad_buckets=buckets, lights=lights,
        use_custom_vjp=cfg.use_custom_vjp)

    losses, psnrs = [], []
    state = None
    cam_est = None
    last = cfg.frames if end_frame is None else min(end_frame, cfg.frames)
    for f in range(start_frame, last):
        cam_true = cam_path(f / cfg.fps)
        target = render_soft_image_sharded(
            truth, cam_true, settings, cfg.height, cfg.width,
            cfg.num_samples, mesh, lights=lights).reshape(-1, 3)

        # this frame's pose estimate: the true pose plus the carried error
        cam_est = dataclasses.replace(cam_true, yaw=cam_true.yaw + cam_off[0],
                                      pitch=cam_true.pitch + cam_off[1])
        if state is None:
            state = init_fn(soft, cam_est)
            if resume:
                # Adam's moments too, so a resumed run continues the
                # uninterrupted trajectory
                restored = load_opt_state(resume, state.template(), device)
                if restored is not None:
                    state.load(restored)

        loss = None
        for _ in range(cfg.steps_per_frame):
            o_c, d_c = camera_frame_rays(cam_est, cfg.height, cfg.width)
            soft, cam_est, state, loss = step_fn(soft, cam_est, state, o_c,
                                                 d_c, target)
        # the pose error after this frame's descent, carried to the next
        cam_off = torch.stack([cam_est.yaw - cam_true.yaw,
                               cam_est.pitch - cam_true.pitch])

        lv = float(loss)
        if not (lv == lv and abs(lv) != float("inf")):
            raise FloatingPointError(f"config5: non-finite loss at frame {f}")
        losses.append(lv)

        pred = render_soft_image_sharded(
            soft, cam_true, settings, cfg.height, cfg.width,
            cfg.num_samples, mesh, lights=lights)
        p = float(psnr(pred, target.reshape(cfg.height, cfg.width, 3)))
        psnrs.append(p)
        sink.emit(frame=f, loss=lv, psnr=p,
                  yaw_err=float(cam_off[0]), pitch_err=float(cam_off[1]))

        if out_dir and process_rank() == 0:
            os.makedirs(out_dir, exist_ok=True)
            if save_frames:
                from vxtpu_torch.utils import save_png

                save_png(os.path.join(out_dir, f"frame_{f:04d}.png"), pred)
            if cfg.ckpt_every and ((f + 1) % cfg.ckpt_every == 0
                                   or f == cfg.frames - 1):
                # zlib over the GBs of a 512^3 scene and its moments would
                # take minutes: grids beyond 128^3 are saved uncompressed
                save_checkpoint(
                    os.path.join(out_dir, "ckpt.npz"), soft, cam_est,
                    step=f + 1, extra={"cam_off": cam_off},
                    opt_state=state.opt_state(),
                    compress=X * Y * Z <= 128 ** 3)

    return dict(losses=losses, psnrs=psnrs,
                yaw_err=float(cam_off[0]), pitch_err=float(cam_off[1]),
                soft=soft, cam=cam_est)
