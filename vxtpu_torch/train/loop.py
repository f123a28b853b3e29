"""Inverse rendering: fit a SoftGrid (voxel densities and colours), and
optionally the camera pose, to target images (counterpart of
``vxtpu/train/loop.py``).

  fit_soft        one target view (+ optional camera-pose refinement);
  fit_soft_views  N posed views, rays drawn from all of them.

PyTorch runs eagerly, so a step is a plain loop body: loss, backward,
Adam (vxtpu's ``optax.adam``: betas (0.9, 0.999), eps 1e-8, the same
update up to rounding) as ``train/kernel_adam.py:Adam``, torch.optim.Adam
whose update on the card is one hand-written kernel (one read of each
parameter, its gradient and both moments). With ``field_kernel`` the scene is
trained in fine-voxel Morton layout through the sampling kernels
(``render/soft_kernel.py``) with the Morton TV prior (on the card its
kernel pair, ``train/kernel_tv.py``), and Adam sees one tensor, its
[D^3, 4] table; otherwise through the plain soft renderer
and autograd. With ``occ_mask`` the fit trains the masked soft model
(``render/occmask.py``): the mask starts all ones, is rebuilt from the
current density every ``mask_refresh`` steps, and each step samples only
its rays' occupied bands, found by a bounds pass before the step.

The optimizer state handed in and out (``opt_state``) is a list of
``AdamGroupState`` in optax's order: one group (``soft``), or two
(``cam``, then ``soft``) when the camera is optimised, as
``optax.multi_transform`` keeps them; within a group the step count and
the moments of each parameter in vxtpu's field order. For the
field-kernel fit those are vxtpu's two planar tables (sigma [D^3], rgb
[3, D^3]): the interleaved table's moments are split into them where the
live optimizer's state is read (``read_opt_state``) and joined back where
it is written (``write_opt_state``), and nowhere else. So a state saved by
either package resumes in the other (``train/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.camera.rays import generate_rays
from vxtpu_torch.render import kernel_sample as ks
from vxtpu_torch.render import occmask
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.render.soft import SoftGrid, render_soft_rays
from vxtpu_torch.render.soft_kernel import (MortonSoftGrid,
                                            render_soft_rays_kernel)
from vxtpu_torch.render.vjp import render_soft_rays_fast
from vxtpu_torch.train import kernel_adam
from vxtpu_torch.train.kernel_tv import tv_prior
from vxtpu_torch.train.loss import mse, tv_loss

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
CAM_FIELDS = ("pos", "yaw", "pitch", "fov_y")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """vxtpu's TrainConfig without ``field_window`` (a TPU window size).
    ``use_custom_vjp`` renders through ``render/vjp.py``'s O(N_rays +
    grid) backward; ``field_kernel`` takes precedence over it."""

    lr: float = 5e-2
    steps: int = 200
    num_samples: int = 128          # ray samples for the soft renderer
    tv_sigma: float = 1e-4          # TV regulariser weight on densities
    tv_rgb: float = 1e-5
    ray_batch: int = 0              # 0 = all rays every step; else minibatch
    optimize_camera: bool = False
    cam_lr: float = 1e-3
    seed: int = 0
    nan_check_every: int = 25       # pull the loss to the host every k
    use_custom_vjp: bool = False
    occ_mask: bool = False          # train the occupancy-masked soft model
    mask_scale: int = 4             # G: mask cell side in voxels
    mask_refresh: int = 50          # rebuild the mask every k steps
    mask_tau: float = 0.01          # density threshold of an occupied cell
    field_kernel: bool = False      # train through the sampling kernels


@dataclasses.dataclass
class AdamGroupState:
    """Adam's state for one parameter group: the step count and the first
    and second moments, one tensor per parameter."""

    count: int
    mu: list
    nu: list


def _loss_fn(model, cam: Camera, o, d, target, hw,
             settings: RenderSettings, cfg: TrainConfig, mask=None,
             bounds=None):
    """target is flat [N, 3]. When the camera is optimised the rays come
    from the current pose (full image, hw = (H, W)), so the pose gets
    gradients through ray generation. ``mask`` and ``bounds`` (t0, t1):
    the masked model's coarse mask and the rays' occupied bands
    (cfg.occ_mask)."""
    if cfg.optimize_camera:
        o, d = generate_rays(cam, *hw)
    masked = dict(mask=mask, mask_scale=cfg.mask_scale, seg_bounds=bounds)
    if cfg.field_kernel:
        pred = render_soft_rays_kernel(model, o, d, settings,
                                       cfg.num_samples, **masked)
        loss = mse(pred, target)
        if cfg.tv_sigma or cfg.tv_rgb:
            loss = loss + tv_prior(model.tab, cfg.tv_sigma, cfg.tv_rgb)
        return loss
    if cfg.use_custom_vjp:
        pred = render_soft_rays_fast(model, o, d, settings, cfg.num_samples,
                                     **masked)
    else:
        pred, _ = render_soft_rays(model, o, d, settings, cfg.num_samples,
                                   **masked)
    loss = mse(pred, target)
    if cfg.tv_sigma:
        loss = loss + cfg.tv_sigma * tv_loss(model.sigma_raw)
    if cfg.tv_rgb:
        loss = loss + cfg.tv_rgb * tv_loss(model.rgb_raw)
    return loss


def make_optimizer(cfg: TrainConfig, params, cam_params=None):
    """The Adam that the fit uses: ``params`` (the scene's tensors: a
    SoftGrid's two, or with ``cfg.field_kernel`` a MortonSoftGrid's one
    table) at ``cfg.lr``, and with ``cfg.optimize_camera`` the camera's
    four tensors at ``cfg.cam_lr`` (every leaf, as optax treats them)."""
    groups = [dict(params=list(params), lr=cfg.lr, name="soft",
                   interleaved=cfg.field_kernel)]
    if cfg.optimize_camera:
        groups.insert(0, dict(params=list(cam_params), lr=cfg.cam_lr,
                              name="cam", interleaved=False))
    return kernel_adam.Adam(groups, betas=BETAS, eps=ADAM_EPS)


def state_params(model) -> list:
    """The tensors that the optimizer state holds moments for, in optax's
    order: a SoftGrid's fields, or a MortonSoftGrid's planar views
    (sigma_tab, rgb_tab) of its one table. ``init_opt_state([...])`` of
    them is the template of ``checkpoint.load_opt_state``."""
    if isinstance(model, MortonSoftGrid):
        return [model.sigma_tab, model.rgb_tab]
    return [getattr(model, f.name) for f in dataclasses.fields(model)]


def init_opt_state(groups) -> list:
    """A fresh state (count 0, zero moments) for parameter groups given
    as lists of tensors, in optax's order: the template that
    ``checkpoint.load_opt_state`` fills."""
    return [AdamGroupState(0, [torch.zeros_like(p) for p in ps],
                           [torch.zeros_like(p) for p in ps])
            for ps in groups]


def read_opt_state(opt: torch.optim.Optimizer) -> list:
    """The live optimizer's state in optax's order; an interleaved
    table's moments split into vxtpu's planar tables."""
    out = []
    for group in opt.param_groups:
        ps = group["params"]
        states = [opt.state.get(p, {}) for p in ps]
        count = int(states[0]["step"]) if states[0] else 0
        mu, nu = [], []
        for s, p in zip(states, ps):
            m = s["exp_avg"].detach() if s else torch.zeros_like(p)
            v = s["exp_avg_sq"].detach() if s else torch.zeros_like(p)
            if group["interleaved"]:
                mu += ks.split_table(m)
                nu += ks.split_table(v)
            else:
                mu.append(m.clone())
                nu.append(v.clone())
        out.append(AdamGroupState(count, mu, nu))
    return out


def write_opt_state(opt: torch.optim.Optimizer, state: list) -> None:
    """Load ``state`` (optax's order, as ``read_opt_state`` gives it) into
    the live optimizer; vxtpu's planar moments are joined into an
    interleaved table's."""
    if len(state) != len(opt.param_groups):
        raise ValueError(f"optimizer state has {len(state)} groups, the "
                         f"optimizer {len(opt.param_groups)}")
    for group, gs in zip(opt.param_groups, state):
        mu, nu = gs.mu, gs.nu
        if group["interleaved"]:
            if len(mu) != 2 * len(group["params"]):
                raise ValueError(f"optimizer state has {len(mu)} moments, "
                                 f"the table needs 2 (sigma, rgb)")
            mu = [ks.interleave_tables(*mu[i:i + 2])
                  for i in range(0, len(mu), 2)]
            nu = [ks.interleave_tables(*nu[i:i + 2])
                  for i in range(0, len(nu), 2)]
        for p, m, v in zip(group["params"], mu, nu, strict=True):
            if m.shape != p.shape or v.shape != p.shape:
                raise ValueError(f"optimizer moment of shape "
                                 f"{tuple(m.shape)} for a parameter of "
                                 f"shape {tuple(p.shape)}")
            if gs.count == 0:
                opt.state.pop(p, None)
                continue
            opt.state[p] = {
                "step": torch.tensor(float(gs.count), dtype=torch.float32),
                "exp_avg": m.detach().to(p.device, torch.float32).clone(),
                "exp_avg_sq": v.detach().to(p.device, torch.float32).clone(),
            }


def fit_soft_views(soft: SoftGrid, cams: list, target_imgs: torch.Tensor,
                   settings: RenderSettings, cfg: TrainConfig,
                   log_fn: Callable[[int, float], None] | None = None,
                   opt_state=None, step_hook=None):
    """Fit a soft grid to V posed views (cams; target_imgs [V, H, W, 3]);
    each step draws a ray minibatch from all views' rays (cfg.ray_batch;
    0 = every ray of every view). Poses are known and fixed. Returns
    (soft', losses [steps], opt_state')."""
    if target_imgs.dim() != 4 or target_imgs.shape[0] != len(cams):
        raise ValueError("target_imgs must be [V, H, W, 3] for V cameras")
    V, H, W = target_imgs.shape[:3]
    rays = [generate_rays(c, H, W) for c in cams]
    o = torch.cat([r[0] for r in rays])
    d = torch.cat([r[1] for r in rays])
    cfg = dataclasses.replace(cfg, optimize_camera=False)
    soft, _, losses, opt_state = _fit_rays(
        soft, cams[0], o, d, target_imgs.reshape(-1, 3), (H, W), settings,
        cfg, log_fn, opt_state, step_hook)
    return soft, losses, opt_state


def fit_soft(soft: SoftGrid, cam: Camera, target_img: torch.Tensor,
             settings: RenderSettings, cfg: TrainConfig,
             log_fn: Callable[[int, float], None] | None = None,
             opt_state=None, step_hook=None):
    """Fit soft grid (and, with cfg.optimize_camera, the camera pose) to
    target_img [H, W, 3] seen from cam. ``opt_state`` resumes Adam from a
    checkpoint; ``step_hook(i, loss)`` is called after every step (the
    loss tensor, not synchronised). Returns (soft', cam', losses [steps],
    opt_state')."""
    H, W = target_img.shape[:2]
    o, d = generate_rays(cam, H, W)
    return _fit_rays(soft, cam, o, d, target_img.reshape(-1, 3), (H, W),
                     settings, cfg, log_fn, opt_state, step_hook)


def _fit_rays(soft: SoftGrid, cam: Camera, o, d, target, hw,
              settings: RenderSettings, cfg: TrainConfig,
              log_fn=None, opt_state=None, step_hook=None):
    """The loop. Minibatch indices come from a torch.Generator seeded
    with cfg.seed: the same seed draws other rays than vxtpu's
    jax.random, so minibatched runs of the two packages differ."""
    minibatched = bool(cfg.ray_batch) and cfg.ray_batch < o.shape[0]
    if cfg.optimize_camera and minibatched:
        raise ValueError("optimize_camera requires full-image steps "
                         "(ray_batch=0)")
    cls = MortonSoftGrid if cfg.field_kernel else SoftGrid
    start = MortonSoftGrid.from_soft(soft) if cfg.field_kernel else soft
    params = [getattr(start, f.name).detach().clone().requires_grad_(True)
              for f in dataclasses.fields(start)]
    model = cls(*params)
    cam_params = [getattr(cam, f).detach().clone().requires_grad_(
        cfg.optimize_camera) for f in CAM_FIELDS]
    opt = make_optimizer(cfg, params, cam_params)
    if opt_state is not None:
        write_opt_state(opt, opt_state)

    mask = mask_df = None
    if cfg.occ_mask:
        mask = occmask.mask_all_ones(soft.dims, cfg.mask_scale, o.device)
        mask_df = occmask.mask_distance_field(mask)
    gen = torch.Generator().manual_seed(cfg.seed)
    n = o.shape[0]
    losses = []
    for i in range(cfg.steps):
        if (cfg.occ_mask and cfg.mask_refresh and i
                and i % cfg.mask_refresh == 0):
            mask = occmask.occupancy_mask_from_soft(
                model, cfg.mask_scale, tau=cfg.mask_tau, dilate=1)
            mask_df = occmask.mask_distance_field(mask)
        if minibatched:
            idx = torch.randint(0, n, (cfg.ray_batch,), generator=gen)
            idx = idx.to(o.device)
            o_b, d_b, t_b = o[idx], d[idx], target[idx]
        else:
            o_b, d_b, t_b = o, d, target
        bounds = None
        if cfg.occ_mask:
            # the bands of this step's rays, from the current pose
            o_r, d_r = (generate_rays(Camera(*cam_params), *hw)
                        if cfg.optimize_camera else (o_b, d_b))
            bounds = occmask.mask_segment_bounds(
                mask, cfg.mask_scale, o_r.detach(), d_r.detach(),
                df_flat=mask_df)
        opt.zero_grad(set_to_none=True)
        loss = _loss_fn(model, Camera(*cam_params), o_b, d_b, t_b, hw,
                        settings, cfg, mask, bounds)
        loss.backward()
        opt.step()
        loss = loss.detach()
        losses.append(loss)
        if step_hook is not None:
            step_hook(i, loss)
        if cfg.nan_check_every and (i % cfg.nan_check_every == 0
                                    or i == cfg.steps - 1):
            lv = float(loss)
            if not (lv == lv and abs(lv) != float("inf")):
                raise FloatingPointError(
                    f"fit_soft: non-finite loss {lv} at step {i}")
        if log_fn is not None and (i % 20 == 0 or i == cfg.steps - 1):
            log_fn(i, float(loss))
    losses = [float(v) for v in losses]
    out = cls(*[p.detach() for p in params])
    if cfg.field_kernel:
        out = out.to_soft()
    cam_out = Camera(*[p.detach() for p in cam_params])
    return out, cam_out, losses, read_opt_state(opt)
