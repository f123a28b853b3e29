"""Rays sharded over a ``torch.distributed`` process group, the grid
replicated (counterpart of ``vxtpu/engine/sharding.py``).

vxtpu runs one SPMD program over a device mesh with ``shard_map``; here
every rank is a process (``engine/platform.py``: NCCL between cards,
gloo between CPU processes or ranks that share a card) and runs the same
code on its own block of rays. Rank r of a mesh of n takes the contiguous
r-th of n equal blocks (vxtpu's ``P(RAY_AXIS)``), padded with +z rays to
a multiple of n; a frame comes back to every rank by ``all_gather`` and
the padding is dropped. Rendering needs nothing else; a train step
all-reduces the loss and the gradients of the grid (and the camera) in
buckets, each bucket's collective started as soon as its backward ends,
and runs the same Adam update on every rank.

A collective the backend cannot run raises; nothing is copied to the CPU
or run unsharded in its place.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.camera.rays import generate_rays
from vxtpu_torch.engine import platform
from vxtpu_torch.render.occmask import mask_segment_bounds
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.render.soft import SoftGrid, render_soft_rays
from vxtpu_torch.render.soft_kernel import (MortonSoftGrid,
                                            render_soft_rays_kernel)
from vxtpu_torch.render.vjp import render_soft_rays_fast
from vxtpu_torch.train import kernel_adam
from vxtpu_torch.train.loop import (ADAM_EPS, BETAS, CAM_FIELDS,
                                    init_opt_state, read_opt_state,
                                    state_params, write_opt_state)

# rays x samples of one chunk of the plain soft renderer in
# render_soft_image_sharded (its [N, S] tensors stay ~tens of MB each)
SOFT_CHUNK_SAMPLES = 1 << 22


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The first ``size`` ranks of the process group. ``rank`` is this
    process's index in it, -1 on a rank outside it (which must not call
    the mesh's functions); ``device`` is where this rank works."""

    group: object
    size: int
    rank: int
    device: torch.device

    @property
    def member(self) -> bool:
        return self.rank >= 0


def make_mesh(n_devices: int | None = None) -> Mesh:
    """A 1D mesh over the whole process group, or its first n ranks.
    Every rank of the group must call it (a sub-group is made
    collectively); raises if n is larger than the group."""
    world = platform.world_size() if dist.is_initialized() else 0
    if not world:
        raise RuntimeError("make_mesh needs a process group: call "
                           "engine.platform.init_multihost first")
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise RuntimeError(f"requested a mesh of {n} ranks but the process "
                           f"group has {world}")
    group = dist.group.WORLD if n == world else dist.new_group(
        list(range(n)))
    rank = dist.get_rank()
    return Mesh(group=group, size=n, rank=rank if rank < n else -1,
                device=platform.rank_device())


def _check_member(mesh: Mesh) -> None:
    if not mesh.member:
        raise ValueError(f"rank {dist.get_rank()} is not in this mesh of "
                         f"{mesh.size} ranks")


def _pad_rays(o, d, n_shards: int):
    """Pad the ray count to a multiple of n_shards with +z rays from the
    origin (dropped after the gather)."""
    n = o.shape[0]
    n_pad = -n % n_shards
    if n_pad:
        o = torch.cat([o, torch.zeros((n_pad, 3), dtype=o.dtype,
                                      device=o.device)])
        plus_z = torch.tensor([0.0, 0.0, 1.0], dtype=o.dtype,
                              device=o.device)
        d = torch.cat([d, plus_z.expand(n_pad, 3)])
    return o, d, n


def _shard(mesh: Mesh, *xs):
    """This rank's contiguous block of each [N, ...] tensor."""
    n_local = xs[0].shape[0] // mesh.size
    sl = slice(mesh.rank * n_local, (mesh.rank + 1) * n_local)
    return [x[sl] for x in xs]


def _gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's equal block of x, concatenated in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def _sharded_frame(mesh: Mesh, cam: Camera, height: int, width: int,
                   render_block) -> torch.Tensor:
    """[H, W, 3]: the camera's rays, padded and sharded; this rank renders
    its block with ``render_block(o, d) -> rgb``; the blocks gathered."""
    _check_member(mesh)
    o, d = generate_rays(cam, height, width)
    o, d, n_real = _pad_rays(o, d, mesh.size)
    o_s, d_s = _shard(mesh, o, d)
    rgb = _gather(mesh, render_block(o_s, d_s))
    return rgb[:n_real].reshape(height, width, 3)


def render_image_sharded(march_factory, grid, cam: Camera, lights, settings,
                         height: int, width: int, mesh: Mesh, accel=None):
    """[H, W, 3] frame of the composable pipeline (``march_factory`` as
    ``app.run.kernel_factory`` gives it) with rays sharded over the mesh;
    grid and ``accel`` replicated. The same values as
    ``pipeline.render_image``."""
    from vxtpu_torch.render.pipeline import render_rays

    dims = grid.dims
    occ_flat = grid.occupancy.reshape(-1)
    march = march_factory(occ_flat, dims, settings, accel)
    albedo = grid.albedo()

    def block(o_s, d_s):
        return render_rays(march, o_s, d_s, albedo, dims, lights, settings,
                           material_ids=occ_flat)[0]

    return _sharded_frame(mesh, cam, height, width, block)


@torch.no_grad()
def render_soft_image_sharded(soft: SoftGrid, cam: Camera,
                              settings: RenderSettings, height: int,
                              width: int, num_samples: int, mesh: Mesh,
                              lights=None) -> torch.Tensor:
    """[H, W, 3] soft-volumetric frame with rays sharded over the mesh and
    the grid replicated (config 5's targets and its PSNR frame). Each rank
    runs the plain soft renderer on its block in chunks of
    SOFT_CHUNK_SAMPLES samples: no sum crosses rays, so chunks change no
    value, and unchunked a 1080p block at S = 192 does not fit a card."""
    chunk = max(1, SOFT_CHUNK_SAMPLES // num_samples)

    def block(o_s, d_s):
        return torch.cat([
            render_soft_rays(soft, o_s[i:i + chunk], d_s[i:i + chunk],
                             settings, num_samples, lights)[0]
            for i in range(0, o_s.shape[0], chunk)])

    return _sharded_frame(mesh, cam, height, width, block)


def render_frame_fused_sharded(accel, mats, dims, cam: Camera, lights,
                               settings: RenderSettings, height: int,
                               width: int, mesh: Mesh,
                               inkernel_shadows: bool = True,
                               rgb8: bool = False) -> torch.Tensor:
    """[H, W, 3] frame through the fused kernel K1 (``render/fused.py``)
    with rays sharded over the mesh: each rank launches it on its own
    block; the Morton and material tables are replicated. Equal to
    ``render_frame_fused`` (one thread a ray: a block changes no ray's
    value)."""
    from vxtpu_torch.render.fused import render_rays_fused

    def block(o_s, d_s):
        return render_rays_fused(o_s, d_s, accel, mats, dims, lights,
                                 settings, inkernel_shadows=inkernel_shadows,
                                 rgb8=rgb8)[0]

    return _sharded_frame(mesh, cam, height, width, block)


def _world_rays(cam: Camera, o_c: torch.Tensor, d_c: torch.Tensor):
    """Camera-frame rays -> world rays (the train step and the bounds pass
    see the same geometry)."""
    fwd, right, up = cam.basis()
    R = torch.stack([fwd, right, up], dim=1)          # [3 (world), 3 (cam)]
    return cam.pos.expand(o_c.shape) + o_c, d_c @ R.t()


def compute_mask_bounds(mask, mask_df, cam: Camera, o_c, d_c,
                        mask_scale: int = 4):
    """Occupancy-band bounds (t0, t1) of the masked train step for the
    current camera: run once a step, before the step."""
    o_w, d_w = _world_rays(cam, o_c, d_c)
    return mask_segment_bounds(mask, mask_scale, o_w, d_w, df_flat=mask_df)


def camera_frame_rays(cam: Camera, height: int, width: int):
    """Rays in camera-relative form: zero origin offsets and directions as
    coefficients of the (forward, right, up) basis, so a step that turns
    them back into world rays keeps the pose differentiable."""
    o, d = generate_rays(cam, height, width)
    fwd, right, up = cam.basis()
    R = torch.stack([fwd, right, up], dim=1)
    return torch.zeros_like(o), d @ R


class ShardedTrainState:
    """The sharded step's optimizer state: the parameters it updates (the
    scene's tensors, and the camera's) and a ``kernel_adam.Adam`` over
    them, identical on every rank. ``opt_state()`` gives it in optax's
    leaf order (the scene's group, then the camera's, as vxtpu's
    ``(opt.init(soft), cam_opt.init(cam))``) for the checkpoint;
    ``template()`` and ``load()`` restore it."""

    def __init__(self, model, cam: Camera, lr: float, cam_lr: float,
                 optimize_camera: bool):
        self.cls = type(model)
        self.params = [getattr(model, f.name).detach().clone()
                       .requires_grad_(True)
                       for f in dataclasses.fields(model)]
        self.cam_params = [getattr(cam, f).detach().clone()
                           .requires_grad_(optimize_camera)
                           for f in CAM_FIELDS]
        groups = [dict(params=self.params, lr=lr, name="soft",
                       interleaved=self.cls is MortonSoftGrid)]
        if optimize_camera:
            groups.append(dict(params=self.cam_params, lr=cam_lr, name="cam",
                               interleaved=False))
        self.opt = kernel_adam.Adam(groups, betas=BETAS, eps=ADAM_EPS)

    def model(self, detach: bool = False):
        return self.cls(*[p.detach() if detach else p for p in self.params])

    def camera(self, detach: bool = False) -> Camera:
        return Camera(*[p.detach() if detach else p
                        for p in self.cam_params])

    def opt_state(self) -> list:
        return read_opt_state(self.opt)

    def template(self) -> list:
        groups = [state_params(self.model())]
        if len(self.opt.param_groups) > 1:
            groups.append(self.cam_params)
        return init_opt_state(groups)

    def load(self, state: list) -> None:
        write_opt_state(self.opt, state)

    def adopt(self, model, cam: Camera) -> None:
        """Make ``model`` and ``cam`` the step's parameters: tensors that
        are not already the state's own (a camera made anew each frame)
        are copied into them."""
        news = [getattr(model, f.name) for f in dataclasses.fields(model)]
        news += [getattr(cam, f) for f in CAM_FIELDS]
        with torch.no_grad():
            for p, x in zip(self.params + self.cam_params, news, strict=True):
                if x.data_ptr() != p.data_ptr():
                    p.copy_(x)


def make_sharded_train_step(settings: RenderSettings, num_samples: int,
                            mesh: Mesh, lr: float = 5e-2,
                            cam_lr: float = 1e-3,
                            optimize_camera: bool = True,
                            grad_buckets: int = 1, lights=None,
                            use_custom_vjp: bool = False,
                            use_mask: bool = False, mask_scale: int = 4,
                            field_kernel: bool = False):
    """Config 5's train step: rays sharded, grid replicated, loss and
    gradients all-reduced, the same Adam update on every rank.

    grad_buckets > 1 overlaps the all-reduce with the backward: the
    rank's rays split into B buckets (the largest divisor of the local ray
    count that is <= grad_buckets), and each bucket's gradients, flattened
    into one buffer with its loss, go out as an asynchronous all-reduce as
    soon as its backward ends; all are waited for before Adam and summed
    in bucket order (summing the reductions equals reducing the sum up to
    float reassociation). Each bucket in flight holds a full grid's
    gradient.

    ``lights`` (replicated, not optimised) turns on the lit soft mode;
    ``use_custom_vjp`` renders through ``render/vjp.py`` (O(N_rays +
    grid) memory: config 5 at 1080p); ``field_kernel`` trains a
    MortonSoftGrid through the sampling kernels K3/K4
    (``render_soft_rays_kernel``) on each rank's rays; ``use_mask`` trains
    the masked model: step_fn then takes trailing ``mask, t0, t1``, the
    coarse mask (replicated) and every ray's band from
    compute_mask_bounds (sharded with the rays). vxtpu's optax arguments
    and TPU window sizes have no counterpart.

    Returns (init_fn, step_fn):
      init_fn(soft, cam) -> ShardedTrainState
      step_fn(soft, cam, state, o, d, target[, mask, t0, t1])
          -> (soft, cam, state, loss)
    o, d (camera-frame rays, ``camera_frame_rays``) and target [N, 3] are
    the whole frame's, N a multiple of the mesh size; each rank takes its
    block. The soft and cam returned are the state's parameters, which the
    next step updates in place (clone them to keep a step's values)."""
    _check_member(mesh)

    def init_fn(soft, cam: Camera) -> ShardedTrainState:
        return ShardedTrainState(soft, cam, lr, cam_lr, optimize_camera)

    def local_loss(model, cam_p, o_s, d_s, tgt_s, n_total, mask, bounds):
        o_w, d_w = _world_rays(cam_p, o_s, d_s)
        masked = dict(mask=mask, mask_scale=mask_scale, seg_bounds=bounds)
        if field_kernel:
            pred = render_soft_rays_kernel(model, o_w, d_w, settings,
                                           num_samples, lights=lights,
                                           **masked)
        elif use_custom_vjp:
            pred = render_soft_rays_fast(model, o_w, d_w, settings,
                                         num_samples, lights, **masked)
        else:
            pred, _ = render_soft_rays(model, o_w, d_w, settings,
                                       num_samples, lights, **masked)
        # the mean over all rays: the local sum over n_total, all-reduced
        return torch.sum((pred - tgt_s) ** 2) / (n_total * 3.0)

    def value_and_grad(soft, cam: Camera, state: ShardedTrainState, o, d,
                       target, *mask_args):
        """(loss, gradients of the state's scene tensors, then the
        camera's when it is optimised), all-reduced over the mesh."""
        if len(mask_args) != (3 if use_mask else 0):
            raise TypeError("step_fn takes mask, t0, t1 exactly when the "
                            "step was made with use_mask=True")
        n_total = o.shape[0]
        if n_total % mesh.size:
            raise ValueError(f"{n_total} rays do not split evenly over "
                             f"{mesh.size} ranks (padding rays would "
                             f"change the mean loss)")
        state.adopt(soft, cam)
        mask = mask_args[0] if use_mask else None
        shards = _shard(mesh, o, d, target, *mask_args[1:])
        o_s, d_s, tgt_s = shards[:3]
        n_local = o_s.shape[0]
        B = max(1, min(grad_buckets, n_local))
        while n_local % B:
            B -= 1
        nb = n_local // B
        model, cam_p = state.model(), state.camera()
        inputs = state.params + (state.cam_params if optimize_camera else [])
        pending = []
        for b in range(B):
            sl = slice(b * nb, (b + 1) * nb)
            bounds = (shards[3][sl], shards[4][sl]) if use_mask else None
            loss_b = local_loss(model, cam_p, o_s[sl], d_s[sl], tgt_s[sl],
                                n_total, mask, bounds)
            grads = torch.autograd.grad(loss_b, inputs, allow_unused=True,
                                        materialize_grads=True)
            buf = torch.cat([g.reshape(-1) for g in grads]
                            + [loss_b.detach().reshape(1)])
            del grads
            pending.append((buf, dist.all_reduce(buf, group=mesh.group,
                                                 async_op=True)))
        total = None
        for buf, work in pending:
            work.wait()
            total = buf if total is None else total + buf
        del pending
        grads, at = [], 0
        for p in inputs:
            grads.append(total[at:at + p.numel()].view_as(p))
            at += p.numel()
        return total[at], grads

    def step_fn(soft, cam: Camera, state: ShardedTrainState, o, d, target,
                *mask_args):
        loss, grads = value_and_grad(soft, cam, state, o, d, target,
                                     *mask_args)
        for p, g in zip(state.params + state.cam_params, grads):
            p.grad = g
        state.opt.step()
        state.opt.zero_grad(set_to_none=True)
        return state.model(detach=True), state.camera(detach=True), state, \
            loss

    step_fn.value_and_grad = value_and_grad
    return init_fn, step_fn
