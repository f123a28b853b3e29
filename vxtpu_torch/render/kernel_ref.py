"""The reference march: the textbook per-ray 3D-DDA (Amanatides & Woo),
with no empty-space skipping (counterpart of ``vxtpu/render/kernel_ref.py``,
the oracle that every fast march is held to, and the CLI's ``--kernel
ref``).

vxtpu runs one ``lax.while_loop`` per ray under ``vmap``. Here every ray
advances in one batched loop under a ``done`` mask; a ray's state changes
only while it is not done, so each ray takes exactly the steps of its own
loop. The loop checks whether every ray is done once every
``_CHECK_EVERY`` steps (each check is a host sync) and stops after
``max_steps`` steps. Plain PyTorch tensor code on the DDA primitives of
``render/dda.py``, in vxtpu's order of float operations: an oracle, not a
fast path.
"""

from __future__ import annotations

import functools

import torch

from vxtpu_torch.render import dda
from vxtpu_torch.render.types import HitRecord
from vxtpu_torch.world.grid import in_bounds, occupancy_at

BIG_T = 1e30
# steps between the loop's tests for "every ray done" (host syncs)
_CHECK_EVERY = 8


def march_ref(o: torch.Tensor, d: torch.Tensor, occ_flat: torch.Tensor,
              dims: tuple[int, int, int], max_steps: int,
              t_max: torch.Tensor | None = None) -> HitRecord:
    """March rays o, d [N, 3] through the flat occupancy; HitRecord [N].

    t_max: optional [N], where each ray ends (a shadow ray stops at its
    light); a crossing beyond it is a miss. ``steps`` counts the DDA
    advances after the entry voxel's read."""
    n = o.shape[0]
    if t_max is None:
        t_max = torch.full((n,), BIG_T, dtype=o.dtype, device=o.device)
    t_enter, t_exit, valid = dda.ray_grid_clip(o, d, dims)
    v, t_next, t_delta, step = dda.dda_init(o, d, t_enter, dims)
    t_end = torch.minimum(t_exit, t_max)

    # the voxel holding the entry point may itself be solid
    hit = valid & (occupancy_at(occ_flat, v, dims) > 0) & (t_enter <= t_max)
    n0 = torch.where(dda.entry_face_mask(o, d, dims), -torch.sign(d),
                     0.0).to(torch.float32)
    t_hit = torch.where(hit, t_enter, BIG_T)
    normal = torch.where(hit[..., None], n0, 0.0)
    steps = torch.zeros((n,), dtype=torch.int32, device=o.device)
    done = hit | ~valid

    for i in range(max_steps):
        if i % _CHECK_EVERY == 0 and bool(done.all()):
            break
        active = ~done
        v2, t_next2, t_cross, mask = dda.dda_advance(v, t_next, t_delta,
                                                     step)
        inside = in_bounds(v2, dims)
        past_end = t_cross > t_end
        new_hit = active & inside & ~past_end & (
            occupancy_at(occ_flat, v2, dims) > 0)
        a3 = active[..., None]
        v = torch.where(a3, v2, v)
        t_next = torch.where(a3, t_next2, t_next)
        hit = hit | new_hit
        t_hit = torch.where(new_hit, t_cross, t_hit)
        normal = torch.where(new_hit[..., None], dda.face_normal(mask, step),
                             normal)
        steps = steps + active.to(torch.int32)
        done = done | new_hit | (active & (~inside | past_end))
    return HitRecord(hit=hit, t=t_hit, voxel=v, normal=normal, steps=steps)


def make_march_ref(occ_flat, dims, settings, accel=None):
    """Pipeline march factory: ``march(o, d, t_max=None) -> HitRecord``.
    The reference march skips no empty space, so ``accel`` is unused."""
    del accel
    return functools.partial(march_ref, occ_flat=occ_flat, dims=dims,
                             max_steps=settings.resolve_max_steps(dims))
