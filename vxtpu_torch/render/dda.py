"""Ray-box clipping and the 3D-DDA primitives (Amanatides & Woo) of the
batched march (counterpart of ``vxtpu/render/dda.py``). The CUDA marches
keep their own DDA in ``csrc/``; ``render/kernel_xla.py`` steps with
these, in vxtpu's order of float operations.

``ray_grid_clip`` is differentiable: the soft renderers sample each ray
over its clipped segment, and the gradient of the segment bounds reaches
the ray origin and direction through it.
"""

from __future__ import annotations

import torch

from vxtpu_torch.device import device_const

BIG = 1e30
EPS_DIR = 1e-12
# nudge past the entry plane so floor() lands in the first interior voxel
ENTRY_EPS = 1e-4
# t_next of an axis the ray never crosses
NEVER = 3.0e30


def relu_like_jax(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) as ``jnp.maximum(x, 0.0)`` differentiates it: half the
    gradient where x == 0 (``torch.clamp`` would pass all of it)."""
    return torch.maximum(x, torch.zeros_like(x))


def safe_inverse(d: torch.Tensor) -> torch.Tensor:
    """1/d with zero components mapped to a signed big-but-finite value
    (vxtpu's ``utils.safe_inverse``): keeps the slab test free of
    inf * 0 = nan for axis-aligned rays."""
    sign = torch.where(d >= 0, 1.0, -1.0).to(d.dtype)
    mag = torch.clamp(d.abs(), min=EPS_DIR)
    return torch.clamp(sign / mag, -BIG, BIG)


def ray_grid_clip(o: torch.Tensor, d: torch.Tensor,
                  dims: tuple[int, int, int]):
    """Slab-test rays against the grid AABB [0,X]x[0,Y]x[0,Z].

    Returns (t_enter, t_exit, valid): enter/exit parameters (t_enter >= 0)
    and a bool mask; rays starting inside get t_enter = 0. The reductions
    are amax/amin, which split the gradient evenly over tied axes as
    jnp.max/jnp.min do (``max(dim)`` would give it all to one index)."""
    inv = safe_inverse(d)
    bmax = torch.tensor(dims, dtype=o.dtype, device=o.device)
    t0 = (0.0 - o) * inv
    t1 = (bmax - o) * inv
    tnear = torch.minimum(t0, t1)
    tfar = torch.maximum(t0, t1)
    t_enter = relu_like_jax(tnear.amax(dim=-1))
    t_exit = tfar.amin(dim=-1)
    valid = t_enter <= t_exit
    return t_enter, t_exit, valid


def dda_init(o: torch.Tensor, d: torch.Tensor, t_start: torch.Tensor,
             dims: tuple[int, int, int]):
    """DDA state at parameter t_start [...]: (voxel int32 [..., 3], t_next
    [..., 3], t_delta [..., 3], step int32 [..., 3]). t_next[a] is the t
    of the next boundary crossing on axis a, t_delta[a] the t between two
    crossings. The voxel is clamped into the grid in float before the
    conversion, so far-off points saturate as XLA's conversion does."""
    p = o + (t_start + ENTRY_EPS)[..., None] * d
    hi = device_const(tuple(n - 1 for n in dims), o.dtype, o.device)
    v = torch.minimum(torch.clamp(torch.floor(p), min=0.0), hi).to(
        torch.int32)
    inv = safe_inverse(d)
    pos = d >= 0
    step = torch.where(pos, 1, -1).to(torch.int32)
    vf = v.to(o.dtype)
    t_next = (torch.where(pos, vf + 1.0, vf) - o) * inv
    t_delta = inv.abs()
    t_next = torch.where(d.abs() < EPS_DIR, NEVER, t_next)
    return v, t_next, t_delta, step


def _one_hot3(idx: torch.Tensor) -> torch.Tensor:
    """Bool [..., 3] one-hot of the axis indices idx [..., 1]."""
    return idx == device_const((0, 1, 2), idx.dtype, idx.device)


def dda_step_mask(t_next: torch.Tensor) -> torch.Tensor:
    """Bool [..., 3]: the axis with the smallest t_next; ties take the
    lowest axis only (argmin returns the first of tied minima), so every
    march takes the same cells. vxtpu keeps the first tied axis with a
    cumsum, whose CUDA kernel takes milliseconds on [N, 3] (chip_smoke.py
    phase 10 times both forms)."""
    return _one_hot3(t_next.argmin(dim=-1, keepdim=True))


def dda_advance(v, t_next, t_delta, step):
    """One DDA step: (v', t_next', t_cross, mask); t_cross is the t where
    the boundary was crossed (the new voxel's entry t), mask the stepped
    axis (the face normal's source)."""
    mask = dda_step_mask(t_next)
    t_cross = t_next.amin(dim=-1)
    v2 = v + torch.where(mask, step, 0).to(v.dtype)
    t_next2 = t_next + torch.where(mask, t_delta, 0.0)
    return v2, t_next2, t_cross, mask


def entry_face_mask(o: torch.Tensor, d: torch.Tensor,
                    dims: tuple[int, int, int]) -> torch.Tensor:
    """Bool [..., 3]: the axis of the AABB face crossed at t_enter (the
    largest near-slab t; ties to the lowest axis). Rays starting inside
    get a fixed axis by the same rule."""
    inv = safe_inverse(d)
    bmax = torch.tensor(dims, dtype=o.dtype, device=o.device)
    tnear = torch.minimum((0.0 - o) * inv, (bmax - o) * inv)
    return _one_hot3(tnear.argmax(dim=-1, keepdim=True))


def face_normal(mask: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """Outward normal float32 [..., 3] of the face entered through the
    masked axis: a +1 step on axis a enters through the -a face."""
    return torch.where(mask, -step, 0).to(torch.float32)
