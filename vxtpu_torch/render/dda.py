"""Ray-box clipping (counterpart of ``vxtpu/render/dda.py``; only
``ray_grid_clip`` and the ``safe_inverse`` it needs: the port's march
keeps its own DDA in ``render/kernel_march.py``).

Differentiable: the soft renderers sample each ray over its clipped
segment, and the gradient of the segment bounds reaches the ray origin
and direction through here.
"""

from __future__ import annotations

import torch

BIG = 1e30
EPS_DIR = 1e-12


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
