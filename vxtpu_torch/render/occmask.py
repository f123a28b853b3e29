"""Occupancy-mask sample skipping for the soft renderer (counterpart of
``vxtpu/render/occmask.py``).

The masked soft model: density at world point p is

    sigma(p) = softplus(sigma_raw)(p) * mask[floor(p) // G]

so it is zero outside occupied coarse mask cells. Restricting each ray's
samples to [t0, t1], its first and last crossing of occupied cells,
changes nothing (transmittance is constant where density is zero), so S
samples land in the occupied band and far fewer of them give the same
in-band spacing. The bounds carry no gradient, exactly: the integrand is
zero at both ends.

The trainer (``train/loop.py``) starts from the all-ones mask (the plain
model) and rebuilds it from the current density every ``mask_refresh``
steps.
"""

from __future__ import annotations

import torch

from vxtpu_torch.device import DEFAULT, resolve
from vxtpu_torch.render import dda
from vxtpu_torch.render import kernel_sample as ks
from vxtpu_torch.render.kernel_xla import march_xla_df
# mask_at is defined once, in render/soft.py, and read here as vxtpu reads
# occmask.mask_at
from vxtpu_torch.render.soft import SoftGrid, mask_at, softplus  # noqa: F401
from vxtpu_torch.render.soft_kernel import MortonSoftGrid
from vxtpu_torch.world.distfield import build_distance_field


@torch.no_grad()
def occupancy_mask_from_soft(soft: SoftGrid | MortonSoftGrid, scale: int = 4,
                             tau: float = 0.01,
                             dilate: int = 1) -> torch.Tensor:
    """uint8 [X/G, Y/G, Z/G]: a cell is occupied iff one of its G^3 voxels
    has softplus(sigma_raw) > tau, then grown ``dilate`` times by its six
    face neighbours, wrapping at the borders as vxtpu's ``jnp.roll`` does
    (wrapping only adds occupied cells). A MortonSoftGrid's mask is read
    from its table, where a G-cube is G^3 consecutive rows: no reorder of
    the whole table."""
    G = scale
    if isinstance(soft, MortonSoftGrid):
        D = soft.dim
        if D % G:
            raise ValueError(f"mask scale {G} does not divide {D}")
        cells = (softplus(soft.tab[:, 0]) > tau).view(-1, G ** 3).any(dim=1)
        m = ks.field_from_morton(cells, D // G)
    else:
        X, Y, Z = soft.dims
        if X % G or Y % G or Z % G:
            raise ValueError(f"mask scale {G} does not divide {soft.dims}")
        occ = softplus(soft.sigma_raw) > tau
        m = occ.reshape(X // G, G, Y // G, G, Z // G, G).any(
            dim=5).any(dim=3).any(dim=1)
    for _ in range(dilate):
        grown = m
        for ax in range(3):
            for sh in (1, -1):
                grown = grown | torch.roll(m, sh, dims=ax)
        m = grown
    return m.to(torch.uint8)


def mask_all_ones(dims, scale: int = 4, device=DEFAULT) -> torch.Tensor:
    """The all-occupied mask uint8 [X/G, Y/G, Z/G] (the plain model)."""
    return torch.ones((dims[0] // scale, dims[1] // scale, dims[2] // scale),
                      dtype=torch.uint8, device=resolve(device))


def mask_distance_field(mask: torch.Tensor) -> torch.Tensor:
    """The mask grid's flat distance field, capped at its largest side:
    build it once per mask refresh and hand it to mask_segment_bounds."""
    return build_distance_field(mask.to(torch.uint8),
                                cap=max(mask.shape)).reshape(-1)


@torch.no_grad()
def mask_segment_bounds(mask: torch.Tensor, scale: int, o: torch.Tensor,
                        d: torch.Tensor, df_flat: torch.Tensor | None = None):
    """(t0, t1) [N] per ray: the entry and exit of its occupied band, in
    world units, conservative. Rays that touch no occupied cell get t0 ==
    t1. No gradient (density is zero at and beyond both bounds).

    Two distance-field marches over the mask grid: forward from the
    origin (the first occupied cell), and along -d from beyond the exit
    (the last one)."""
    G = float(scale)
    md = tuple(int(x) for x in mask.shape)
    if df_flat is None:
        df_flat = mask_distance_field(mask)
    max_steps = sum(md) + 2
    om = o / G
    _, t_exit_m, valid = dda.ray_grid_clip(om, d, md)
    fwd = march_xla_df(om, d, df_flat, md, max_steps)
    o_back = om + (t_exit_m[:, None] + 1.0) * d
    bwd = march_xla_df(o_back, -d, df_flat, md, max_steps)
    hit_any = fwd.hit & bwd.hit & valid
    t0 = G * torch.where(hit_any, fwd.t, 0.0)
    t1 = torch.maximum(G * torch.where(hit_any, (t_exit_m + 1.0) - bwd.t,
                                       0.0), t0)
    return t0, t1
