"""Differentiable volumetric ("soft") rendering (counterpart of
``vxtpu/render/soft.py``), config 4's scene model.

The scene is a density grid sigma [X,Y,Z] and a colour grid rgb
[3,X,Y,Z]; a ray accumulates

    alpha_i = 1 - exp(-softplus(sigma_i) * dt)
    T_i     = prod_{j<i} (1 - alpha_j)
    C       = sum_i T_i alpha_i c_i + T_end * sky

over S uniform samples of its grid-clipped segment, with sigma and rgb
interpolated trilinearly. Plain PyTorch: autograd gives the gradients to
the grids and to the rays (so to the camera pose). This module is the
semantics oracle of the kernel path (``render/soft_kernel.py``) and
renders the trainer's target views.

Voxel-centre convention: the value stored at index (i,j,k) lives at world
point (i+.5, j+.5, k+.5).
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from vxtpu_torch.camera.rays import generate_rays
from vxtpu_torch.device import DEFAULT, resolve
from vxtpu_torch.render import dda
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.render.shade import sky_color
from vxtpu_torch.world.grid import material_rgb


@dataclasses.dataclass(frozen=True)
class SoftGrid:
    """Optimisable scene: raw (pre-softplus) densities and rgb logits.

    sigma_raw: float32 [X,Y,Z], softplus'd into a non-negative density.
    rgb_raw:   float32 [3,X,Y,Z], sigmoid'd into [0,1] colour; channel-major
               as in vxtpu, so the two packages' arrays compare directly.
    """

    sigma_raw: torch.Tensor
    rgb_raw: torch.Tensor

    @property
    def dims(self) -> tuple[int, int, int]:
        return tuple(self.sigma_raw.shape)  # type: ignore[return-value]

    @staticmethod
    def zeros(dims: tuple[int, int, int], device=DEFAULT) -> "SoftGrid":
        f32 = dict(dtype=torch.float32, device=resolve(device))
        return SoftGrid(sigma_raw=torch.full(dims, -2.0, **f32),
                        rgb_raw=torch.zeros((3, *dims), **f32))

    @staticmethod
    def from_hard(grid, sigma_solid: float = 40.0) -> "SoftGrid":
        """From a hard VoxelGrid (on its device): solid voxels get a high
        density; empty voxels take the mean colour of their solid
        neighbours over two dilation passes, so trilinear samples at a
        surface do not darken toward black."""
        occ = grid.occupancy > 0
        sigma_raw = torch.where(occ, sigma_solid, -6.0).to(torch.float32)
        if grid.rgb is not None:
            chans = [grid.rgb[..., c] for c in range(3)]
        else:
            pal = material_rgb(occ.device)
            ids = torch.clamp(grid.occupancy.to(torch.int64),
                              max=pal.shape[0] - 1)
            chans = [pal[:, c][ids] for c in range(3)]
        w = occ.to(torch.float32)
        cols = [c * w for c in chans]
        for _ in range(2):
            wsum = torch.zeros_like(w)
            csums = [torch.zeros_like(c) for c in cols]
            for ax in range(3):
                for sh in (1, -1):
                    wsum = wsum + torch.roll(w, sh, dims=ax)
                    csums = [cs + torch.roll(c, sh, dims=ax)
                             for cs, c in zip(csums, cols)]
            filled = wsum > 0
            denom = torch.clamp(wsum, min=1.0)
            cols = [torch.where(w > 0, c, torch.where(filled, cs / denom, c))
                    for c, cs in zip(cols, csums)]
            w = torch.maximum(w, filled.to(torch.float32))
        logit = [torch.log(torch.clamp(c, 1e-3, 1.0 - 1e-3))
                 - torch.log1p(-torch.clamp(c, 1e-3, 1.0 - 1e-3))
                 for c in cols]
        return SoftGrid(sigma_raw=sigma_raw, rgb_raw=torch.stack(logit))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (= logaddexp(x, 0)) in its own formula."""
    return dda.relu_like_jax(x) + torch.log1p(torch.exp(-x.abs()))


def _corners(p: torch.Tensor, dims):
    """Corner indices and fractions of the trilinear stencil at p [...,3]:
    (i0, i1) int64 [...,3] and f [...,3]. i1 = clamp(clamp(floor q) + 1),
    so in the half-voxel shell next to a low face the sample mixes voxels
    0 and 1 with f in [0.5, 1) (vxtpu's convention, kept exactly)."""
    q = p - 0.5
    q0 = torch.floor(q)
    f = q - q0
    hi = torch.tensor([n - 1 for n in dims], dtype=q.dtype, device=q.device)
    # clamp in float before converting, so far-off points saturate alike
    i0 = torch.minimum(torch.clamp(q0, min=0.0), hi).to(torch.int64)
    i1 = torch.minimum(i0 + 1, hi.to(torch.int64))
    return i0, i1, f


def _gather8(flat: torch.Tensor, i0, i1, dims):
    """The 8 corner values c000..c111 (k = ex*4 + ey*2 + ez)."""
    _, Y, Z = dims
    out = []
    for k in range(8):
        ix = (i1 if (k >> 2) & 1 else i0)[..., 0]
        iy = (i1 if (k >> 1) & 1 else i0)[..., 1]
        iz = (i1 if k & 1 else i0)[..., 2]
        out.append(flat[(ix * Y + iy) * Z + iz])
    return out


def trilinear(values: torch.Tensor, p: torch.Tensor, dims):
    """Trilinear interpolation of ``values`` ([X,Y,Z], or channel-major
    [C,X,Y,Z]) at world points p [...,3], edge-clamped corners. Returns
    [...] for a scalar field, [..., C] otherwise."""
    i0, i1, f = _corners(p, dims)
    if values.dim() == 3:
        flat = values.reshape(-1)
        c = [v[..., None] for v in _gather8(flat, i0, i1, dims)]
    else:
        flats = [values[ch].reshape(-1) for ch in range(values.shape[0])]
        per = [_gather8(fl, i0, i1, dims) for fl in flats]
        c = [torch.stack([per[ch][k] for ch in range(len(flats))], dim=-1)
             for k in range(8)]
    out = lerp8(c, f[..., 0:1], f[..., 1:2], f[..., 2:3])
    return out[..., 0] if values.dim() == 3 else out


def lerp8(c, fx, fy, fz):
    """The trilinear ladder over the 8 corner values c000..c111 (a
    sequence), z first, then y, then x."""
    c00 = c[0] * (1 - fz) + c[1] * fz
    c01 = c[2] * (1 - fz) + c[3] * fz
    c10 = c[4] * (1 - fz) + c[5] * fz
    c11 = c[6] * (1 - fz) + c[7] * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def grad8(c, fx, fy, fz):
    """(gx, gy, gz): the analytic derivative of the trilinear basis over
    the 8 corner values c000..c111 (piecewise constant per cell)."""
    c000, c001, c010, c011, c100, c101, c110, c111 = c
    gx = (((c100 - c000) * (1 - fy) + (c110 - c010) * fy) * (1 - fz)
          + ((c101 - c001) * (1 - fy) + (c111 - c011) * fy) * fz)
    gy = (((c010 - c000) * (1 - fx) + (c110 - c100) * fx) * (1 - fz)
          + ((c011 - c001) * (1 - fx) + (c111 - c101) * fx) * fz)
    gz = (((c001 - c000) * (1 - fx) + (c101 - c100) * fx) * (1 - fy)
          + ((c011 - c010) * (1 - fx) + (c111 - c110) * fx) * fy)
    return gx, gy, gz


def trilinear_grad(values: torch.Tensor, p: torch.Tensor, dims):
    """Spatial gradient [...,3] of the trilinear field of ``values``
    ([X,Y,Z]) at p: the analytic derivative of the interpolation basis,
    from the same 8 corners (piecewise constant per cell)."""
    i0, i1, f = _corners(p, dims)
    c = _gather8(values.reshape(-1), i0, i1, dims)
    return torch.stack(grad8(c, f[..., 0], f[..., 1], f[..., 2]), dim=-1)


def shade_samples(c_raw, grad_raw, p, view_dir, lights,
                  settings: RenderSettings):
    """Lambert (+ Blinn-Phong for shading='full') lighting of volume
    samples with density-gradient normals n = -normalize(grad_raw).

    c_raw [...,3] sample colour; grad_raw [...,3] gradient of the raw
    sigma field at p [...,3]; view_dir [...,3] (broadcastable)."""
    g2 = torch.sum(grad_raw * grad_raw, dim=-1, keepdim=True)
    n = -grad_raw * torch.rsqrt(g2 + 1e-9)
    acc_l = torch.full(c_raw.shape[:-1] + (1,), settings.ambient,
                       dtype=c_raw.dtype, device=c_raw.device)
    lvec = lights.pos - p[..., None, :]                          # [...,L,3]
    dist2 = torch.sum(lvec * lvec, dim=-1)                       # [...,L]
    ldir = lvec * torch.rsqrt(torch.clamp(dist2, min=1e-12))[..., None]
    # max(x, 0) with jnp.maximum's gradient at x == 0 (half), as vxtpu: an
    # untouched grid has zero density gradients, so every sample sits there
    ndotl = dda.relu_like_jax(torch.sum(n[..., None, :] * ldir, dim=-1))
    atten = lights.intensity / (1.0 + 0.002 * dist2)
    diff = ndotl * atten
    out = c_raw * (acc_l + torch.sum(diff[..., None] * lights.rgb, dim=-2))
    if settings.shading == "full":
        h = ldir - view_dir[..., None, :]
        h = h * torch.rsqrt(torch.clamp(torch.sum(h * h, dim=-1),
                                        min=1e-12))[..., None]
        ndoth = dda.relu_like_jax(torch.sum(n[..., None, :] * h, dim=-1))
        spec = settings.specular_k * torch.pow(ndoth, settings.specular_exp)
        spec = spec * (ndotl > 0.0) * atten
        out = out + torch.sum(spec[..., None] * lights.rgb, dim=-2)
    return out


_warned_scope: set = set()


def warn_soft_scope(settings: RenderSettings, lights) -> None:
    """Soft mode's scope cuts warn once each instead of passing silently:
    shadow marches and fog are hard-frame only, and lit shading needs
    lights."""
    lit_requested = settings.shading != "flat"
    have_lights = lights is not None and lights.count > 0
    key = (settings.shadows, settings.fog, lit_requested and not have_lights)
    if key in _warned_scope:
        return
    _warned_scope.add(key)
    if settings.shadows or settings.fog:
        warnings.warn(
            "soft (volumetric) render mode does not implement shadow "
            "marches or fog; settings.shadows/settings.fog are ignored "
            "here (hard-render pipeline only)", stacklevel=3)
    if lit_requested and not have_lights:
        warnings.warn(
            f"soft render with shading={settings.shading!r} but no lights: "
            "falling back to emission shading — pass lights= for the lit "
            "soft mode", stacklevel=3)


def mask_at(mask: torch.Tensor, scale: int, p: torch.Tensor) -> torch.Tensor:
    """Nearest-cell value (0/1 float) of a coarse occupancy mask uint8
    [X/G, Y/G, Z/G] at world points p [...,3] (vxtpu's
    ``occmask.mask_at``); points outside clamp to the border cell."""
    Xc, Yc, Zc = mask.shape
    hi = torch.tensor([Xc - 1, Yc - 1, Zc - 1], dtype=p.dtype,
                      device=p.device)
    ci = torch.minimum(torch.clamp(torch.floor(p / scale), min=0.0),
                       hi).to(torch.int64)
    idx = (ci[..., 0] * Yc + ci[..., 1]) * Zc + ci[..., 2]
    return mask.reshape(-1)[idx].to(torch.float32)


def render_soft_rays(soft: SoftGrid, o: torch.Tensor, d: torch.Tensor,
                     settings: RenderSettings, num_samples: int,
                     lights=None, mask=None, mask_scale: int = 4,
                     seg_bounds=None):
    """Volumetric render of rays [N,3] -> (rgb [N,3], aux dict).

    Uniform samples over each ray's clipped [t_enter, t_exit]; rays that
    miss the grid get the sky. ``lights`` (with shading 'lambert' or
    'full') lights the samples through density-gradient normals.
    ``mask``: a coarse occupancy mask; density is zero outside its
    occupied cells. ``seg_bounds``: per-ray (t0, t1) that narrow the
    segment, taken as constants (no gradient), as vxtpu's stop_gradient.
    """
    dims = soft.dims
    warn_soft_scope(settings, lights)
    t_enter, t_exit, valid = dda.ray_grid_clip(o, d, dims)
    if seg_bounds is not None:
        t0 = torch.maximum(seg_bounds[0], t_enter).detach()
        t1 = torch.minimum(seg_bounds[1], t_exit).detach()
        seg = dda.relu_like_jax(t1 - t0)
        start = t0
    else:
        seg = dda.relu_like_jax(t_exit - t_enter)
        start = t_enter
    dt = seg / num_samples                                        # [N]
    s_idx = torch.arange(num_samples, dtype=o.dtype, device=o.device) + 0.5
    t_s = start[:, None] + dt[:, None] * s_idx[None, :]           # [N,S]
    p = o[:, None, :] + t_s[..., None] * d[:, None, :]            # [N,S,3]

    sigma = softplus(trilinear(soft.sigma_raw, p, dims))          # [N,S]
    if mask is not None:
        sigma = sigma * mask_at(mask, mask_scale, p)
    rgb = torch.sigmoid(trilinear(soft.rgb_raw, p, dims))         # [N,S,3]
    if (lights is not None and lights.count > 0
            and settings.shading != "flat"):
        grad_raw = trilinear_grad(soft.sigma_raw, p, dims)
        rgb = shade_samples(rgb, grad_raw, p, d[:, None, :], lights,
                            settings)

    alpha = 1.0 - torch.exp(-sigma * dt[:, None])
    alpha = torch.where(valid[:, None], alpha, 0.0)
    # exclusive cumprod of (1 - alpha) by a shift, never by a division
    # (which divides by exactly zero at saturated samples)
    one_m = 1.0 - alpha + 1e-10
    T = torch.cumprod(torch.cat([torch.ones_like(one_m[:, :1]),
                                 one_m[:, :-1]], dim=1), dim=1)
    w = T * alpha
    color = torch.sum(w[..., None] * rgb, dim=1)
    T_end = torch.prod(one_m, dim=1)
    color = color + T_end[..., None] * sky_color(d, settings)
    aux = dict(weights=w, t=t_s, transmittance_end=T_end,
               opacity=1.0 - T_end)
    return color, aux


def render_soft_image(soft: SoftGrid, cam, settings: RenderSettings,
                      height: int, width: int, num_samples: int,
                      lights=None) -> torch.Tensor:
    """[H,W,3] differentiable render (gradients reach the grid and the
    camera pose); ``lights`` enables the lit soft mode."""
    o, d = generate_rays(cam, height, width)
    rgb, _ = render_soft_rays(soft, o, d, settings, num_samples, lights)
    return rgb.reshape(height, width, 3)
