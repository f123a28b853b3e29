"""Differentiable soft rendering on the field-sampling kernels (counterpart
of ``vxtpu/render/soft_pallas.py``): the trainer's fast path.

  * ``MortonSoftGrid`` holds the scene in the kernels' layout, one
    channel-interleaved fine-voxel Morton table [D^3, 4], so a training
    step never re-lays the grid out; conversion happens only at the ends
    (``from_soft`` / ``to_soft``).
  * ``SampleFields`` is the only hand-differentiated boundary (vxtpu's
    ``jax.custom_vjp`` around ``sample_fields``): forward the sampling
    kernel, backward the scatter kernel, which returns the table's
    gradient in its own shape and skips the rays' unless they need it.
    Everything else (softplus, mask, lit shading, the transmittance
    cumprod, sky) is [S, N] tensor code that autograd differentiates.

Semantics are ``render/soft.render_soft_rays``'s: the same sample
positions, clip conventions and cumprod order. vxtpu's TPU-only arguments
(window, image_shape, block_shape, interpret, nsplit, stats) have no
counterpart.
"""

from __future__ import annotations

import dataclasses

import torch

from vxtpu_torch.camera.rays import generate_rays
from vxtpu_torch.render import dda
from vxtpu_torch.render import kernel_sample as ks
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.render.shade import sky_color
from vxtpu_torch.render.soft import (SoftGrid, mask_at, softplus,
                                     warn_soft_scope)

_EPS = 1e-10


@dataclasses.dataclass(frozen=True)
class MortonSoftGrid:
    """Optimisable scene in fine-voxel Morton layout.

    tab: float32 [D^3, 4]; row m holds (sigma, r, g, b) of the voxel whose
    Morton code is m: the raw density (softplus'd downstream) and the rgb
    logits (sigmoid'd downstream). vxtpu keeps the same words as two
    planar tables, which the read-only views ``sigma_tab`` and
    ``rgb_tab`` show."""

    tab: torch.Tensor

    @property
    def dim(self) -> int:
        return round(self.tab.shape[0] ** (1.0 / 3.0))

    @property
    def dims(self) -> tuple[int, int, int]:
        return (self.dim,) * 3

    @property
    def sigma_tab(self) -> torch.Tensor:
        """[D^3] view of the densities (vxtpu's sigma_tab)."""
        return self.tab[:, 0]

    @property
    def rgb_tab(self) -> torch.Tensor:
        """[3, D^3] view of the rgb logits (vxtpu's rgb_tab)."""
        return self.tab[:, 1:].t()

    @staticmethod
    def from_soft(soft: SoftGrid) -> "MortonSoftGrid":
        return MortonSoftGrid(tab=ks.build_interleaved_morton(
            soft.sigma_raw, soft.rgb_raw))

    def to_soft(self) -> SoftGrid:
        sigma, rgb = ks.fields_from_interleaved(self.tab, self.dim)
        return SoftGrid(sigma_raw=sigma, rgb_raw=rgb)


class SampleFields(torch.autograd.Function):
    """Raw trilinear samples along rays, differentiable with respect to the
    scene's table (tab [D^3, 4]) and the ray parameters (o, d, t0, dt):
    forward ``sample_fields_fwd``, backward ``sample_grads``, whose
    gradient has the table's shape and is handed over as it is. The
    backward asks for the ray cotangents only where o, d, t0 or dt needs
    a gradient. ``plain`` runs the plain versions on any device (the
    oracle of the kernel path)."""

    @staticmethod
    def forward(ctx, S, dim, lit, plain, tab, o, d, t0, dt):
        ctx.save_for_backward(tab, o, d, t0, dt)
        ctx.S, ctx.dim, ctx.lit, ctx.plain = S, dim, lit, plain
        fwd = (ks.sample_fields_fwd_reference if plain
               else ks.sample_fields_fwd)
        return fwd(tab, o, d, t0, dt, S, dim, lit)

    @staticmethod
    def backward(ctx, *cots):
        tab, o, d, t0, dt = ctx.saved_tensors
        ray_grads = any(ctx.needs_input_grad[5:9])
        bwd = (ks.sample_fields_bwd_reference if ctx.plain
               else ks.sample_grads)
        grad, go, gd, gt0, gdt = bwd(
            tab, o, d, t0, dt, tuple(c.contiguous() for c in cots), ctx.dim,
            ctx.lit, ray_grads)
        return (None, None, None, None, grad, go, gd, gt0, gdt)


def _shade_samples_cm(rc, gc, bc, gx, gy, gz, px, py, pz, dx, dy, dz,
                      lights, settings: RenderSettings):
    """soft.shade_samples on [S, N] planes, one light at a time (the same
    math up to float reassociation)."""
    g2 = gx * gx + gy * gy + gz * gz
    rinv = torch.rsqrt(g2 + 1e-9)
    nx, ny, nz = -gx * rinv, -gy * rinv, -gz * rinv
    acc = settings.ambient
    outr, outg, outb = rc * acc, gc * acc, bc * acc
    for li in range(lights.count):
        lx = lights.pos[li, 0] - px
        ly = lights.pos[li, 1] - py
        lz = lights.pos[li, 2] - pz
        dist2 = lx * lx + ly * ly + lz * lz
        linv = torch.rsqrt(torch.clamp(dist2, min=1e-12))
        ldx, ldy, ldz = lx * linv, ly * linv, lz * linv
        # jnp.maximum's gradient at 0, as soft.shade_samples
        ndotl = dda.relu_like_jax(nx * ldx + ny * ldy + nz * ldz)
        atten = lights.intensity[li] / (1.0 + 0.002 * dist2)
        diff = ndotl * atten
        outr = outr + rc * diff * lights.rgb[li, 0]
        outg = outg + gc * diff * lights.rgb[li, 1]
        outb = outb + bc * diff * lights.rgb[li, 2]
        if settings.shading == "full":
            hx, hy, hz = ldx - dx, ldy - dy, ldz - dz
            hn = torch.rsqrt(torch.clamp(hx * hx + hy * hy + hz * hz,
                                         min=1e-12))
            ndoth = dda.relu_like_jax((nx * hx + ny * hy + nz * hz) * hn)
            spec = (settings.specular_k
                    * torch.pow(ndoth, settings.specular_exp)
                    * (ndotl > 0.0) * atten)
            outr = outr + spec * lights.rgb[li, 0]
            outg = outg + spec * lights.rgb[li, 1]
            outb = outb + spec * lights.rgb[li, 2]
    return outr, outg, outb


def _enter_dt_soft(o, d, dims, num_samples, seg_bounds):
    """(t_start, dt, valid) of the sampled segment; seg_bounds are
    constants (no gradient); rays that miss get a zero-length segment at
    t = 0 (their output is the sky)."""
    t_enter, t_exit, valid = dda.ray_grid_clip(o, d, dims)
    if seg_bounds is not None:
        t0 = torch.maximum(seg_bounds[0], t_enter).detach()
        t1 = torch.minimum(seg_bounds[1], t_exit).detach()
        dt = dda.relu_like_jax(t1 - t0) / num_samples
    else:
        t0 = t_enter
        dt = dda.relu_like_jax(t_exit - t_enter) / num_samples
    t0 = torch.where(valid, t0, 0.0)
    dt = torch.where(valid, dt, 0.0)
    return t0, dt, valid


def render_soft_rays_kernel(msoft: MortonSoftGrid, o: torch.Tensor,
                            d: torch.Tensor, settings: RenderSettings,
                            num_samples: int, lights=None, mask=None,
                            mask_scale: int = 4, seg_bounds=None,
                            plain: bool = False) -> torch.Tensor:
    """Volumetric render rgb [N, 3] through the sampling kernels,
    differentiable by autograd (the kernel pair is the hand-written
    boundary). ``plain`` runs the kernels' plain versions instead."""
    dims = msoft.dims
    warn_soft_scope(settings, lights)
    lit = (lights is not None and lights.count > 0
           and settings.shading != "flat")
    t0, dt, valid = _enter_dt_soft(o, d, dims, num_samples, seg_bounds)
    vals = SampleFields.apply(num_samples, msoft.dim, lit, plain, msoft.tab,
                              o.contiguous(), d.contiguous(), t0.contiguous(),
                              dt.contiguous())
    sv, rr, gg, bb = vals[:4]                                 # [S, N]
    sigma = softplus(sv)
    rc, gc, bc = torch.sigmoid(rr), torch.sigmoid(gg), torch.sigmoid(bb)
    if mask is not None or lit:
        s_idx = torch.arange(num_samples, dtype=o.dtype,
                             device=o.device) + 0.5
        t_s = t0[None, :] + dt[None, :] * s_idx[:, None]      # [S, N]
        px = o[None, :, 0] + t_s * d[None, :, 0]
        py = o[None, :, 1] + t_s * d[None, :, 1]
        pz = o[None, :, 2] + t_s * d[None, :, 2]
    if mask is not None:
        sigma = sigma * mask_at(mask, mask_scale,
                                torch.stack([px, py, pz], dim=-1))
    if lit:
        rc, gc, bc = _shade_samples_cm(
            rc, gc, bc, vals[4], vals[5], vals[6], px, py, pz,
            d[None, :, 0], d[None, :, 1], d[None, :, 2], lights, settings)

    alpha = 1.0 - torch.exp(-sigma * dt[None, :])
    alpha = torch.where(valid[None, :], alpha, 0.0)
    one_m = 1.0 - alpha + _EPS
    # exclusive cumprod by a shift, never by a division (see soft.py)
    T = torch.cumprod(torch.cat([torch.ones_like(one_m[:1]), one_m[:-1]],
                                dim=0), dim=0)
    w = T * alpha
    T_end = torch.prod(one_m, dim=0)
    color = torch.stack([torch.sum(w * rc, dim=0), torch.sum(w * gc, dim=0),
                         torch.sum(w * bc, dim=0)], dim=-1)
    return color + T_end[..., None] * sky_color(d, settings)


def render_soft_image_kernel(msoft: MortonSoftGrid, cam,
                             settings: RenderSettings, height: int,
                             width: int, num_samples: int,
                             lights=None) -> torch.Tensor:
    """[H, W, 3] differentiable render through the sampling kernels
    (gradients reach the Morton table and the camera pose)."""
    o, d = generate_rays(cam, height, width)
    rgb = render_soft_rays_kernel(msoft, o, d, settings, num_samples, lights)
    return rgb.reshape(height, width, 3)
