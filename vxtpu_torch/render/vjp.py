"""The soft render with a hand-written backward (counterpart of
``vxtpu/render/vjp.py``): memory O(N_rays + grid) where autograd through
``render/soft.py`` keeps O(N_rays x S) residuals. At config 5's size
(2,073,600 rays x 192 samples) those residuals do not fit one card: the
trilinear gather's int64 corner indices alone would be 25.5 GB.

  forward   a loop over the S samples carrying only the transmittance T
            and the accumulated colour; it saves the output colour C.
  backward  re-walks the same samples, keeping T_s and the suffix
            sum_{j>s} w_j c_j + T_end sky as C - sum_{j<=s} w_j c_j:

              dC/dc_s     = w_s
              dC/dalpha_s = T_s c_s - suffix_s / (1 - alpha_s + eps)

            Each sample's radiance model (trilinear sigma and rgb, and in
            lit mode the density-gradient normal and the lights) is
            differentiated by autograd with respect to its 8 gathered
            corner rows (sigma, r, g, b), the sample point, the view
            direction and the lights, never the whole grid; the corner
            cotangents are added into one [X*Y*Z, 4] accumulator with
            ``index_add_`` (bitwise repeatable on the CPU; on CUDA its
            float atomics sum in a varying order, so runs agree to
            allclose). The sample
            point's cotangent chains into (o, d) through p = o + t_s d
            and the grid clip.

Plain PyTorch: vxtpu's version calls no Pallas kernel either.
"""

from __future__ import annotations

import torch

from vxtpu_torch.camera.rays import generate_rays
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.render.shade import sky_color
from vxtpu_torch.render.soft import (SoftGrid, _corners, grad8, lerp8,
                                     mask_at, softplus, warn_soft_scope)
from vxtpu_torch.render.soft_kernel import _enter_dt_soft, _shade_samples_cm
from vxtpu_torch.world.lights import Lights

_EPS = 1e-10


def _is_lit(settings: RenderSettings, lights) -> bool:
    return (lights is not None and lights.count > 0
            and settings.shading != "flat")


def _corner_index(p: torch.Tensor, dims) -> torch.Tensor:
    """int64 [N, 8]: flat indices of the trilinear corners c000..c111 (k =
    ex*4 + ey*2 + ez) of the points p [N, 3]. Ray-major: the backward's
    ``index_add_`` then gives a warp's lanes the distinct corners of a few
    rays, not one corner of 32 neighbouring rays (which share voxels, and
    whose float atomics on one address serialise)."""
    _, Y, Z = dims
    i0, i1, _ = _corners(p, dims)
    xs = torch.stack([i0[:, 0], i1[:, 0]], dim=1) * (Y * Z)
    ys = torch.stack([i0[:, 1], i1[:, 1]], dim=1) * Z
    zs = torch.stack([i0[:, 2], i1[:, 2]], dim=1)
    return (xs[:, :, None, None] + ys[:, None, :, None]
            + zs[:, None, None, :]).reshape(-1, 8)


def _sample_color(rows, p, d, lights, settings: RenderSettings, lit: bool):
    """(raw sigma [N], sample colour [N, 3]) at points p [N, 3] from the
    gathered corner rows [N, 8, 4] (sigma, r, g, b logits): the radiance
    model that the forward loop and the backward re-walk share, and that
    the backward differentiates."""
    q = p - 0.5
    f = q - torch.floor(q)
    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    v = lerp8(rows.unbind(1), fx, fy, fz)                     # [N, 4]
    sv = v[:, 0]
    c = torch.sigmoid(v[:, 1:])
    if lit:
        gx, gy, gz = grad8(rows[..., 0].unbind(1), fx[:, 0], fy[:, 0],
                           fz[:, 0])
        c = torch.stack(_shade_samples_cm(
            c[:, 0], c[:, 1], c[:, 2], gx, gy, gz, p[:, 0], p[:, 1],
            p[:, 2], d[:, 0], d[:, 1], d[:, 2], lights, settings), dim=1)
    return sv, c


def _table(sigma_raw, rgb_raw) -> torch.Tensor:
    """[X*Y*Z, 4]: each voxel's (sigma, r, g, b), so a corner is one
    16-byte row to gather and to add into."""
    return torch.cat([sigma_raw.reshape(-1, 1),
                      rgb_raw.reshape(3, -1).t()], dim=1).contiguous()


def _gather_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab[idx] -> [N, 8, 4], each 16-byte row moved as one complex128
    element: PyTorch's CUDA gather of [V, 4] float rows (its vectorized
    row gather) took ~10 ms a sample at 1080p on the H100, ~20x the same
    bytes through the element-wise gather."""
    rows = tab.view(torch.complex128).reshape(-1)[idx]
    return rows.view(torch.float32).reshape(idx.shape[0], 8, 4)


class _SoftRenderFast(torch.autograd.Function):
    """rgb [N, 3] of rays (o, d) through the soft grid (sigma_raw,
    rgb_raw), differentiable with respect to both fields, the rays and
    the lights' tensors."""

    @staticmethod
    def forward(ctx, settings, num_samples, mask, mask_scale, b0, b1,
                sigma_raw, rgb_raw, o, d, lpos, lrgb, lint):
        dims = tuple(sigma_raw.shape)
        lights = None if lpos is None else Lights(lpos, lrgb, lint)
        lit = _is_lit(settings, lights)
        bounds = None if b0 is None else (b0, b1)
        tab = _table(sigma_raw, rgb_raw)
        t_enter, dt, valid = _enter_dt_soft(o, d, dims, num_samples, bounds)
        T = torch.ones_like(t_enter)
        acc = torch.zeros_like(o)
        for s in range(num_samples):
            t_s = t_enter + dt * (s + 0.5)
            p = o + t_s[:, None] * d
            rows = _gather_rows(tab, _corner_index(p, dims))
            sv, c = _sample_color(rows, p, d, lights, settings, lit)
            sigma = softplus(sv)
            if mask is not None:
                sigma = sigma * mask_at(mask, mask_scale, p)
            alpha = torch.where(valid, 1.0 - torch.exp(-sigma * dt), 0.0)
            acc = acc + (T * alpha)[:, None] * c
            T = T * (1.0 - alpha + _EPS)
        color = acc + T[:, None] * sky_color(d, settings)
        ctx.settings, ctx.num_samples = settings, num_samples
        ctx.mask_scale = mask_scale
        ctx.save_for_backward(sigma_raw, rgb_raw, o, d, lpos, lrgb, lint,
                              color, mask, b0, b1)
        return color

    @staticmethod
    def backward(ctx, g):
        (sigma_raw, rgb_raw, o, d, lpos, lrgb, lint, color, mask, b0,
         b1) = ctx.saved_tensors
        settings, S = ctx.settings, ctx.num_samples
        dims = tuple(sigma_raw.shape)
        lights = None if lpos is None else Lights(lpos, lrgb, lint)
        lit = _is_lit(settings, lights)
        bounds = None if b0 is None else (b0, b1)
        tab = _table(sigma_raw.detach(), rgb_raw.detach())
        o, d = o.detach(), d.detach()
        with torch.enable_grad():
            o_c = o.detach().requires_grad_()
            d_c = d.detach().requires_grad_()
            te_c, dt_c, valid = _enter_dt_soft(o_c, d_c, dims, S, bounds)
        t_enter, dt = te_c.detach(), dt_c.detach()

        g = g.contiguous()
        gtab = torch.zeros_like(tab)        # the (sigma, r, g, b) gradient
        go = torch.zeros_like(o)
        gd = torch.zeros_like(d)
        gte = torch.zeros_like(t_enter)
        gdt = torch.zeros_like(t_enter)
        gl = [torch.zeros_like(x) for x in (lpos, lrgb, lint)] if lit else []
        T = torch.ones_like(t_enter)
        acc = torch.zeros_like(color)
        for s in range(S):
            sf = s + 0.5
            t_s = t_enter + dt * sf
            p = o + t_s[:, None] * d
            idx = _corner_index(p, dims)
            rows = _gather_rows(tab, idx)
            with torch.enable_grad():
                leaves = [rows.requires_grad_(), p.requires_grad_()]
                if lit:
                    leaves += [d.detach().requires_grad_(),
                               *(x.detach().requires_grad_()
                                 for x in (lpos, lrgb, lint))]
                    lts = Lights(*leaves[3:])
                    sv, c = _sample_color(rows, p, leaves[2], lts, settings,
                                          True)
                else:
                    sv, c = _sample_color(rows, p, None, None, settings,
                                          False)
            sv_d, c_d = sv.detach(), c.detach()
            sigma = softplus(sv_d)
            m_s = 1.0
            if mask is not None:
                m_s = mask_at(mask, ctx.mask_scale, p.detach())
                sigma = sigma * m_s
            e = torch.exp(-sigma * dt)
            alpha = torch.where(valid, 1.0 - e, 0.0)
            one_m = 1.0 - alpha + _EPS
            w = T * alpha
            acc_new = acc + w[:, None] * c_d
            suffix = color - acc_new                  # sum_{j>s} + sky term
            denom = torch.clamp(one_m, min=_EPS)
            galpha = torch.sum(
                g * (T[:, None] * c_d - suffix / denom[:, None]), dim=-1)
            galpha = torch.where(valid, galpha, 0.0)
            gc = g * w[:, None]
            gsv = galpha * dt * e * m_s * torch.sigmoid(sv_d)
            grads = torch.autograd.grad((sv, c), leaves, (gsv, gc),
                                        allow_unused=True,
                                        materialize_grads=True)
            gtab.index_add_(0, idx.reshape(-1), grads[0].reshape(-1, 4))
            gp = grads[1]
            gts = torch.sum(gp * d, dim=-1)                   # p = o + t_s d
            go = go + gp
            gd = gd + gp * t_s[:, None]
            if lit:
                gd = gd + grads[2]
                gl = [a + b for a, b in zip(gl, grads[3:])]
            gte = gte + gts
            gdt = gdt + gts * sf + galpha * sigma * e         # alpha's dt term
            T = T * one_m
            acc = acc_new

        # the sky: C += T_end sky(d); T_end's dependence on the samples is
        # inside the suffix above, only sky's own d remains
        with torch.enable_grad():
            d_s = d.detach().requires_grad_()
            (gd_sky,) = torch.autograd.grad(sky_color(d_s, settings), d_s,
                                            T[:, None] * g)
        gd = gd + gd_sky
        # t_enter and dt back into (o, d) through the grid clip (nothing
        # with seg_bounds: the band is a constant)
        if bounds is None:
            go2, gd2 = torch.autograd.grad((te_c, dt_c), (o_c, d_c),
                                           (gte, gdt))
            go, gd = go + go2, gd + gd2
        glights = gl if lit else [None if x is None else torch.zeros_like(x)
                                  for x in (lpos, lrgb, lint)]
        gsig = gtab[:, 0].reshape(sigma_raw.shape)
        grgb = gtab[:, 1:].t().reshape(rgb_raw.shape)
        return (None, None, None, None, None, None, gsig, grgb, go, gd,
                *glights)


def render_soft_rays_fast(soft: SoftGrid, o: torch.Tensor, d: torch.Tensor,
                          settings: RenderSettings, num_samples: int,
                          lights: Lights | None = None, mask=None,
                          mask_scale: int = 4,
                          seg_bounds=None) -> torch.Tensor:
    """Volumetric render rgb [N, 3]: ``render_soft_rays(...)[0]``'s value
    (the same sample order), with the O(N_rays + grid) backward above.
    Gradients reach the grid, the rays (o, d; so the camera pose) and, in
    lit mode, the lights' tensors. ``mask`` gates the density;
    ``seg_bounds`` (t0, t1) narrow each ray's sampled segment and carry
    no gradient, as in ``render_soft_rays``."""
    warn_soft_scope(settings, lights)
    lt = ((None, None, None) if lights is None
          else (lights.pos, lights.rgb, lights.intensity))
    b0, b1 = (None, None) if seg_bounds is None else seg_bounds
    return _SoftRenderFast.apply(settings, num_samples, mask, mask_scale,
                                 b0, b1, soft.sigma_raw, soft.rgb_raw, o, d,
                                 *lt)


def render_soft_image_fast(soft: SoftGrid, cam, settings: RenderSettings,
                           height: int, width: int, num_samples: int,
                           lights: Lights | None = None) -> torch.Tensor:
    """[H, W, 3] render on the custom-backward path (gradients reach the
    grid and, through generate_rays, the camera pose)."""
    o, d = generate_rays(cam, height, width)
    rgb = render_soft_rays_fast(soft, o, d, settings, num_samples, lights)
    return rgb.reshape(height, width, 3)
