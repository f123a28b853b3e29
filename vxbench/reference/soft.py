"""Plain reference of the soft-voxel fit (config 4): the emission-only
volume render of S samples a ray over its clipped segment (or its
occupied band), MSE plus the even-pair TV prior, autograd, and Adam.

The semantics are vxtpu_torch's (``render/soft.py``,
``render/soft_kernel.py``, ``train/loss.py:tv_prior_morton``,
``render/occmask.py``, ``train/loop.py``), written again in plain tensor
code over a row-major [D^3, 4] table (row (x*D + y)*D + z holds sigma,
r, g, b), with the float dtype a parameter. The program keeps the same
rows in Morton order; every number compared (losses, norms) does not
depend on the order. The TV prior's pairs are (2a, 2a + 1) along each
axis, which in Morton order are the rows that differ in one of the low
three bits.
"""

from __future__ import annotations

import math

import torch

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
_T_EPS = 1e-10


def relu(x):
    return torch.maximum(x, torch.zeros_like(x))


def softplus(x):
    return relu(x) + torch.log1p(torch.exp(-x.abs()))


def clip(o, d, dims):
    """(t_enter >= 0, t_exit, valid) of rays against [0, X]x[0, Y]x[0, Z]."""
    sign = torch.where(d >= 0, 1.0, -1.0).to(d.dtype)
    inv = torch.clamp(sign / torch.clamp(d.abs(), min=1e-12), -1e30, 1e30)
    bmax = torch.tensor(dims, dtype=o.dtype, device=o.device)
    t0 = (0.0 - o) * inv
    t1 = (bmax - o) * inv
    t_enter = relu(torch.minimum(t0, t1).amax(dim=-1))
    t_exit = torch.maximum(t0, t1).amin(dim=-1)
    return t_enter, t_exit, t_enter <= t_exit


def sky(d, settings: dict):
    top = torch.tensor(settings["sky_top"], dtype=d.dtype, device=d.device)
    hor = torch.tensor(settings["sky_horizon"], dtype=d.dtype,
                       device=d.device)
    u = torch.clamp(d[..., 2] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    return hor * (1.0 - u) + top * u


def mask_at(mask, G: int, p):
    Xc, Yc, Zc = mask.shape
    hi = torch.tensor([Xc - 1, Yc - 1, Zc - 1], dtype=p.dtype,
                      device=p.device)
    ci = torch.minimum(torch.clamp(torch.floor(p.float() / G), min=0.0),
                       hi.float()).to(torch.int64)
    idx = (ci[..., 0] * Yc + ci[..., 1]) * Zc + ci[..., 2]
    return mask.reshape(-1)[idx].to(p.dtype)


def render(tab, o, d, D: int, S: int, settings: dict, bands=None,
           mask=None, G: int = 4):
    """rgb [N, 3] of rays o, d through the row-major table tab [D^3, 4]
    (differentiable with respect to tab). ``bands`` (t0, t1): each ray's
    occupied band, which narrows its segment; ``mask``: the coarse
    occupancy mask whose empty cells hold no density."""
    ft = tab.dtype
    o, d = o.to(ft), d.to(ft)
    t_enter, t_exit, valid = clip(o, d, (D, D, D))
    if bands is not None:
        t0 = torch.maximum(bands[0].to(ft), t_enter)
        t1 = torch.minimum(bands[1].to(ft), t_exit)
        dt = relu(t1 - t0) / S
    else:
        t0 = t_enter
        dt = relu(t_exit - t_enter) / S
    t0 = torch.where(valid, t0, 0.0)
    dt = torch.where(valid, dt, 0.0)
    s = torch.arange(S, dtype=ft, device=o.device) + 0.5
    t = t0[None, :] + dt[None, :] * s[:, None]                   # [S, N]
    p = torch.stack([o[None, :, k] + t * d[None, :, k] for k in range(3)],
                    dim=-1)                                       # [S, N, 3]
    q = p - 0.5
    q0 = torch.floor(q)
    f = q - q0
    # the index in float32: a low precision cannot hold every voxel index
    i0 = torch.clamp(q0.float(), 0.0, float(D - 1)).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=D - 1)
    act = (dt > 0)[None, :]
    idx = []
    for k in range(8):
        ix = (i1 if (k >> 2) & 1 else i0)[..., 0]
        iy = (i1 if (k >> 1) & 1 else i0)[..., 1]
        iz = (i1 if k & 1 else i0)[..., 2]
        idx.append(torch.where(act, (ix * D + iy) * D + iz, 0))
    # index_select: its backward adds into the table's gradient
    rows = tab.index_select(0, torch.stack(idx).reshape(-1)).view(
        8, S, o.shape[0], tab.shape[-1])                          # [8,S,N,4]
    rows = torch.where(act[None, ..., None], rows, 0.0)
    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    c00 = rows[0] * (1.0 - fz) + rows[1] * fz
    c01 = rows[2] * (1.0 - fz) + rows[3] * fz
    c10 = rows[4] * (1.0 - fz) + rows[5] * fz
    c11 = rows[6] * (1.0 - fz) + rows[7] * fz
    c0 = c00 * (1.0 - fy) + c01 * fy
    c1 = c10 * (1.0 - fy) + c11 * fy
    val = torch.where(act[..., None], c0 * (1.0 - fx) + c1 * fx, 0.0)
    sigma = softplus(val[..., 0])
    rgb = torch.sigmoid(val[..., 1:])
    if mask is not None:
        sigma = sigma * mask_at(mask, G, p)
    alpha = 1.0 - torch.exp(-sigma * dt[None, :])
    alpha = torch.where(valid[None, :], alpha, 0.0)
    one_m = 1.0 - alpha + _T_EPS
    T = torch.cumprod(torch.cat([torch.ones_like(one_m[:1]), one_m[:-1]],
                                dim=0), dim=0)
    w = T * alpha
    color = torch.sum(w[..., None] * rgb, dim=0)
    return color + torch.prod(one_m, dim=0)[:, None] * sky(d, settings)


def tv_prior(tab, D: int, tv_sigma: float, tv_rgb: float):
    """tv_sigma * TV(sigma) + tv_rgb * mean over r, g, b of TV(c), each TV
    the mean squared difference of the even pairs (2a, 2a + 1) along each
    axis, summed over the axes, x 2/3."""
    T = tab.view(D, D, D, tab.shape[-1])
    diffs = (T[1::2] - T[0::2], T[:, 1::2] - T[:, 0::2],
             T[:, :, 1::2] - T[:, :, 0::2])
    per = sum(torch.mean(x ** 2, dim=(0, 1, 2)) for x in diffs)
    return 2.0 * (tv_sigma * per[0] + tv_rgb * torch.mean(per[1:])) / 3.0


def occupancy_mask(tab, D: int, G: int, tau: float):
    """uint8 [D/G]^3: cells with a voxel of softplus(sigma) > tau, grown by
    their six face neighbours (wrapping at the borders)."""
    occ = softplus(tab[:, 0].view(D, D, D)) > tau
    n = D // G
    m = occ.reshape(n, G, n, G, n, G).any(dim=5).any(dim=3).any(dim=1)
    grown = m
    for ax in range(3):
        for sh in (1, -1):
            grown = grown | torch.roll(m, sh, dims=ax)
    return grown.to(torch.uint8)


def bands(mask, G: int, o, d):
    """(t0, t1) world-unit band of each ray from its first to its last
    occupied mask cell (0, 0 for a ray that crosses none), by a plain
    cell-by-cell DDA over the mask grid. float32."""
    o, d = o.float(), d.float()
    md = tuple(int(x) for x in mask.shape)
    om = o / float(G)
    t_enter, t_exit, valid = clip(om, d, md)
    n = o.shape[0]
    dev = o.device
    p = om + (t_enter + 1e-4)[:, None] * d
    hi = torch.tensor(md, device=dev) - 1
    v = torch.minimum(torch.clamp(torch.floor(p), min=0.0).to(torch.int64),
                      hi)
    step = torch.where(d >= 0, 1, -1).to(torch.int64)
    inv = 1.0 / torch.where(d.abs() < 1e-12, 1e-12, d.abs())
    nxt = (v + (step > 0).to(torch.int64)).to(torch.float32)
    t_next = torch.where(d.abs() < 1e-12, 3e30, (nxt - om) * (step * inv))
    t_delta = torch.where(d.abs() < 1e-12, 3e30, inv)
    t_cur = t_enter.clone()
    live = valid.clone()
    first = torch.zeros(n, dtype=torch.float32, device=dev)
    last = torch.zeros(n, dtype=torch.float32, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    flat = mask.reshape(-1)
    Yc, Zc = md[1], md[2]
    for _ in range(sum(md) + 2):
        inb = ((v >= 0) & (v <= hi)).all(dim=-1)
        live = live & inb & (t_cur <= t_exit)
        vc = torch.where(live[:, None], v, 0)
        occ = live & (flat[(vc[:, 0] * Yc + vc[:, 1]) * Zc + vc[:, 2]] > 0)
        t_out = torch.minimum(t_next.amin(dim=-1), t_exit)
        first = torch.where(occ & ~found, t_cur, first)
        last = torch.where(occ, t_out, last)
        found = found | occ
        a = t_next.argmin(dim=-1, keepdim=True)
        t_cur = torch.where(live, t_next.gather(1, a)[:, 0], t_cur)
        v = v + torch.zeros_like(v).scatter_(1, a, step.gather(1, a)) \
            * live[:, None]
        t_next = t_next + torch.zeros_like(t_next).scatter_(
            1, a, t_delta.gather(1, a)) * live[:, None]
        if not bool(live.any()):
            break
    t0 = float(G) * torch.where(found, first, 0.0)
    t1 = torch.maximum(float(G) * torch.where(found, last, 0.0), t0)
    return t0, t1


def render_blocks(tab, o, d, D, S, settings, block: int, **kw):
    """render() over blocks of rays, no gradient."""
    with torch.no_grad():
        return torch.cat([render(tab, o[i:i + block], d[i:i + block], D, S,
                                 settings, **_slice(kw, i, block))
                          for i in range(0, o.shape[0], block)])


def _slice(kw: dict, i: int, block: int) -> dict:
    out = dict(kw)
    if kw.get("bands") is not None:
        out["bands"] = tuple(b[i:i + block] for b in kw["bands"])
    return out


def loss(tab, o, d, target, D, S, settings, tv, block: int, **kw) -> float:
    """MSE(render, target) + the TV prior, no gradient, in float64."""
    pred = render_blocks(tab, o, d, D, S, settings, block, **kw)
    with torch.no_grad():
        return float(torch.mean((pred.float() - target.float()) ** 2)
                     .double() + tv_prior(tab.float(), D, *tv).double())


def loss_and_grad(tab, o, d, target, D, S, settings, tv, block: int,
                  **kw):
    """(loss, gradient [D^3, 4]) of MSE(render, target) + the TV prior,
    the render in blocks of rays."""
    leaf = tab.detach().requires_grad_(True)
    n3 = target.numel()
    total = torch.zeros((), dtype=torch.float64, device=tab.device)
    for i in range(0, o.shape[0], block):
        pred = render(leaf, o[i:i + block], d[i:i + block], D, S, settings,
                      **_slice(kw, i, block))
        part = torch.sum((pred - target[i:i + block].to(pred.dtype)) ** 2)
        (part / n3).backward()
        total += part.detach().double()
    prior = tv_prior(leaf, D, tv[0], tv[1])
    prior.backward()
    return float(total / n3 + prior.detach().double()), leaf.grad


def adam(p, g, m, v, step: int, lr: float):
    """One step of Adam (torch.optim.Adam's arithmetic), in place."""
    m.lerp_(g, 1.0 - BETAS[0])
    v.mul_(BETAS[1]).addcmul_(g, g, value=1.0 - BETAS[1])
    bc1 = 1.0 - BETAS[0] ** step
    bc2 = 1.0 - BETAS[1] ** step
    denom = (v.sqrt() / math.sqrt(bc2)).add_(ADAM_EPS)
    p.addcdiv_(m, denom, value=-lr / bc1)


def leaf_norms(t) -> list:
    """Euclidean norms of the table's two leaves, (sigma, rgb), as the
    optimizer state keeps them: column 0 and columns 1-3."""
    t = t.double()
    return [float(torch.linalg.vector_norm(t[:, 0])),
            float(torch.linalg.vector_norm(t[:, 1:]))]
