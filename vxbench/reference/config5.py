"""Plain reference of config 5's per-frame fit (``train/config5.py``):
the orbit's true pose, the pose estimate carried from frame to frame, the
yaw/pitch camera's rays in camera frame turned into world rays, the lit
soft render (trilinear density and rgb logits, the density-gradient
normal, one light's diffuse and specular terms as ``soft.shade_samples``
defines them, compositing over S samples with the sky behind), the mean
squared error over all rays, autograd to the grid and to the camera
(pos, yaw, pitch, fov_y), and Adam with the grid's and the camera's
learning rates.

The semantics are vxtpu_torch's (``train/config5.py``,
``engine/sharding.py``, ``render/vjp.py``, ``render/soft.py``,
``camera/``), written again in plain tensor code with the float dtype a
parameter. TF32 is off for every matmul. Conventions kept, and where the
reference departs:

- ``max(n.l, 0)``, ``max(n.h, 0)`` and the clip's ``max(t, 0)`` pass half
  the gradient where the argument is 0, as ``jnp.maximum`` does and the
  program's ``dda.relu_like_jax`` keeps: ``torch.maximum(x, 0)`` here.
  Every sample of an untouched grid sits there (zero density gradient).
- The grid is one row-major [D^3, 4] table (row (x*D + y)*D + z holds
  sigma, r, g, b) with Adam's moments in the same layout; the program
  keeps planar sigma [X, Y, Z] and rgb [3, X, Y, Z] and gathers the same
  rows. Every number compared is a norm by leaf (sigma, rgb, pos, yaw,
  pitch, fov_y), which the layout does not change.
- The program marches the samples one at a time with a hand-written
  backward (``render/vjp.py``); the reference renders all S samples of a
  block of rays at once and lets autograd differentiate. Blocks change
  nothing but rounding: the loss is a sum over rays, accumulated here in
  float64.
- The program's ``_world_rays`` adds the camera's position to zero
  origin offsets; so does the reference. The field of view reaches the
  rays only through the camera-frame directions, which are constants of
  a step, so fov_y's gradient is 0 in both.
- Voxel indices are computed in float32 whatever the dtype: a low
  precision cannot hold every index.
"""

from __future__ import annotations

import math

import torch

from vxbench import camera, world
from vxbench.reference import soft as rsoft

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BETAS = rsoft.BETAS
LEAVES = ("sigma", "rgb", "pos", "yaw", "pitch", "fov_y")
_T_EPS = 1e-10


def orbit_pose(cfg: dict, dims, frame: int, device):
    """(pos, yaw, pitch, fov_y) float32 of the true camera at ``frame``:
    the orbit of ``cfg["orbit"]`` (centre, radius and height as shares of
    the grid) aimed at its centre, a loop of ``frames`` frames."""
    X, Y, Z = dims
    c5, orb = cfg["config5"], cfg["orbit"]
    f32 = dict(dtype=torch.float32, device=device)
    center = torch.as_tensor([orb["center"][0] * X, orb["center"][1] * Y,
                              orb["center"][2] * Z], **f32)
    pos = camera.orbit_pos(center, orb["radius"] * X, orb["height"] * Z,
                           c5["frames"] / c5["fps"], frame / c5["fps"])
    yaw, pitch = camera.look_at(pos, center)
    fov = torch.as_tensor(float(orb["fov_deg"]), **f32) * (math.pi / 180.0)
    return pos, yaw, pitch, fov


def light(cfg: dict, dims, device):
    """(pos [3], rgb [3], intensity) of the configuration's one light."""
    li = cfg["light"]
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor([a * n for a, n in zip(li["pos"], dims)], **f32),
            torch.as_tensor(li["rgb"], **f32),
            torch.as_tensor(float(li["intensity"]), **f32))


def truth_table(dims, seed: int, sigma_solid: float, device):
    """Row-major [D^3, 4] (sigma, r, g, b) of the seed's terrain as a soft
    grid."""
    occ, rgb = world.terrain(dims, seed, device)
    sigma, rgb_raw = world.soft_truth(occ, rgb, sigma_solid)
    del occ, rgb
    return torch.cat([sigma.reshape(-1, 1), rgb_raw.reshape(3, -1).t()],
                     dim=1)


def basis_matrix(yaw, pitch):
    """[3 (world), 3 (camera)]: the columns forward, right, up."""
    return torch.stack(camera.basis(yaw, pitch), dim=1)


def camera_frame_dirs(pos, yaw, pitch, fov, h: int, w: int):
    """[H*W, 3]: the directions of the camera's rays as coefficients of
    its (forward, right, up) basis (``sharding.camera_frame_rays``)."""
    _, d = camera.rays(pos, yaw, pitch, fov, h, w)
    return d @ basis_matrix(yaw, pitch)


def _grad8(c, fx, fy, fz):
    """(gx, gy, gz): the derivative of the trilinear basis over the corner
    values c000..c111 (k = ex*4 + ey*2 + ez)."""
    c000, c001, c010, c011, c100, c101, c110, c111 = c
    gx = (((c100 - c000) * (1 - fy) + (c110 - c010) * fy) * (1 - fz)
          + ((c101 - c001) * (1 - fy) + (c111 - c011) * fy) * fz)
    gy = (((c010 - c000) * (1 - fx) + (c110 - c100) * fx) * (1 - fz)
          + ((c011 - c001) * (1 - fx) + (c111 - c101) * fx) * fz)
    gz = (((c001 - c000) * (1 - fx) + (c101 - c100) * fx) * (1 - fy)
          + ((c011 - c010) * (1 - fx) + (c111 - c110) * fx) * fy)
    return gx, gy, gz


def shade(c, g, p, d, lt, settings: dict):
    """Lambert (+ Blinn-Phong for 'full') lighting of sample colours c
    [..., 3] by one light lt = (pos, rgb, intensity), the normal
    -normalize(g) of the raw density's gradient g [..., 3] at points p,
    viewed along d (``soft.shade_samples``)."""
    lpos, lrgb, lint = (x.to(c.dtype) for x in lt)
    relu = rsoft.relu
    n = -g * torch.rsqrt(torch.sum(g * g, dim=-1, keepdim=True) + 1e-9)
    lvec = lpos - p
    dist2 = torch.sum(lvec * lvec, dim=-1, keepdim=True)
    ldir = lvec * torch.rsqrt(torch.clamp(dist2, min=1e-12))
    ndotl = relu(torch.sum(n * ldir, dim=-1, keepdim=True))
    atten = lint / (1.0 + 0.002 * dist2)
    out = c * (settings["ambient"] + ndotl * atten * lrgb)
    if settings["shading"] == "full":
        hv = ldir - d
        hv = hv * torch.rsqrt(torch.clamp(torch.sum(hv * hv, dim=-1,
                                                    keepdim=True), min=1e-12))
        ndoth = relu(torch.sum(n * hv, dim=-1, keepdim=True))
        spec = (settings["specular_k"]
                * torch.pow(ndoth, settings["specular_exp"])
                * (ndotl > 0.0) * atten)
        out = out + spec * lrgb
    return out


def render(tab, o, d, D: int, S: int, settings: dict, lt=None):
    """rgb [N, 3] of rays o, d through the row-major table tab [D^3, 4],
    lit by lt = (pos, rgb, intensity) when given; differentiable with
    respect to tab, o and d."""
    ft = tab.dtype
    o, d = o.to(ft), d.to(ft)
    t_enter, t_exit, valid = rsoft.clip(o, d, (D, D, D))
    dt = torch.where(valid, rsoft.relu(t_exit - t_enter) / S, 0.0)
    t0 = torch.where(valid, t_enter, 0.0)
    s = torch.arange(S, dtype=ft, device=o.device) + 0.5
    t = t0[None, :] + dt[None, :] * s[:, None]                   # [S, N]
    p = o[None] + t[..., None] * d[None]                          # [S, N, 3]
    q = p - 0.5
    q0 = torch.floor(q)
    f = q - q0
    i0 = torch.clamp(q0.float(), 0.0, float(D - 1)).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=D - 1)
    idx = []
    for k in range(8):
        ix = (i1 if (k >> 2) & 1 else i0)[..., 0]
        iy = (i1 if (k >> 1) & 1 else i0)[..., 1]
        iz = (i1 if k & 1 else i0)[..., 2]
        idx.append((ix * D + iy) * D + iz)
    # index_select: its backward adds into the table's gradient
    rows = tab.index_select(0, torch.stack(idx).reshape(-1)).view(
        8, S, o.shape[0], tab.shape[-1]).unbind(0)                # 8 [S,N,4]
    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    c00 = rows[0] * (1.0 - fz) + rows[1] * fz
    c01 = rows[2] * (1.0 - fz) + rows[3] * fz
    c10 = rows[4] * (1.0 - fz) + rows[5] * fz
    c11 = rows[6] * (1.0 - fz) + rows[7] * fz
    c0 = c00 * (1.0 - fy) + c01 * fy
    c1 = c10 * (1.0 - fy) + c11 * fy
    val = c0 * (1.0 - fx) + c1 * fx                               # [S,N,4]
    sigma = rsoft.softplus(val[..., 0])
    rgb = torch.sigmoid(val[..., 1:])
    if lt is not None:
        g = torch.stack(_grad8([r[..., 0] for r in rows], f[..., 0],
                               f[..., 1], f[..., 2]), dim=-1)
        rgb = shade(rgb, g, p, d[None], lt, settings)
    alpha = torch.where(valid[None, :], 1.0 - torch.exp(-sigma * dt[None, :]),
                        0.0)
    one_m = 1.0 - alpha + _T_EPS
    T = torch.cumprod(torch.cat([torch.ones_like(one_m[:1]), one_m[:-1]],
                                dim=0), dim=0)
    color = torch.sum((T * alpha)[..., None] * rgb, dim=0)
    return color + torch.prod(one_m, dim=0)[:, None] * rsoft.sky(d, settings)


def render_blocks(tab, o, d, D, S, settings, block: int, lt=None):
    """render() over blocks of rays, no gradient."""
    with torch.no_grad():
        return torch.cat([render(tab, o[i:i + block], d[i:i + block], D, S,
                                 settings, lt)
                          for i in range(0, o.shape[0], block)])


def loss_and_grads(tab, cam, d_c, target, D, S, settings, block: int,
                   lt=None):
    """(loss, [gradient of tab [D^3, 4], of pos, yaw, pitch, fov_y]) of
    the mean squared error over all rays of the world rays of cam =
    (pos, yaw, pitch, fov_y) with camera-frame directions d_c, rendered in
    blocks of rays."""
    leaf = tab.detach().requires_grad_(True)
    cam_l = [x.detach().to(tab.dtype).requires_grad_(True) for x in cam]
    n3 = target.numel()
    total = torch.zeros((), dtype=torch.float64, device=tab.device)
    for i in range(0, d_c.shape[0], block):
        dc = d_c[i:i + block].to(tab.dtype)
        o_w = cam_l[0].expand(dc.shape) + torch.zeros_like(dc)
        d_w = dc @ basis_matrix(cam_l[1], cam_l[2]).t()
        pred = render(leaf, o_w, d_w, D, S, settings, lt)
        part = torch.sum((pred - target[i:i + block].to(pred.dtype)) ** 2)
        (part / n3).backward()
        total += part.detach().double()
    grads = [leaf.grad] + [torch.zeros_like(x) if x.grad is None else x.grad
                           for x in cam_l]
    return float(total / n3), grads


def leaf_norms(tab_like, cam_like) -> list:
    """Euclidean norms by leaf: sigma, rgb (columns 0 and 1-3 of a [D^3,
    4] table), then pos, yaw, pitch, fov_y."""
    return rsoft.leaf_norms(tab_like) + [
        float(torch.linalg.vector_norm(x.double())) for x in cam_like]


def follow_frame(start: dict, cfg: dict, settings: dict, dims, h: int,
                 w: int, S: int, frame: int, target, block: int,
                 dtype=torch.float32, lit: bool = True) -> dict:
    """Frame ``frame`` of the fit from ``start``, the state after the last
    step of the frame before: ``tab`` [D^3, 4]; ``cam`` (pos, yaw, pitch,
    fov_y) as that step left it; ``m``, ``v``: Adam's moments, a [D^3, 4]
    table and the camera's four; ``steps``: Adam's step count. The pose
    estimate starts at the true pose with the yaw and pitch error the
    frame before carried over; each step renders the estimate's rays
    against ``target`` [H*W, 3]. Returns the steps' losses, the first
    step's gradient norms by leaf, the estimate the frame started from
    and the parameters after its last step."""
    c5 = cfg["config5"]
    D, dev = dims[0], start["tab"].device
    lt = light(cfg, dims, dev) if lit else None
    prev = orbit_pose(cfg, dims, frame - 1, dev)
    true = orbit_pose(cfg, dims, frame, dev)
    off_yaw = start["cam"][1] - prev[1]
    off_pitch = start["cam"][2] - prev[2]
    cam0 = [true[0], true[1] + off_yaw, true[2] + off_pitch, true[3]]
    p = [start["tab"].to(dtype).clone()] + [x.to(dtype).clone()
                                             for x in cam0]
    m = [x.to(dtype).clone() for x in start["m"]]
    v = [x.to(dtype).clone() for x in start["v"]]
    lrs = [c5["lr"]] + [c5["cam_lr"]] * 4
    losses, g0 = [], None
    for k in range(int(c5["steps_per_frame"])):
        d_c = camera_frame_dirs(*[x.float() for x in p[1:]], h, w)
        loss, g = loss_and_grads(p[0], p[1:], d_c, target, D, S, settings,
                                 block, lt)
        losses.append(loss)
        if k == 0:
            g0 = leaf_norms(g[0], g[1:])
        with torch.no_grad():
            for x, gx, mx, vx, lr in zip(p, g, m, v, lrs):
                rsoft.adam(x, gx.to(dtype), mx, vx, start["steps"] + k + 1,
                           lr)
        del g
    return dict(losses=losses, g0=g0, cam0=cam0, tab=p[0], cam=p[1:])
