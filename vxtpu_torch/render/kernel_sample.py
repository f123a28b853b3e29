"""The trilinear field-sampling kernels and their plain PyTorch versions.

Counterpart of ``vxtpu/render/kernel_sample.py``: ``sample_fields_fwd``
replaces the Pallas kernel ``_sample_fwd_kernel`` and
``sample_fields_bwd`` replaces ``_sample_bwd_kernel``, its backward. Both
kernels are hand-written CUDA C++ in ``vxtpu_torch/csrc/sample.cu``,
built for sm_90a at first use.

The four fields (sigma, r, g, b) live in one channel-interleaved table
``tab``, float32 [D^3, 4]: row m holds the four values of the fine voxel
(i, j, k) with ``morton3(i, j, k) == m`` (D a power of two). vxtpu keeps
four planar tables in the same order as [D^3/128, 128] rows;
``build_interleaved_morton`` / ``fields_from_interleaved`` and
``interleave_tables`` / ``split_table`` convert.

For ray n and sample s < S the forward takes p = o + (t0 + dt (s + 1/2)) d
and samples the four fields trilinearly there, returning four [S, N]
planes, and with ``lit`` three more: the spatial gradient of sigma. The
backward walks the same samples again and scatter-adds the cotangents
times the corner weights into a gradient of the table's own shape
[D^3, 4]; with ``ray_grads`` it also sums each ray's cotangents of o, d,
t0 and dt, and without it (rays that need no gradient, the trainer's
main path) it reads no table and computes none. Rays with dt == 0 give 0
in every channel and get no gradient. Gradients flow through the
interpolation weights only: corner indices are constants, as in vxtpu.
Semantics are ``render/soft.trilinear`` / ``trilinear_grad``, including
their corner clamp (see ``soft._corners``).

On a CUDA tensor the wrappers launch the kernels or raise; on a CPU tensor
they run the plain versions, ``sample_fields_fwd_reference`` and
``sample_fields_bwd_reference``, which repeat the kernels' arithmetic
operation by operation. The kernels' scatter adds with float atomics in
an order that changes between runs, so their gradient tables match the
plain version (which sums in float64) and each other within rounding,
not bit for bit (vxtpu's TPU scatter is bitwise deterministic); the ray
cotangents are summed in a fixed order and match bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from vxtpu_torch.render.kernel_march import _check, _device_kind
from vxtpu_torch.world.packed import (_morton_order, _require_cubic_pow2,
                                      morton3, part1by2)

NCH = 4  # sigma, r, g, b

# Kernel launches since the last reset_launch_counts(), by kernel name.
# Each wrapper adds one where it launches its kernel, and nowhere else.
LAUNCHES = {"sample_fwd_kernel": 0, "sample_bwd_kernel<kRayGrads=false>": 0,
            "sample_bwd_kernel<kRayGrads=true>": 0,
            "sample_ray_sum_kernel": 0}

# samples per thread of sample_bwd_kernel<kRayGrads=true>: its per-ray
# sums run over s within each chunk, then over the chunks, and the plain
# version sums in the same order. The wrapper passes it to the kernel,
# which refuses a value other than its compile-time kChunk.
RAY_CHUNK = 16


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_field_morton(field: torch.Tensor) -> torch.Tensor:
    """[D, D, D] field (D a power of two) -> flat float32 [D^3] in Morton
    order, on the field's device."""
    _require_cubic_pow2(tuple(field.shape))
    return _morton_order(field.to(torch.float32))


def _morton_index(dim: int, device) -> torch.Tensor:
    """int64 [dim^3]: the Morton code of each voxel in row-major order."""
    r = torch.arange(dim, dtype=torch.int64, device=device)
    return morton3(r[:, None, None], r[None, :, None],
                   r[None, None, :]).reshape(-1)


def field_from_morton(table: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of build_field_morton: flat [dim^3] -> [dim, dim, dim]."""
    return table.reshape(-1)[_morton_index(dim, table.device)].reshape(
        dim, dim, dim)


def build_interleaved_morton(sigma: torch.Tensor,
                             rgb: torch.Tensor) -> torch.Tensor:
    """sigma [D, D, D] and rgb [3, D, D, D] (D a power of two) -> the
    channel-interleaved table float32 [D^3, 4], row morton3(i, j, k) =
    (sigma, r, g, b) of voxel (i, j, k), on sigma's device."""
    dim = sigma.shape[0]
    _require_cubic_pow2(tuple(sigma.shape))
    if tuple(rgb.shape) != (3, dim, dim, dim):
        raise ValueError(f"rgb must be [3, {dim}, {dim}, {dim}], got "
                         f"{tuple(rgb.shape)}")
    mi = _morton_index(dim, sigma.device)
    tab = torch.empty((dim ** 3, NCH), dtype=torch.float32,
                      device=sigma.device)
    tab[mi, 0] = sigma.reshape(-1).to(torch.float32)
    tab[mi, 1:] = rgb.reshape(3, -1).t().to(torch.float32)
    return tab


def fields_from_interleaved(tab: torch.Tensor, dim: int):
    """Inverse of build_interleaved_morton: [dim^3, 4] -> (sigma [dim, dim,
    dim], rgb [3, dim, dim, dim])."""
    rows = tab[_morton_index(dim, tab.device)]
    return (rows[:, 0].reshape(dim, dim, dim),
            rows[:, 1:].t().reshape(3, dim, dim, dim))


def interleave_tables(sigma_tab: torch.Tensor,
                      rgb_tab: torch.Tensor) -> torch.Tensor:
    """vxtpu's planar Morton tables, sigma [D^3] and rgb [3, D^3] (or any
    shapes holding those words in that order, such as [rows, 128] and
    [3, rows, 128]) -> one [D^3, 4] table."""
    return torch.cat([sigma_tab.reshape(-1, 1),
                      rgb_tab.reshape(3, -1).t()], dim=1).to(torch.float32)


def split_table(tab: torch.Tensor):
    """Inverse of interleave_tables: [D^3, 4] -> (sigma [D^3], rgb
    [3, D^3]), both contiguous copies."""
    return tab[:, 0].contiguous(), tab[:, 1:].t().contiguous()


# --------------------------------------------------------------------------
# plain PyTorch versions (the kernels' arithmetic, operation by operation)


def _positions(o, d, t0, dt, S):
    """t and p = o + t d of every sample: [S, N] planes."""
    s = torch.arange(S, dtype=torch.float32, device=o.device) + 0.5
    t = t0[None, :] + dt[None, :] * s[:, None]
    px = o[None, :, 0] + t * d[None, :, 0]
    py = o[None, :, 1] + t * d[None, :, 1]
    pz = o[None, :, 2] + t * d[None, :, 2]
    return t, px, py, pz


def _corner_setup(px, py, pz, D):
    """Morton codes of the 8 corners (k = ex*4 + ey*2 + ez) and the
    fractions, as csrc/sample.cu's corner_setup."""
    fs, sp = [], []
    for p in (px, py, pz):
        q = p - 0.5
        q0 = torch.floor(q)
        fs.append(q - q0)
        i0 = torch.clamp(q0, 0.0, float(D - 1)).to(torch.int64)
        sp.append((part1by2(i0), part1by2(torch.clamp(i0 + 1, max=D - 1))))
    sx, sy, sz = sp
    codes = [sx[(k >> 2) & 1] | (sy[(k >> 1) & 1] << 1) | (sz[k & 1] << 2)
             for k in range(8)]
    return codes, fs[0], fs[1], fs[2]


def _lerp_ladder(v, fx, fy, fz):
    c00 = v[0] * (1.0 - fz) + v[1] * fz
    c01 = v[2] * (1.0 - fz) + v[3] * fz
    c10 = v[4] * (1.0 - fz) + v[5] * fz
    c11 = v[6] * (1.0 - fz) + v[7] * fz
    c0 = c00 * (1.0 - fy) + c01 * fy
    c1 = c10 * (1.0 - fy) + c11 * fy
    return c0 * (1.0 - fx) + c1 * fx


def _grad_ladder(v, fx, fy, fz):
    c000, c001, c010, c011, c100, c101, c110, c111 = v
    gx = (((c100 - c000) * (1.0 - fy) + (c110 - c010) * fy) * (1.0 - fz)
          + ((c101 - c001) * (1.0 - fy) + (c111 - c011) * fy) * fz)
    gy = (((c010 - c000) * (1.0 - fx) + (c110 - c100) * fx) * (1.0 - fz)
          + ((c011 - c001) * (1.0 - fx) + (c111 - c101) * fx) * fz)
    gz = (((c001 - c000) * (1.0 - fx) + (c101 - c100) * fx) * (1.0 - fy)
          + ((c011 - c010) * (1.0 - fx) + (c111 - c110) * fx) * fy)
    return gx, gy, gz


def _value_f_grads(v, fx, fy, fz):
    c00 = v[0] * (1.0 - fz) + v[1] * fz
    c01 = v[2] * (1.0 - fz) + v[3] * fz
    c10 = v[4] * (1.0 - fz) + v[5] * fz
    c11 = v[6] * (1.0 - fz) + v[7] * fz
    c0 = c00 * (1.0 - fy) + c01 * fy
    c1 = c10 * (1.0 - fy) + c11 * fy
    dfx = c1 - c0
    dfy = (c01 - c00) * (1.0 - fx) + (c11 - c10) * fx
    dfz = (((v[1] - v[0]) * (1.0 - fy) + (v[3] - v[2]) * fy) * (1.0 - fx)
           + ((v[5] - v[4]) * (1.0 - fy) + (v[7] - v[6]) * fy) * fx)
    return dfx, dfy, dfz


def _grad_f_grads(v, fx, fy, fz, ggx, ggy, ggz):
    c000, c001, c010, c011, c100, c101, c110, c111 = v
    dgx_dfy = (((c110 - c010) - (c100 - c000)) * (1.0 - fz)
               + ((c111 - c011) - (c101 - c001)) * fz)
    dgx_dfz = (((c101 - c001) * (1.0 - fy) + (c111 - c011) * fy)
               - ((c100 - c000) * (1.0 - fy) + (c110 - c010) * fy))
    dgy_dfx = (((c110 - c100) - (c010 - c000)) * (1.0 - fz)
               + ((c111 - c101) - (c011 - c001)) * fz)
    dgy_dfz = (((c011 - c001) * (1.0 - fx) + (c111 - c101) * fx)
               - ((c010 - c000) * (1.0 - fx) + (c110 - c100) * fx))
    dgz_dfx = (((c101 - c100) - (c001 - c000)) * (1.0 - fy)
               + ((c111 - c110) - (c011 - c010)) * fy)
    dgz_dfy = (((c011 - c010) * (1.0 - fx) + (c111 - c110) * fx)
               - ((c001 - c000) * (1.0 - fx) + (c101 - c100) * fx))
    return (ggy * dgy_dfx + ggz * dgz_dfx, ggx * dgx_dfy + ggz * dgz_dfy,
            ggx * dgx_dfz + ggy * dgy_dfz)


def _fetch(tab, codes, act):
    """The 8 corner rows [S, N, 4] of the table; 0 for inactive rays,
    which fetch nothing."""
    return [torch.where(act[..., None], tab[torch.where(act, c, 0)], 0.0)
            for c in codes]


def _channel(rows, c):
    return [r[..., c] for r in rows]


def sample_fields_fwd_reference(tab, o, d, t0, dt, S: int, dim: int,
                                lit: bool = False):
    """Plain version of ``sample_fields_fwd``."""
    act = (dt > 0)[None, :]
    _, px, py, pz = _positions(o, d, t0, dt, S)
    codes, fx, fy, fz = _corner_setup(px, py, pz, dim)
    rows = _fetch(tab, codes, act)
    outs = [torch.where(act, _lerp_ladder(_channel(rows, c), fx, fy, fz),
                        0.0) for c in range(NCH)]
    if lit:
        outs += [torch.where(act, g, 0.0)
                 for g in _grad_ladder(_channel(rows, 0), fx, fy, fz)]
    return tuple(outs)


def sample_fields_bwd_reference(tab, o, d, t0, dt, cots, dim: int,
                                lit: bool = False, ray_grads: bool = True):
    """Plain version of ``sample_grads``: the gradient [dim^3, 4] by
    index_add_, summed in float64 (the exact sums that the kernel's float
    atomics approximate, in whatever order they land); with ``ray_grads``
    the per-ray sums in the kernel's order (over s within chunks of
    RAY_CHUNK samples, then over the chunks), else None for the four ray
    outputs, which are not computed."""
    S, n = cots[0].shape
    act = (dt > 0)[None, :]
    t, px, py, pz = _positions(o, d, t0, dt, S)
    codes, fx, fy, fz = _corner_setup(px, py, pz, dim)
    w = ((1.0 - fx, fx), (1.0 - fy, fy), (1.0 - fz, fz))
    sel = act.expand(S, n)
    grad = torch.zeros((dim ** 3, NCH), dtype=torch.float64, device=o.device)
    for k in range(8):
        ex, ey, ez = (k >> 2) & 1, (k >> 1) & 1, k & 1
        wk = w[0][ex] * w[1][ey] * w[2][ez]
        gc = [cots[c] * wk for c in range(NCH)]
        if lit:
            dsx = (1.0 if ex else -1.0) * w[1][ey] * w[2][ez]
            dsy = w[0][ex] * (1.0 if ey else -1.0) * w[2][ez]
            dsz = w[0][ex] * w[1][ey] * (1.0 if ez else -1.0)
            gc[0] = gc[0] + cots[4] * dsx + cots[5] * dsy + cots[6] * dsz
        grad.index_add_(0, codes[k][sel],
                        torch.stack(gc, dim=-1)[sel].double())
    grad = grad.float()
    if not ray_grads:
        return grad, None, None, None, None
    rows = _fetch(tab, codes, act)
    gfx = gfy = gfz = 0.0
    for c in range(NCH):
        dfx, dfy, dfz = _value_f_grads(_channel(rows, c), fx, fy, fz)
        gfx = gfx + cots[c] * dfx
        gfy = gfy + cots[c] * dfy
        gfz = gfz + cots[c] * dfz
    if lit:
        g2 = _grad_f_grads(_channel(rows, 0), fx, fy, fz, cots[4], cots[5],
                           cots[6])
        gfx, gfy, gfz = gfx + g2[0], gfy + g2[1], gfz + g2[2]
    gdot = gfx * d[None, :, 0] + gfy * d[None, :, 1] + gfz * d[None, :, 2]
    sf = torch.arange(S, dtype=torch.float32, device=o.device) + 0.5
    terms = torch.stack((gfx, gfy, gfz, gfx * t, gfy * t, gfz * t, gdot,
                         gdot * sf[:, None]))
    terms = torch.where(act, terms, 0.0)                     # [8, S, N]
    # the kernel's order: s in order within each chunk, then the chunks
    part = terms.new_zeros((max(-(-S // RAY_CHUNK), 1), 8, n))
    for s in range(S):
        part[s // RAY_CHUNK] = part[s // RAY_CHUNK] + terms[:, s]
    return (grad, *ray_sums_reference(part))


def ray_sums_reference(part: torch.Tensor):
    """Plain version of ``ray_sums``: the chunks added in chunk order."""
    acc = torch.zeros_like(part[0])
    for p in part:
        acc = acc + p
    return acc[0:3].t(), acc[3:6].t(), acc[6], acc[7]


# --------------------------------------------------------------------------
# kernel wrappers


def _check_rays(tab, o, d, t0, dt, dim):
    device = o.device
    _device_kind(device)
    _require_cubic_pow2((dim,) * 3)
    f32 = torch.float32
    _check("tab", tab, f32, (dim ** 3, NCH), device)
    if device.type == "cuda" and tab.data_ptr() % 16:
        raise ValueError("tab must be 16-byte aligned (the kernels read "
                         "its rows as float4)")
    n = o.shape[0]
    _check("o", o, f32, (n, 3), device)
    _check("d", d, f32, (n, 3), device)
    _check("t0", t0, f32, (n,), device)
    _check("dt", dt, f32, (n,), device)
    return device, n


def _ptrs(xs):
    return (ctypes.c_void_p * len(xs))(*[x.data_ptr() for x in xs])


def sample_fields_fwd(tab, o, d, t0, dt, S: int, dim: int,
                      lit: bool = False):
    """Raw trilinear samples along rays: (sigma, r, g, b[, gsx, gsy, gsz]),
    each float32 [S, N]. tab: the channel-interleaved Morton table
    [dim^3, 4]; o, d [N, 3]; t0, dt [N]. CUDA tensors launch
    ``sample_fwd_kernel``; CPU tensors run the plain version."""
    device, n = _check_rays(tab, o, d, t0, dt, dim)
    if device.type == "cpu":
        return sample_fields_fwd_reference(tab, o, d, t0, dt, S, dim, lit)

    from vxtpu_torch import _build

    lib = _build.load()
    outs = [torch.empty((S, n), dtype=torch.float32, device=device)
            for _ in range(7 if lit else 4)]
    if n and S:
        rc = lib.vx_sample_fwd(
            o.data_ptr(), d.data_ptr(), t0.data_ptr(), dt.data_ptr(), n, S,
            tab.data_ptr(), dim, int(lit), _ptrs(outs),
            torch.cuda.current_stream(device).cuda_stream)
        if rc:
            raise RuntimeError(f"sample_fwd_kernel launch failed: "
                               f"{_build.error_string(rc)}")
        LAUNCHES["sample_fwd_kernel"] += 1
    return tuple(outs)


def sample_grads(tab, o, d, t0, dt, cots, dim: int, lit: bool = False,
                 ray_grads: bool = True):
    """Backward of ``sample_fields_fwd`` with the gradient in the table's
    own shape: (grad [dim^3, 4], go [N, 3], gd [N, 3], gt0 [N], gdt [N]),
    the ray outputs None unless ``ray_grads``. CUDA tensors launch
    ``sample_bwd_kernel`` (the pure scatter, or with ``ray_grads`` the
    chunked variant and ``sample_ray_sum_kernel``), which adds into the
    zeroed gradient that it returns; CPU tensors run the plain version."""
    device, n = _check_rays(tab, o, d, t0, dt, dim)
    if len(cots) != (7 if lit else 4):
        raise ValueError(f"expected {7 if lit else 4} cotangents, "
                         f"got {len(cots)}")
    S = cots[0].shape[0] if cots[0].dim() == 2 else -1
    for c, x in enumerate(cots):
        _check(f"cots[{c}]", x, torch.float32, (S, n), device)
    if device.type == "cpu":
        return sample_fields_bwd_reference(tab, o, d, t0, dt, cots, dim, lit,
                                           ray_grads)

    from vxtpu_torch import _build

    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    grad = torch.zeros((dim ** 3, NCH), **f32)
    # the kernel writes every slot of part; with S == 0 the sums are 0
    part = ((torch.empty((-(-S // RAY_CHUNK), 8, n), **f32) if S
             else torch.zeros((1, 8, n), **f32)) if ray_grads else None)
    name = f"sample_bwd_kernel<kRayGrads={str(ray_grads).lower()}>"
    if n and S:
        rc = lib.vx_sample_bwd(
            o.data_ptr(), d.data_ptr(), t0.data_ptr(), dt.data_ptr(), n, S,
            tab.data_ptr(), dim, int(lit), int(ray_grads), RAY_CHUNK,
            _ptrs(cots), grad.data_ptr(),
            part.data_ptr() if ray_grads else None, stream)
        if rc:
            raise RuntimeError(f"{name} launch failed: "
                               f"{_build.error_string(rc)}")
        LAUNCHES[name] += 1
    if not ray_grads:
        return grad, None, None, None, None
    return (grad, *ray_sums(part))


def ray_sums(part: torch.Tensor):
    """Per-ray cotangents from the partial sums [chunks, 8, N] of
    ``sample_bwd_kernel<kRayGrads=true>``: (go [N, 3], gd [N, 3], gt0 [N],
    gdt [N]), the chunks added in chunk order. CUDA tensors launch
    ``sample_ray_sum_kernel``; CPU tensors run the plain version."""
    if (part.dim() != 3 or part.shape[1] != 8
            or part.dtype != torch.float32 or not part.is_contiguous()):
        raise ValueError(f"expected a contiguous float32 [chunks, 8, N] "
                         f"tensor, got {part.dtype} {tuple(part.shape)}")
    if part.device.type == "cpu":
        return ray_sums_reference(part)

    from vxtpu_torch import _build

    chunks, _, n = part.shape
    f32 = dict(dtype=torch.float32, device=part.device)
    go, gd = torch.empty((n, 3), **f32), torch.empty((n, 3), **f32)
    gt0, gdt = torch.empty(n, **f32), torch.empty(n, **f32)
    if n:
        rc = _build.load().vx_sample_ray_sum(
            part.data_ptr(), n, chunks, go.data_ptr(), gd.data_ptr(),
            gt0.data_ptr(), gdt.data_ptr(),
            torch.cuda.current_stream(part.device).cuda_stream)
        if rc:
            raise RuntimeError(f"sample_ray_sum_kernel launch failed: "
                               f"{_build.error_string(rc)}")
        LAUNCHES["sample_ray_sum_kernel"] += 1
    return go, gd, gt0, gdt


def sample_fields_bwd(tab, o, d, t0, dt, cots, dim: int, lit: bool = False,
                      ray_grads: bool = True):
    """Backward of ``sample_fields_fwd`` in vxtpu's form: cotangents
    ``cots`` of its outputs (4, or 7 when lit, each [S, N]) -> (the four
    planar gradient tables sigma, r, g, b (4 x [dim^3], the rows of one
    [4, dim^3] tensor), go [N, 3], gd [N, 3], gt0 [N], gdt [N]); the four
    ray outputs are None when ``ray_grads`` is False. ``sample_grads``
    computes it (CUDA tensors launch the kernels, CPU tensors run the
    plain version) in the table's [dim^3, 4] shape."""
    grad, *rays = sample_grads(tab, o, d, t0, dt, cots, dim, lit, ray_grads)
    return (tuple(grad.t().contiguous()), *rays)
