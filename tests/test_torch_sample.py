"""Parity: vxtpu_torch's field-sampling path (render/kernel_sample.py: the
plain versions of the CUDA kernels K3/K4, which CPU tensors run; and
render/soft_kernel.py) against vxtpu.

  * the plain versions against vxtpu's XLA oracle (soft.trilinear /
    trilinear_grad and their jax.vjp), eagerly;
  * the plain versions against vxtpu's Pallas kernels
    (sample_fields_fwd / sample_fields_bwd, interpret mode: two calls in
    all, lit, D = 16, 1,024 rays, S = 4);
  * render_soft_rays_kernel against vxtpu's render_soft_rays.

Tolerances: forward samples within atol 1e-5 of the XLA oracle, and
within rtol 1e-5 / atol 1e-5 x max|v| of the Pallas kernel (whose bf16
split fetch rounds to about 2^-16 in interpret mode); gradients within
rtol 1e-5 and atol 1e-5 x max|g| (another summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vxtpu.render import kernel_sample as jks
from vxtpu.render import soft as jsoft
from vxtpu.render import soft_pallas as jsp
from vxtpu.render.settings import RenderSettings as JSettings
from vxtpu.world.lights import Lights as JLights
from vxtpu_torch import convert
from vxtpu_torch.render import kernel_sample as ks
from vxtpu_torch.render import soft, soft_kernel
from vxtpu_torch.render.settings import RenderSettings

CPU = torch.device("cpu")
D = 16
DIMS = (D, D, D)
LIGHT = ([(0.2 * D, -0.3 * D, 1.4 * D)], [(1.0, 0.9, 0.8)], [2.0])


def t(x):
    return torch.tensor(np.asarray(x))


def rays(n, seed=0):
    """Rays from outside and inside the grid (a quarter of them), a few
    axis-aligned, a few missing it (dt == 0)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.6 * D, 1.6 * D, (n, 3))
    o[: n // 4] = rng.uniform(0.1 * D, 0.9 * D, (n // 4, 3))
    d = rng.uniform(0.05 * D, 0.95 * D, (n, 3)) - o
    d[n // 4: n // 4 + 8, 1:] = 0.0
    d[n // 4 + 8: n // 4 + 16] = -d[n // 4 + 8: n // 4 + 16]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def segments(o, d, S):
    """(t0, dt) of each ray's sampled segment, as the soft renderers
    compute them (misses: 0, 0)."""
    t0, dt, _ = soft_kernel._enter_dt_soft(t(o), t(d), DIMS, S, None)
    return t0.numpy(), dt.numpy()


def fields(seed=1):
    rng = np.random.default_rng(seed)
    sig = (rng.normal(size=DIMS) * 2.0 - 1.0).astype(np.float32)
    rgb = rng.normal(size=(3,) + DIMS).astype(np.float32)
    return sig, rgb


def morton_tabs(sig, rgb):
    return tuple(ks.build_field_morton(t(x)) for x in (sig, *rgb))


def test_morton_tables_match_vxtpu():
    sig, _ = fields()
    want = np.asarray(jks.build_field_morton(jnp.asarray(sig)))
    got = ks.build_field_morton(t(sig))
    assert got.shape == (D ** 3,)
    np.testing.assert_array_equal(got.numpy(), want.reshape(-1))
    np.testing.assert_array_equal(ks.field_from_morton(got, D).numpy(), sig)
    m = soft_kernel.MortonSoftGrid.from_soft(
        soft.SoftGrid(sigma_raw=t(sig), rgb_raw=t(fields()[1])))
    jm = jsp.MortonSoftGrid.from_soft(jsoft.SoftGrid(
        sigma_raw=jnp.asarray(sig), rgb_raw=jnp.asarray(fields()[1])))
    np.testing.assert_array_equal(m.rgb_tab.numpy(),
                                  np.asarray(jm.rgb_tab).reshape(3, -1))
    assert m.dim == D
    back = m.to_soft()
    np.testing.assert_array_equal(back.rgb_raw.numpy(), fields()[1])


def _jax_samples(sig, r, g, b, o, d, t0, dt, S, act):
    """vxtpu's XLA oracle of the kernels' outputs: soft.trilinear and
    trilinear_grad at p_s = o + (t0 + dt (s + 1/2)) d, [S, N] planes,
    zero for rays with dt == 0."""
    s = jnp.arange(S, dtype=jnp.float32) + 0.5
    tt = t0[None, :] + dt[None, :] * s[:, None]
    p = jnp.stack([o[None, :, k] + tt * d[None, :, k] for k in range(3)],
                  axis=-1)
    outs = [jsoft.trilinear(v, p, DIMS) for v in (sig, r, g, b)]
    gr = jsoft.trilinear_grad(sig, p, DIMS)
    outs += [gr[..., k] for k in range(3)]
    return tuple(jnp.where(act[None, :], x, 0.0) for x in outs)


def test_fwd_reference_matches_trilinear():
    sig, rgb = fields()
    S = 16
    o, d = rays(1024)
    t0, dt = segments(o, d, S)
    want = _jax_samples(*map(jnp.asarray, (sig, *rgb, o, d, t0, dt)), S,
                        jnp.asarray(dt > 0))
    got = ks.sample_fields_fwd(morton_tabs(sig, rgb), t(o), t(d), t(t0),
                               t(dt), S, D, lit=True)
    assert len(got) == 7 and all(x.shape == (S, 1024) for x in got)
    assert (dt == 0).sum() >= 8
    for c, (x, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=f"channel {c}")
    assert (got[0].numpy()[:, dt == 0] == 0).all()


def _check_grads(got, want, what):
    for k, (x, w) in enumerate(zip(got, want)):
        x, w = np.asarray(x), np.asarray(w)
        assert x.shape == w.shape, (what, k, x.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(x, w, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=f"{what} gradient {k}")


@pytest.mark.parametrize("lit", [False, True])
def test_bwd_reference_matches_jax_vjp(lit):
    sig, rgb = fields()
    S = 8
    o, d = rays(512, seed=2)
    t0, dt = segments(o, d, S)
    nout = 7 if lit else 4
    cots = np.random.default_rng(3).normal(size=(nout, S, 512)).astype(
        np.float32)
    act = jnp.asarray(dt > 0)

    def f(*args):
        return _jax_samples(*args, S, act)[:nout]

    _, vjp = jax.vjp(f, *map(jnp.asarray, (sig, *rgb, o, d, t0, dt)))
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    gtabs, go, gd, gt0, gdt = ks.sample_fields_bwd(
        morton_tabs(sig, rgb), t(o), t(d), t(t0), t(dt),
        tuple(t(c) for c in cots), D, lit=lit)
    # vxtpu's grid gradients, in Morton order
    want_tabs = [ks.build_field_morton(t(w)).numpy() for w in want[:4]]
    _check_grads([g.numpy() for g in gtabs], want_tabs, "table")
    _check_grads([go, gd, gt0, gdt], want[4:], "ray")


def test_bwd_reference_matches_autograd_of_fwd_reference():
    sig, rgb = fields()
    S = 6
    o, d = rays(256, seed=4)
    t0, dt = segments(o, d, S)
    cots = [t(c) for c in np.random.default_rng(5).normal(
        size=(7, S, 256)).astype(np.float32)]
    args = [x.requires_grad_(True) for x in
            (*morton_tabs(sig, rgb), t(o), t(d), t(t0), t(dt))]
    outs = ks.sample_fields_fwd_reference(tuple(args[:4]), *args[4:], S, D,
                                          lit=True)
    want = torch.autograd.grad(outs, args, cots)
    gtabs, go, gd, gt0, gdt = ks.sample_fields_bwd_reference(
        tuple(x.detach() for x in args[:4]),
        *[x.detach() for x in args[4:]], cots, D, lit=True)
    _check_grads([*gtabs, go, gd, gt0, gdt], [w.numpy() for w in want],
                 "autograd")


@pytest.fixture(scope="module")
def pallas_lit():
    """vxtpu's Pallas kernels in interpret mode, lit, D = 16, 1,024 rays,
    S = 4: one forward and one backward call."""
    sig, rgb = fields(seed=7)
    S = 4
    o, d = rays(1024, seed=8)
    t0, dt = segments(o, d, S)
    cots = np.random.default_rng(9).normal(size=(7, S, 1024)).astype(
        np.float32)
    jtabs = tuple(jks.build_field_morton(jnp.asarray(x)) for x in
                  (sig, *rgb))
    ja = tuple(map(jnp.asarray, (o, d, t0, dt)))
    fwd = jks.sample_fields_fwd(jtabs, *ja, S, D, lit=True, interpret=True)
    bwd = jks.sample_fields_bwd(jtabs, *ja, tuple(map(jnp.asarray, cots)),
                                D, lit=True, interpret=True)
    return dict(sig=sig, rgb=rgb, o=o, d=d, t0=t0, dt=dt, S=S, cots=cots,
                fwd=[np.asarray(x) for x in fwd],
                bwd=[np.asarray(x) for x in (*bwd[0], *bwd[1:])])


def test_fwd_reference_matches_pallas_kernel(pallas_lit):
    c = pallas_lit
    got = ks.sample_fields_fwd(morton_tabs(c["sig"], c["rgb"]), t(c["o"]),
                               t(c["d"]), t(c["t0"]), t(c["dt"]), c["S"], D,
                               lit=True)
    # vxtpu's kernel fetches through a 3-way bf16 split of the tables; in
    # interpret mode on the CPU that rounds to about 2^-16 of the value
    _check_grads([x.numpy() for x in got], c["fwd"], "sample")


def test_bwd_reference_matches_pallas_kernel(pallas_lit):
    c = pallas_lit
    gtabs, go, gd, gt0, gdt = ks.sample_fields_bwd(
        morton_tabs(c["sig"], c["rgb"]), t(c["o"]), t(c["d"]), t(c["t0"]),
        t(c["dt"]), tuple(t(x) for x in c["cots"]), D, lit=True)
    want = c["bwd"]
    _check_grads([g.numpy() for g in gtabs], [w.reshape(-1)
                                              for w in want[:4]], "table")
    _check_grads([go, gd, gt0, gdt], want[4:], "ray")


@pytest.mark.parametrize("lit", [False, True])
def test_render_soft_rays_kernel_matches_vxtpu(lit):
    """The kernel path (plain versions on the CPU) against vxtpu's XLA
    soft renderer: colour and gradients to the fields and the rays."""
    sig, rgb = fields()
    S = 8
    o, d = rays(256, seed=10)
    cot = np.random.default_rng(11).normal(size=(256, 3)).astype(np.float32)
    jlights = JLights.make(*LIGHT) if lit else None
    settings = JSettings(shading="lambert" if lit else "flat")

    def f(s_, c_, o_, d_):
        out, _ = jsoft.render_soft_rays(jsoft.SoftGrid(sigma_raw=s_,
                                                       rgb_raw=c_),
                                        o_, d_, settings, S, lights=jlights)
        return out

    want_out, vjp = jax.vjp(f, *map(jnp.asarray, (sig, rgb, o, d)))
    want = vjp(jnp.asarray(cot))

    m = soft_kernel.MortonSoftGrid.from_soft(
        soft.SoftGrid(sigma_raw=t(sig), rgb_raw=t(rgb)))
    m = soft_kernel.MortonSoftGrid(m.sigma_tab.requires_grad_(True),
                                   m.rgb_tab.requires_grad_(True))
    ot, dt_ = t(o).requires_grad_(True), t(d).requires_grad_(True)
    lights = convert.lights_from_numpy(*LIGHT, device=CPU) if lit else None
    ks.reset_launch_counts()
    out = soft_kernel.render_soft_rays_kernel(
        m, ot, dt_, RenderSettings(shading="lambert" if lit else "flat"), S,
        lights=lights)
    gs, gc, go, gd = torch.autograd.grad(out, [m.sigma_tab, m.rgb_tab, ot,
                                               dt_], t(cot))
    assert ks.LAUNCHES == {"sample_fwd_kernel": 0, "sample_bwd_kernel": 0}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=1e-5)
    got = [ks.field_from_morton(gs, D).numpy(),
           np.stack([ks.field_from_morton(gc[k], D).numpy()
                     for k in range(3)]), go.numpy(), gd.numpy()]
    _check_grads(got, [np.asarray(w) for w in want], "render")


def test_wrappers_reject_bad_inputs():
    sig, rgb = fields()
    tabs = morton_tabs(sig, rgb)
    o, d = (t(x) for x in rays(8))
    t0 = torch.zeros(8)
    dt = torch.full((8,), 0.5)
    with pytest.raises(TypeError):
        ks.sample_fields_fwd(tabs, o.double(), d, t0, dt, 4, D)
    with pytest.raises(ValueError):
        ks.sample_fields_fwd(tabs, o, d, t0[:4], dt, 4, D)
    with pytest.raises(ValueError):
        ks.sample_fields_fwd(tabs[:3], o, d, t0, dt, 4, D)
    with pytest.raises(ValueError):
        ks.sample_fields_fwd(tabs, o, d, t0, dt, 4, 12)
    with pytest.raises(ValueError):
        ks.sample_fields_fwd(tabs, d.t().contiguous().t(), d, t0, dt, 4, D)
    cots = tuple(torch.zeros(4, 8) for _ in range(4))
    with pytest.raises(ValueError):
        ks.sample_fields_bwd(tabs, o, d, t0, dt, cots, D, lit=True)
    with pytest.raises(ValueError):
        ks.sample_fields_bwd(tabs, o, d, t0, dt, cots[:3] + (
            torch.zeros(3, 8),), D)
