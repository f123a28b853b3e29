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


def morton_tab(sig, rgb):
    """The channel-interleaved Morton table [D^3, 4] of the fields."""
    return ks.build_interleaved_morton(t(sig), t(rgb))


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
    got = ks.sample_fields_fwd(morton_tab(sig, rgb), t(o), t(d), t(t0),
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
        morton_tab(sig, rgb), t(o), t(d), t(t0), t(dt),
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
            (morton_tab(sig, rgb), t(o), t(d), t(t0), t(dt))]
    outs = ks.sample_fields_fwd_reference(*args, S, D, lit=True)
    want = torch.autograd.grad(outs, args, cots)
    gtab, go, gd, gt0, gdt = ks.sample_fields_bwd_reference(
        *[x.detach() for x in args], cots, D, lit=True)
    assert gtab.shape == (D ** 3, 4)
    _check_grads([*gtab.t(), go, gd, gt0, gdt],
                 [*want[0].t().numpy(), *[w.numpy() for w in want[1:]]],
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
    got = ks.sample_fields_fwd(morton_tab(c["sig"], c["rgb"]), t(c["o"]),
                               t(c["d"]), t(c["t0"]), t(c["dt"]), c["S"], D,
                               lit=True)
    # vxtpu's kernel fetches through a 3-way bf16 split of the tables; in
    # interpret mode on the CPU that rounds to about 2^-16 of the value
    _check_grads([x.numpy() for x in got], c["fwd"], "sample")


def test_bwd_reference_matches_pallas_kernel(pallas_lit):
    c = pallas_lit
    gtabs, go, gd, gt0, gdt = ks.sample_fields_bwd(
        morton_tab(c["sig"], c["rgb"]), t(c["o"]), t(c["d"]), t(c["t0"]),
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
    m = soft_kernel.MortonSoftGrid(m.tab.requires_grad_(True))
    ot, dt_ = t(o).requires_grad_(True), t(d).requires_grad_(True)
    lights = convert.lights_from_numpy(*LIGHT, device=CPU) if lit else None
    ks.reset_launch_counts()
    out = soft_kernel.render_soft_rays_kernel(
        m, ot, dt_, RenderSettings(shading="lambert" if lit else "flat"), S,
        lights=lights)
    gtab, go, gd = torch.autograd.grad(out, [m.tab, ot, dt_], t(cot))
    assert not any(ks.LAUNCHES.values())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=1e-5)
    gs, gc = ks.fields_from_interleaved(gtab, D)
    got = [gs.numpy(), gc.numpy(), go.numpy(), gd.numpy()]
    _check_grads(got, [np.asarray(w) for w in want], "render")


def test_wrappers_reject_bad_inputs():
    sig, rgb = fields()
    tab = morton_tab(sig, rgb)
    o, d = (t(x) for x in rays(8))
    t0 = torch.zeros(8)
    dt = torch.full((8,), 0.5)
    with pytest.raises(TypeError):
        ks.sample_fields_fwd(tab, o.double(), d, t0, dt, 4, D)
    with pytest.raises(ValueError):
        ks.sample_fields_fwd(tab, o, d, t0[:4], dt, 4, D)
    with pytest.raises(ValueError):
        ks.sample_fields_fwd(tab[:, :3], o, d, t0, dt, 4, D)
    with pytest.raises(ValueError):
        ks.sample_fields_fwd(tab.t().contiguous().t(), o, d, t0, dt, 4, D)
    with pytest.raises(ValueError):
        ks.sample_fields_fwd(tab, o, d, t0, dt, 4, 12)
    with pytest.raises(ValueError):
        ks.sample_fields_fwd(tab, d.t().contiguous().t(), d, t0, dt, 4, D)
    cots = tuple(torch.zeros(4, 8) for _ in range(4))
    with pytest.raises(ValueError):
        ks.sample_fields_bwd(tab, o, d, t0, dt, cots, D, lit=True)
    with pytest.raises(ValueError):
        ks.sample_fields_bwd(tab, o, d, t0, dt, cots[:3] + (
            torch.zeros(3, 8),), D)


# The backward's two variants: the pure scatter (ray_grads=False, the
# trainer's main path) and the one with the ray cotangents, summed in
# chunks of RAY_CHUNK samples; S = 20 is one full chunk and one partial.
S_CHUNKED = 20


@pytest.mark.parametrize("lit", [False, True])
def test_scatter_only_backward_matches_jax_vjp(lit):
    """ray_grads=False gives the same gradient tables as ray_grads=True and
    no ray outputs; both match jax.vjp of vxtpu's XLA oracle, the chunked
    ray sums too."""
    assert ks.RAY_CHUNK < S_CHUNKED < 2 * ks.RAY_CHUNK
    sig, rgb = fields(seed=13)
    S = S_CHUNKED
    o, d = rays(384, seed=14)
    t0, dt = segments(o, d, S)
    nout = 7 if lit else 4
    cots = np.random.default_rng(15).normal(size=(nout, S, 384)).astype(
        np.float32)
    act = jnp.asarray(dt > 0)

    def f(*args):
        return _jax_samples(*args, S, act)[:nout]

    _, vjp = jax.vjp(f, *map(jnp.asarray, (sig, *rgb, o, d, t0, dt)))
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    args = (morton_tab(sig, rgb), t(o), t(d), t(t0), t(dt),
            tuple(t(c) for c in cots), D, lit)
    full = ks.sample_fields_bwd(*args, ray_grads=True)
    scatter = ks.sample_fields_bwd(*args, ray_grads=False)
    assert scatter[1:] == (None, None, None, None)
    for a, b in zip(full[0], scatter[0]):
        assert torch.equal(a, b)
    want_tabs = [ks.build_field_morton(t(w)).numpy() for w in want[:4]]
    _check_grads([g.numpy() for g in scatter[0]], want_tabs, "table")
    _check_grads(full[1:], want[4:], "chunked ray")


def test_sample_fields_bwd_tables_share_one_storage():
    sig, rgb = fields()
    o, d = rays(64, seed=16)
    t0, dt = segments(o, d, 6)
    cots = tuple(torch.ones(6, 64) for _ in range(4))
    for ray_grads in (False, True):
        gtabs = ks.sample_fields_bwd(morton_tab(sig, rgb), t(o), t(d),
                                     t(t0), t(dt), cots, D,
                                     ray_grads=ray_grads)[0]
        assert len(gtabs) == 4
        assert all(g.shape == (D ** 3,) and g.is_contiguous() for g in gtabs)
        assert len({g.untyped_storage().data_ptr() for g in gtabs}) == 1
        assert [g.storage_offset() for g in gtabs] == [
            c * D ** 3 for c in range(4)]


@pytest.mark.parametrize("plain", [False, True])
def test_sample_fields_asks_for_ray_grads_exactly_when_rays_need_them(
        plain, monkeypatch):
    """SampleFields' backward (kernel path and plain path alike) asks the
    plain backward for the ray cotangents iff o or d requires grad."""
    seen = []
    real = ks.sample_fields_bwd_reference

    def spy(*args, **kwargs):
        seen.append(kwargs.get("ray_grads", args[8] if len(args) > 8
                               else True))
        return real(*args, **kwargs)

    monkeypatch.setattr(ks, "sample_fields_bwd_reference", spy)
    sig, rgb = fields()
    m = soft_kernel.MortonSoftGrid.from_soft(
        soft.SoftGrid(sigma_raw=t(sig), rgb_raw=t(rgb)))
    o, d = rays(64, seed=17)
    for o_grad, d_grad in ((False, False), (True, False), (False, True),
                           (True, True)):
        params = [m.tab.clone().requires_grad_(True)]
        ot = t(o).requires_grad_(o_grad)
        dt_ = t(d).requires_grad_(d_grad)
        out = soft_kernel.render_soft_rays_kernel(
            soft_kernel.MortonSoftGrid(*params), ot, dt_,
            RenderSettings(shading="flat"), 8, plain=plain)
        out.sum().backward()
        assert seen[-1] == (o_grad or d_grad)
        assert (ot.grad is not None) == o_grad
        assert (dt_.grad is not None) == d_grad
        assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
                   for p in params)
    assert len(seen) == 4


def _select_into(var, root):
    """Autograd nodes of the graph under ``root`` that are SelectBackward
    and feed ``var``'s gradient accumulator directly."""
    found, stack, done = [], [root], set()
    while stack:
        node = stack.pop()
        if node is None or node in done:
            continue
        done.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None and getattr(nxt, "variable", None) is var \
                    and type(node).__name__.startswith("SelectBackward"):
                found.append(node)
            stack.append(nxt)
    return found


def test_no_select_backward_of_rgb_tab_in_a_train_step():
    """A trainer step's graph (render_soft_rays_kernel + the Morton TV
    prior) hands the table's gradient over whole: the one parameter tab
    (whose views rgb_tab and sigma_tab are) gets no SelectBackward, whose
    backward would zero-fill a table-sized tensor, and the sampling
    kernel's backward feeds its accumulator directly."""
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.train import loop

    sig, rgb = fields()
    m = soft_kernel.MortonSoftGrid.from_soft(
        soft.SoftGrid(sigma_raw=t(sig), rgb_raw=t(rgb)))
    model = soft_kernel.MortonSoftGrid(m.tab.requires_grad_(True))
    cam = Camera.make(pos=(-0.7 * D, 0.5 * D, 1.1 * D), device=CPU).look_at(
        (0.5 * D, 0.5 * D, 0.27 * D))
    o, d = rays(64, seed=18)
    cfg = loop.TrainConfig(field_kernel=True, num_samples=8)
    loss = loop._loss_fn(model, cam, t(o), t(d), torch.zeros(64, 3), (8, 8),
                         RenderSettings(), cfg)
    assert _select_into(model.tab, loss.grad_fn) == []
    feeders, stack, done = [], [loss.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in done:
            continue
        done.add(node)
        for nxt, _ in node.next_functions:
            if getattr(nxt, "variable", None) is model.tab:
                feeders.append(type(node).__name__)
            stack.append(nxt)
    assert "SampleFieldsBackward" in feeders
    loss.backward()
    assert model.tab.grad.shape == (D ** 3, 4)


@pytest.mark.parametrize("lit", [False, True])
def test_render_soft_rays_kernel_table_grads_match_vxtpu(lit):
    """With rays that need no gradient (the trainer's main path, the pure
    scatter) the gradient to the table matches vxtpu's, channel by
    channel."""
    sig, rgb = fields(seed=19)
    S = S_CHUNKED
    o, d = rays(256, seed=20)
    cot = np.random.default_rng(21).normal(size=(256, 3)).astype(np.float32)
    jlights = JLights.make(*LIGHT) if lit else None
    settings = JSettings(shading="lambert" if lit else "flat")
    jo, jd = jnp.asarray(o), jnp.asarray(d)

    def f(s_, c_):
        out, _ = jsoft.render_soft_rays(jsoft.SoftGrid(sigma_raw=s_,
                                                       rgb_raw=c_),
                                        jo, jd, settings, S, lights=jlights)
        return out

    _, vjp = jax.vjp(f, jnp.asarray(sig), jnp.asarray(rgb))
    want = vjp(jnp.asarray(cot))
    m = soft_kernel.MortonSoftGrid.from_soft(
        soft.SoftGrid(sigma_raw=t(sig), rgb_raw=t(rgb)))
    m = soft_kernel.MortonSoftGrid(m.tab.requires_grad_(True))
    lights = convert.lights_from_numpy(*LIGHT, device=CPU) if lit else None
    out = soft_kernel.render_soft_rays_kernel(
        m, t(o), t(d), RenderSettings(shading="lambert" if lit else "flat"),
        S, lights=lights)
    gtab, = torch.autograd.grad(out, [m.tab], t(cot))
    got = [x.numpy() for x in ks.fields_from_interleaved(gtab, D)]
    _check_grads(got, [np.asarray(w) for w in want], "render")


def test_ray_sums_plain_version_adds_the_chunks_in_order():
    g = torch.Generator().manual_seed(6)
    part = torch.randn(3, 8, 5, generator=g) * torch.tensor([1e8, 1.0, -1e8])[
        :, None, None]
    go, gd, gt0, gdt = ks.ray_sums(part)
    want = (part[0] + part[1]) + part[2]
    assert torch.equal(go, want[0:3].t()) and torch.equal(gd, want[3:6].t())
    assert torch.equal(gt0, want[6]) and torch.equal(gdt, want[7])
    with pytest.raises(ValueError):
        ks.ray_sums(torch.zeros(3, 7, 5))


@pytest.mark.parametrize("S", [1, 16, 17, 33])
def test_chunked_ray_sums_match_jax_vjp(S):
    """The plain backward's ray cotangents, summed in chunks of RAY_CHUNK
    samples (S below, at and across chunk edges), match jax.vjp of
    vxtpu's XLA oracle."""
    sig, rgb = fields(seed=22)
    o, d = rays(128, seed=23)
    t0, dt = segments(o, d, S)
    cots = np.random.default_rng(24).normal(size=(4, S, 128)).astype(
        np.float32)
    act = jnp.asarray(dt > 0)

    def f(*args):
        return _jax_samples(*args, S, act)[:4]

    _, vjp = jax.vjp(f, *map(jnp.asarray, (sig, *rgb, o, d, t0, dt)))
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    got = ks.sample_fields_bwd(morton_tab(sig, rgb), t(o), t(d), t(t0),
                               t(dt), tuple(t(c) for c in cots), D)
    _check_grads(got[1:], want[4:], f"ray (S = {S})")


@pytest.mark.parametrize("lit", [False, True])
@pytest.mark.parametrize("kind", ["outside", "inside", "dt0", "random"])
def test_scatter_only_tables_equal_ray_grads_tables(kind, lit):
    """On every ray set of kernel_check, the plain pure scatter
    (ray_grads=False) gives the ray_grads variant's gradient tables bit for
    bit, and no ray outputs."""
    from vxtpu_torch import kernel_check as kc

    S, n = S_CHUNKED, 256
    tab = kc.sample_fields(D, CPU)
    o, d = kc.sample_rays(kind, D, n, CPU)
    t0, dt, _ = soft_kernel._enter_dt_soft(o, d, DIMS, S, None)
    if kind == "dt0":
        dt = torch.where(torch.arange(n) % 4 == 1, 0.0, dt)
    g = torch.Generator().manual_seed(25)
    cots = tuple(torch.randn(S, n, generator=g) for _ in range(7 if lit
                                                               else 4))
    args = (tab, o, d, t0.contiguous(), dt.contiguous(), cots, D, lit)
    full = ks.sample_grads(*args, ray_grads=True)
    scatter = ks.sample_grads(*args, ray_grads=False)
    assert scatter[1:] == (None, None, None, None)
    assert all(x is not None for x in full[1:])
    assert torch.equal(scatter[0], full[0])
    assert bool(scatter[0].abs().sum() > 0)
