"""Parity: the field-kernel fit's parameter layout, one channel-interleaved
Morton table [D^3, 4] (render/kernel_sample.py, render/soft_kernel.py,
train/loss.py, train/loop.py), and the checkpoint loader's and saver's
handling of rgb layouts and extras (train/checkpoint.py), against vxtpu,
which keeps the same words as two planar Morton tables.

Tolerances: tables bit for bit; samples and gradients within rtol 1e-5 /
atol 1e-5 x max|v| of vxtpu's Pallas kernels in interpret mode (whose
bf16 split fetch rounds to about 2^-16); the TV prior within rel 1e-5,
its gradient within rtol 1e-5 / atol 1e-6 x max|g|; Adam's parameters
within 5e-6 of optax's (a tenth of a step at lr 5e-2) and its moments
within rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vxtpu.camera.camera import Camera as JCamera
from vxtpu.render import kernel_sample as jks
from vxtpu.render import soft as jsoft
from vxtpu.render import soft_pallas as jsp
from vxtpu.render.settings import RenderSettings as JSettings
from vxtpu.train import checkpoint as jckpt
from vxtpu.train import loss as jloss
from vxtpu_torch import convert
from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.render import kernel_sample as ks
from vxtpu_torch.render import soft, soft_kernel
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.train import checkpoint, loop, loss

CPU = torch.device("cpu")
D = 16
DIMS = (D, D, D)


def t(x):
    return torch.tensor(np.asarray(x))


def fields(seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=DIMS) * 2.0).astype(np.float32),
            rng.normal(size=(3,) + DIMS).astype(np.float32))


def rays(n, S, seed=1):
    """Rays from outside the grid towards points inside it, a few turned
    away (dt == 0), and their sampled segments."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.6 * D, 1.6 * D, (n, 3)).astype(np.float32)
    d = rng.uniform(0.1 * D, 0.9 * D, (n, 3)) - o
    d[:8] = -d[:8]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t0, dt, _ = soft_kernel._enter_dt_soft(t(o), t(d), DIMS, S, None)
    return o, d, t0.numpy(), dt.numpy()


def _close(got, want, what, atol_rel=1e-5):
    for k, (x, w) in enumerate(zip(got, want)):
        x, w = np.asarray(x), np.asarray(w)
        assert x.shape == w.shape, (what, k, x.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(x, w, rtol=1e-5, atol=atol_rel * scale,
                                   err_msg=f"{what} {k}")


def test_interleaved_table_round_trips():
    """The builder puts vxtpu's four planar Morton tables side by side; its
    inverse, the planar split and join, and MortonSoftGrid's views and
    conversions undo it exactly."""
    sig, rgb = fields()
    tab = ks.build_interleaved_morton(t(sig), t(rgb))
    assert tab.shape == (D ** 3, 4) and tab.dtype == torch.float32
    for c, f in enumerate((sig, *rgb)):
        want = np.asarray(jks.build_field_morton(jnp.asarray(f)))
        np.testing.assert_array_equal(tab[:, c].numpy(), want.reshape(-1))
    s2, r2 = ks.fields_from_interleaved(tab, D)
    np.testing.assert_array_equal(s2.numpy(), sig)
    np.testing.assert_array_equal(r2.numpy(), rgb)
    st, rt = ks.split_table(tab)
    assert st.shape == (D ** 3,) and rt.shape == (3, D ** 3)
    assert torch.equal(ks.interleave_tables(st, rt), tab)
    jm = jsp.MortonSoftGrid.from_soft(jsoft.SoftGrid(jnp.asarray(sig),
                                                     jnp.asarray(rgb)))
    m = soft_kernel.MortonSoftGrid.from_soft(soft.SoftGrid(t(sig), t(rgb)))
    assert torch.equal(m.tab, tab) and m.dim == D
    np.testing.assert_array_equal(m.sigma_tab.numpy(),
                                  np.asarray(jm.sigma_tab).reshape(-1))
    np.testing.assert_array_equal(m.rgb_tab.numpy(),
                                  np.asarray(jm.rgb_tab).reshape(3, -1))
    mg = convert.morton_soft_grid_from_numpy(jm.sigma_tab, jm.rgb_tab,
                                             device=CPU)
    assert torch.equal(mg.tab, tab)
    back = m.to_soft()
    np.testing.assert_array_equal(back.sigma_raw.numpy(), sig)
    np.testing.assert_array_equal(back.rgb_raw.numpy(), rgb)


@pytest.mark.parametrize("lit", [False, True])
def test_sample_fwd_on_interleaved_table_matches_vxtpu_kernel(lit):
    """K3's plain version on the interleaved table against vxtpu's
    sample_fields_fwd (its Pallas kernel in interpret mode) on the four
    planar tables of the same fields: D = 16, 256 rays, S = 4."""
    sig, rgb = fields(seed=2)
    S = 4
    o, d, t0, dt = rays(256, S, seed=3)
    jtabs = tuple(jks.build_field_morton(jnp.asarray(x))
                  for x in (sig, *rgb))
    want = jks.sample_fields_fwd(jtabs, *map(jnp.asarray, (o, d, t0, dt)),
                                 S, D, lit=lit, interpret=True)
    got = ks.sample_fields_fwd(ks.build_interleaved_morton(t(sig), t(rgb)),
                               t(o), t(d), t(t0), t(dt), S, D, lit=lit)
    assert len(got) == (7 if lit else 4)
    _close([x.numpy() for x in got], want, "sample")


def test_tab_grad_matches_jax_vjp_of_vxtpu_field_kernel_render():
    """tab.grad after a backward through render_soft_rays_kernel (the plain
    versions here) against jax.vjp of vxtpu's render_soft_rays_pallas with
    respect to its planar tables (Pallas kernels in interpret mode), and
    the colours: D = 16, 256 rays, S = 4."""
    sig, rgb = fields(seed=4)
    S = 4
    o, d, _, _ = rays(256, S, seed=5)
    cot = np.random.default_rng(6).normal(size=(256, 3)).astype(np.float32)
    jm = jsp.MortonSoftGrid.from_soft(jsoft.SoftGrid(jnp.asarray(sig),
                                                     jnp.asarray(rgb)))

    def f(m_):
        return jsp.render_soft_rays_pallas(
            m_, jnp.asarray(o), jnp.asarray(d), JSettings(shading="flat"), S,
            interpret=True)

    want_out, vjp = jax.vjp(f, jm)
    gm, = vjp(jnp.asarray(cot))
    m = soft_kernel.MortonSoftGrid.from_soft(soft.SoftGrid(t(sig), t(rgb)))
    m = soft_kernel.MortonSoftGrid(m.tab.requires_grad_(True))
    out = soft_kernel.render_soft_rays_kernel(
        m, t(o), t(d), RenderSettings(shading="flat"), S)
    (out * t(cot)).sum().backward()
    assert m.tab.grad.shape == (D ** 3, 4)
    _close([out.detach().numpy()], [want_out], "colour")
    want = ks.interleave_tables(t(np.asarray(gm.sigma_tab)),
                                t(np.asarray(gm.rgb_tab)))
    _close([g.numpy() for g in m.tab.grad.t()],
           [w.numpy() for w in want.t()], "table gradient channel")


def test_tv_prior_matches_vxtpu_value_and_grad():
    """tv_prior_morton on the interleaved table equals vxtpu's
    tv_sigma * tv_loss_morton(sigma_tab) + tv_rgb * tv_loss_morton(
    rgb_tab) in value, and its gradient equals jax.grad of that."""
    sig, rgb = fields(seed=7)
    jm = jsp.MortonSoftGrid.from_soft(jsoft.SoftGrid(jnp.asarray(sig),
                                                     jnp.asarray(rgb)))
    w_s, w_rgb = 1e-4, 1e-5

    def f(s_, c_):
        return (w_s * jloss.tv_loss_morton(s_)
                + w_rgb * jloss.tv_loss_morton(c_))

    want = float(f(jm.sigma_tab, jm.rgb_tab))
    gs, gc = jax.grad(f, argnums=(0, 1))(jm.sigma_tab, jm.rgb_tab)
    tab = ks.build_interleaved_morton(t(sig), t(rgb)).requires_grad_(True)
    got = loss.tv_prior_morton(tab, w_s, w_rgb)
    assert float(got.detach()) == pytest.approx(want, rel=1e-5)
    got.backward()
    wg = ks.interleave_tables(t(np.asarray(gs)), t(np.asarray(gc)))
    _close([g.numpy() for g in tab.grad.t()], [w.numpy() for w in wg.t()],
           "prior gradient channel", atol_rel=1e-6)


def _optax_steps(params, grads):
    """optax.adam(5e-2) over ``params`` (a pytree) from a fresh state, one
    update per entry of ``grads``: (params, state)."""
    opt = optax.adam(5e-2)
    state = opt.init(params)
    for g in grads:
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return params, state


def _planar_grads(rng, n):
    return [(rng.normal(size=(D ** 3 // 128, 128)).astype(np.float32),
             rng.normal(size=(3, D ** 3 // 128, 128)).astype(np.float32)
             * 1e-2) for _ in range(n)]


def _port_adam(tab):
    p = tab.clone().requires_grad_(True)
    return p, loop.make_optimizer(loop.TrainConfig(field_kernel=True), [p])


def _port_step(p, opt, g):
    p.grad = ks.interleave_tables(t(g[0]), t(g[1]))
    opt.step()


def test_adam_state_of_vxtpu_field_kernel_fit_resumes_here():
    """An optax state over vxtpu's planar Morton tables (two steps) goes
    through the port's checkpoint leaves into the Adam that sees the one
    interleaved table; the next step equals optax's third, and the state
    read back equals optax's leaves."""
    sig, rgb = fields(seed=8)
    jm = jsp.MortonSoftGrid.from_soft(jsoft.SoftGrid(jnp.asarray(sig),
                                                     jnp.asarray(rgb)))
    grads = _planar_grads(np.random.default_rng(9), 3)
    jp, js = _optax_steps(jm, [jsp.MortonSoftGrid(*map(jnp.asarray, g))
                               for g in grads[:2]])
    m = soft_kernel.MortonSoftGrid.from_soft(soft.SoftGrid(t(sig), t(rgb)))
    tmpl = loop.init_opt_state([loop.state_params(m)])
    state = convert.adam_state_from_optax_leaves(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(js)], tmpl,
        device=CPU)
    p, opt = _port_adam(convert.morton_soft_grid_from_numpy(
        jp.sigma_tab, jp.rgb_tab, device=CPU).tab)
    loop.write_opt_state(opt, state)
    assert torch.equal(opt.state[p]["exp_avg"], ks.interleave_tables(
        state[0].mu[0], state[0].mu[1]))
    _port_step(p, opt, grads[2])
    upd, js = optax.adam(5e-2).update(
        jsp.MortonSoftGrid(*map(jnp.asarray, grads[2])), js, jp)
    jp = optax.apply_updates(jp, upd)
    want = ks.interleave_tables(t(np.asarray(jp.sigma_tab)),
                                t(np.asarray(jp.rgb_tab)))
    np.testing.assert_allclose(p.detach().numpy(), want.numpy(), rtol=0,
                               atol=5e-6)
    got = checkpoint.opt_state_leaves(loop.read_opt_state(opt))
    wl = jax.tree_util.tree_leaves(js)
    assert [np.shape(x) for x in got] == [np.shape(x) for x in wl]
    assert int(got[0]) == int(wl[0]) == 3
    _close(got[1:], wl[1:], "moment leaf", atol_rel=1e-6)


def test_adam_state_of_the_port_resumes_in_vxtpu():
    """The port's Adam over the interleaved table (two steps), read out in
    optax's leaves, restores into optax's state of vxtpu's planar tables;
    vxtpu's next step equals the port's third."""
    sig, rgb = fields(seed=10)
    grads = _planar_grads(np.random.default_rng(11), 3)
    p, opt = _port_adam(ks.build_interleaved_morton(t(sig), t(rgb)))
    for g in grads[:2]:
        _port_step(p, opt, g)
    leaves = checkpoint.opt_state_leaves(loop.read_opt_state(opt))
    st, rt = ks.split_table(p.detach())
    jp = jsp.MortonSoftGrid(jnp.asarray(st.numpy().reshape(-1, 128)),
                            jnp.asarray(rt.numpy().reshape(3, -1, 128)))
    opt_j = optax.adam(5e-2)
    tmpl = opt_j.init(jp)
    treedef = jax.tree_util.tree_structure(tmpl)
    js = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x)
                                                for x in leaves])
    upd, _ = opt_j.update(jsp.MortonSoftGrid(*map(jnp.asarray, grads[2])),
                          js, jp)
    jp = optax.apply_updates(jp, upd)
    _port_step(p, opt, grads[2])
    want = ks.interleave_tables(t(np.asarray(jp.sigma_tab)),
                                t(np.asarray(jp.rgb_tab)))
    np.testing.assert_allclose(p.detach().numpy(), want.numpy(), rtol=0,
                               atol=5e-6)


def _ckpt_payload(rgb):
    sig = np.zeros(rgb.shape[1:] if rgb.shape[0] == 3 else rgb.shape[:3],
                   np.float32)
    return dict(sigma_raw=sig, rgb_raw=rgb, cam_pos=np.zeros(3, np.float32),
                cam_yaw=np.float32(0.1), cam_pitch=np.float32(-0.2),
                cam_fov_y=np.float32(1.0), step=np.asarray(3))


def test_ambiguous_rgb_layout_raises_in_both_packages(tmp_path):
    """An rgb_raw of shape [3, X, Y, 3] could be channel-major or vxtpu's
    old [X, Y, Z, 3]: both loaders refuse it; the old layout of another
    shape loads channel-major in both."""
    path = str(tmp_path / "ambiguous.npz")
    np.savez(path, **_ckpt_payload(np.ones((3, 3, 4, 3), np.float32)))
    with pytest.raises(ValueError, match="ambiguous"):
        jckpt.load_checkpoint(path)
    with pytest.raises(ValueError, match="ambiguous"):
        checkpoint.load_checkpoint(path, device=CPU)
    old = np.arange(4 * 4 * 4 * 3, dtype=np.float32).reshape(4, 4, 4, 3)
    path = str(tmp_path / "old.npz")
    np.savez(path, **_ckpt_payload(old))
    want = np.asarray(jckpt.load_checkpoint(path)[0].rgb_raw)
    got = checkpoint.load_checkpoint(path, device=CPU)[0].rgb_raw
    assert got.shape == (3, 4, 4, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_save_checkpoint_extra_tensor_that_requires_grad(tmp_path):
    """An extra that is a tensor requiring grad (vxtpu's config 5 saves
    its camera offset so) is saved as its values and loads back, in both
    packages."""
    cam_off = torch.tensor([0.5, -1.25, 2.0], requires_grad=True) * 1.0
    path = str(tmp_path / "extra.npz")
    cam = Camera.make(pos=(1.0, 2.0, 3.0), device=CPU)
    checkpoint.save_checkpoint(path, soft.SoftGrid.zeros(DIMS, device=CPU),
                               cam, 4, extra={"cam_off": cam_off,
                                              "losses": [0.5, 0.25]})
    _, _, step, extra = checkpoint.load_checkpoint(path, device=CPU)
    assert step == 4
    np.testing.assert_array_equal(extra["cam_off"], [0.5, -1.25, 2.0])
    np.testing.assert_array_equal(extra["losses"], [0.5, 0.25])
    _, jc, _, jextra = jckpt.load_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(jextra["cam_off"]),
                                  [0.5, -1.25, 2.0])
    assert isinstance(jc, JCamera)
