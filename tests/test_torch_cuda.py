"""On an NVIDIA GPU: each CUDA kernel of vxtpu_torch against its plain
PyTorch version on the same inputs, with the checks of chip_smoke.py
phase 3 (vxtpu_torch.kernel_check). Skipped where there is no GPU; on the
GPU machine (which need not have JAX, imported by tests/conftest.py) run

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from vxtpu_torch import kernel_check as kc
from vxtpu_torch.camera.rays import generate_rays
from vxtpu_torch.render import kernel_march as km
from vxtpu_torch.render import kernel_packed as kp
from vxtpu_torch.render import kernel_sample as ks
from vxtpu_torch.render import probe
from vxtpu_torch.world import procgen
from vxtpu_torch.world.packed import build_material_morton, build_packed_morton

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", kc.MARCH_CASES)
def test_march_kernel_matches_plain(cuda, name):
    km.reset_launch_counts()
    m = kc.run_march_case(name, cuda)
    kc.check_march_case(m, name)
    assert km.LAUNCHES["march_shade_kernel"] == 1


@pytest.mark.parametrize("name", kc.SHADE_CASES)
def test_shade_matches_plain(cuda, name):
    km.reset_launch_counts()
    m = kc.run_shade_case(name, cuda)
    kc.check_shade_case(m, name)
    uses_shade_kernel = name in ("shade_kernel", "full_shadows_fog_composed")
    assert (km.LAUNCHES["shade_kernel"] == 1) == uses_shade_kernel


def test_cuda_tensor_never_reaches_plain_version(cuda, monkeypatch):
    """On CUDA tensors march() launches the kernel: no plain version is
    called, not even as a fallback."""
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("march_shade_reference", "march_reference",
                 "shade_reference"):
        monkeypatch.setattr(km, name, boom)
    grid = procgen.shell_sphere((16, 16, 16), device=cuda)
    acc = build_packed_morton(grid.occupancy)
    mats = build_material_morton(grid.occupancy)
    o = torch.full((8, 3), 8.0, device=cuda)
    d = torch.nn.functional.normalize(torch.ones((8, 3), device=cuda), dim=1)
    km.reset_launch_counts()
    rec, rgb = km.march(o, d, acc, (16, 16, 16), 50,
                        shade_spec=km.ShadeSpec(n_lights=0), mats=mats,
                        lights_arr=torch.zeros((8, 8), device=cuda))
    torch.cuda.synchronize()
    assert bool(rec.hit.all()) and bool(torch.isfinite(rgb).all())
    assert km.LAUNCHES["march_shade_kernel"] == 1


@pytest.mark.parametrize("name", list(kc.K1_CASES))
def test_march_shade_instantiation_matches_plain(cuda, name):
    """Each instantiation of march_shade_kernel equals its plain version on
    every ray and pixel (no agreement margin), and the wrapper launched the
    one its ShadeSpec names."""
    km.reset_launch_counts()
    m = kc.run_k1_case(name, cuda)
    kc.check_k1_case(m, name)
    assert m["variant"] == kc.K1_CASES[name]
    assert km.VARIANT_LAUNCHES == {
        v: int(v == m["variant"]) for v in km.K1_VARIANTS}
    assert km.LAUNCHES["march_shade_kernel"] == 1


@pytest.mark.parametrize("variant, want", enumerate((8, 8, 6, 6, 5, 5)))
def test_march_shade_instantiation_occupancy(cuda, variant, want):
    """Each instantiation holds at least the blocks an SM its
    __launch_bounds__ asks for (8 marching and at most shading flat, 6
    lighting, 5 with shadow marches), with the dilation table of a 512^3
    and of a 2048^3 grid."""
    from vxtpu_torch import _build

    lib = _build.load()
    assert lib.vx_march_shade_blocks_per_sm(variant, 512) >= want
    assert lib.vx_march_shade_blocks_per_sm(variant, 2048) >= want


@pytest.mark.parametrize("name", kc.SAMPLE_CASES)
def test_sample_kernels_match_plain(cuda, name):
    ks.reset_launch_counts()
    m = kc.run_sample_case(name, cuda)
    kc.check_sample_case(m, name)
    rg = m["ray_grads"]
    assert ks.LAUNCHES == {"sample_fwd_kernel": 1,
                           "sample_bwd_kernel<kRayGrads=false>": 0 if rg else 2,
                           "sample_bwd_kernel<kRayGrads=true>": 2 if rg else 0,
                           "sample_ray_sum_kernel": 2 if rg else 0}


def test_cuda_tensor_never_reaches_sample_plain_versions(cuda, monkeypatch):
    """On CUDA tensors the sampling path launches the kernels, forward and
    backward, with rays that need no gradient (the pure scatter) and with
    rays that do (kRayGrads, its chunk sum): no plain version is called,
    not even as a fallback."""
    from vxtpu_torch.render.soft_kernel import (MortonSoftGrid,
                                                render_soft_rays_kernel)
    from vxtpu_torch.render.settings import RenderSettings

    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    for name in ("sample_fields_fwd_reference", "sample_fields_bwd_reference",
                 "ray_sums_reference"):
        monkeypatch.setattr(ks, name, boom)
    m = MortonSoftGrid(kc.sample_fields(16, cuda).requires_grad_(True))
    o, d = kc.sample_rays("outside", 16, 256, cuda)
    ks.reset_launch_counts()
    for ray_grad in (False, True):
        ot = o.clone().requires_grad_(ray_grad)
        rgb = render_soft_rays_kernel(m, ot, d, RenderSettings(), 20)
        rgb.sum().backward()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(rgb).all())
        assert bool(torch.isfinite(m.tab.grad).all())
        assert (ot.grad is not None) == ray_grad
        if ray_grad:
            assert bool(torch.isfinite(ot.grad).all())
    assert ks.LAUNCHES == {"sample_fwd_kernel": 2,
                           "sample_bwd_kernel<kRayGrads=false>": 1,
                           "sample_bwd_kernel<kRayGrads=true>": 1,
                           "sample_ray_sum_kernel": 1}


@pytest.mark.parametrize("case", list(kc.TV_CASES))
@pytest.mark.parametrize("D", [64, 512])
def test_tv_kernels_match_plain(cuda, D, case):
    """The TV prior's kernel pair against its plain version at D^3 in each
    of kernel_check.TV_CASES (a zero weight, an upstream gradient of 3.7,
    a gradient accumulated onto an existing .grad): the value within rel
    1e-6 and equal bit for bit on a second launch, the gradient within
    1e-6 x max|g|; one launch of each kernel a forward, one backward."""
    m = kc.run_tv_case(D, cuda, case)
    kc.check_tv_case(m, f"TV prior at {D}^3")
    assert m["launches"] == {"tv_fwd_kernel": 2, "tv_fwd_finish_kernel": 2,
                             "tv_bwd_kernel": 1}


def test_tv_kernels_never_sync_and_never_reach_the_plain_version(
        cuda, monkeypatch):
    """Forward and backward of the prior on a CUDA table run clean under
    torch.cuda.set_sync_debug_mode("error") (no host sync: g is read on
    the device), and the plain version is not called, not even as a
    fallback."""
    from vxtpu_torch.train import kernel_tv

    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(kernel_tv, "tv_prior_morton", boom)
    tab = kc.tv_table(64, cuda).requires_grad_(True)
    kernel_tv.tv_prior(tab.detach(), 1e-4, 1e-5)        # build, load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (2.0 * kernel_tv.tv_prior(tab, 1e-4, 1e-5)).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(tab.grad).all())


def test_field_kernel_fit_launches_the_tv_kernels(cuda):
    """Three fit_soft steps with field_kernel at 32^3 launch each TV
    kernel once a step, and Adam's kernel once a step (one table)."""
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.render import soft
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.train import kernel_adam, kernel_tv, loop

    truth = soft.SoftGrid.from_hard(procgen.terrain(
        (32,) * 3, seed=7, with_rgb=True, device=cuda))
    cam = Camera.make(pos=(-22.4, 16.0, 35.2), device=cuda).look_at(
        (16.0, 16.0, 8.64))
    with torch.no_grad():
        target = soft.render_soft_image(truth, cam, RenderSettings(), 32, 32,
                                        32)
    kernel_tv.reset_launch_counts()
    kernel_adam.reset_launch_counts()
    _, _, losses, _ = loop.fit_soft(
        soft.SoftGrid.zeros((32,) * 3, device=cuda), cam, target,
        RenderSettings(), loop.TrainConfig(steps=3, num_samples=16,
                                           field_kernel=True))
    assert kernel_tv.LAUNCHES == {"tv_fwd_kernel": 3,
                                  "tv_fwd_finish_kernel": 3,
                                  "tv_bwd_kernel": 3}
    assert kernel_adam.LAUNCHES == {"adam_step_kernel": 3}
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", list(kc.ADAM_CASES))
def test_adam_kernel_matches_torch_step(cuda, name):
    """kernel_adam.Adam against torch.optim.Adam's foreach step over five
    steps in each of kernel_check.ADAM_CASES (numel 1, 3, 4, 1,027 and
    64^3 x 4, a view off the 16-byte boundary, a state resumed at count
    7, the camera's four tensors): parameters and moments within rtol
    1e-6, equal bit for bit on a second run, one adam_step_kernel launch
    a parameter a step."""
    kc.check_adam_case(kc.run_adam_case(cuda, **kc.ADAM_CASES[name]),
                       f"Adam ({name})")


def test_adam_kernel_never_syncs_and_never_reaches_torch_step(
        cuda, monkeypatch):
    """Steps of kernel_adam.Adam on CUDA parameters run clean under
    torch.cuda.set_sync_debug_mode("error") (the count lives on the host,
    the bias corrections go to the kernel as arguments), and neither the
    plain version nor torch's own step is called."""
    from vxtpu_torch.train import kernel_adam

    def boom(*a, **k):
        raise AssertionError("a plain step called for CUDA tensors")

    monkeypatch.setattr(kernel_adam, "adam_step_reference", boom)
    monkeypatch.setattr(torch.optim.Adam, "step", boom)
    ps = [torch.randn((64 ** 3, 4), device=cuda).requires_grad_(True),
          torch.zeros((), device=cuda).requires_grad_(True)]
    opt = kernel_adam.Adam(ps, lr=5e-2)
    for p in ps:
        p.grad = torch.randn_like(p)
    opt.step()                                  # build, load, state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt.step()
        opt.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(p).all()) for p in ps)
    assert float(opt.state[ps[0]]["step"]) == 3


def test_sample_bwd_refuses_another_chunk_length(cuda, monkeypatch):
    """The wrapper passes RAY_CHUNK to the kRayGrads kernel, which refuses
    any length but its own (the scratch is sized from RAY_CHUNK)."""
    tab = kc.sample_fields(16, cuda)
    o, d = kc.sample_rays("outside", 16, 256, cuda)
    t0 = torch.zeros(256, device=cuda)
    dt = torch.ones(256, device=cuda)
    cots = tuple(torch.ones(20, 256, device=cuda) for _ in range(4))
    monkeypatch.setattr(ks, "RAY_CHUNK", ks.RAY_CHUNK // 2)
    ks.reset_launch_counts()
    with pytest.raises(RuntimeError, match="kRayGrads=true"):
        ks.sample_grads(tab, o, d, t0, dt, cots, 16, ray_grads=True)
    ks.sample_grads(tab, o, d, t0, dt, cots, 16, ray_grads=False)
    torch.cuda.synchronize()
    assert ks.LAUNCHES["sample_bwd_kernel<kRayGrads=true>"] == 0
    assert ks.LAUNCHES["sample_bwd_kernel<kRayGrads=false>"] == 1


def test_ray_gradients_run_the_ray_grads_variant(cuda):
    """Rays that need a gradient (camera refinement) run K4 with kRayGrads
    and its chunk sum; the gradients equal the plain path's (tables
    allclose, rays through the same autograd graph)."""
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.render.soft_kernel import (MortonSoftGrid,
                                                render_soft_rays_kernel)

    tab = kc.sample_fields(16, cuda)
    o, d = kc.sample_rays("outside", 16, 256, cuda)
    grads = []
    for plain in (False, True):
        m = MortonSoftGrid(tab.clone().requires_grad_(True))
        ot, dt = o.clone().requires_grad_(True), d.clone().requires_grad_(True)
        ks.reset_launch_counts()
        rgb = render_soft_rays_kernel(m, ot, dt, RenderSettings(shading="flat"),
                                      20, plain=plain)
        gtab, go, gd = torch.autograd.grad(rgb.sum(), [m.tab, ot, dt])
        grads.append([*kc.channels(gtab), go, gd])
        assert ks.LAUNCHES == {
            "sample_fwd_kernel": 0 if plain else 1,
            "sample_bwd_kernel<kRayGrads=false>": 0,
            "sample_bwd_kernel<kRayGrads=true>": 0 if plain else 1,
            "sample_ray_sum_kernel": 0 if plain else 1}
    torch.cuda.synchronize()
    assert kc.grads_excess(grads[0], grads[1]) <= 1.0


def test_sample_wrappers_refuse_a_misaligned_table(cuda):
    """The kernels read the table's rows as float4: a table that does not
    start on a 16-byte boundary raises before any launch."""
    D = 16
    tab = torch.zeros(D ** 3 * 4 + 1, device=cuda)[1:].view(D ** 3, 4)
    o, d = kc.sample_rays("outside", D, 256, cuda)
    t0, dt = torch.zeros(256, device=cuda), torch.ones(256, device=cuda)
    ks.reset_launch_counts()
    with pytest.raises(ValueError, match="aligned"):
        ks.sample_fields_fwd(tab, o, d, t0, dt, 4, D)
    with pytest.raises(ValueError, match="aligned"):
        ks.sample_grads(tab, o, d, t0, dt, tuple(
            torch.ones(4, 256, device=cuda) for _ in range(4)), D)
    assert not any(ks.LAUNCHES.values())


def test_save_checkpoint_extra_cuda_tensor(cuda, tmp_path):
    """An extra that is a CUDA tensor requiring grad (vxtpu's config 5
    saves its device-side camera offset so) is saved as its values."""
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.render.soft import SoftGrid
    from vxtpu_torch.train import checkpoint

    cam_off = torch.tensor([0.5, -1.25, 2.0], device=cuda,
                           requires_grad=True) * 1.0
    path = str(tmp_path / "extra.npz")
    checkpoint.save_checkpoint(path, SoftGrid.zeros((8, 8, 8), device=cuda),
                               Camera.make(pos=(1.0, 2.0, 3.0), device=cuda),
                               2, extra={"cam_off": cam_off})
    _, _, step, extra = checkpoint.load_checkpoint(path, device=cuda)
    assert step == 2
    assert extra["cam_off"].tolist() == [0.5, -1.25, 2.0]


@pytest.mark.parametrize("name", kc.PACKED_CASES)
def test_packed_march_kernel_matches_plain(cuda, name):
    kp.reset_launch_counts()
    m = kc.run_packed_case(name, cuda)
    kc.check_packed_case(m, name)
    assert kp.LAUNCHES["march_packed_kernel"] == 1


def test_packed_march_takes_unaligned_rays_and_refuses_a_wrong_bricked_table(
        cuda):
    """The kernel reads each ray's o, d and t_max as scalars, so rays that
    start 4 bytes past an aligned address (views into a larger buffer)
    march as the plain version does; a bricked copy of the wrong size or
    type raises."""
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.world.packed import PackedAccel, build_packed

    dims = (32, 32, 32)
    acc = build_packed(procgen.terrain(dims, seed=11, device=cuda).occupancy)
    cam = kc._cameras_dims(dims, cuda)["outside"]
    o, d = generate_rays(cam, 19, 27)                # 513 rays
    n = o.shape[0]
    views = []
    for x in (o, d):
        buf = torch.zeros(3 * n + 1, device=cuda)
        buf[1:] = x.reshape(-1)
        views.append(buf[1:].view(n, 3))
    tbuf = torch.zeros(n + 1, device=cuda)
    tbuf[1:] = 40.0
    uo, ud, ut = views[0], views[1], tbuf[1:]
    assert uo.data_ptr() % 16 and ud.data_ptr() % 16 and ut.data_ptr() % 16
    ms = sum(dims) + 2
    kp.reset_launch_counts()
    rec = kp.march_packed(uo, ud, acc, dims, ms, t_max=ut)
    assert kp.LAUNCHES["march_packed_kernel"] == 1
    ref = kp.march_packed_reference(o, d, acc, dims, ms,
                                    t_max=torch.full((n,), 40.0, device=cuda))
    kc.check_packed(kc.packed_mismatch(rec, ref), "unaligned rays")
    assert bool(rec.hit.any())
    with pytest.raises(ValueError, match="bricks"):
        kp.march_packed(o, d, PackedAccel(acc.words, acc.bricks[:-64]), dims,
                        ms)
    with pytest.raises(TypeError, match="bricks"):
        kp.march_packed(o, d, PackedAccel(acc.words, acc.bricks.int()), dims,
                        ms)


def test_cuda_tensor_never_reaches_packed_plain_version(cuda, monkeypatch):
    """On CUDA tensors the pipeline's row-major march launches the kernel
    for the primary and the shadow rays: no plain version is called."""
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.render.pipeline import render_image
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.world.lights import Lights

    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(kp, "march_packed_reference", boom)
    grid = procgen.terrain((32, 32, 16), seed=3, with_rgb=True, device=cuda)
    cam = Camera.make(pos=(-20.0, 16.0, 30.0), device=cuda).look_at(
        (16.0, 16.0, 4.0))
    kp.reset_launch_counts()
    img = render_image(kp.make_march_packed, grid, cam,
                       Lights.single((6.0, -9.0, 40.0), intensity=2.0,
                                     device=cuda),
                       RenderSettings(shading="full", shadows=True, fog=True),
                       24, 32)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(img).all())
    assert kp.LAUNCHES["march_packed_kernel"] == 2


@pytest.mark.parametrize("name", kc.MARCH_CASES)
def test_resume_kernel_matches_plain(cuda, name):
    km.reset_launch_counts()
    m = kc.run_resume_case(name, cuda)
    kc.check_resume_case(m, name)
    # a capped round 0 and a resume per budget
    assert km.LAUNCHES["march_resume_kernel"] == 2 * len(kc.RESUME_BUDGETS)
    assert km.LAUNCHES["march_shade_kernel"] == 0


@pytest.mark.parametrize("name", kc.PROBE_CASES)
def test_probe_kernel_matches_plain(cuda, name):
    probe.reset_launch_counts()
    m = kc.run_probe_case(name, cuda)
    kc.check_probe_case(m, name)
    assert probe.LAUNCHES["march_probe_kernel"] == \
        (2 if name.startswith("identity") else 1)


def test_probe_instantiations_fit_and_the_orders_agree(cuda):
    """Every K6 instantiation (variant x layout x step) holds at least one
    block of 512 threads an SM, and in the 32x32 block order with padded
    blocks (a 48 x 80 frame) every variant's acc, put back in pixel
    order, equals scanline's."""
    dims = (32, 32, 32)
    for step in probe.STEPS:
        for layout in probe.LAYOUTS:
            for v in probe.VARIANTS:
                assert probe.blocks_per_sm(v, layout, step, 512, dims) >= 1
    grid = procgen.terrain(dims, seed=3, device=cuda)
    table = kc.probe_table("bricked16", grid)
    o, d = generate_rays(kc._cameras(32, cuda)["inside"], 48, 80)
    for v in probe.VARIANTS:
        want = probe.march_probe(o, d, table, dims, 16, v, "bricked16")
        for name in ("block32x32", "block4x8"):
            po, pd, inv = probe.ordered_rays(o, d, (48, 80), name)
            got = probe.march_probe(po, pd, table, dims, 16, v, "bricked16",
                                    threads=128)
            assert torch.equal(got[inv], want), (v, name)


def test_cuda_tensor_never_reaches_resume_or_probe_plain_versions(
        cuda, monkeypatch):
    """On CUDA tensors the resume mode, the sorted march and the probe
    launch their kernels: no plain version is called, not even as a
    fallback."""
    def boom(*a, **k):
        raise AssertionError("plain version called for CUDA tensors")

    monkeypatch.setattr(km, "march_reference", boom)
    monkeypatch.setattr(probe, "march_probe_reference", boom)
    grid = procgen.terrain((32, 32, 32), seed=3, device=cuda)
    acc = build_packed_morton(grid.occupancy)
    o, d = kc.sample_rays("outside", 32, 4096, cuda)
    km.reset_launch_counts()
    probe.reset_launch_counts()
    rec = km.march_sorted(o, d, acc, (32, 32, 32), 98, round0_iters=2)
    accs = [probe.march_probe(o, d, acc.words, (32, 32, 32), 8, v)
            for v in probe.VARIANTS]
    torch.cuda.synchronize()
    assert bool(rec.hit.any()) and all(bool(a.isfinite().all()) for a in accs)
    assert km.LAUNCHES["march_resume_kernel"] >= 2
    assert probe.LAUNCHES["march_probe_kernel"] == len(probe.VARIANTS)


def _to(rec, device):
    return type(rec)(*(getattr(rec, f).to(device) for f in
                       ("hit", "t", "voxel", "normal", "steps")))


@pytest.mark.parametrize("accel", ["distfield", "pyramid"])
@pytest.mark.parametrize("cam", ["outside", "inside"])
def test_xla_march_on_card_matches_cpu(cuda, accel, cam):
    """The batched march (plain tensor code, no kernel of its own) on the
    card against the same march on the CPU, at 64^3."""
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render import kernel_xla
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.world import distfield
    from vxtpu_torch.world.pyramid import build_pyramid

    cpu = torch.device("cpu")
    recs = []
    for dev in (cuda, cpu):
        grid = procgen.terrain((64,) * 3, seed=11, device=dev)
        o, d = generate_rays(kc._cameras(64, dev)[cam], 128, 128)
        s = RenderSettings(pyramid_levels=2)
        acc = (distfield.build(grid.occupancy) if accel == "distfield"
               else build_pyramid(grid.occupancy, 2))
        march = kernel_xla.make_march_xla(grid.occupancy.reshape(-1),
                                          (64,) * 3, s, acc)
        recs.append(march(o, d))
    m = kc.record_mismatch(_to(recs[0], cpu), recs[1])
    kc.check_records(m, f"xla march {accel} {cam}")
    assert bool(recs[0].hit.any())


@pytest.mark.parametrize("schedule", ["default", "rounds", "drain"])
@pytest.mark.parametrize("cam", ["outside", "inside"])
def test_wavefront_march_on_card_matches_cpu(cuda, schedule, cam):
    """The wavefront march on the card (each buffer size's step captured
    as a CUDA graph and replayed; drain rounds of one size reuse it)
    against the same march on the CPU at 64^3: records and counters."""
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render import kernel_wavefront as kw
    from vxtpu_torch.world import distfield

    kwargs = {"default": {},
              "rounds": dict(schedule=((4096, 3), (2048, 5)),
                             drain_buf=1024, drain_steps=4),
              "drain": dict(schedule=(), drain_buf=2048, drain_steps=8)}
    cpu = torch.device("cpu")
    out = []
    for dev in (cuda, cpu):
        grid = procgen.terrain((64,) * 3, seed=11, device=dev)
        o, d = generate_rays(kc._cameras(64, dev)[cam], 128, 128)
        df = distfield.build(grid.occupancy, cap=24).field.reshape(-1)
        out.append(kw.march_wavefront(o, d, df, (64,) * 3, 194, stats=True,
                                      **kwargs[schedule]))
    (rec, st), (want, wst) = out
    kc.check_exact(kc.record_mismatch(_to(rec, cpu), want), None,
                   f"wavefront march {schedule} {cam}")
    assert bool(rec.hit.any())
    for k in ("round_steps", "drain_rounds", "drain_steps_total",
              "gathered_lanes", "host_syncs"):
        assert st[k] == wst[k], k
    assert [int(c) for c in st["round_counts"]] == [
        int(c) for c in wst["round_counts"]]
    if schedule != "default":
        assert st["drain_rounds"] > 1     # the drain replays its graph


def test_ref_march_on_card_matches_cpu(cuda):
    """The per-ray reference march on the card against the CPU at 64^3."""
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render.kernel_ref import march_ref

    cpu = torch.device("cpu")
    recs = []
    for dev in (cuda, cpu):
        grid = procgen.terrain((64,) * 3, seed=11, device=dev)
        o, d = generate_rays(kc._cameras(64, dev)["outside"], 128, 128)
        recs.append(march_ref(o, d, grid.occupancy.reshape(-1), (64,) * 3,
                              194))
    kc.check_exact(kc.record_mismatch(_to(recs[0], cpu), recs[1]), None,
                   "reference march")


def test_mask_bounds_on_card_match_cpu(cuda):
    """The occupancy mask read from a Morton table and the band bounds of
    its rays, on the card against the CPU: the mask byte for byte, the
    bounds within 1e-4 and the same empty bands."""
    from vxtpu_torch.render.occmask import mask_segment_bounds

    cpu = torch.device("cpu")
    out = []
    for dev in (cuda, cpu):
        tab, mask, mask_df = kc.masked_sample_fields(64, dev)
        o, d = kc.sample_rays("masked", 64, 16384, dev)
        out.append((mask.cpu(), *(x.cpu() for x in mask_segment_bounds(
            mask, 4, o, d, df_flat=mask_df))))
    (mg, t0g, t1g), (mc, t0c, t1c) = out
    assert torch.equal(mg, mc)
    assert torch.equal(t0g == t1g, t0c == t1c) and bool((t0c < t1c).any())
    assert float((t0g - t0c).abs().max()) <= 1e-4
    assert float((t1g - t1c).abs().max()) <= 1e-4


@pytest.mark.parametrize("name", kc.BOUNDS_CASES)
def test_bounds_kernel_matches_batched_path(cuda, name):
    """mask_bounds_kernel against the batched path on the card, in each of
    kernel_check.BOUNDS_CASES over a 512^3 world's mask (128^3 at G = 4,
    64^3 at G = 8; a 510^3 world's 170^3 at G = 3), 16,384 rays: t0 and t1 equal bit for bit, so the
    empty bands too; one launch a pass."""
    kc.check_bounds_case(kc.run_bounds_case(name, cuda), f"bounds ({name})")


def test_bounds_kernel_on_the_c4_view(cuda):
    """The c4 fit's 65,536 rays (256 x 256) over the 512^3 terrain's 128^3
    mask: bit for bit the batched path's bounds, one launch."""
    m = kc.run_bounds_case("terrain-c4-g4", cuda, D=512, n=256 * 256)
    kc.check_bounds_case(m, "bounds (c4 view)")
    assert m["n"] == 65536 and m["bands"] > 0


def test_masked_fit_launches_the_bounds_kernel(cuda, monkeypatch):
    """Three masked field-kernel steps at 32^3 launch mask_bounds_kernel
    once a step and never reach march_xla_df (patched to raise); a bounds
    pass runs clean under torch.cuda.set_sync_debug_mode("error")."""
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.render import kernel_bounds, occmask, soft
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.train import loop

    def boom(*a, **k):
        raise AssertionError("the batched march called for CUDA tensors")

    monkeypatch.setattr(occmask, "march_xla_df", boom)
    truth = soft.SoftGrid.from_hard(procgen.terrain(
        (32,) * 3, seed=7, with_rgb=True, device=cuda))
    cam = Camera.make(pos=(-22.4, 16.0, 35.2), device=cuda).look_at(
        (16.0, 16.0, 8.64))
    with torch.no_grad():
        target = soft.render_soft_image(truth, cam, RenderSettings(), 32, 32,
                                        32)
    kernel_bounds.reset_launch_counts()
    _, _, losses, _ = loop.fit_soft(
        soft.SoftGrid.zeros((32,) * 3, device=cuda), cam, target,
        RenderSettings(), loop.TrainConfig(
            steps=3, num_samples=16, seed=7, occ_mask=True, mask_refresh=2,
            field_kernel=True))
    assert kernel_bounds.LAUNCHES == {"mask_bounds_kernel": 3}
    assert losses[-1] < losses[0]
    mask = occmask.occupancy_mask_from_soft(truth, 4, 0.01, 1)
    df = occmask.mask_distance_field(mask)
    o, d = generate_rays(cam, 32, 32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0, t1 = occmask.mask_segment_bounds(mask, 4, o, d, df_flat=df)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert kernel_bounds.LAUNCHES == {"mask_bounds_kernel": 4}
    assert bool((t0 < t1).any()) and bool((t1 >= t0).all())


def test_masked_fit_runs_the_kernels(cuda):
    """Three masked field-kernel steps at 32^3 (the mask rebuilt before
    step 2) launch K3 and K4's scatter once a step, and their losses
    equal the same fit's on the CPU (the kernels' plain versions) within
    rel 1e-5."""
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.render import soft
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.train import loop

    losses = []
    for dev in (cuda, torch.device("cpu")):
        truth = soft.SoftGrid.from_hard(procgen.terrain(
            (32,) * 3, seed=7, with_rgb=True, device=dev))
        cam = Camera.make(pos=(-22.4, 16.0, 35.2), device=dev).look_at(
            (16.0, 16.0, 8.64))
        with torch.no_grad():
            target = soft.render_soft_image(truth, cam, RenderSettings(), 32,
                                            32, 32)
        ks.reset_launch_counts()
        _, _, got, _ = loop.fit_soft(
            soft.SoftGrid.zeros((32,) * 3, device=dev), cam, target,
            RenderSettings(), loop.TrainConfig(
                steps=3, num_samples=16, seed=7, occ_mask=True,
                mask_refresh=2, field_kernel=True))
        losses.append(got)
        if dev.type == "cuda":
            assert ks.LAUNCHES["sample_fwd_kernel"] == 3
            assert ks.LAUNCHES["sample_bwd_kernel<kRayGrads=false>"] == 3
    assert losses[0][-1] < losses[0][0]
    for a, b in zip(*losses):
        assert abs(a - b) <= 1e-5 * abs(b)


def _vjp_grads(fast, sig, rgb, cam, o_c, d_c, target, settings, S, lights):
    """Loss and the gradients to (sigma, rgb, cam pos, yaw, pitch) through
    the custom backward (render/vjp.py) or autograd through the plain
    soft renderer."""
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.engine.sharding import _world_rays
    from vxtpu_torch.render.soft import SoftGrid, render_soft_rays
    from vxtpu_torch.render.vjp import render_soft_rays_fast

    leaves = [x.detach().clone().requires_grad_(True)
              for x in (sig, rgb, cam.pos, cam.yaw, cam.pitch)]
    s = SoftGrid(leaves[0], leaves[1])
    o_w, d_w = _world_rays(Camera(*leaves[2:], cam.fov_y), o_c, d_c)
    if fast:
        pred = render_soft_rays_fast(s, o_w, d_w, settings, S, lights)
    else:
        pred = render_soft_rays(s, o_w, d_w, settings, S, lights)[0]
    loss = torch.mean((pred - target) ** 2)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("shading", ["flat", "full"])
def test_custom_vjp_matches_autograd_on_the_card(cuda, shading):
    """The custom backward against autograd through the plain renderer at
    64^3 on 4,096 rays (index_add_ on CUDA sums in a varying order: rtol
    2e-4 / atol 2e-5 x max|g|, tests/test_vjp.py's tolerance)."""
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.engine.sharding import camera_frame_rays
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.world.lights import Lights

    g = torch.Generator().manual_seed(3)
    D = 64
    sig = (torch.randn((D,) * 3, generator=g) * 2.0).to(cuda)
    rgb = torch.randn((3,) + (D,) * 3, generator=g).to(cuda)
    cam = Camera.make(pos=(-40.0, 30.0, 70.0), fov_y_deg=55.0,
                      device=cuda).look_at((32.0, 32.0, 16.0))
    o_c, d_c = camera_frame_rays(cam, 64, 64)
    target = torch.rand((64 * 64, 3), generator=g).to(cuda)
    lights = Lights.single((12.0, -20.0, 90.0), intensity=2.0, device=cuda)
    st = RenderSettings(shading=shading)
    lf, gf = _vjp_grads(True, sig, rgb, cam, o_c, d_c, target, st, 48,
                        lights)
    lp, gp = _vjp_grads(False, sig, rgb, cam, o_c, d_c, target, st, 48,
                        lights)
    assert abs(float(lf) - float(lp)) <= 1e-5 * abs(float(lp))
    for a, b in zip(gf, gp):
        atol = 2e-5 * max(float(b.abs().max()), 1e-30)
        assert kc.allclose_excess(a, b, 2e-4, atol) <= 1.0


@pytest.fixture
def nccl_rank(cuda):
    from vxtpu_torch.engine import platform

    platform.init_multihost(device=cuda)
    yield cuda
    platform.shutdown()


def test_one_rank_nccl_sharded_step_matches_fit_soft(nccl_rank):
    """The sharded field-kernel step on a 1-rank NCCL group: its loss and
    table gradient against the single-device kernel path (fit_soft's loss
    without the TV prior) within phase 6's limits; then fit_soft's one
    step (TV off) and the sharded step give the same loss."""
    import torch.distributed as dist

    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.engine import sharding
    from vxtpu_torch.render import soft
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.render.soft_kernel import (MortonSoftGrid,
                                                render_soft_rays_kernel)
    from vxtpu_torch.train import loop

    dev = nccl_rank
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    truth = soft.SoftGrid.from_hard(procgen.terrain(
        (32,) * 3, seed=7, with_rgb=True, device=dev))
    cam = Camera.make(pos=(-22.4, 16.0, 35.2), device=dev).look_at(
        (16.0, 16.0, 8.64))
    st = RenderSettings()
    with torch.no_grad():
        target = soft.render_soft_image(truth, cam, st, 32, 32, 32)
    o_c, d_c = sharding.camera_frame_rays(cam, 32, 32)
    o_w, d_w = sharding._world_rays(cam, o_c, d_c)
    model = MortonSoftGrid.from_soft(soft.SoftGrid.zeros((32,) * 3,
                                                         device=dev))
    init_fn, step_fn = sharding.make_sharded_train_step(
        st, 16, sharding.make_mesh(), optimize_camera=False,
        field_kernel=True)
    state = init_fn(model, cam)
    loss, grads = step_fn.value_and_grad(model, cam, state, o_c, d_c,
                                         target.reshape(-1, 3))
    p = model.tab.clone().requires_grad_(True)
    want = torch.mean((render_soft_rays_kernel(
        MortonSoftGrid(p), o_w, d_w, st, 16) - target.reshape(-1, 3)) ** 2)
    gw, = torch.autograd.grad(want, [p])
    assert abs(float(loss) - float(want)) <= 1e-6 * abs(float(want))
    assert kc.grads_excess(kc.channels(grads[0]), kc.channels(gw)) <= 1.0
    _, _, fit_losses, _ = loop.fit_soft(
        soft.SoftGrid.zeros((32,) * 3, device=dev), cam, target, st,
        loop.TrainConfig(steps=1, num_samples=16, tv_sigma=0.0, tv_rgb=0.0,
                         field_kernel=True))
    assert abs(fit_losses[0] - float(loss)) <= 1e-6 * abs(float(loss))


def test_validate_platform_on_the_card(cuda):
    from vxtpu_torch.engine import platform

    info = platform.validate_platform(device=cuda)
    props = torch.cuda.get_device_properties(cuda)
    assert info.capability == (9, 0) and info.hbm_bytes == props.total_memory
    assert platform.platform_report(cuda)["device_kind"] == props.name
    with pytest.raises(RuntimeError, match="scene needs"):
        platform.validate_platform(
            {"grid": torch.empty(1, device=cuda)}, hbm_headroom=0.0,
            device=cuda)
