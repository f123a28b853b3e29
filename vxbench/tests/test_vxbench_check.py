"""What decides ``correct``: the frozen plain references agree with the
port's own plain paths at 32^3 (the same semantics); a run with a fault
planted in the timed path comes out not correct; the controls (the
reference in bfloat16, or on half of the batch, in the program's place)
fail the limits; and a run loads no JAX module and fails where there is
no card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from vxbench import camera, harness, world
from vxbench.drivers import Run, soft_fit
from vxbench.reference import march as rmarch
from vxbench.reference import soft as rsoft

ROOT = harness.ROOT
CPU = torch.device("cpu")
SMALL_RENDER = dict(dims=(32, 32, 32), height=24, width=32, loop=4,
                    warm_frames=2)
SMALL_TRAIN = dict(dims=(16, 16, 16), height=8, width=8, samples=8,
                   target_samples=8, mask_refresh=4, window_after_step=4,
                   ray_block=32)


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


@pytest.mark.parametrize("cell_name", ["render512_1080p.orbit",
                                       "render512_1080p.lowpass"])
@pytest.mark.parametrize("shading,shadows", [("full", True),
                                             ("lambert", False)])
def test_march_reference_equals_the_port(manifest, cell_name, shading,
                                         shadows):
    from vxtpu_torch.camera import paths
    from vxtpu_torch.render.fused import render_frame_fused
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.world.grid import VoxelGrid
    from vxtpu_torch.world.lights import Lights
    from vxtpu_torch.world.packed import (build_packed_morton,
                                          build_rgb8_morton)

    cell = harness.find_cell(manifest, cell_name)
    cfg, tr = cell.config, cell.traffic
    dims, h, w = (32, 32, 32), 24, 32
    occ, rgb = world.terrain(dims, 5, CPU)
    top = world.top_height(occ)
    st = dict(cfg["settings"], shading=shading, shadows=shadows)
    lp = tuple(p * n for p, n in zip(cfg["lights"][0]["pos"], dims))
    lights = Lights.single(lp, intensity=2.0, device=CPU)
    acc = build_packed_morton(occ, cap=64)
    mats = build_rgb8_morton(VoxelGrid(occupancy=occ, rgb=rgb))
    args = camera.path_args(tr, dims, top)
    if tr["path"] == "orbit":
        at = paths.orbit(center=args["center"], radius=args["radius"],
                         height=args["height"], period=args["period"],
                         fov_y_deg=args["fov_y_deg"], device=CPU)
    else:
        at = paths.flythrough(args["waypoints"], args["look_at"],
                              period=args["period"],
                              fov_y_deg=args["fov_y_deg"], device=CPU)
    words, albedo = rmarch.cell_table(occ), rmarch.rgb8_albedo(rgb)
    for t in (0.0, 1.3, 7.9):
        img = render_frame_fused(acc, mats, dims, at(t), lights,
                                 RenderSettings(**st), h, w, rgb8=True)
        pos, yaw, pitch, fov = camera.pose(tr, dims, top, t, CPU)
        o, d = camera.rays(pos, yaw, pitch, fov, h, w)
        ref = rmarch.render(o, d, words, albedo, dims, [(lp, (1.0, 1.0, 1.0),
                                                         2.0)], st)
        assert (img.reshape(-1, 3) - ref).abs().max() <= 1e-6


def _soft_inputs(D=32, h=16, w=16):
    occ, rgb = world.terrain((D,) * 3, 9, CPU)
    sigma, rgb_raw = world.soft_truth(occ, rgb)
    g = torch.Generator().manual_seed(1)
    tab = torch.cat([sigma.reshape(-1, 1), rgb_raw.reshape(3, -1).t()],
                    dim=1)
    # noise on the colours and on the solid voxels' densities; the empty
    # ones stay under the mask's threshold
    noise = 0.3 * torch.randn(tab.shape, generator=g)
    noise[:, 0] *= tab[:, 0] > 0
    tab = tab + noise
    cfg = json.loads((harness.HERE / "configs"
                      / "c4_512_diff.json").read_text())
    o, d = soft_fit.view_rays(cfg, (D,) * 3, h, w, CPU)
    target = torch.rand((h * w, 3), generator=g)
    return tab, o, d, target, cfg


@pytest.mark.parametrize("masked", [False, True])
def test_soft_reference_equals_the_port(masked):
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.render import occmask
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.render.soft import SoftGrid
    from vxtpu_torch.render.soft_kernel import MortonSoftGrid
    from vxtpu_torch.train import loop

    D, S, G = 32, 16, 4
    tab, o, d, target, cfg = _soft_inputs(D)
    mi = world.morton_index(D, CPU)
    soft = SoftGrid(sigma_raw=tab[:, 0].reshape(D, D, D).clone(),
                    rgb_raw=tab[:, 1:].t().reshape(3, D, D, D).clone())
    model = MortonSoftGrid.from_soft(soft)
    leaf = model.tab.clone().requires_grad_(True)
    t = cfg["train"]
    tc = loop.TrainConfig(num_samples=S, tv_sigma=t["tv_sigma"],
                          tv_rgb=t["tv_rgb"], field_kernel=True,
                          occ_mask=masked, mask_scale=G)
    kw, pkw = {}, {}
    if masked:
        pmask = occmask.occupancy_mask_from_soft(model, G, tau=0.01,
                                                 dilate=1)
        rmask = rsoft.occupancy_mask(tab, D, G, 0.01)
        assert torch.equal(pmask, rmask)
        assert 0 < int(rmask.sum()) < rmask.numel()
        pb = occmask.mask_segment_bounds(pmask, G, o, d)
        rb = rsoft.bands(rmask, G, o, d)
        for a, b in zip(pb, rb):
            assert torch.allclose(a, b, atol=1e-3, rtol=0)
        # the same bands on both sides: the render's semantics alone
        pkw = dict(mask=pmask, bounds=pb)
        kw = dict(bands=pb, mask=rmask, G=G)
    cam = Camera.make((0.0, 0.0, 0.0), device=CPU)
    loss = loop._loss_fn(MortonSoftGrid(leaf), cam, o, d, target, (16, 16),
                         RenderSettings(**cfg["settings"]), tc,
                         pkw.get("mask"), pkw.get("bounds"))
    loss.backward()
    r_loss, r_grad = rsoft.loss_and_grad(
        tab, o, d, target, D, S, cfg["settings"],
        (t["tv_sigma"], t["tv_rgb"]), 64, **kw)
    assert float(loss.detach()) == pytest.approx(r_loss, rel=1e-6)
    scale = float(r_grad.abs().max())
    assert torch.allclose(leaf.grad[mi], r_grad, rtol=1e-4,
                          atol=1e-6 * scale)
    # one Adam step each, on the same gradient
    opt = torch.optim.Adam([leaf], lr=t["lr"], betas=rsoft.BETAS,
                           eps=rsoft.ADAM_EPS)
    opt.step()
    p, m, v = tab.clone(), torch.zeros_like(tab), torch.zeros_like(tab)
    rsoft.adam(p, leaf.grad[mi], m, v, 1, t["lr"])
    assert torch.allclose(leaf.detach()[mi], p, rtol=0, atol=1e-6)


def _run(manifest, name, faults=()):
    cell = harness.find_cell(manifest, name)
    sizes = SMALL_RENDER if "render" in name else SMALL_TRAIN
    return harness.driver(cell.config["kind"]).run(Run(
        cell=cell, seed=2 ** 31 + 77, seconds=0.2, trace=False, device=CPU,
        t_start=time.perf_counter(), sizes=sizes, faults=faults))


@pytest.mark.parametrize("name,faults", [
    ("render512_1080p.orbit", ()),
    ("render512_1080p.orbit", ("answer_altered",)),
    ("render512_1080p.lowpass", ("answer_altered",)),
    ("c4_512_diff.fit", ()),
    ("c4_512_diff.fit", ("state_unchanged",)),
    ("c4_512_diff.fit", ("half_batch",)),
    ("c4_512_diff.masked", ()),
    ("c4_512_diff.masked", ("state_unchanged",)),
    ("c4_512_diff.masked", ("half_batch",)),
])
def test_a_planted_fault_is_not_correct(manifest, name, faults):
    """The rest of a run (the look for a card skipped) with the timed path
    broken underneath: a frame altered where it is made, a step that
    leaves its state unchanged, half of the batch left out."""
    out = _run(manifest, name, faults)
    ok = harness.checks_ok(out.checks) and out.failed == 0
    assert ok == (not faults), out.checks
    assert out.attempted > 0 and out.metrics["setup_s"] > 0


@pytest.mark.parametrize("name,mode", [
    ("render512_1080p.orbit", "bfloat16"),
    ("render512_1080p.lowpass", "bfloat16"),
    ("c4_512_diff.fit", "bfloat16"),
    ("c4_512_diff.fit", "half_batch"),
    ("c4_512_diff.masked", "bfloat16"),
    ("c4_512_diff.masked", "half_batch"),
])
def test_the_control_fails_the_limits(manifest, name, mode):
    from vxbench import control

    cell = harness.find_cell(manifest, name)
    kind = cell.config["kind"]
    fn = control.render_control if kind == "fused_render" \
        else control.train_control
    nums = fn(cell, 21, mode, CPU, control.SMALL[kind])
    lim = cell.config["limits"]
    assert any(v > lim[k] for k, v in nums.items()), nums


@pytest.mark.cuda
def test_the_control_fails_the_limits_on_the_card(manifest):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vxbench import control

    cell = harness.find_cell(manifest, "c4_512_diff.fit")
    nums = control.train_control(cell, 21, "bfloat16",
                                 torch.device("cuda"),
                                 control.SMALL["soft_fit"])
    assert any(v > cell.config["limits"][k] for k, v in nums.items())


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env.update(extra)
    return env


def test_a_run_of_each_kind_loads_no_jax():
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from vxbench import harness\n"
        "from vxbench.drivers import Run\n"
        "m = harness.load_manifest()\n"
        "for name, sz in ((\"render512_1080p.orbit\", "
        f"{SMALL_RENDER!r}), (\"c4_512_diff.masked\", {SMALL_TRAIN!r})):\n"
        "    cell = harness.find_cell(m, name)\n"
        "    harness.driver(cell.config['kind']).run(Run(cell=cell, seed=3,"
        " seconds=0.1, trace=False, device=torch.device('cpu'),"
        " t_start=time.perf_counter(), sizes=sz))\n"
        "print(sorted({k.split('.')[0] for k in sys.modules}))\n"
        "print(harness.forbidden_loaded())\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_clean_env(), timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = eval(p.stdout.splitlines()[-2])
    assert "vxtpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "vxtpu"} & set(tops)
    assert p.stdout.splitlines()[-1] == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    p = subprocess.run(
        [sys.executable, str(ROOT / "vxbench" / "run.py"), "--workload",
         "render512_1080p.orbit", "--seed", "5", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        env=_clean_env(CUDA_VISIBLE_DEVICES=""), timeout=120)
    assert p.returncode != 0
    assert "correct" not in p.stdout
    assert "never falls back to the CPU" in p.stderr
