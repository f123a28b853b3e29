"""The pipeline cell (``c3_256_pipeline.orbit``): the frozen v1 reference
agrees with the port's composable pipeline at 32^3; a run with a fault
planted in the timed path comes out not correct; the bfloat16 control
fails the limit; K5's bound counts its bytes; the new readers read what a
frame context holds and nothing of a training one; and a run of the kind
loads no JAX module."""

import dataclasses
import os
import subprocess
import sys
import time

import pytest
import torch

from vxbench import bounds, bounds_packed, camera, harness, world
from vxbench.drivers import Run
from vxbench.reference import pipeline as rpipe
from vxbench.trace import Window

ROOT = harness.ROOT
CPU = torch.device("cpu")
CELL = "c3_256_pipeline.orbit"
SMALL = dict(dims=(32, 32, 32), height=24, width=32, loop=4, warm_frames=2)


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


@pytest.mark.parametrize("shading,shadows", [("full", True),
                                             ("lambert", False)])
def test_pipeline_reference_equals_the_port(manifest, shading, shadows):
    from vxtpu_torch.camera import paths
    from vxtpu_torch.render.kernel_packed import make_march_packed
    from vxtpu_torch.render.pipeline import render_image
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.world.grid import VoxelGrid
    from vxtpu_torch.world.lights import Lights
    from vxtpu_torch.world.packed import build_packed

    cell = harness.find_cell(manifest, CELL)
    cfg, tr = cell.config, cell.traffic
    dims, h, w = (32, 32, 32), 24, 32
    occ, rgb = world.terrain(dims, 5, CPU)
    top = world.top_height(occ)
    st = dict(cfg["settings"], shading=shading, shadows=shadows)
    lp = tuple(p * n for p, n in zip(cfg["lights"][0]["pos"], dims))
    lights = Lights.single(lp, intensity=2.0, device=CPU)
    accel = build_packed(occ, cap=cfg["table_cap"])
    words = rpipe.packed_table(occ)
    assert torch.equal(words, accel.words)
    args = camera.path_args(tr, dims, top)
    at = paths.orbit(center=args["center"], radius=args["radius"],
                     height=args["height"], period=args["period"],
                     fov_y_deg=args["fov_y_deg"], device=CPU)
    grid = VoxelGrid(occupancy=occ, rgb=rgb)
    for t in (0.0, 1.3, 7.9):
        img = render_image(make_march_packed, grid, at(t), lights,
                           RenderSettings(**st), h, w, accel)
        pos, yaw, pitch, fov = camera.pose(tr, dims, top, t, CPU)
        o, d = camera.rays(pos, yaw, pitch, fov, h, w)
        ref = rpipe.render(o, d, words, rgb.reshape(-1, 3), dims,
                           [(lp, (1.0, 1.0, 1.0), 2.0)], st)
        assert (img.reshape(-1, 3) - ref).abs().max() <= 1e-6


def test_the_v1_march_equals_the_ports(manifest):
    """Hit, t, voxel, normal and steps of every ray, primary and shadow,
    against ``kernel_packed.march_packed_reference``, and the counts."""
    from vxtpu_torch.render import kernel_packed as kp
    from vxtpu_torch.world.packed import build_packed

    cell = harness.find_cell(manifest, CELL)
    dims = (32, 32, 32)
    occ, _ = world.terrain(dims, 5, CPU)
    top = world.top_height(occ)
    accel = build_packed(occ)
    words = rpipe.packed_table(occ)
    pos, yaw, pitch, fov = camera.pose(cell.traffic, dims, top, 2.0, CPU)
    o, d = camera.rays(pos, yaw, pitch, fov, 24, 32)
    ms = sum(dims) + 2
    counts = rpipe.Counts(words.numel(), CPU)
    got = rpipe.march(o, d, words, dims, ms, counts=counts)
    want = kp.march_packed_reference(o, d, accel, dims, ms)
    hit, t, vox, rax, rsg, steps = got
    normal = rpipe._normal(hit, rax, rsg, torch.float32)
    assert torch.equal(hit, want.hit) and torch.equal(t, want.t)
    assert torch.equal(vox, want.voxel) and torch.equal(steps, want.steps)
    assert torch.equal(normal, want.normal)
    assert 0 < int(hit.sum()) < hit.numel()
    p, ldir, tm = rpipe.shadow_batch(hit, t, normal, o, d, (6.4, -9.6, 44.8))
    sgot = rpipe.march(p, ldir, words, dims, ms, t_max=tm, counts=counts)
    swant = kp.march_packed_reference(p, ldir, accel, dims, ms, t_max=tm)
    assert torch.equal(sgot[0], swant.hit)
    assert torch.equal(sgot[5], swant.steps)
    assert counts.steps == int(steps.sum()) + int(sgot[5].sum())
    assert len(counts.launch_words) == 2
    assert max(counts.launch_words) <= counts.frame_words \
        <= sum(counts.launch_words)


def _run(manifest, faults=()):
    cell = harness.find_cell(manifest, CELL)
    return harness.driver(cell.config["kind"]).run(Run(
        cell=cell, seed=2 ** 31 + 77, seconds=0.2, trace=False, device=CPU,
        t_start=time.perf_counter(), sizes=SMALL, faults=faults))


@pytest.mark.parametrize("faults", [(), ("answer_altered",)])
def test_a_planted_fault_is_not_correct(manifest, faults):
    out = _run(manifest, faults)
    ok = harness.checks_ok(out.checks) and out.failed == 0
    assert ok == (not faults), out.checks
    assert out.attempted > 0 and out.metrics["setup_s"] > 0


def test_the_bfloat16_control_fails_the_limit(manifest):
    from vxbench import control_pipeline

    cell = harness.find_cell(manifest, CELL)
    nums = control_pipeline.pipeline_control(cell, 21, "bfloat16", CPU,
                                             control_pipeline.SMALL)
    lim = cell.config["limits"]
    assert any(v > lim[k] for k, v in nums.items()), nums


def test_k5_bound_counts_its_bytes():
    assert bounds_packed.PRIMARY_RAY_BYTES == 57
    assert bounds_packed.SHADOW_RAY_BYTES == 61
    assert bounds_packed.WORD_BYTES == 2
    b = bounds_packed.k5_work(10, 7, 0, 5)
    assert b["bytes"] == 10 * 57 + 7 * 61 + 5 * 2
    assert b["ops"] == 17 * bounds.MARCH_OPS_RAY
    # the c3 frame's primary launch (1024 x 1024 rays, 222,092 words)
    c3 = bounds_packed.k5_work(1024 * 1024, 0, 0, 222_092)
    assert round(c3["bound_ms"], 5) == 0.01797 and c3["bound_by"] == "bytes"


class _Win:
    """A Window's fields, set by hand."""

    def __init__(self, ops, host, spans, start, end):
        self.ops, self.host, self.spans = ops, host, spans
        self.start_us, self.end_us = start, end


def _frame_ctx():
    k5 = "void march_packed_kernel(float const*)"
    ops = [(k5, 10.0, 40.0), ("elementwise", 45.0, 50.0), (k5, 60.0, 90.0),
           ("elementwise", 120.0, 125.0), (k5, 130.0, 150.0)]
    host = [("vxtpu_torch.pipeline.shade", 92.0, 100.0),
            ("vxtpu_torch.pipeline.shade", 151.0, 155.0),
            ("aten::mul", 93.0, 94.0)]
    spans = [("vxbench.frame.0", 0.0, 110.0),
             ("vxbench.frame.1", 115.0, 160.0)]
    win = _Win(ops, host, spans, 0.0, 160.0)
    return dict(kind="frame", window=win, host_ms=[1.0, 2.0], frames=2,
                pixels=12, frame_work=[],
                k5_work=[(100, 100, 50, 20, 60e-6, 2, 2),
                         (100, 100, 50, 20, 20e-6, 1, 2)])


def test_the_new_readers():
    ctx = _frame_ctx()
    train = dict(kind="step", window=ctx["window"], steps=3)
    for name in ("k5_roofline", "shade_host_ms.frame", "launches.frame"):
        assert harness.reader(name)(train) is None
    least = bounds_packed.k5_work(100, 100, 50, 20)["bound_ms"] / 1e3
    # the second frame recorded one of its two K5 launches: left out
    assert harness.reader("k5_roofline")(ctx) == pytest.approx(
        100.0 * least / 60e-6)
    assert harness.reader("shade_host_ms.frame")(ctx) == pytest.approx(
        (8.0 + 4.0) / 1e3 / 2)
    assert harness.reader("launches.frame")(ctx) == pytest.approx(
        (3 + 2) / 2)
    # the parent's program records no span: the reader returns None
    bare = dict(ctx, window=_Win(ctx["window"].ops, [], ctx["window"].spans,
                                 0.0, 160.0))
    assert harness.reader("shade_host_ms.frame")(bare) is None
    assert harness.reader("k5_roofline")(dict(ctx, k5_work=[])) is None


def test_a_traced_run_reports_every_metric_of_the_cell(manifest):
    """A traced run at 32^3 on the CPU, three frames traced and a loop of
    three: the profiler records the frame spans and the program's shade
    spans (no device, so no K5 launch: the device readers find
    nothing)."""
    cell = harness.find_cell(manifest, CELL)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                  traced_frames=3))
    out = harness.driver(cell.config["kind"]).run(Run(
        cell=cell, seed=5, seconds=0.1, trace=True, device=CPU,
        t_start=time.perf_counter(), sizes=dict(SMALL, loop=3)))
    assert harness.checks_ok(out.checks) and out.failed == 0
    got = harness.read_layers(cell, out.layer_ctx)
    assert {"frame_host_ms", "shade_host_ms.frame"} <= set(got)
    assert "k5_roofline" not in got
    assert len(out.layer_ctx["k5_work"]) == 3
    spans = [n for n, _, _ in out.window.spans]
    assert "vxbench.frame.0" in spans
    assert isinstance(out.window, Window)


def test_a_pipeline_run_loads_no_jax():
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from vxbench import harness\n"
        "from vxbench.drivers import Run\n"
        "m = harness.load_manifest()\n"
        f"cell = harness.find_cell(m, {CELL!r})\n"
        "harness.driver(cell.config['kind']).run(Run(cell=cell, seed=3,"
        " seconds=0.1, trace=False, device=torch.device('cpu'),"
        f" t_start=time.perf_counter(), sizes={SMALL!r}))\n"
        "print(harness.forbidden_loaded())\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.splitlines()[-1] == "[]"
