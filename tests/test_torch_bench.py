"""vxtpu_torch/bench.py's sections called small on the CPU (the kernels'
plain versions): 16^3, 16 x 32 rays; train steps at 8^3, 16 x 16, S = 8.
Its frames equal the paths they time, its counters the wavefront march's
stats, and its JSON lines carry bench.py's keys with a clock beside every
time."""

import functools
import json
import math

import pytest
import torch

from vxtpu_torch import bench
from vxtpu_torch.camera.rays import generate_rays
from vxtpu_torch.render import kernel_wavefront as kw
from vxtpu_torch.render.fused import render_frame_fused
from vxtpu_torch.render.pipeline import render_image
from vxtpu_torch.render.probe import CLOCK_WALL
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.world import distfield
from vxtpu_torch.world.lights import Lights
from vxtpu_torch.world.packed import (build_material_morton,
                                      build_packed_morton)

CPU = torch.device("cpu")
D, H, W = 16, 16, 32
SIZES = dict(forward=dict(D=D, h=H, w=W, iters=1),
             fused=dict(D=D, h=H, w=W, iters=1),
             train=dict(D=8, h=16, w=16, S=8, S_mask=8, iters=1))
# bench.py's last-line keys that have a meaning on the card
KEYS = ("metric", "value", "unit", "fps", "kernel", "wavefront_mrays",
        "wavefront_pct_of_endpoint_floor", "pallas2_mrays", "train_step_ms",
        "train_step_masked_ms", "train_step_field_ms", "vs_baseline")


times_without_clock = bench.times_without_clock


def test_times_without_clock_finds_every_bare_time():
    """The clock check sees a time key without its clock at any depth,
    and only such keys."""
    obj = {"ms": 1.0, "ms_clock": CLOCK_WALL, "frame_ms": 2.0,
           "row": {"kernel_device_ms": 3.0, "mrays": 4.0,
                   "deep": {"ms": 5.0}},
           "gather_ms": None, "gather_ms_clock": bench.NOT_MEASURED}
    assert times_without_clock(obj) == ["frame_ms", "row.kernel_device_ms",
                                        "row.deep.ms"]


def test_device_time_off_the_card_is_not_measured():
    row = {}
    assert bench.device_time(row, "k_ms", lambda: None, CPU) == \
        bench.NOT_MEASURED
    assert row == {"k_ms": None, "k_ms_clock": bench.NOT_MEASURED}


@pytest.fixture(scope="module")
def grid():
    return bench.world(CPU, D)


def test_forward_section(grid):
    """The wavefront frame and its counters: the frame equals the
    pipeline's through the wavefront factory over the cap-96 field, the
    counters the march's stats."""
    details = {}
    out = bench.bench_forward(details, CPU, grid, **SIZES["forward"])
    s = D / 512
    cam = bench.camera(bench.OUTSIDE, CPU, s)
    o, d = generate_rays(cam, H, W)
    vc = kw.count_valid_rays(o, d, grid.dims)
    assert 0 < vc < H * W and details["forward"]["valid_rays"] == vc
    acc = distfield.build(grid.occupancy, cap=96)
    want = render_image(functools.partial(kw.make_march_wavefront,
                                          valid_count=vc), grid, cam,
                        Lights.single(bench.scaled(bench.LIGHT, s),
                                      intensity=2.0, device=CPU),
                        RenderSettings(shading="lambert", step_chunk=8), H, W,
                        acc)
    assert torch.equal(out["frame"], want)
    _, st = kw.march_wavefront(o, d, acc.field.reshape(-1), grid.dims,
                               sum(grid.dims) + 2, valid_count=vc, stats=True)
    c = details["counters"]
    assert c["round_counts"] == [int(x) for x in st["round_counts"]]
    assert (c["round_steps"], c["drain_rounds"], c["gathered_lanes"]) == (
        st["round_steps"], st["drain_rounds"], st["gathered_lanes"])
    assert c["useful_ray_steps"] == int(out["rec"].steps.sum()) > 0
    roof = details["roofline"]
    # the floor is a device time: not measured on the CPU
    assert roof["gather_ms"] is None and roof["floor_ms_clock"] == \
        bench.NOT_MEASURED
    assert details["forward"]["frame_ms_clock"] == CLOCK_WALL
    assert not times_without_clock(details)


def test_forward_section_inside_camera(grid):
    details = {}
    bench.bench_forward(details, CPU, grid, inside=True, **SIZES["forward"])
    inn = details["forward_inside_camera"]
    assert inn["valid_rays"] == H * W and inn["frame_ms"] > 0


def test_fused_section(grid):
    """The lambert frame equals render_frame_fused's; the march's steps and
    warp coherence; no launches counted on the CPU (plain versions)."""
    details = {}
    out = bench.bench_fused(details, CPU, grid, **SIZES["fused"])
    s = D / 512
    want = render_frame_fused(
        build_packed_morton(grid.occupancy, cap=64),
        build_material_morton(grid.occupancy), grid.dims,
        bench.camera(bench.OUTSIDE, CPU, s),
        Lights.single(bench.scaled(bench.LIGHT, s), intensity=2.0,
                      device=CPU), RenderSettings(shading="lambert"), H, W)
    assert torch.equal(out["frame"], want)
    for name in ("pallas2_march", "pallas2_512_1080p",
                 "pallas2_512_1080p_full", "pallas2_inside_camera_frame"):
        assert details[name]["ms"] > 0 and details[name]["mrays"] > 0
    assert details["pallas2_512_1080p"]["kernel_device_ms"] is None
    cnt = details["pallas2_counters"]
    assert cnt["useful_ray_steps"] == int(out["rec"].steps.sum()) > 0
    assert 0 < cnt["warp_coherence"] <= 1
    assert details["launches_fused"]["march_shade_kernel"] == 0
    assert not times_without_clock(details)


def test_train_section():
    """The four steps at 8^3: finite losses, the masked step's occupied
    share, each step timed on the host's clock; the process group it
    starts is left again."""
    import torch.distributed as dist

    details = {}
    bench.bench_train(details, CPU, **SIZES["train"])
    assert not dist.is_initialized()
    for k in ("train_step_b1", "train_step_b4", "train_step_masked",
              "train_step_field"):
        assert math.isfinite(details[k]["loss"]) and details[k]["ms"] > 0
        assert details[k]["ms_clock"] == CLOCK_WALL
    assert details["train_step_b4"]["grad_buckets"] == 4
    assert 0 < details["train_step_masked"]["mask_occupied_frac"] <= 1
    assert details["train_step_field"]["field_kernel"]
    assert set(details["launches_train_field"]) == {
        "sample_fwd_kernel", "sample_bwd_kernel<kRayGrads=false>",
        "sample_bwd_kernel<kRayGrads=true>", "sample_ray_sum_kernel"}


def test_json_lines(monkeypatch, tmp_path, capsys):
    """main prints the details line, then the headline with bench.py's
    keys; --details writes the details too; every time names a clock."""
    monkeypatch.setattr(bench, "run", functools.partial(bench.run,
                                                        sizes=SIZES))
    path = tmp_path / "details.json"
    assert bench.main(["--device", "cpu", "--details", str(path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    details, line = json.loads(lines[-2]), json.loads(lines[-1])
    assert json.loads(path.read_text()) == details
    for k in KEYS:
        assert k in line, k
    assert line["metric"] == f"Mrays/s/chip @ {D}^3 grid, {H}p forward"
    assert line["vs_baseline"] == pytest.approx(
        line["value"] / (1920 * 1080 * 60 / 1e6))
    assert "display rate" in line["baseline"]
    assert line["train_step_ms"] == details["train_step_b1"]["ms"]
    assert not times_without_clock(details) and not times_without_clock(line)
    assert details["gpu"] and details["device"] == "cpu"


def test_sections_can_be_left_out(monkeypatch, capsys):
    monkeypatch.setattr(bench, "run", functools.partial(bench.run,
                                                        sizes=SIZES))
    assert bench.main(["--device", "cpu", "--skip-fused",
                       "--skip-train"]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["kernel"] == "wavefront" and "pallas2_mrays" not in line
    assert "train_step_ms" not in line


def test_default_device_is_the_gpu():
    """Without --device the bench runs on the card, and raises where there
    is none; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    with pytest.raises(RuntimeError, match="GPU"):
        bench.main([])
