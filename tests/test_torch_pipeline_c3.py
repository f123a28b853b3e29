"""Config 3 on the composable pipeline (``--kernel pallas`` / ``pallas2``)
on the CPU, without JAX: ``app/run.py:make_frame`` builds the table its
kernel marches once, at set-up, whatever ``--accel`` says, and a frame
records the pipeline's four stage spans without changing a bit of its
image."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vxtpu_torch.app import run
from vxtpu_torch.app.configs import CONFIGS
from vxtpu_torch.camera import paths
from vxtpu_torch.render import kernel_march, kernel_packed, pipeline
from vxtpu_torch.world import packed
from vxtpu_torch.world.lights import Lights

CPU = torch.device("cpu")
DIMS = (32, 32, 32)
H, W = 12, 16
C3 = CONFIGS["c3_256_shadows"]


def _orbit():
    X, Y, Z = DIMS
    return paths.orbit(center=(0.5 * X, 0.5 * Y, 0.3 * Z), radius=0.9 * X,
                       height=1.1 * Z, period=10.0, device=CPU)


def _count_builds(monkeypatch, name):
    """Count calls of world/packed.py's ``name`` through every module that
    holds it."""
    calls = []
    real = getattr(packed, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    for mod in (packed, kernel_packed, kernel_march, run):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("kernel,marched,build", [
    ("pallas", "packed", "build_packed"),
    ("pallas2", "morton", "build_packed_morton"),
])
def test_make_frame_builds_the_marched_table_once(monkeypatch, kernel,
                                                  marched, build):
    at = _orbit()
    want_frame, _ = run.make_frame(C3, DIMS, H, W, CPU, kernel, marched)
    want = [want_frame(at(t)) for t in (0.0, 1.3, 7.9)]
    calls = _count_builds(monkeypatch, build)
    frame, _ = run.make_frame(C3, DIMS, H, W, CPU, kernel, "distfield")
    assert calls == [build]
    got = [frame(at(t)) for t in (0.0, 1.3, 7.9)]
    assert calls == [build]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kernel,accel_kind,want", [
    ("pallas", "distfield", "packed"), ("pallas", "none", "packed"),
    ("pallas2", "pyramid", "morton"), ("xla", "pyramid", "pyramid"),
    ("wavefront", "distfield", "distfield"),
])
def test_marched_accel(kernel, accel_kind, want):
    assert run.marched_accel(kernel, accel_kind) == want


def _render(n_lights):
    grid, accel, _, _ = run.build_scene(C3, DIMS, "packed", CPU)
    X, Y, Z = DIMS
    pos = [(0.2 * X, -0.3 * Y, 1.4 * Z), (0.9 * X, 0.8 * Y, 1.2 * Z)]
    lights = Lights.make(pos[:n_lights], [(1.0, 1.0, 1.0)] * n_lights,
                         [2.0] * n_lights, device=CPU)
    return pipeline.render_image(kernel_packed.make_march_packed, grid,
                                 _orbit()(2.5), lights, C3.settings, H, W,
                                 accel)


@pytest.mark.parametrize("n_lights", [1, 2])
def test_a_frame_records_the_four_stage_spans_in_order(n_lights):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render(n_lights)
    spans = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.name.startswith(pipeline.SPAN))
    names = [n[len(pipeline.SPAN):] for _, n in spans]
    assert names == ["rays", "march"] + ["shadows"] * n_lights + ["shade"]


def test_the_spans_change_no_bit_of_the_image(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with_spans = _render(1)
    assert [e for e in prof.events() if e.name.startswith(pipeline.SPAN)]
    monkeypatch.setattr(pipeline, "record_function",
                        lambda name: contextlib.nullcontext())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        without = _render(1)
    assert not [e for e in prof.events()
                if e.name.startswith(pipeline.SPAN)]
    assert torch.equal(with_spans, without)


def test_a_frame_opens_no_span_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(pipeline, "record_function",
                        lambda name: opened.append(name)
                        or contextlib.nullcontext())
    plain = _render(1)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _render(1)
    assert opened == [pipeline.SPAN + s
                      for s in ("rays", "march", "shadows", "shade")]
    assert torch.equal(plain, traced)
