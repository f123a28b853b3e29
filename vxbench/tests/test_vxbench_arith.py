"""The benchmark's arithmetic: the percentile over all frames, the window
over the steps, the frozen bounds against ``chip_smoke.py``'s, the idle
share of a trace, and the check of loaded modules."""

import importlib.util
import math
import random

import pytest

from vxbench import bounds, harness, trace


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_bounds", harness.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_percentile_takes_every_value():
    xs = list(range(1, 101))
    random.Random(3).shuffle(xs)
    assert harness.percentile(xs, 95) == 95
    assert harness.percentile(xs, 100) == 100
    # one slow frame in twenty is the 95th percentile; none of the
    # values is dropped or averaged away
    assert harness.percentile([1.0] * 19 + [9.0], 95) == 1.0
    assert harness.percentile([1.0] * 18 + [9.0, 9.5], 95) == 9.0
    assert harness.percentile([4.2], 95) == 4.2
    with pytest.raises(ValueError):
        harness.percentile([], 95)


def test_window_over_steps():
    assert harness.rate_per_item(2.0, 40) == pytest.approx(50.0)
    assert harness.rate_per_item(10.0, 3) == pytest.approx(3333.333333)
    with pytest.raises(ValueError):
        harness.rate_per_item(1.0, 0)


@pytest.mark.parametrize("nb,ops", [(1.357e9, 4e9), (1e6, 9e12), (0, 1)])
def test_bound_matches_chip_smoke(chip_smoke, nb, ops):
    assert bounds.bound(nb, ops) == chip_smoke._bound(nb, ops)
    assert (bounds.PEAK_BYTES, bounds.PEAK_F32) == (chip_smoke.PEAK_BYTES,
                                                    chip_smoke.PEAK_F32)
    assert (bounds.MARCH_OPS_RAY, bounds.MARCH_OPS_STEP) == (
        chip_smoke.MARCH_OPS_RAY, chip_smoke.MARCH_OPS_STEP)


def test_frame_work_and_fit_bytes():
    w = bounds.frame_work(pixels=100, table_words=10, rays=100,
                          shadow_rays=50, steps=1000)
    assert w["bytes"] == 100 * 12 + 10 * 2
    assert w["ops"] == 150 * 60 + 1000 * 20
    assert w["bound_ms"] == pytest.approx(max(w["bytes"] / 3.35e12,
                                              w["ops"] / 67e12) * 1e3)
    assert bounds.fit_step_bytes(512, 65536) == 6 * 512 ** 3 * 16 \
        + 65536 * 36
    assert bounds.fit_step_bytes(512, 65536) / 1e9 == pytest.approx(
        12.887, rel=1e-3)


def test_union_and_gaps():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 15.0), ("c", 20.0, 30.0),
           ("d", 40.0, 45.0)]
    assert trace.union_us(ops, 0.0, 50.0) == 30.0
    assert trace.union_us(ops, 8.0, 42.0) == 7.0 + 10.0 + 2.0
    assert trace.idle_gaps(ops, 0.0, 50.0) == [(15.0, 20.0), (30.0, 40.0),
                                               (45.0, 50.0)]


def test_readers_of_a_trace():
    w = trace.Window()
    w.start_us, w.end_us = 0.0, 1000.0
    w.ops = [("void sample_fwd_kernel<4>", 100.0, 300.0),
             ("void sample_bwd_kernel<false, false>", 400.0, 500.0),
             ("elementwise", 450.0, 700.0)]
    ctx = {"kind": "step", "window": w, "steps": 2, "step_s": 0.5,
           "D": 512, "rays": 65536}
    idle = harness.reader("device_idle.train")(ctx)
    assert idle == pytest.approx(100.0 * (1 - 500.0 / 1000.0))
    assert harness.reader("sample_kernels_ms.train")(ctx) == \
        pytest.approx((200.0 + 100.0) / 2 / 1e3)
    assert harness.reader("mfu.train")(ctx) == pytest.approx(
        100 * bounds.fit_step_bytes(512, 65536) / 3.35e12 / 0.5)
    assert harness.reader("device_idle.frame")(ctx) is None
    assert harness.reader("mask_bounds_ms.train")(ctx) is None
    frame = {"kind": "frame", "window": w, "pixels": 100, "host_ms": [],
             "frame_work": [(10, 100, 50, 1000, 2e-6)]}
    share = harness.reader("mfu.frame")(frame)
    assert share == pytest.approx(100 * bounds.frame_work(
        100, 10, 100, 50, 1000)["bound_ms"] / 1e3 / 2e-6)
    assert harness.reader("frame_host_ms")(frame) is None
    frame["frame_work"] = [(10, 100, 50, 1000, 0.0)]
    assert harness.reader("mfu.frame")(frame) is None


def test_forbidden_modules_by_whole_top_level_name():
    assert harness.forbidden_loaded({"vxtpu_torch", "vxtpu_torch.render",
                                     "torch", "jaxtyping"}) == []
    assert harness.forbidden_loaded({"vxtpu_torch", "vxtpu.render.soft"}) \
        == ["vxtpu"]
    assert harness.forbidden_loaded({"jax.numpy", "jaxlib", "flax"}) == [
        "flax", "jax", "jaxlib"]


def test_checks_and_result_line():
    ok = {"a": {"value": 0.0, "limit": 0.0}, "b": {"value": 1e-6,
                                                   "limit": 1e-4}}
    assert harness.checks_ok(ok)
    assert not harness.checks_ok({"a": {"value": 2.0, "limit": 1.0}})
    assert not harness.checks_ok({"a": {"value": math.nan, "limit": 1.0}})
    line = harness.result_line(True, 3, 0, {}, {"platform": "gpu"}, ok)
    assert list(__import__("json").loads(line))[-1] == "checks"
