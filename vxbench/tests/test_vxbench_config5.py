"""The config-5 cell (``c5_1080p_pod.anim_fit``) at 16^3, 8x8 rays, S = 8
and 3 frames (frame 0 set-up, frame 1 the window, frame 2 checked): the
plain reference follows the program's checked frame within every limit,
lit and unlit; each planted fault and the bfloat16 control come out above
a limit; a traced run records the program's spans and counters; the new
readers read a config-5 step context and nothing of a frame context or of
an incomplete trace; the step's bound against a hand count; and a run of
the kind loads no JAX module."""

import os
import subprocess
import sys
import time

import pytest
import torch

from vxbench import bounds, bounds_c5, control_config5, harness, launches
from vxbench.drivers import Run

ROOT = harness.ROOT
CPU = torch.device("cpu")
CELL = "c5_1080p_pod.anim_fit"
SMALL = control_config5.SMALL
SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def cell():
    return harness.find_cell(harness.load_manifest(), CELL)


def _run(cell, faults=(), trace=False, **sizes):
    return harness.driver(cell.config["kind"]).run(Run(
        cell=cell, seed=SEED, seconds=0.0, trace=trace, device=CPU,
        t_start=time.perf_counter(), sizes=dict(SMALL, **sizes),
        faults=faults))


@pytest.mark.parametrize("lit", [True, False])
def test_the_reference_follows_the_program(cell, lit):
    out = _run(cell, lit=lit)
    assert harness.checks_ok(out.checks) and out.failed == 0, out.checks
    assert set(out.checks) == set(cell.config["limits"])
    # one frame of 2 steps in the window
    assert out.attempted == 2 and out.metrics["train_step_ms"] > 0
    assert out.metrics["setup_s"] > 0


@pytest.mark.parametrize("fault", control_config5.FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    out = _run(cell, faults=(fault,))
    assert not harness.checks_ok(out.checks), out.checks


def test_the_bfloat16_control_fails_a_limit(cell):
    nums = control_config5.config5_control(cell, SEED, "bfloat16", CPU,
                                           SMALL)
    lim = cell.config["limits"]
    assert set(nums) == set(lim)
    assert any(v > lim[k] for k, v in nums.items()), nums


def test_a_traced_run_records_the_programs_spans_and_counters(cell):
    """On the CPU the profiler records the host spans, and no device
    operation: the device readers find nothing to read."""
    out = _run(cell, trace=True)
    assert harness.checks_ok(out.checks), out.checks
    ctx = out.layer_ctx
    names = {n for n, _, _ in ctx["window"].host}
    for span in ("config5.target", "config5.step", "config5.eval",
                 "vjp.forward", "vjp.backward", "sharding.allreduce",
                 "sharding.adam"):
        assert "vxtpu_torch." + span in names, span
    assert len(launches.spans(ctx["window"], launches.C5_STEP)) == 2
    c5 = ctx["c5"]
    rays, S = SMALL["height"] * SMALL["width"], SMALL["num_samples"]
    assert c5["samples_fwd"] == c5["samples_bwd"] == 2 * rays * S
    assert c5["rows_added"] == 8 * 2 * rays * S
    assert harness.read_layers(cell, ctx) == {}


class _Win:
    """A LaunchWindow's fields, set by hand."""

    def __init__(self, launched, host):
        self.launched, self.host, self.spans = launched, host, []
        self.ops = [(n, h, h + us) for n, us, h in launched]
        self.start_us, self.end_us = 0.0, 1000.0


def _step_ctx(index_adds=4):
    """Two steps of 8 rays of 2 samples: each step's backward launched 2
    index_add_ kernels. launched: (name, device us, launch host us)."""
    host = [("vxtpu_torch.config5.target", 0.0, 50.0),
            ("vxtpu_torch.config5.step", 100.0, 300.0),
            ("vxtpu_torch.vjp.forward", 110.0, 150.0),
            ("vxtpu_torch.vjp.backward", 160.0, 290.0),
            ("vxtpu_torch.config5.step", 400.0, 600.0),
            ("vxtpu_torch.vjp.forward", 410.0, 450.0),
            ("vxtpu_torch.vjp.backward", 460.0, 590.0),
            ("vxtpu_torch.config5.eval", 700.0, 750.0)]
    launched = [("render", 30.0, 5.0),                  # target
                ("fwd", 30.0, 115.0),                   # forward
                ("fwd", 10.0, 415.0),                   # forward
                ("adam", 20.0, 295.0),                  # step only
                ("eval", 40.0, 710.0),                  # eval
                ("copy", 50.0, 900.0)]                  # no span
    launched += [("void indexFuncLargeIndex<float>", 5.0,
                  165.0 + 300 * (k % 2)) for k in range(index_adds)]
    c5 = dict(D=4, rays=8, rays_local=8, samples=2, samples_fwd=32,
              samples_bwd=32, rows_added=8 * 8 * 4)
    return dict(kind="step", window=_Win(launched, host), steps=2, c5=c5)


def test_the_new_readers():
    ctx = _step_ctx()
    assert harness.reader("vjp_fwd_ms.c5")(ctx) == pytest.approx(
        40e-6 / 2 * 1e3)
    assert harness.reader("vjp_bwd_ms.c5")(ctx) == pytest.approx(
        20e-6 / 2 * 1e3)
    assert harness.reader("eval_render_ms.c5")(ctx) == pytest.approx(
        70e-6 / 2 * 1e3)
    least = bounds_c5.c5_step_work(4, 8, 2)["bound_ms"] / 1e3
    assert harness.reader("mfu.c5")(ctx) == pytest.approx(
        100.0 * least * 2 / 80e-6)
    names = ("vjp_fwd_ms.c5", "vjp_bwd_ms.c5", "eval_render_ms.c5", "mfu.c5")
    # a trace that lost one of the step's index_add_ launches reads nothing
    for name in names:
        assert harness.reader(name)(_step_ctx(index_adds=3)) is None
    # nothing of a frame context, or of a c4 step context
    frame = dict(kind="frame", window=ctx["window"], frames=1, host_ms=[],
                 frame_work=[], pixels=1)
    c4 = dict(kind="step", window=ctx["window"], steps=3, step_s=0.02, D=4,
              rays=8)
    for name in names:
        assert harness.reader(name)(frame) is None
        assert harness.reader(name)(c4) is None


def test_the_launch_windows_breakdown_equals_the_windows():
    """LaunchWindow.breakdown (one sweep) gives Window.breakdown's numbers
    (a search of every host range for every gap)."""
    from vxbench.launches import LaunchWindow
    from vxbench.trace import Window

    ops = [("k1", 10.0, 20.0), ("k2", 25.0, 40.0), ("k1", 60.0, 70.0),
           ("k3", 71.0, 90.0)]
    host = [("aten::mul", 0.0, 30.0), ("aten::add", 18.0, 23.0),
            ("cudaStreamSynchronize", 40.0, 65.0), ("aten::sum", 45.0, 50.0)]
    spans = [("vxbench.frame.0", 0.0, 100.0)]
    wins = []
    for cls in (Window, LaunchWindow):
        w = cls()
        w.ops, w.host, w.spans = ops, host, spans
        w.start_us, w.end_us = 0.0, 100.0
        wins.append(w.breakdown())
    assert wins[0] == wins[1]
    assert dict(wins[1]["idle_gaps"]) == pytest.approx({
        "aten::mul": 10e-6, "aten::add": 5e-6,
        "cudaStreamSynchronize": 20e-6, "vxbench.frame.0": 11e-6})


def test_the_step_bound_against_a_hand_count():
    b = bounds_c5.c5_step_work(8, 100, 4)
    assert b["bytes"] == 6 * 8 ** 3 * 16 + 100 * 36
    assert b["ops"] == 100 * 4 * (254 + 274)
    assert b["bound_ms"] == pytest.approx(max(
        b["bytes"] / bounds.PEAK_BYTES, b["ops"] / bounds.PEAK_F32) * 1e3)
    # config 5 on one card: 512^3, 1080 x 1920 rays, S = 192
    full = bounds_c5.c5_step_work(512, 1080 * 1920, 192)
    assert full["bound_by"] == "bytes"
    assert full["bytes"] == 12_884_901_888 + 2_073_600 * 36
    assert round(full["bound_ms"], 4) == 3.8685


def test_a_config5_run_loads_no_jax():
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from vxbench import harness\n"
        "from vxbench.drivers import Run\n"
        "m = harness.load_manifest()\n"
        f"cell = harness.find_cell(m, {CELL!r})\n"
        "harness.driver(cell.config['kind']).run(Run(cell=cell, seed=3,"
        " seconds=0.0, trace=False, device=torch.device('cpu'),"
        f" t_start=time.perf_counter(), sizes={SMALL!r}))\n"
        "print(harness.forbidden_loaded())\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.splitlines()[-1] == "[]"
