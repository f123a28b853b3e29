"""vxtpu_torch and chip_smoke.py run where JAX is not installed: no file of
theirs may import jax or vxtpu. An AST scan rather than a subprocess,
because an interpreter here may import jax at start-up on its own."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "vxtpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "vxtpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for mod in ("render/kernel_march.py", "render/dda.py", "render/soft.py",
                "render/kernel_sample.py", "render/soft_kernel.py",
                "train/loss.py", "train/loop.py", "train/checkpoint.py",
                "camera/paths.py", "device.py", "convert.py",
                "render/kernel_packed.py", "render/pipeline.py",
                "world/atlas.py", "obs/log.py", "obs/metrics.py",
                "native/framesink.py", "render/probe.py",
                "render/kernel_xla.py", "render/occmask.py",
                "world/pyramid.py", "engine/sharding.py",
                "engine/platform.py", "render/vjp.py", "train/config5.py",
                "app/schedule.py", "app/dryrun.py", "render/kernel_ref.py",
                "render/kernel_wavefront.py", "native/oracle.py",
                "bench.py"):
        assert f"vxtpu_torch/{mod}" in names, mod
    assert "chip_smoke.py" in names and (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_jax_or_vxtpu_import(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("recorded", [[10.0, 30.0], []],
                         ids=["profiler", "none_recorded"])
def test_device_ms_names_its_clock(monkeypatch, recorded):
    """render/probe.py:device_ms returns the clock behind its time: the
    profiler's device time where it recorded launches, CUDA events where
    it recorded none in any window (a fallback it does not hide)."""
    from vxtpu_torch.render import probe

    windows = []
    monkeypatch.setattr(probe, "launch_us",
                        lambda fn, reps, kernel: windows.append(1)
                        or list(recorded))
    monkeypatch.setattr(probe, "_events_ms", lambda fn, reps: 1.5)
    monkeypatch.setattr(probe.time, "sleep", lambda s: None)
    ms, clock = probe.device_ms(lambda: None, 4, "k")
    if recorded:
        assert (ms, clock) == (0.02, probe.CLOCK_DEVICE) and windows == [1]
        assert probe.device_ms(lambda: None, 4, "k", per_call=True) == (
            0.01, probe.CLOCK_DEVICE)
    else:
        assert (ms, clock) == (1.5, probe.CLOCK_EVENTS)
        assert len(windows) == probe._EMPTY_WINDOW_RETRIES
