"""Parity: vxtpu_torch's reference march (render/kernel_ref.py) against
vxtpu's ``march_ref``, and the port's binding of the native C++ oracle
(native/oracle.py) against the port's ``march_ref``, on the same numpy
rays; the CLI's commands with ``--kernel ref``.

Tolerances (tests/test_wavefront.py's between vxtpu's paths): hit,
voxel, normal and steps equal on every ray; t within rtol 1e-5 / atol
1e-4 on hits. A ``--kernel ref`` frame within 1e-5 of vxtpu's
(tests/test_torch_pipeline.py's tolerance)."""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vxtpu.app.configs import CONFIGS as JCONFIGS
from vxtpu.app.run import _build_scene as jbuild_scene
from vxtpu.camera.camera import Camera as JCamera
from vxtpu.camera.rays import generate_rays as jgenerate_rays
from vxtpu.render.kernel_ref import make_march_ref as jmake_march_ref
from vxtpu.render.kernel_ref import march_ref as jmarch_ref
from vxtpu.render.pipeline import render_image as jrender_image
from vxtpu.world import procgen as jprocgen
from vxtpu_torch.app import run
from vxtpu_torch.app.configs import CONFIGS
from vxtpu_torch.engine import platform
from vxtpu_torch.native import oracle
from vxtpu_torch.render import kernel_ref
from vxtpu_torch.render.settings import RenderSettings

CPU = torch.device("cpu")
DIMS = (32, 32, 32)
MAX_STEPS = sum(DIMS) + 2
# a t_max each camera's rays cross surfaces on both sides of
T_CUT = {"outside": 30.0, "inside": 6.0}


def t(x):
    return torch.tensor(np.asarray(x))


@functools.cache
def occupancy():
    """vxtpu's 32^3 terrain, seed 5 (tests/test_wavefront.py's scene)."""
    return np.asarray(jprocgen.terrain(DIMS, seed=5).occupancy)


@functools.cache
def rays(cam):
    """24 x 24 rays of the outside camera or of one inside the grid."""
    if cam == "outside":
        c = JCamera.make(pos=(-22.0, 16.0, 36.0), fov_y_deg=55.0).look_at(
            (16.0, 16.0, 9.0))
    else:
        c = JCamera.make(pos=(16.0, 16.0, 20.0), fov_y_deg=70.0).look_at(
            (30.0, 16.0, 8.0))
    return tuple(np.asarray(x) for x in jgenerate_rays(c, 24, 24))


def arr(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(got, want, what=""):
    """got: a HitRecord or the oracle's dict; want: a HitRecord."""
    field = (got.get if isinstance(got, dict)
             else functools.partial(getattr, got))
    hit = arr(want.hit)
    np.testing.assert_array_equal(arr(field("hit")), hit, f"{what} hit")
    assert hit.any(), f"{what}: no ray hits"
    for f in ("voxel", "normal", "steps"):
        np.testing.assert_array_equal(arr(field(f)), arr(getattr(want, f)),
                                      f"{what} {f}")
    np.testing.assert_allclose(arr(field("t"))[hit], arr(want.t)[hit],
                               rtol=1e-5, atol=1e-4, err_msg=f"{what} t")


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("cam", ["outside", "inside"])
def test_march_ref_matches_vxtpu(cam, cut):
    o, d = rays(cam)
    occ = occupancy()
    tm = np.full((o.shape[0],), T_CUT[cam], np.float32) if cut else None
    want = jmarch_ref(jnp.asarray(o), jnp.asarray(d),
                      jnp.asarray(occ.reshape(-1)), DIMS, MAX_STEPS,
                      t_max=None if tm is None else jnp.asarray(tm))
    got = kernel_ref.march_ref(t(o), t(d), t(occ).reshape(-1), DIMS,
                               MAX_STEPS, t_max=None if tm is None else t(tm))
    assert got.voxel.dtype == torch.int32 and got.steps.dtype == torch.int32
    assert_same(got, want, f"{cam} t_max={tm is not None}")
    if cut:
        full = kernel_ref.march_ref(t(o), t(d), t(occ).reshape(-1), DIMS,
                                    MAX_STEPS)
        assert int(got.hit.sum()) < int(full.hit.sum())


def test_march_ref_check_every_and_step_budget(monkeypatch):
    """How often the loop tests for the end changes nothing; a step budget
    stops every ray after that many advances."""
    o, d = (t(x) for x in rays("outside"))
    occ = t(occupancy()).reshape(-1)
    a = kernel_ref.march_ref(o, d, occ, DIMS, MAX_STEPS)
    monkeypatch.setattr(kernel_ref, "_CHECK_EVERY", 1)
    b = kernel_ref.march_ref(o, d, occ, DIMS, MAX_STEPS)
    assert_same(b, a, "a test for the end after every step")
    monkeypatch.undo()
    short = kernel_ref.march_ref(o, d, occ, DIMS, 5)
    assert int(short.steps.max()) == 5
    assert bool((short.hit <= a.hit).all())


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("cam", ["outside", "inside"])
def test_native_oracle_matches_march_ref(cam, cut):
    if not oracle.native_available():
        pytest.skip("no C++ compiler: the native oracle cannot be built")
    o, d = (t(x) for x in rays(cam))
    occ = t(occupancy())
    tm = torch.full((o.shape[0],), T_CUT[cam]) if cut else None
    want = kernel_ref.march_ref(o, d, occ.reshape(-1), DIMS, MAX_STEPS,
                                t_max=tm)
    got = oracle.march_native(o, d, occ, DIMS, MAX_STEPS, t_max=tm)
    assert set(got) == {"hit", "t", "voxel", "normal", "steps"}
    assert_same(got, want, f"native {cam} t_max={cut}")


def test_native_oracle_builds_into_the_port(tmp_path):
    """The library is built under vxtpu_torch/_build, never under
    native/_build (vxtpu's)."""
    if not oracle.native_available():
        pytest.skip("no C++ compiler: the native oracle cannot be built")
    lib = oracle._build_lib()
    assert lib.parent == oracle.BUILD_DIR and lib.name.startswith(
        "libvxoracle_")
    with pytest.raises(ValueError):
        oracle.march_native(np.zeros((4, 3)), np.ones((4, 3)),
                            np.zeros((8, 8, 8)), DIMS, 10)


def test_make_march_ref_factory():
    occ = t(occupancy()).reshape(-1)
    march = kernel_ref.make_march_ref(occ, DIMS, RenderSettings(), None)
    o, d = (t(x) for x in rays("outside"))
    assert_same(march(o, d), kernel_ref.march_ref(o, d, occ, DIMS,
                                                  MAX_STEPS), "factory")


def test_cli_ref_frame_matches_vxtpu():
    """The frame ``render --kernel ref --device cpu`` makes (c3_256_shadows
    at 16^3, 16 x 24: full + shadows + fog) against vxtpu's render_image
    through its make_march_ref."""
    dims = (16, 16, 16)
    frame, cam = run.make_frame(CONFIGS["c3_256_shadows"], dims, 16, 24,
                                CPU, "ref", "none")
    got = frame(cam)
    jcfg = JCONFIGS["c3_256_shadows"]
    jg, _, jcam, jl = jbuild_scene(jcfg, dims, "none")
    want = jrender_image(jmake_march_ref, jg, jcam, jl, jcfg.settings, 16,
                         24)
    assert got.shape == (16, 24, 3) and got.std() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("cmd", ["render", "animate", "bench", "scaling"])
def test_cli_commands_with_ref(cmd, tmp_path, capsys):
    size = ["--dims", "16", "--height", "8", "--width", "8", "--device",
            "cpu"]
    argv = {"render": ["--out", str(tmp_path / "f.png")],
            "animate": ["--frames", "2", "--out", str(tmp_path / "a")],
            "bench": ["--iters", "1"], "scaling": ["--iters", "1"]}[cmd]
    try:
        assert run.main([cmd, "--config", "c3_256_shadows", "--kernel",
                         "ref", *size, *argv]) == 0
    finally:
        platform.shutdown()     # scaling starts a 1-rank process group
    out = capsys.readouterr().out.splitlines()
    if cmd in ("bench", "scaling"):
        rec = json.loads(out[-1])
        assert rec["kernel"] == "ref" and rec.get("value", rec.get(
            "mrays")) > 0
    else:
        assert any("wrote" in line for line in out)
