"""Parity: vxtpu_torch's wavefront march (render/kernel_wavefront.py)
against vxtpu's ``march_wavefront`` and against the port's
``march_xla_df``, on tests/test_wavefront.py's scene (32^3 terrain, seed
5, a cap-24 distance field, 24 x 24 rays) carried across as numpy: the
default schedule, the three forced schedules that land in the drain
rounds, a t_max, the camera inside the grid with ``valid_count``, and the
empty grid; the CLI's commands with ``--kernel wavefront``.

Tolerances: against vxtpu hit, voxel, normal and steps equal on every
ray, t within rtol 1e-5 / atol 1e-4 on hits, and the stats counters
(round counts and steps, drain rounds and steps, gathered lanes, valid
rays) equal; against ``march_xla_df`` tests/test_wavefront.py's
``_assert_same``; a ``--kernel wavefront`` frame within 1e-5 of vxtpu's
(tests/test_torch_pipeline.py's tolerance)."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vxtpu.app.configs import CONFIGS as JCONFIGS
from vxtpu.app.run import _build_scene as jbuild_scene
from vxtpu.camera.camera import Camera as JCamera
from vxtpu.camera.rays import generate_rays as jgenerate_rays
from vxtpu.render import kernel_wavefront as jwf
from vxtpu.render.pipeline import render_image as jrender_image
from vxtpu.world import distfield as jdistfield
from vxtpu_torch.app import run
from vxtpu_torch.app.configs import CONFIGS
from vxtpu_torch.engine import platform
from vxtpu_torch.render import kernel_wavefront as kw
from vxtpu_torch.render.kernel_xla import march_xla_df
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.world import distfield, procgen
from vxtpu_torch.world.distfield import DistanceField

CPU = torch.device("cpu")
DIMS = (32, 32, 32)
MAX_STEPS = sum(DIMS) + 2
# (schedule, drain_buf, drain_steps) of tests/test_wavefront.py
SCHEDULES = {
    "default": (None, None, 24),
    "drain_only_after_one": (((64, 2),), 64, 4),
    "two_rounds": (((128, 3), (64, 5)), 32, 4),
    "pure_drain": ((), 96, 4),
}


def t(x):
    return torch.tensor(np.asarray(x))


@functools.cache
def scene():
    """(occupancy, cap-24 field) of the 32^3 terrain, seed 5, made by the
    port's builders (equal to vxtpu's: tests/test_torch_world.py,
    tests/test_torch_xla.py; vxtpu's eager builders take seconds)."""
    g = procgen.terrain(DIMS, seed=5, device=CPU)
    return (g.occupancy.numpy(),
            distfield.build(g.occupancy, cap=24).field.numpy())


@functools.cache
def rays(cam):
    if cam == "outside":
        c = JCamera.make(pos=(-22.0, 16.0, 36.0), fov_y_deg=55.0).look_at(
            (16.0, 16.0, 9.0))
    else:
        c = JCamera.make(pos=(16.0, 16.0, 20.0), fov_y_deg=70.0).look_at(
            (30.0, 16.0, 8.0))
    return tuple(np.asarray(x) for x in jgenerate_rays(c, 24, 24))


def arr(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(got, want, what="", all_rays=True):
    """Hit flags equal; voxel and normal (and steps) equal on every ray
    (``all_rays``) or on hits; t on hits within rtol 1e-5 / atol 1e-4."""
    hit = arr(want.hit)
    np.testing.assert_array_equal(arr(got.hit), hit, f"{what} hit")
    sel = slice(None) if all_rays else hit
    for f in ("voxel", "normal") + (("steps",) if all_rays else ()):
        np.testing.assert_array_equal(arr(getattr(got, f))[sel],
                                      arr(getattr(want, f))[sel],
                                      f"{what} {f}")
    np.testing.assert_allclose(arr(got.t)[hit], arr(want.t)[hit],
                               rtol=1e-5, atol=1e-4, err_msg=f"{what} t")


def assert_stats(got, want):
    assert int(got["valid"]) == int(want["valid"])
    assert tuple(got["schedule"]) == tuple(
        tuple(int(x) for x in r) for r in want["schedule"])
    assert [int(c) for c in got["round_counts"]] == [
        int(c) for c in want["round_counts"]]
    assert list(got["round_steps"]) == [int(s) for s in want["round_steps"]]
    for k in ("drain_buf", "drain_rounds", "drain_steps_total",
              "total_rounds", "n_rays"):
        assert int(got[k]) == int(want[k]), k
    assert got["gathered_lanes"] == float(want["gathered_lanes"])


def run_both(o, d, field, dims, max_steps, **kw_args):
    """(port's (rec, stats), vxtpu's (rec, stats)) on the same inputs;
    vxtpu's under jax.jit (as its bench runs it; eagerly each while_loop
    compiles anew)."""
    tm = kw_args.pop("t_max", None)
    jfn = jax.jit(functools.partial(jwf.march_wavefront, dims=dims,
                                    max_steps=max_steps, stats=True,
                                    **kw_args))
    want = jfn(jnp.asarray(o), jnp.asarray(d), jnp.asarray(field.reshape(-1)),
               t_max=None if tm is None else jnp.asarray(tm))
    got = kw.march_wavefront(t(o), t(d), t(field).reshape(-1), dims,
                             max_steps, t_max=None if tm is None else t(tm),
                             stats=True, **kw_args)
    return got, want


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_wavefront_matches_vxtpu(name):
    schedule, drain, steps = SCHEDULES[name]
    o, d = rays("outside")
    _, field = scene()
    (rec, st), (jrec, jst) = run_both(o, d, field, DIMS, MAX_STEPS,
                                      schedule=schedule, drain_buf=drain,
                                      drain_steps=steps)
    assert_same(rec, jrec, name)
    assert_stats(st, jst)
    assert st["host_syncs"] > 0
    # and hit for hit the batched distance-field march
    ref = march_xla_df(t(o), t(d), t(field).reshape(-1), DIMS, MAX_STEPS)
    assert_same(rec, ref, f"{name} vs march_xla_df", all_rays=False)


def test_wavefront_t_max_matches_vxtpu():
    o, d = rays("outside")
    _, field = scene()
    tm = np.full((o.shape[0],), 18.0, np.float32)
    (rec, st), (jrec, jst) = run_both(o, d, field, DIMS, MAX_STEPS, t_max=tm,
                                      schedule=((96, 4),), drain_buf=48,
                                      drain_steps=6)
    assert_same(rec, jrec, "t_max")
    assert_stats(st, jst)
    ref = march_xla_df(t(o), t(d), t(field).reshape(-1), DIMS, MAX_STEPS,
                       t_max=t(tm))
    assert_same(rec, ref, "t_max vs march_xla_df", all_rays=False)


def test_inside_camera_valid_count_matches_vxtpu():
    """Every ray of a camera inside the grid meets it: count_valid_rays
    sizes round 1 to hold them all, as vxtpu's does."""
    o, d = rays("inside")
    _, field = scene()
    vc = kw.count_valid_rays(t(o), t(d), DIMS)
    assert vc == jwf.count_valid_rays(jnp.asarray(o), jnp.asarray(d), DIMS)
    assert vc == o.shape[0]
    sched = kw._default_schedule(o.shape[0], MAX_STEPS, vc)
    assert sched == jwf._default_schedule(o.shape[0], MAX_STEPS, vc)
    assert sched[0][0] >= vc
    (rec, st), (jrec, jst) = run_both(o, d, field, DIMS, MAX_STEPS,
                                      valid_count=vc)
    assert_same(rec, jrec, "inside")
    assert_stats(st, jst)


@pytest.mark.parametrize("n,max_steps,vc", [
    (2_073_600, 1538, None), (2_073_600, 1538, 1_232_190),
    (4096, 98, None), (576, 8, None), (40_000, 20, 30_000)])
def test_default_schedule_matches_vxtpu(n, max_steps, vc):
    assert kw._default_schedule(n, max_steps, vc) == \
        jwf._default_schedule(n, max_steps, vc)


def test_empty_grid_and_no_jumps():
    """No voxel is solid: no ray hits, misses' voxel and steps as vxtpu's
    (a miss that steps to -1 packs its bits alike); use_jumps=False takes
    the same cells as the jumps."""
    dims = (16, 16, 16)
    field = distfield.build(torch.zeros(dims, dtype=torch.uint8),
                            cap=8).field.numpy()
    c = JCamera.make(pos=(-10.0, 8.0, 8.0)).look_at((8.0, 8.0, 8.0))
    o, d = (np.asarray(x) for x in jgenerate_rays(c, 8, 8))
    (rec, st), (jrec, jst) = run_both(o, d, field, dims, 50)
    assert not bool(rec.hit.any())
    assert_same(rec, jrec, "empty")
    assert_stats(st, jst)
    o, d = rays("outside")
    _, field = scene()
    a = kw.march_wavefront(t(o), t(d), t(field).reshape(-1), DIMS, MAX_STEPS)
    b = kw.march_wavefront(t(o), t(d), t(field).reshape(-1), DIMS, MAX_STEPS,
                           use_jumps=False)
    assert_same(b, a, "use_jumps=False", all_rays=False)


def test_make_march_wavefront_builds_a_cap96_field():
    """Without a DistanceField the factory marches a cap-96 field of the
    grid, as vxtpu's (whose eager 95 dilations are run jitted here)."""
    occ, field = scene()
    march = kw.make_march_wavefront(t(occ).reshape(-1), DIMS,
                                    RenderSettings())
    f96 = np.asarray(jax.jit(functools.partial(
        jdistfield.build_distance_field, cap=96))(jnp.asarray(occ)))
    np.testing.assert_array_equal(march.keywords["df_flat"].numpy(),
                                  f96.reshape(-1))
    o, d = rays("outside")
    (_, _), (jrec, _) = run_both(o, d, f96, DIMS, MAX_STEPS)
    assert_same(march(t(o), t(d)), jrec, "factory, cap 96")
    given = kw.make_march_wavefront(t(occ).reshape(-1), DIMS,
                                    RenderSettings(),
                                    DistanceField(t(field)))
    assert torch.equal(given.keywords["df_flat"], t(field).reshape(-1))


def test_cli_wavefront_frame_matches_vxtpu():
    """The frame ``render --kernel wavefront --device cpu`` makes
    (c3_256_shadows at 16^3, 16 x 24: full + shadows + fog through the
    wavefront march over the cap-24 field of --accel distfield) against
    vxtpu's render_image through its make_march_wavefront."""
    dims = (16, 16, 16)
    frame, cam = run.make_frame(CONFIGS["c3_256_shadows"], dims, 16, 24,
                                CPU, "wavefront", "distfield")
    got = frame(cam)
    jcfg = JCONFIGS["c3_256_shadows"]
    jg, jacc, jcam, jl = jbuild_scene(jcfg, dims, "distfield")
    want = jax.jit(lambda g, acc: jrender_image(
        jwf.make_march_wavefront, g, jcam, jl, jcfg.settings, 16, 24,
        acc))(jg, jacc)
    assert got.shape == (16, 24, 3) and got.std() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("cmd", ["render", "animate", "bench", "scaling"])
def test_cli_commands_with_wavefront(cmd, tmp_path, capsys):
    size = ["--dims", "16", "--height", "8", "--width", "8", "--device",
            "cpu"]
    argv = {"render": ["--out", str(tmp_path / "f.png")],
            "animate": ["--frames", "2", "--out", str(tmp_path / "a")],
            "bench": ["--iters", "1"], "scaling": ["--iters", "1"]}[cmd]
    try:
        assert run.main([cmd, "--config", "c3_256_shadows", "--kernel",
                         "wavefront", *size, *argv]) == 0
    finally:
        platform.shutdown()     # scaling starts a 1-rank process group
    out = capsys.readouterr().out.splitlines()
    if cmd in ("bench", "scaling"):
        rec = json.loads(out[-1])
        assert rec["kernel"] == "wavefront" and rec.get(
            "value", rec.get("mrays")) > 0
    else:
        assert any("wrote" in line for line in out)
