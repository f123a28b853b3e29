"""Parity: vxtpu_torch's composable render pipeline against vxtpu's, on
the same world, rays, lights and atlas (carried across as numpy):
``Albedo``, ``sample_atlas``, the full ``shade`` dispatch (within 1e-6),
``render_image`` through the row-major march (on CPU tensors its plain
version; vxtpu's ``march_pallas`` in interpret mode; within 1e-5), and
the CLI's render, animate and bench commands on the CPU.

vxtpu's procedural atlas draws its noise with ``jax.random``, the port's
with a seeded ``torch.Generator``: the atlas is carried across for the
comparisons, and the port's own generator is checked for its structure."""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vxtpu.app.configs import CONFIGS as JCONFIGS
from vxtpu.camera.camera import Camera as JCamera
from vxtpu.render.kernel_pallas import make_march_pallas
from vxtpu.render.pipeline import render_image as jrender_image
from vxtpu.render.settings import RenderSettings as JSettings
from vxtpu.render.shade import shade as jshade
from vxtpu.render.types import HitRecord as JHitRecord
from vxtpu.world import atlas as jatlas
from vxtpu.world import procgen as jprocgen
from vxtpu.world.lights import Lights as JLights
from vxtpu_torch import convert
from vxtpu_torch.app import run
from vxtpu_torch.app.configs import CONFIGS
from vxtpu_torch.render import kernel_packed
from vxtpu_torch.render.kernel_march import make_march
from vxtpu_torch.render.kernel_packed import make_march_packed
from vxtpu_torch.render.pipeline import render_image
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.render.shade import shade
from vxtpu_torch.render.types import HitRecord
from vxtpu_torch.utils import load_png
from vxtpu_torch.world import atlas, grid as tgrid
from vxtpu_torch.world.grid import VoxelGrid

CPU = torch.device("cpu")
DIMS = (32, 32, 32)
N = 512
LIGHTS = ([(25.0, -10.0, 60.0), (40.0, 48.0, 50.0)],
          [(1.0, 0.9, 0.8), (0.4, 0.5, 1.0)], [2.0, 1.2])


@functools.cache
def _jax_terrain():
    return jprocgen.terrain(DIMS, seed=3, with_rgb=True)


def jax_world(with_rgb):
    """vxtpu's 32^3 terrain (seed 3), with per-voxel RGB or in palette
    mode (built once: vxtpu's eager terrain takes ~3 s)."""
    jg = _jax_terrain()
    return jg if with_rgb else type(jg)(occupancy=jg.occupancy)


def torch_grid(jg):
    return VoxelGrid(
        occupancy=convert.occupancy_from_numpy(np.asarray(jg.occupancy),
                                               device=CPU),
        rgb=None if jg.rgb is None else torch.tensor(np.asarray(jg.rgb)))


def _lights():
    return (JLights.make(*LIGHTS),
            convert.lights_from_numpy(*LIGHTS, device=CPU))


def _atlases():
    ja = jatlas.build_procedural_atlas(tex_size=8, seed=4)
    return ja, convert.atlas_from_numpy([np.asarray(c) for c in ja.channels],
                                        ja.tex_size, device=CPU)


def random_record(seed=0):
    """A HitRecord with random hits on random voxels and axis-aligned
    normals, numpy and torch; plus rays o, d and shadow visibility."""
    rng = np.random.default_rng(seed)
    hit = rng.random(N) < 0.7
    t = np.where(hit, rng.uniform(1.0, 60.0, N), 1e30).astype(np.float32)
    vox = rng.integers(0, 32, (N, 3)).astype(np.int32)
    ax = rng.integers(0, 3, N)
    sg = rng.choice([-1.0, 1.0], N)
    normal = np.zeros((N, 3), np.float32)
    normal[np.arange(N), ax] = sg
    normal[~hit] = 0.0
    steps = rng.integers(0, 50, N).astype(np.int32)
    o = rng.uniform(-20.0, 50.0, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    vis = (rng.random((N, 2)) < 0.6).astype(np.float32)
    jrec = JHitRecord(hit=jnp.asarray(hit), t=jnp.asarray(t),
                      voxel=jnp.asarray(vox), normal=jnp.asarray(normal),
                      steps=jnp.asarray(steps))
    rec = HitRecord(hit=torch.tensor(hit), t=torch.tensor(t),
                    voxel=torch.tensor(vox), normal=torch.tensor(normal),
                    steps=torch.tensor(steps))
    return jrec, rec, o, d, vis


@pytest.mark.parametrize("with_rgb", [False, True])
def test_albedo_matches_vxtpu(with_rgb):
    jg = jax_world(with_rgb)
    g = torch_grid(jg)
    idx = np.random.default_rng(1).integers(0, 32 ** 3, 300)
    want = np.asarray(jg.albedo().at(jnp.asarray(idx)))
    got = g.albedo().at(torch.tensor(idx))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
    np.testing.assert_allclose(g.albedo_flat().numpy(),
                               np.asarray(jg.albedo_flat()), atol=1e-7)
    assert g.albedo().size == 32 ** 3


def test_grid_index_helpers():
    v = torch.tensor([[0, 0, 0], [1, 2, 3], [31, 31, 31], [-1, 0, 0],
                      [0, 32, 0]], dtype=torch.int32)
    assert tgrid.linear_index(v, DIMS)[:3].tolist() == [0, 1 * 1024 + 67,
                                                       32 ** 3 - 1]
    assert tgrid.in_bounds(v, DIMS).tolist() == [True, True, True, False,
                                                 False]
    occ = torch.arange(32 ** 3, dtype=torch.int64) % 7
    assert tgrid.occupancy_at(occ, v, DIMS).tolist() == [0, 1091 % 7,
                                                         (32 ** 3 - 1) % 7,
                                                         0, 0]


def test_sample_atlas_matches_vxtpu():
    ja, ta = _atlases()
    jrec, rec, o, d, _ = random_record(2)
    p = o + np.asarray(jrec.t)[:, None].clip(0, 60) * d
    mat = np.random.default_rng(3).integers(-1, 10, N)
    want = np.asarray(jatlas.sample_atlas(ja, jnp.asarray(mat),
                                          jnp.asarray(p), jrec.normal))
    got = atlas.sample_atlas(ta, torch.tensor(mat), torch.tensor(p),
                             rec.normal)
    np.testing.assert_array_equal(got.numpy(), want)


def test_procedural_atlas_structure():
    a = atlas.build_procedural_atlas(tex_size=8, seed=4, device=CPU)
    b = atlas.build_procedural_atlas(tex_size=8, seed=4, device=CPU)
    c = atlas.build_procedural_atlas(tex_size=8, seed=5, device=CPU)
    assert a.num_materials == 8 and a.tex_size == 8
    assert all(torch.equal(x, y) for x, y in zip(a.channels, b.channels))
    assert not torch.equal(a.channels[0], c.channels[0])
    # texel / palette colour lies in the modulation's range
    pal = tgrid.material_rgb(CPU)
    tex = torch.stack(a.channels, -1).reshape(8, 64, 3)[1:]
    ratio = tex / pal[1:, None, :]
    assert ratio.min() >= 0.75 * 0.92 - 1e-6
    assert (ratio.max() <= 1.25 * 1.08 + 1e-6) or (tex.max() == 1.0)
    with pytest.raises(ValueError):
        atlas.build_procedural_atlas(num_materials=9, device=CPU)


@pytest.mark.parametrize("case", ["flat", "lambert", "full_fog_vis_atlas"])
def test_shade_matches_vxtpu(case):
    jg = jax_world(case != "flat")
    g = torch_grid(jg)
    jl, tl = _lights()
    jrec, rec, o, d, vis = random_record(5)
    kw = {"flat": dict(shading="flat"), "lambert": dict(shading="lambert"),
          "full_fog_vis_atlas": dict(shading="full", fog=True,
                                     shadows=True)}[case]
    ja = ta = None
    jvis = tvis = None
    if case == "full_fog_vis_atlas":
        ja, ta = _atlases()
        jvis, tvis = jnp.asarray(vis), torch.tensor(vis)
    want = jshade(jrec, jnp.asarray(o), jnp.asarray(d), jg.albedo(), DIMS,
                  jl, JSettings(**kw), shadow_vis=jvis, atlas=ja,
                  material_ids=jg.occupancy.reshape(-1))
    got = shade(rec, torch.tensor(o), torch.tensor(d), g.albedo(), DIMS, tl,
                RenderSettings(**kw), shadow_vis=tvis, atlas=ta,
                material_ids=g.occupancy.reshape(-1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


_JAX_MARCHES = {}


def jax_factory_memo(occ_flat, dims, settings, accel=None):
    """vxtpu's make_march_pallas in interpret mode, each march computed
    once per (rays, t_max): the frames with and without the atlas share
    their marches."""
    march = make_march_pallas(occ_flat, dims, settings, accel,
                              interpret=True)

    def memo(o, d, t_max=None):
        key = tuple(None if x is None else np.asarray(x).tobytes()
                    for x in (o, d, t_max))
        if key not in _JAX_MARCHES:
            _JAX_MARCHES[key] = march(o, d, t_max=t_max)
        return _JAX_MARCHES[key]

    return memo


def _cams():
    jc = JCamera.make(pos=(-22.4, 16.0, 35.2), fov_y_deg=55.0).look_at(
        (16.0, 16.0, 8.64))
    return jc, convert.camera_from_numpy(np.asarray(jc.pos), jc.yaw,
                                         jc.pitch, jc.fov_y, device=CPU)


@pytest.mark.parametrize("with_atlas", [False, True])
def test_render_image_matches_vxtpu(with_atlas):
    """32^3 terrain with per-voxel RGB, 24 x 32, full + shadows + fog, one
    light (config c3 cut to size), through the row-major march."""
    jg = jax_world(True)
    g = torch_grid(jg)
    jc, tc = _cams()
    jl = JLights.single((6.4, -9.6, 44.8), intensity=2.0)
    tl = convert.lights_from_numpy(np.asarray(jl.pos), np.asarray(jl.rgb),
                                   np.asarray(jl.intensity), device=CPU)
    ja, ta = _atlases() if with_atlas else (None, None)
    kw = dict(shading="full", shadows=True, fog=True)
    want = jrender_image(jax_factory_memo, jg, jc, jl, JSettings(**kw), 24,
                         32, atlas=ja)
    kernel_packed.reset_launch_counts()
    got = render_image(make_march_packed, g, tc, tl, RenderSettings(**kw),
                       24, 32, atlas=ta)
    assert kernel_packed.LAUNCHES == {"march_packed_kernel": 0}
    assert got.shape == (24, 32, 3) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_pallas_and_pallas2_pipelines_agree():
    """The row-major march and the fused kernel's march-only mode give the
    same frame: their contracts differ only on misses (voxel, steps)."""
    g = torch_grid(jax_world(True))
    _, tc = _cams()
    tl = convert.lights_from_numpy(*LIGHTS, device=CPU)
    s = RenderSettings(shading="full", shadows=True, fog=True)
    a = render_image(make_march_packed, g, tc, tl, s, 32, 48)
    b = render_image(make_march, g, tc, tl, s, 32, 48)
    assert torch.equal(a, b)


def test_configs_match_vxtpu():
    for name in ("c1_64_flat", "c2_128_lit", "c3_256_shadows"):
        a, b = CONFIGS[name], JCONFIGS[name]
        for f in ("name", "dims", "height", "width", "with_rgb", "soft",
                  "lights", "seed"):
            assert getattr(a, f) == getattr(b, f), (name, f)
        for f in ("shading", "shadows", "fog", "max_steps", "pyramid_levels",
                  "step_chunk", "ambient", "specular_exp", "specular_k",
                  "fog_density", "sky_top", "sky_horizon"):
            assert getattr(a.settings, f) == getattr(b.settings, f), (name, f)


def test_cli_render_pallas(tmp_path, capsys):
    out = tmp_path / "f.png"
    assert run.main(["render", "--config", "c3_256_shadows", "--kernel",
                     "pallas", "--dims", "16", "--height", "16", "--width",
                     "24", "--atlas", "--device", "cpu",
                     "--out", str(out)]) == 0
    img = load_png(str(out))
    assert img.shape == (16, 24, 3) and img.std() > 0
    assert "kernel=pallas" in capsys.readouterr().out


def test_cli_animate_and_bench(tmp_path, capsys):
    from vxtpu_torch.native.framesink import framesink_available

    out = tmp_path / "anim"
    assert run.main(["animate", "--config", "c1_64_flat", "--kernel",
                     "pallas", "--dims", "16", "--height", "16", "--width",
                     "16", "--frames", "3", "--device", "cpu",
                     "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    fps = json.loads(lines[0])
    assert fps["metric"] == "fps" and fps["frames"] == 3 and fps["value"] > 0
    assert fps["sink"] == ("native" if framesink_available() else "pil")
    frames = sorted(out.iterdir())
    assert len(frames) == 3 and load_png(str(frames[0])).shape == (16, 16, 3)

    assert run.main(["bench", "--config", "c3_256_shadows", "--kernel",
                     "pallas", "--dims", "16", "--height", "16", "--width",
                     "16", "--iters", "1", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["metric"] == "Mrays/s/chip @ c3_256_shadows 16^3 16x16"
    assert rec["unit"] == "Mrays/s" and rec["value"] > 0
    assert rec["kernel"] == "pallas" and rec["device"] == "cpu"


@pytest.mark.parametrize("accel", ["distfield", "pyramid"])
def test_cli_render_xla(accel, tmp_path, capsys):
    """vxtpu's default march, over either acceleration, at 8^3."""
    out = tmp_path / "f.png"
    assert run.main(["render", "--config", "c3_256_shadows", "--kernel",
                     "xla", "--accel", accel, "--dims", "8", "--height", "8",
                     "--width", "12", "--device", "cpu",
                     "--out", str(out)]) == 0
    img = load_png(str(out))
    assert img.shape == (8, 12, 3) and img.std() > 0
    assert "kernel=xla" in capsys.readouterr().out


def test_cli_bench_xla(capsys):
    assert run.main(["bench", "--config", "c3_256_shadows", "--kernel", "xla",
                     "--dims", "8", "--height", "8", "--width", "8",
                     "--iters", "1", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["kernel"] == "xla" and rec["value"] > 0


@pytest.mark.parametrize("argv", [
    ["animate", "--kernel", "pallas-interpret"],
    ["bench", "--kernel", "pallas-interpret"],
    ["render", "--kernel", "pallas-interpret"]])
def test_cli_unported_raise(argv, tmp_path):
    """vxtpu's TPU interpreter is the one --kernel without a counterpart
    (--kernel ref and wavefront run: tests/test_torch_ref.py and
    tests/test_torch_wavefront.py)."""
    with pytest.raises(NotImplementedError, match="interpreter"):
        run.main([*argv, "--dims", "8", "--height", "4", "--width", "4",
                  "--device", "cpu", "--out", str(tmp_path / "x")]
                 if argv[0] != "bench" else
                 [*argv, "--dims", "8", "--device", "cpu"])


def test_metrics_sink_and_framesink(tmp_path, capsys):
    from vxtpu_torch.native.framesink import (FrameSink, framesink_available,
                                              write_png)
    from vxtpu_torch.obs.metrics import MetricsSink, mrays_per_s

    assert mrays_per_s(1080, 1920, 0.5) == pytest.approx(4.1472)
    sink = MetricsSink(path=str(tmp_path / "m.jsonl"))
    sink.emit(metric="x", value=1.5)
    line = json.loads((tmp_path / "m.jsonl").read_text())
    assert line["metric"] == "x" and line["value"] == 1.5
    assert json.loads(capsys.readouterr().out) == line
    if not framesink_available():
        pytest.skip("no C++ compiler")
    img = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    write_png(str(tmp_path / "a.png"), img)
    with FrameSink(workers=2) as fs:
        fs.submit(str(tmp_path / "b.png"), torch.tensor(img))
    want = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    for name in ("a.png", "b.png"):
        np.testing.assert_array_equal(load_png(str(tmp_path / name)), want)
