"""The march-cost probe (vxtpu_torch/render/probe.py), on CPU tensors its
plain version, against the TPU probe's own loop.

The reference is ``tools/probe_pallas2_cost.py:_kernel`` itself: its body
(the while loop of :73-133 and the one-hot window read) traced by
``jax.jit`` over array-backed refs for one [8,128] tile, with its window
set to the table's rows, so that its read is the exact word. No
``pl.pallas_call`` runs; the script is loaded with
``enable_compilation_cache`` replaced by a no-op, so that its persistent
cache stays out of this process, and its DIMS set to the test grid.
Tolerances: acc equal on every ray for ``empty``, ``nomath`` and
``full`` (counts of solid voxels visited: the same voxels on every ray);
within rtol 1e-6 for ``nofetch``, whose sum of x * 1e-9 XLA contracts
into fused multiply-adds where the port rounds the product first (one or
two ulps of the sum, on the same voxels).
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vxtpu.camera.camera import Camera as JCamera
from vxtpu.camera.rays import generate_rays as jgenerate_rays
from vxtpu.world import procgen as jprocgen
from vxtpu.world.packed import build_packed_morton as jbuild_packed_morton
from vxtpu_torch import convert
from vxtpu_torch import kernel_check as kc
from vxtpu_torch.render import probe
from vxtpu_torch.world.packed import build_packed

ROOT = Path(__file__).resolve().parent.parent
DIMS = (32, 32, 32)
CPU = torch.device("cpu")
N_ITERS = 48


@functools.cache
def _tpu_probe():
    """tools/probe_pallas2_cost.py as a private module."""
    import vxtpu.engine.platform as platform

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(platform, "enable_compilation_cache",
                   lambda *a, **k: None)
        spec = importlib.util.spec_from_file_location(
            "_tpu_probe_pallas2_cost",
            ROOT / "tools" / "probe_pallas2_cost.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    mod.DIMS = DIMS
    return mod


class _Ref:
    """An array behind the ref interface the probe's kernel uses: ``[:]``,
    a ``pl.ds`` row window, ``.shape`` and ``[:] =``."""

    def __init__(self, a):
        self.a = a

    @property
    def shape(self):
        return self.a.shape

    def __getitem__(self, idx):
        if idx == slice(None):
            return self.a
        rows, _ = idx
        return jax.lax.dynamic_slice_in_dim(self.a, rows.start, rows.size)

    def __setitem__(self, idx, v):
        self.a = v


@functools.cache
def _world():
    """(vxtpu's 32^3 terrain, its Morton words, rays of one tile)."""
    grid = jprocgen.terrain(DIMS, seed=11)
    jacc = jbuild_packed_morton(grid.occupancy, cap=64)
    rays = {}
    for name, cam in {
            "outside": JCamera.make(pos=(-20.0, 16.0, 40.0)).look_at(
                (16.0, 16.0, 12.0)),
            "inside": JCamera.make(pos=(16.0, 16.0, 28.0), yaw=2.2,
                                   pitch=-0.5)}.items():
        o, d = jgenerate_rays(cam, 32, 32)
        rays[name] = (np.array(o), np.array(d))
    return grid, np.asarray(jacc.words), rays


@functools.cache
def _tpu_acc(variant, cam):
    mod = _tpu_probe()
    _, words, rays = _world()
    o, d = rays[cam]

    @jax.jit
    def run(o, d, words):
        chans = [_Ref(x.reshape(8, 128)) for x in
                 (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])]
        out = _Ref(jnp.zeros((8, 128), jnp.float32))
        mod._kernel(*chans, _Ref(words), out, window=words.shape[0],
                    variant=variant)
        return out.a.reshape(-1)

    return np.asarray(run(o, d, words))


def _port(variant, cam, layout="morton16"):
    grid, words, rays = _world()
    o, d = (torch.from_numpy(x) for x in rays[cam])
    if layout == "morton16":
        table = convert.packed_morton_from_numpy(words, DIMS, device=CPU).words
    else:
        occ = convert.occupancy_from_numpy(np.asarray(grid.occupancy),
                                           device=CPU)
        table = build_packed(occ).words
    return probe.march_probe(o, d, table, DIMS, N_ITERS, variant,
                             layout).numpy()


@pytest.mark.parametrize("cam", ["outside", "inside"])
@pytest.mark.parametrize("variant", ["empty", "nofetch", "nomath", "full"])
def test_plain_probe_matches_tpu_probe_loop(variant, cam):
    want = _tpu_acc(variant, cam)
    got = _port(variant, cam)
    assert got.dtype == np.float32 and got.shape == (1024,)
    if variant == "nofetch":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)
    else:
        assert np.array_equal(got, want), np.flatnonzero(got != want)[:8]
    if variant == "empty":
        assert (got == N_ITERS).all()
    if variant in ("nomath", "full"):
        assert got.max() > 0          # some rays visit solid voxels


@pytest.mark.parametrize("variant", probe.VARIANTS)
def test_layouts_agree(variant):
    """The same world in the two layouts: every variant counts the same
    (the row-major word's D is 0 exactly where the Morton word is
    positive)."""
    for cam in ("outside", "inside"):
        a = _port(variant, cam, "morton16")
        b = _port(variant, cam, "rowmajor32")
        assert np.array_equal(a, b), (variant, cam)


@pytest.mark.parametrize("layout", probe.LAYOUTS)
def test_static_reads_one_address(layout):
    """With every word the same, reading one address per ray (static) is
    reading the word under the ray (full)."""
    _, _, rays = _world()
    o, d = (torch.from_numpy(x) for x in rays["inside"])
    table = probe.identity_table(layout, DIMS, CPU)
    table = torch.full_like(table, 0x5A)
    full = probe.march_probe(o, d, table, DIMS, N_ITERS, "full", layout)
    static = probe.march_probe(o, d, table, DIMS, N_ITERS, "static", layout)
    assert torch.equal(full, static) and bool((full > 0).any())
    # and on the real world they differ: the static read is one cell's
    _, words, _ = _world()
    real = convert.packed_morton_from_numpy(words, DIMS, device=CPU).words
    if layout == "morton16":
        a = probe.march_probe(o, d, real, DIMS, N_ITERS, "full", layout)
        b = probe.march_probe(o, d, real, DIMS, N_ITERS, "static", layout)
        assert not torch.equal(a, b)


@pytest.mark.parametrize("layout", probe.LAYOUTS)
def test_identity_table_gives_the_expected_words(layout):
    """probe_r4_matfetch's check: a table of known words (cell i holds i
    mod 2^15) read along known positions gives the count computed from
    the index formula alone."""
    _, _, rays = _world()
    o, d = (torch.from_numpy(x) for x in rays["outside"])
    table = probe.identity_table(layout, DIMS, CPU)
    got = probe.march_probe(o, d, table, DIMS, N_ITERS, "nomath", layout)
    want = kc.probe_identity_expected(o, d, DIMS, N_ITERS, layout)
    assert torch.equal(got, want)
    assert 0 < float(got.sum()) < N_ITERS * o.shape[0]


def test_probe_rejects_bad_inputs():
    _, words, rays = _world()
    o, d = (torch.from_numpy(x) for x in rays["outside"])
    table = convert.packed_morton_from_numpy(words, DIMS, device=CPU).words
    with pytest.raises(ValueError):
        probe.march_probe(o, d, table, DIMS, variant="fast")
    with pytest.raises(ValueError):
        probe.march_probe(o, d, table, DIMS, layout="rowmajor16")
    with pytest.raises(ValueError):
        probe.march_probe(o, d, table, DIMS, threads=100)
    with pytest.raises(ValueError):
        probe.march_probe(o, d, table, DIMS, n_iters=-1)
    with pytest.raises(TypeError):
        probe.march_probe(o, d, table.to(torch.int32), DIMS)
    with pytest.raises(ValueError):
        probe.march_probe(o, d, table, (32, 32, 16))
    with pytest.raises(TypeError):
        probe.march_probe(o, d, table, DIMS, layout="rowmajor32")


def test_cpu_launches_no_kernel_and_timing_needs_the_gpu():
    _, words, rays = _world()
    o, d = (torch.from_numpy(x) for x in rays["outside"])
    table = convert.packed_morton_from_numpy(words, DIMS, device=CPU).words
    probe.reset_launch_counts()
    probe.march_probe(o, d, table, DIMS, 4, "full")
    assert probe.LAUNCHES == {"march_probe_kernel": 0}
    with pytest.raises(RuntimeError):
        probe.cost_probe(o, d, {"morton16": table}, DIMS)
    with pytest.raises(RuntimeError):
        probe.sorted_probe(o, d, None, DIMS, 98)


def test_cost_and_sorted_probe_control_flow(monkeypatch):
    """cost_probe's and sorted_probe's loops and arithmetic, with the GPU
    timers replaced."""
    from vxtpu_torch.world.packed import PackedMorton

    _, words, rays = _world()
    o, d = (torch.from_numpy(x) for x in rays["inside"])
    acc = PackedMorton(words=convert.packed_morton_from_numpy(
        words, DIMS, device=CPU).words)
    calls = []

    def timer(fn, reps, *kernel):
        calls.append(fn())
        return 2.0

    monkeypatch.setattr(probe, "_require_cuda", lambda device: None)
    monkeypatch.setattr(probe, "_events_ms", timer)
    monkeypatch.setattr(probe, "device_ms",
                        lambda *a: (timer(*a), probe.CLOCK_DEVICE))
    tables = {"morton16": acc.words,
              "rowmajor32": probe.identity_table("rowmajor32", DIMS, CPU)}
    rows = probe.cost_probe(o, d, tables, DIMS, n_iters=4,
                            variants=("empty", "full"), threads=(128, 512))
    assert [(r["variant"], r["layout"], r["threads"]) for r in rows] == [
        (v, lay, th) for lay in tables for v in ("empty", "full")
        for th in (128, 512)]
    assert rows[0]["ns_per_ray_iter"] == pytest.approx(2.0e6 / (1024 * 4))
    assert {r["clock"] for r in rows} == {probe.CLOCK_DEVICE}
    out = probe.sorted_probe(o, d, acc, DIMS, 98, round0_iters=(2, 6),
                             survivor_frac=8)
    assert set(out["sorted"]) == {2, 6} and out["n"] == 1024
    assert out["single_device_clock"] == probe.CLOCK_DEVICE
    assert out["sorted"][2]["survivors"] >= out["sorted"][6]["survivors"]
