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
two ulps of the sum, on the same voxels). The plain version's default
step is K1's (integer faces, clamp then truncate, the dilation table, a
read on a cell change); it is held to the TPU probe's float form and to
the TPU probe's loop exactly. The image-block ray order is held to
vxtpu's ``_tile_layout`` pack of ``arange`` exactly.
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
from vxtpu.render.kernel_pallas_v2 import _tile_layout
from vxtpu.world.packed import build_packed_morton as jbuild_packed_morton
from vxtpu_torch import convert
from vxtpu_torch import kernel_check as kc
from vxtpu_torch.render import probe
from vxtpu_torch.world.packed import (BRICK, brick_dims, brick_words,
                                      build_packed)

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
    return probe.march_probe(o, d, _table(layout), DIMS, N_ITERS, variant,
                             layout).numpy()


@functools.cache
def _table(layout):
    """The test world's table in a probe layout."""
    grid, words, _ = _world()
    if layout == "morton16":
        return convert.packed_morton_from_numpy(words, DIMS, device=CPU).words
    occ = convert.occupancy_from_numpy(np.asarray(grid.occupancy),
                                       device=CPU)
    packed = build_packed(occ)
    return packed.bricks if layout == "bricked16" else packed.words


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
    with pytest.raises(TypeError):
        probe.march_probe(o, d, table.to(torch.int32), DIMS,
                          layout="bricked16")
    with pytest.raises(ValueError):
        probe.march_probe(o, d, table, DIMS, step="fast")


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


@pytest.mark.parametrize("variant", probe.VARIANTS)
def test_bricked16_agrees_with_the_other_layouts(variant):
    """K5's bricked 16-bit table holds the row-major words: every variant
    counts what rowmajor32 and morton16 count, on every ray."""
    for cam in ("outside", "inside"):
        b = _port(variant, cam, "bricked16")
        assert np.array_equal(b, _port(variant, cam, "rowmajor32")), cam
        assert np.array_equal(b, _port(variant, cam, "morton16")), cam


def test_identity_table_bricked16_holds_the_row_major_words():
    """identity_table("bricked16") is rowmajor32's identity bricked: the
    word at each cell's bricked index is its row-major index mod 2^15, and
    the padding cells hold 0."""
    for dims in (DIMS, (36, 44, 20)):
        rm = probe.identity_table("rowmajor32", dims, CPU)
        br = probe.identity_table("bricked16", dims, CPU)
        assert br.dtype == torch.int16
        assert torch.equal(br, brick_words(rm, dims))
        cx, cy, cz = (n // 2 for n in dims)
        c = torch.stack(torch.meshgrid(
            *(torch.arange(k) for k in (cx, cy, cz)), indexing="ij"),
            -1).reshape(-1, 3)
        idx = probe._cell_index(c[:, 0], c[:, 1], c[:, 2], "bricked16",
                                dims)
        row = (c[:, 0] * cy + c[:, 1]) * cz + c[:, 2]
        assert torch.equal(br[idx].long(), row % (1 << 15))
        bx, by, bz = brick_dims(dims)
        assert br.numel() == bx * by * bz * BRICK ** 3
        pad = torch.ones(br.numel(), dtype=torch.bool)
        pad[idx] = False
        assert not bool(br[pad].any())


@pytest.mark.parametrize("variant", probe.VARIANTS)
@pytest.mark.parametrize("layout", probe.LAYOUTS)
def test_k1_step_equals_the_tpu_float_step(variant, layout):
    """K1's formulations (integer faces, clamp then truncate, the dilation
    table, a read only on a cell change) give the TPU probe's float form's
    acc on every ray: the two cameras and random rays, some with zero or
    tiny direction components and origins outside the grid. Full reads
    less; nomath and static read every iteration."""
    g = np.random.default_rng(5)
    n = 2048
    o = g.uniform(-12.0, 44.0, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d[:256, 0] = 0.0
    d[256:512, 1] = 1e-13
    d[512:640, :2] = 0.0
    o[640:768] = np.floor(o[640:768])          # on voxel faces
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _, _, rays = _world()
    sets = [(torch.from_numpy(o), torch.from_numpy(d))] + [
        tuple(torch.from_numpy(x) for x in rays[c])
        for c in ("outside", "inside")]
    table = _table(layout)
    for ro, rd in sets:
        sk, st = {}, {}
        k1 = probe.march_probe_reference(ro, rd, table, DIMS, N_ITERS,
                                         variant, layout, "k1", sk)
        tpu = probe.march_probe_reference(ro, rd, table, DIMS, N_ITERS,
                                          variant, layout, "tpu", st)
        assert torch.equal(k1, tpu), int((k1 != tpu).sum())
        if variant in ("empty", "nofetch"):
            assert not bool(sk["reads"].any())
        elif variant == "full":
            assert bool((st["reads"] == N_ITERS).all())
            assert bool((sk["reads"] >= 1).all())
            assert int(sk["reads"].sum()) < int(st["reads"].sum())
        else:
            assert bool((sk["reads"] == N_ITERS).all())


@pytest.mark.parametrize("image_shape", [(40, 72), (64, 96)])
def test_tile_order_matches_vxtpu_tile_layout(image_shape):
    """The 32x32 block order is vxtpu's _tile_layout pack of arange(H*W)
    (padded slots -1), at a padded size and an exact one; its unpack of
    the slot numbers is the inverse."""
    H, W = image_shape
    n = H * W
    pack, unpack, _, _ = _tile_layout(n, image_shape, (32, 32))
    want = np.asarray(pack(jnp.arange(n, dtype=jnp.int32), -1)).reshape(-1)
    order, inverse = probe.tile_order(image_shape, (32, 32), CPU)
    assert np.array_equal(order.numpy(), want)
    slots = jnp.arange(want.size, dtype=jnp.int32)
    assert np.array_equal(inverse.numpy(), np.asarray(unpack(slots)))


@pytest.mark.parametrize("block", [(32, 32), (4, 8)])
@pytest.mark.parametrize("image_shape", [(40, 72), (1080 // 8, 1920 // 8),
                                         (32, 32)])
def test_tile_order_is_a_permutation(image_shape, block):
    """Every pixel has one slot, the padded slots are the blocks' excess,
    each block's pixels are next to each other, and the inverse undoes
    the order."""
    H, W = image_shape
    bh, bw = block
    order, inverse = probe.tile_order(image_shape, block, CPU)
    Hp, Wp = -(-H // bh) * bh, -(-W // bw) * bw
    assert order.numel() == Hp * Wp
    real = order[order >= 0]
    assert torch.equal(torch.sort(real).values, torch.arange(H * W))
    assert torch.equal(order[inverse], torch.arange(H * W))
    first = order[:bh * bw]
    assert torch.equal(first, (torch.arange(bh)[:, None] * W
                               + torch.arange(bw)[None, :]).reshape(-1))
    o = torch.randn(H * W, 3)
    po, pd = probe.permute_rays(o, o, order)
    assert torch.equal(po[inverse], o)
    assert torch.equal(pd[order < 0], torch.tensor(
        [probe.PAD_D] * int((order < 0).sum())).reshape(-1, 3))


@pytest.mark.parametrize("variant", probe.VARIANTS)
def test_acc_equal_across_orders(variant):
    """The rays in each block order, acc put back in pixel order, equal
    the scanline acc (a 32x32 frame, and its rays as a 16x64 one, whose
    32x32 blocks are padded)."""
    _, _, rays = _world()
    o, d = (torch.from_numpy(x) for x in rays["inside"])
    table = _table("bricked16")
    want = probe.march_probe(o, d, table, DIMS, N_ITERS, variant,
                             "bricked16")
    for shape in ((32, 32), (16, 64)):
        for name in ("block32x32", "block4x8"):
            po, pd, inverse = probe.ordered_rays(o, d, shape, name)
            got = probe.march_probe(po, pd, table, DIMS, N_ITERS, variant,
                                    "bricked16")
            assert torch.equal(got[inverse], want), (shape, name)


def test_cost_probe_orders_and_steps_control_flow(monkeypatch):
    """cost_probe over orders and steps, with the GPU timers replaced: one
    row per order x step x layout x variant x block size, ns per
    ray-iteration over the rays given (not the padded slots), and the
    check across orders."""
    _, _, rays = _world()
    o, d = (torch.from_numpy(x) for x in rays["inside"])
    monkeypatch.setattr(probe, "_require_cuda", lambda device: None)
    monkeypatch.setattr(probe, "_events_ms", lambda fn, reps: 1.0)
    monkeypatch.setattr(probe, "device_ms",
                        lambda *a: (2.0, probe.CLOCK_DEVICE))
    tables = {lay: _table(lay) for lay in ("morton16", "bricked16")}
    orders = tuple(probe.ORDERS)
    rows = probe.cost_probe(o, d, tables, DIMS, n_iters=6,
                            variants=("nofetch", "full"), threads=(256,),
                            orders=orders, image_shape=(16, 64),
                            steps=probe.STEPS)
    assert [(r["order"], r["step"], r["layout"], r["variant"])
            for r in rows] == [(od, st, lay, v) for od in orders
                               for st in probe.STEPS for lay in tables
                               for v in ("nofetch", "full")]
    assert {r["slots"] for r in rows if r["order"] == "block32x32"} == {
        2048}
    assert rows[0]["ns_per_ray_iter"] == pytest.approx(2.0e6 / (1024 * 6))
    with pytest.raises(ValueError):
        probe.cost_probe(o, d, tables, DIMS, orders=("block4x8",))
    # an order whose acc differs from the first one's is refused
    real = probe.march_probe
    monkeypatch.setattr(probe, "march_probe", lambda o_, *a, **k: real(
        o_, *a, **k) + (o_.shape[0] != o.shape[0]))
    with pytest.raises(AssertionError):
        probe.cost_probe(o, d, tables, DIMS, n_iters=2, variants=("full",),
                         threads=(256,), orders=("scanline", "block32x32"),
                         image_shape=(16, 64))
