"""The resumable march (vxtpu_torch's ``march`` in resume mode and
``march_sorted``; on CPU tensors the plain version of
``march_resume_kernel``) against the single-round march, and against
vxtpu's resume mode of ``march_pallas_v2`` (interpret mode, three calls).

Within the port every comparison is exact (hit, t, voxel, normal, steps,
done, dist): the rounds make the same operations in the same order as the
single round. Across packages, vxtpu caps the iterations of a whole
[8,128] tile and the port each ray, so their round-0 states differ; the
tests carry vxtpu's own round-0 state across and compare the final
records with the agreement of tests/test_torch_march.py (hit >= 0.998, t
rtol 1e-4 / atol 1e-3, voxel > 0.998, normal > 0.995, steps >= 0.99).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vxtpu.camera.camera import Camera as JCamera
from vxtpu.camera.rays import generate_rays as jgenerate_rays
from vxtpu.render import dda as jdda
from vxtpu.render.kernel_pallas_v2 import march_pallas_v2
from vxtpu.world import procgen as jprocgen
from vxtpu.world.packed import build_packed_morton as jbuild_packed_morton
from vxtpu_torch import convert
from vxtpu_torch import kernel_check as kc
from vxtpu_torch.camera.rays import generate_rays
from vxtpu_torch.render import kernel_march as km
from vxtpu_torch.world.packed import build_packed_morton

DIMS = (32, 32, 32)
MAX_STEPS = sum(DIMS) + 2
CPU = torch.device("cpu")
FIELDS = ("hit", "t", "voxel", "normal", "steps")


def _check(want, rec, min_agree=0.998):
    """tests/test_torch_march.py's agreement with vxtpu's record."""
    hit_r, hit_f = want["hit"], rec.hit.numpy()
    assert (hit_r == hit_f).mean() >= min_agree
    both = hit_r & hit_f
    np.testing.assert_allclose(rec.t.numpy()[both], want["t"][both],
                               rtol=1e-4, atol=1e-3)
    same_vox = (rec.voxel.numpy()[both] == want["voxel"][both]).all(axis=-1)
    assert same_vox.mean() > 0.998
    same_n = (np.abs(rec.normal.numpy()[both] - want["normal"][both])
              < 1e-6).all(axis=-1)
    assert same_n.mean() > 0.995
    steps_eq = (rec.steps.numpy() == want["steps"]).mean()
    assert steps_eq >= 0.99, steps_eq


def _equal(a: km.HitRecord, b: km.HitRecord) -> None:
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@functools.cache
def _vxtpu():
    """vxtpu on the 32^3 terrain (seed 11), outside camera, 32x32 rays:
    the single round, a resume with every ray's entry fetch pending, and
    round 0 capped at 6 iterations a tile (three interpret-mode calls)."""
    grid = jprocgen.terrain(DIMS, seed=11)
    jacc = jbuild_packed_morton(grid.occupancy, cap=64)
    cam = JCamera.make(pos=(-20.0, 16.0, 40.0)).look_at((16.0, 16.0, 12.0))
    o, d = jgenerate_rays(cam, 32, 32)
    kw = dict(image_shape=(32, 32), window=jacc.rows, interpret=True)
    single = march_pallas_v2(o, d, jacc, DIMS, MAX_STEPS, **kw)
    t_enter, _, _ = jdda.ray_grid_clip(o, d, DIMS)
    v0, _, _, _ = jdda.dda_init(o, d, t_enter, DIMS)
    fresh = march_pallas_v2(
        o, d, jacc, DIMS, MAX_STEPS,
        resume_state=(v0, jnp.full((o.shape[0],), -2, jnp.int32)), **kw)
    round0, ext0 = march_pallas_v2(o, d, jacc, DIMS, MAX_STEPS,
                                   iter_budget=6, extended=True, **kw)

    def rec(r):
        return {k: np.asarray(getattr(r, k)) for k in FIELDS}

    return dict(o=np.array(o), d=np.array(d), words=np.asarray(jacc.words),
                v0=np.array(v0), single=rec(single), fresh=rec(fresh),
                round0=rec(round0),
                ext0={k: np.asarray(v) for k, v in ext0.items()})


def _port_inputs():
    j = _vxtpu()
    acc = convert.packed_morton_from_numpy(j["words"], DIMS, device=CPU)
    return torch.from_numpy(j["o"]), torch.from_numpy(j["d"]), acc


def test_fresh_sentinel_resume_equals_scratch():
    """Every ray marked -2 (entry fetch pending) at its entry voxel: the
    resume equals a from-scratch march, in vxtpu (tests/test_pallas_v2.py
    :205) and exactly in the port."""
    j = _vxtpu()
    a, b = j["single"], j["fresh"]
    assert (a["hit"] == b["hit"]).all()
    np.testing.assert_allclose(a["t"][a["hit"]], b["t"][a["hit"]], rtol=1e-6)

    o, d, acc = _port_inputs()
    single = km.march(o, d, acc, DIMS, MAX_STEPS)
    r0, e0 = km.march(o, d, acc, DIMS, MAX_STEPS, iter_budget=0,
                      extended=True)
    # the port's entry voxel is vxtpu's dda_init voxel
    assert torch.equal(r0.voxel, torch.from_numpy(j["v0"]))
    n = o.shape[0]
    resumed = km.march(o, d, acc, DIMS, MAX_STEPS, resume_state=(
        r0.voxel, torch.full((n,), -2, dtype=torch.int32)))
    _equal(resumed, single)
    assert bool(single.hit.any())


def test_resume_from_vxtpu_round0_equals_vxtpu_single_round():
    """vxtpu's round 0 (iter_budget=6, extended), carried across by
    convert.resume_state_from_numpy and resumed by the port, gives vxtpu's
    single-round record."""
    j = _vxtpu()
    o, d, acc = _port_inputs()
    e0 = j["ext0"]
    assert 0 < int((~e0["done"]).sum()) < o.shape[0]
    assert (e0["dist"] >= 0).all()            # every entry fetch ran
    state = convert.resume_state_from_numpy(
        j["round0"]["voxel"], e0["dist"], j["round0"]["steps"], e0["done"],
        device=CPU)
    rec, ext = km.march(o, d, acc, DIMS, MAX_STEPS, resume_state=state,
                        extended=True)
    assert bool(ext["done"].all())
    done0 = torch.from_numpy(np.array(e0["done"]))
    round0 = km.HitRecord(*(torch.from_numpy(np.array(j["round0"][f]))
                            for f in FIELDS))
    merged = kc.merge_rounds(done0, round0, rec)
    _check(j["single"], merged)
    # and the resumed rays' own steps continue vxtpu's counts
    live = ~done0
    assert bool((rec.steps[live] >= state[2][live]).all())


def _case(cam_name, tmax=False, hw=32):
    D = DIMS[0]
    grid = kc._scenes(D, CPU)["terrain"]
    acc = build_packed_morton(grid.occupancy)
    o, d = generate_rays(kc._cameras(D, CPU)[cam_name], hw, hw)
    t_max = torch.full((o.shape[0],), 1.2 * D) if tmax else None
    return o, d, acc, t_max


@pytest.mark.parametrize("budget", [0, 1, 3, 6])
@pytest.mark.parametrize("cam", ["outside", "inside", "outside-tmax"])
def test_round0_plus_resume_equals_single_round(cam, budget):
    o, d, acc, t_max = _case(cam.split("-")[0], cam.endswith("tmax"))
    single = km.march(o, d, acc, DIMS, MAX_STEPS, t_max=t_max)
    r0, e0 = km.march(o, d, acc, DIMS, MAX_STEPS, t_max=t_max,
                      iter_budget=budget, extended=True)
    state = (r0.voxel, torch.where(e0["done"], -1, e0["dist"]), r0.steps)
    r1, e1 = km.march(o, d, acc, DIMS, MAX_STEPS, t_max=t_max,
                      resume_state=state, extended=True)
    assert bool(e1["done"].all())
    _equal(kc.merge_rounds(e0["done"], r0, r1), single)
    assert not bool(e0["done"].all())          # round 0 left rays to resume


@pytest.mark.parametrize("round0_iters", [2, 4, 6])
def test_march_sorted_equals_single_round(round0_iters):
    """At 64x64 rays the resume buffer holds 1024 rays, fewer than the
    survivors of round 0: the drain loop runs more rounds."""
    D = DIMS[0]
    grid = kc._scenes(D, CPU)["sphere"]
    acc = build_packed_morton(grid.occupancy)
    o, d = generate_rays(kc._cameras(D, CPU)["inside"], 64, 64)
    single = km.march(o, d, acc, DIMS, MAX_STEPS)
    stats = {}
    rec = km.march_sorted(o, d, acc, DIMS, MAX_STEPS,
                          round0_iters=round0_iters, stats=stats)
    _equal(rec, single)
    assert stats["buffer"] == 1024 and stats["survivors"] > 1024
    assert stats["rounds"] >= 2 and len(stats["resume_steps"]) == \
        stats["rounds"]
    # the first resume round took the 1024 live rays of the lowest cells
    first = stats["resume_steps"][0]
    assert first.shape == (1024,) and bool((first >= 0).all())


def test_done_and_dist_semantics():
    o, d, acc, _ = _case("outside")
    n = o.shape[0]
    single, ext = km.march(o, d, acc, DIMS, MAX_STEPS, extended=True)
    # budget 0: nothing runs; valid rays are pending (-2), invalid done
    r0, e0 = km.march(o, d, acc, DIMS, MAX_STEPS, iter_budget=0,
                      extended=True)
    valid = ~e0["done"]
    assert bool(valid.any()) and bool((~valid).any())
    assert bool((e0["dist"][valid] == -2).all())
    assert bool((e0["dist"][~valid] == 0).all())
    assert not bool(r0.hit.any()) and not bool(r0.steps.any())
    # one round to the end: every ray done, a hit's cell is occupied
    assert bool(ext["done"].all()) and bool((ext["dist"] >= 0).all())
    assert bool((ext["dist"][single.hit] == 0).all())
    # budget 1: a pending ray spends it on the entry fetch (no step)
    r1, e1 = km.march(o, d, acc, DIMS, MAX_STEPS, iter_budget=1,
                      extended=True)
    assert not bool(r1.steps.any())
    assert bool((e1["dist"] >= 0).all())
    assert torch.equal(r1.hit, r1.hit & single.hit)
    # dead slots: done at once, a miss at the clipped voxel, steps kept
    vox = torch.tensor([[-5, 40, 3]], dtype=torch.int32).expand(n, 3)
    dead = km.march(o, d, acc, DIMS, MAX_STEPS, resume_state=(
        vox.contiguous(), torch.full((n,), -1, dtype=torch.int32),
        torch.full((n,), 7, dtype=torch.int32)), extended=True)
    assert bool(dead[1]["done"].all()) and not bool(dead[0].hit.any())
    assert bool((dead[0].voxel == torch.tensor([0, 31, 3],
                                               dtype=torch.int32)).all())
    assert bool((dead[0].steps == 7).all())
    assert bool((dead[0].t == km.BIG_T).all())
    # a resumed ray goes on from its given steps: one step this round
    live = ~e1["done"]
    r2, e2 = km.march(o, d, acc, DIMS, MAX_STEPS, iter_budget=1,
                      resume_state=(r1.voxel, torch.where(
                          e1["done"], -1, e1["dist"]), r1.steps),
                      extended=True)
    assert bool((r2.steps[live] <= 1).all())
    assert bool((r2.steps[live] == 1).any())


def test_resume_rejects_bad_inputs():
    o, d, acc, _ = _case("outside", hw=4)
    n = o.shape[0]
    v = torch.zeros((n, 3), dtype=torch.int32)
    dist = torch.full((n,), -2, dtype=torch.int32)
    with pytest.raises(ValueError):
        km.march(o, d, acc, DIMS, MAX_STEPS, iter_budget=3,
                 shade_spec=km.ShadeSpec(n_lights=0),
                 mats=torch.zeros((16 ** 3,), dtype=torch.int32),
                 lights_arr=torch.zeros((8, 8)))
    with pytest.raises(ValueError):
        km.march(o, d, acc, DIMS, MAX_STEPS, iter_budget=-1)
    with pytest.raises(ValueError):
        km.march(o, d, acc, DIMS, MAX_STEPS, resume_state=(v,))
    with pytest.raises(TypeError):
        km.march(o, d, acc, DIMS, MAX_STEPS,
                 resume_state=(v, dist.to(torch.int64)))
    with pytest.raises(ValueError):
        km.march(o, d, acc, DIMS, MAX_STEPS, resume_state=(v[:, :2], dist))
    with pytest.raises(ValueError):
        km.march(o, d, acc, DIMS, MAX_STEPS,
                 resume_state=(v, dist, dist[:3]))


def test_cpu_launches_no_kernel():
    o, d, acc, _ = _case("inside", hw=16)
    km.reset_launch_counts()
    km.march(o, d, acc, DIMS, MAX_STEPS, iter_budget=2, extended=True)
    km.march_sorted(o, d, acc, DIMS, MAX_STEPS, round0_iters=2)
    assert km.LAUNCHES == {"march_shade_kernel": 0, "shade_kernel": 0,
                           "march_resume_kernel": 0}
