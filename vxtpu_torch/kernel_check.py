"""Kernels against their plain PyTorch versions on the same inputs, on the
GPU. Shared by ``chip_smoke.py`` (phase 3) and ``tests/test_torch_cuda.py``.

March and shade (K1, K2): hit, voxel, normal and steps equal on >= 99.9%
of rays; t within rtol 1e-5 where both hit; rgb within 1e-5 on >= 99.9%
of pixels. Both sides round every operation the same way (the kernels
are built with -fmad=false), so the margin only absorbs rays that graze a
voxel edge and the last bits of expf/powf. ``check_exact`` holds K1 to no
margin: every ray and every pixel (the main-path frames, each
instantiation of march_shade_kernel in tests/test_torch_cuda.py).

Row-major march (K5): hit, voxel, normal and steps equal on every ray
and |t difference| <= 1e-6 (the same operations in the same order, no
grazing-ray margin).

Resume march (K1', march_resume_kernel): hit, t, voxel, normal, steps,
done and dist equal on every ray, for a capped round 0 and for the resume
from the plain round 0's state (both sides make the same operations in the
same order, as K1's do).

March-cost probe (K6, march_probe_kernel): acc equal bit for bit on every
ray, in each table layout, for both steps (K1's and the TPU probe's float
form) and in a block ray order put back in pixel order, and on an
identity table equal to the count computed from the index formula alone.

Field sampling (K3, K4): forward samples within |d| <= 1e-6 (the same
operations in the same order); backward gradient tables within rtol 1e-5
and atol 1e-6 x max|g|, because the kernel's float atomicAdd scatter sums
in an order that changes from run to run (the plain version sums in
float64; two runs of the kernel are held to the same limits); per-ray
cotangents (the kRayGrads variant) equal bit for bit (summed in chunks
in a fixed order, the plain version in the same order).

Morton TV prior (tv_fwd_kernel, tv_fwd_finish_kernel, tv_bwd_kernel):
the value within rel 1e-6 of the plain version's (train/loss.py:
tv_prior_morton; both sum in float32, in other orders) and equal bit for
bit on a second launch; the gradient within 1e-6 x its max |g| of the
plain version's autograd gradient; in each of TV_CASES (a zero weight,
an upstream gradient other than 1, a gradient accumulated onto an
existing .grad).

Adam (adam_step_kernel, train/kernel_adam.py): five steps of
kernel_adam.Adam against torch.optim.Adam's foreach step from the same
parameters, gradients and state, each parameter and both moments within
rtol 1e-6 / atol 1e-6 x max |x| (the kernel rounds where torch's kernels
round; the margin takes a last-bit difference where m sums to near 0),
equal bit for bit on a second run, one launch a parameter a step; in each
of ADAM_CASES (sizes with and without a float4 tail, a view that is not
16-byte aligned, a state resumed at count 7, the camera's four tensors).
"""

from __future__ import annotations

import numpy as np
import torch

from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.camera.rays import generate_rays
from vxtpu_torch.render import kernel_march as km
from vxtpu_torch.render import kernel_packed as kp
from vxtpu_torch.render import kernel_sample as ks
from vxtpu_torch.render import occmask, probe
from vxtpu_torch.render.fused import render_rays_fused
from vxtpu_torch.render.pipeline import shadow_ray_batch
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.render.soft_kernel import MortonSoftGrid, _enter_dt_soft
from vxtpu_torch.train import kernel_adam, kernel_tv
from vxtpu_torch.train.loop import ADAM_EPS, BETAS
from vxtpu_torch.train.loss import tv_prior_morton
from vxtpu_torch.world import procgen
from vxtpu_torch.world.lights import Lights
from vxtpu_torch.world.packed import (build_material_morton, build_packed,
                                      build_packed_morton, build_rgb8_morton)

RAY_AGREE = 0.999
T_RTOL = 1e-5
RGB_ATOL = 1e-5
RGB_AGREE = 0.999


def record_mismatch(a: km.HitRecord, b: km.HitRecord) -> dict:
    """Counts of rays whose hit, voxel, normal or steps differ, and the
    largest relative t difference where both hit."""
    both = a.hit & b.hit
    rel = ((a.t - b.t).abs() / b.t.abs().clamp(min=1e-30))[both]
    return dict(
        n=int(a.hit.numel()),
        hit=int((a.hit != b.hit).sum()),
        voxel=int((a.voxel != b.voxel).any(-1).sum()),
        normal=int((a.normal != b.normal).any(-1).sum()),
        steps=int((a.steps != b.steps).sum()),
        t_rel=float(rel.max()) if rel.numel() else 0.0,
    )


def image_mismatch(a: torch.Tensor, b: torch.Tensor) -> dict:
    diff = (a - b).abs().reshape(-1, 3).amax(-1)
    return dict(n=int(diff.numel()), rgb=int((diff > RGB_ATOL).sum()),
                max_abs=float(diff.max()) if diff.numel() else 0.0)


def check_records(m: dict, what: str) -> None:
    for k in ("hit", "voxel", "normal", "steps"):
        if m[k] > (1.0 - RAY_AGREE) * m["n"]:
            raise AssertionError(f"{what}: {k} differs on {m[k]} of "
                                 f"{m['n']} rays")
    if m["t_rel"] > T_RTOL:
        raise AssertionError(f"{what}: t differs by rel {m['t_rel']:.3g}")


def check_exact(rm: dict, im: dict | None, what: str) -> None:
    """K1 on a main-path frame: hit, voxel, normal and steps equal on every
    ray (no RAY_AGREE margin), t within T_RTOL, and rgb (im, when given)
    within RGB_ATOL on every pixel."""
    bad = {k: rm[k] for k in ("hit", "voxel", "normal", "steps") if rm[k]}
    if bad:
        raise AssertionError(f"{what}: differs on {bad} of {rm['n']} rays")
    if rm["t_rel"] > T_RTOL:
        raise AssertionError(f"{what}: t differs by rel {rm['t_rel']:.3g}")
    if im is not None and im["rgb"]:
        raise AssertionError(f"{what}: rgb differs by more than {RGB_ATOL} "
                             f"on {im['rgb']} of {im['n']} pixels (max "
                             f"{im['max_abs']:.3g})")


def check_image(m: dict, what: str) -> None:
    if m["rgb"] > (1.0 - RGB_AGREE) * m["n"]:
        raise AssertionError(f"{what}: rgb differs by more than {RGB_ATOL} "
                             f"on {m['rgb']} of {m['n']} pixels "
                             f"(max {m['max_abs']:.3g})")


def _scenes(D, device):
    return {
        "box": procgen.solid_box((D,) * 3, (D // 4,) * 3,
                                 (3 * D // 4, 3 * D // 4, 5 * D // 8),
                                 device=device),
        "sphere": procgen.shell_sphere((D,) * 3, device=device),
        "terrain": procgen.terrain((D,) * 3, seed=11, device=device),
    }


def _cameras(D, device):
    return _cameras_dims((D,) * 3, device)


def _cameras_dims(dims, device):
    X, Y, Z = dims
    return {
        "outside": Camera.make(pos=(-0.625 * X, 0.5 * Y, 1.25 * Z),
                               device=device).look_at(
                                   (0.5 * X, 0.5 * Y, 0.375 * Z)),
        "inside": Camera.make(pos=(0.5 * X, 0.5 * Y, 0.875 * Z), yaw=2.2,
                              pitch=-0.5, device=device),
    }


MARCH_CASES = [f"{s}-{c}" for s in ("box", "sphere", "terrain")
               for c in ("outside", "inside")] + ["terrain-outside-tmax"]
SHADE_CASES = ["flat", "lambert", "full_fog", "full_shadows_fog_inkernel",
               "full_shadows_fog_composed", "shade_kernel", "rgb8"]


def run_march_case(name: str, device, D: int = 64, h: int = 256,
                   w: int = 256) -> dict:
    """march (the kernel) vs march_reference on one scene and camera."""
    scene, cam_name, *rest = name.split("-")
    grid = _scenes(D, device)[scene]
    acc = build_packed_morton(grid.occupancy, cap=64)
    o, d = generate_rays(_cameras(D, device)[cam_name], h, w)
    t_max = None
    if rest == ["tmax"]:
        t_max = torch.full((o.shape[0],), 1.2 * D, device=device)
    ms = 3 * D + 2
    rec = km.march(o, d, acc, (D,) * 3, ms, t_max=t_max)
    ref = km.march_reference(o, d, acc, (D,) * 3, ms, t_max=t_max)
    m = record_mismatch(rec, ref)
    m["hits"] = int(rec.hit.sum())
    return m


def run_shade_case(name: str, device, D: int = 64, h: int = 256,
                   w: int = 256) -> dict:
    """A shaded frame through the kernels vs the plain versions."""
    dims = (D,) * 3
    rgb8 = name == "rgb8"
    grid = procgen.terrain(dims, seed=11, with_rgb=rgb8, device=device)
    acc = build_packed_morton(grid.occupancy, cap=64)
    mats = build_rgb8_morton(grid) if rgb8 else \
        build_material_morton(grid.occupancy)
    o, d = generate_rays(_cameras(D, device)["outside"], h, w)
    one = Lights.single((0.8 * D, -0.3 * D, 1.9 * D), intensity=2.0,
                        device=device)
    two = Lights.make([(0.15 * D, -0.3 * D, 1.4 * D),
                       (1.25 * D, 0.95 * D, 1.55 * D)],
                      [(1.0, 0.9, 0.8), (0.4, 0.5, 1.0)], [2.0, 1.0],
                      device=device)
    full_sh = RenderSettings(shading="full", shadows=True, fog=True)
    settings, lights, inkernel = {
        "flat": (RenderSettings(shading="flat"), Lights.none(device), True),
        "lambert": (RenderSettings(shading="lambert"), one, True),
        "full_fog": (RenderSettings(shading="full", fog=True), two, True),
        "full_shadows_fog_inkernel": (full_sh, two, True),
        "full_shadows_fog_composed": (full_sh, two, False),
        "shade_kernel": (full_sh, two, False),
        "rgb8": (RenderSettings(shading="lambert"), one, True),
    }[name]
    ms = settings.resolve_max_steps(dims)
    lights_arr = km.pack_lights(lights)
    if name == "shade_kernel":
        # the shade kernel alone, on the plain march's record and
        # visibility, against shade_reference on the same inputs
        rec = km.march_reference(o, d, acc, dims, ms)
        vis = torch.stack([km.shadow_visibility_reference(
            rec, o, d, acc, dims, ms, lights.pos[li])
            for li in range(lights.count)], dim=-1)
        spec = km.ShadeSpec.from_settings(settings, lights, use_vis=True,
                                          shadows=False)
        got = km.shade(rec, o, d, vis, mats, lights_arr, spec)
        want = km.shade_reference(rec, o, d, vis, mats, lights_arr, spec)
        m = image_mismatch(got, want)
        m["hits"] = int(rec.hit.sum())
        return m
    got, rec = render_rays_fused(o, d, acc, mats, dims, lights, settings,
                                 inkernel_shadows=inkernel, rgb8=rgb8)
    shadowed = settings.shadows and lights.count > 0
    spec = km.ShadeSpec.from_settings(settings, lights, shadows=shadowed,
                                      rgb8=rgb8)
    ref, want = km.march_shade_reference(o, d, acc, dims, ms, None, spec,
                                         mats, lights_arr)
    m = image_mismatch(got, want)
    m.update({f"rec_{k}": v for k, v in record_mismatch(rec, ref).items()})
    m["hits"] = int(rec.hit.sum())
    return m


def check_march_case(m: dict, what: str) -> None:
    check_records(m, what)
    if m["hits"] == 0:
        raise AssertionError(f"{what}: no ray hit")


def check_shade_case(m: dict, what: str) -> None:
    check_image(m, what)
    if "rec_n" in m:
        check_records({k[4:]: v for k, v in m.items()
                       if k.startswith("rec_")}, what)
    if m["hits"] == 0:
        raise AssertionError(f"{what}: no ray hit")


# K1's instantiations one by one (km.K1_VARIANTS), each case naming the
# variant it must launch: march only, each shading mode, the lit modes with
# in-kernel shadows, the RGB8 albedo, and ray counts that leave a partial
# last block (PACKED_RAYS' n117 and n1961)
K1_CASES = {
    "march": "march", "flat": "flat", "lambert": "lambert",
    "full_fog": "full", "lambert_shadows": "lambert_shadows",
    "full_shadows_fog": "full_shadows", "rgb8": "lambert",
    "march-n117": "march", "full_shadows_fog-n1961": "full_shadows",
}


def run_k1_case(name: str, device, D: int = 64, h: int = 256,
                w: int = 256) -> dict:
    """One instantiation of march_shade_kernel (km.march, the kernel) vs
    march_shade_reference on the 64^3 terrain from the outside camera:
    record_mismatch, and image_mismatch of the rgb where it shades."""
    mode, *rest = name.split("-")
    for v in rest:
        h, w = PACKED_RAYS[v]
    dims = (D,) * 3
    rgb8 = mode == "rgb8"
    grid = procgen.terrain(dims, seed=11, with_rgb=rgb8, device=device)
    acc = build_packed_morton(grid.occupancy, cap=64)
    mats = build_rgb8_morton(grid) if rgb8 else \
        build_material_morton(grid.occupancy)
    o, d = generate_rays(_cameras(D, device)["outside"], h, w)
    two = Lights.make([(0.15 * D, -0.3 * D, 1.4 * D),
                       (1.25 * D, 0.95 * D, 1.55 * D)],
                      [(1.0, 0.9, 0.8), (0.4, 0.5, 1.0)], [2.0, 1.0],
                      device=device)
    settings, lights = {
        "march": (RenderSettings(shading="lambert"), two),
        "flat": (RenderSettings(shading="flat"), Lights.none(device)),
        "lambert": (RenderSettings(shading="lambert"), two),
        "full_fog": (RenderSettings(shading="full", fog=True), two),
        "lambert_shadows": (RenderSettings(shading="lambert", shadows=True),
                            two),
        "full_shadows_fog": (RenderSettings(shading="full", shadows=True,
                                            fog=True), two),
        "rgb8": (RenderSettings(shading="lambert"), two),
    }[mode]
    ms = settings.resolve_max_steps(dims)
    lights_arr = km.pack_lights(lights)
    spec = None if mode == "march" else km.ShadeSpec.from_settings(
        settings, lights, rgb8=rgb8)
    got = km.march(o, d, acc, dims, ms, shade_spec=spec, mats=mats,
                   lights_arr=lights_arr)
    want = km.march_shade_reference(o, d, acc, dims, ms, None, spec, mats,
                                    lights_arr)
    if spec is None:
        m = record_mismatch(got, want)
        m["image"] = None
    else:
        m = record_mismatch(got[0], want[0])
        m["image"] = image_mismatch(got[1], want[1])
        got = got[0]
    m["hits"] = int(got.hit.sum())
    m["variant"] = km.K1_VARIANTS[km.k1_variant(spec)]
    return m


def check_k1_case(m: dict, what: str) -> None:
    check_exact(m, m["image"], what)
    if m["hits"] == 0:
        raise AssertionError(f"{what}: no ray hit")


RESUME_BUDGETS = (0, 1, 3, 24)
RESUME_FIELDS = ("hit", "t", "voxel", "normal", "steps", "done", "dist")


def resume_mismatch(rec_a, ext_a, rec_b, ext_b) -> dict:
    """Rays on which two resume-mode results differ, field by field
    (exact, t included)."""
    m = {}
    for f in RESUME_FIELDS:
        a = ext_a[f] if f in ext_a else getattr(rec_a, f)
        b = ext_b[f] if f in ext_b else getattr(rec_b, f)
        ne = a != b
        m[f] = int((ne.any(-1) if ne.dim() == 2 else ne).sum())
    return m


def merge_rounds(done0, rec0, rec1) -> km.HitRecord:
    """The final record of two rounds: round 0's for the rays it finished,
    the resume round's for the rest."""
    def pick(a, b):
        return torch.where(done0[:, None] if a.dim() == 2 else done0, a, b)

    return km.HitRecord(*(pick(getattr(rec0, f), getattr(rec1, f))
                          for f in ("hit", "t", "voxel", "normal", "steps")))


def exact_mismatch(a: km.HitRecord, b: km.HitRecord) -> int:
    """Rays on which two records differ in hit, t, voxel, normal or
    steps."""
    ne = ((a.hit != b.hit) | (a.t != b.t) | (a.steps != b.steps)
          | (a.voxel != b.voxel).any(-1) | (a.normal != b.normal).any(-1))
    return int(ne.sum())


def run_resume_case(name: str, device, D: int = 64, h: int = 256,
                    w: int = 256, budgets=RESUME_BUDGETS) -> dict:
    """march in resume mode (the kernel) vs march_reference's resume mode
    on one march case, for each budget: round 0 capped at the budget, and
    the resume from the plain round 0's state (the rays it finished as
    dead slots); the merged record against the plain single round."""
    scene, cam_name, *rest = name.split("-")
    dims = (D,) * 3
    grid = _scenes(D, device)[scene]
    acc = build_packed_morton(grid.occupancy, cap=64)
    o, d = generate_rays(_cameras(D, device)[cam_name], h, w)
    t_max = None
    if rest == ["tmax"]:
        t_max = torch.full((o.shape[0],), 1.2 * D, device=device)
    ms = 3 * D + 2
    single = km.march_reference(o, d, acc, dims, ms, t_max=t_max)
    out = dict(n=int(o.shape[0]), hits=int(single.hit.sum()),
               mismatch={f: 0 for f in RESUME_FIELDS}, merged=0,
               unfinished=0, survivors={})
    for b in budgets:
        rk, ek = km.march(o, d, acc, dims, ms, t_max=t_max, iter_budget=b,
                          extended=True)
        rp, ep = km.march_reference(o, d, acc, dims, ms, t_max,
                                    iter_budget=b, extended=True)
        state = (rp.voxel, torch.where(ep["done"], -1, ep["dist"]), rp.steps)
        rk1, ek1 = km.march(o, d, acc, dims, ms, t_max=t_max,
                            resume_state=state, extended=True)
        rp1, ep1 = km.march_reference(o, d, acc, dims, ms, t_max,
                                      resume_state=state, extended=True)
        for m in (resume_mismatch(rk, ek, rp, ep),
                  resume_mismatch(rk1, ek1, rp1, ep1)):
            for f, v in m.items():
                out["mismatch"][f] += v
        out["merged"] += exact_mismatch(
            merge_rounds(ek["done"], rk, rk1), single)
        out["unfinished"] += int((~ek1["done"]).sum())
        out["survivors"][b] = int((~ek["done"]).sum())
    return out


def check_resume_case(m: dict, what: str) -> None:
    """Exact: no field of any ray differs, every ray is done after the
    resume, and the merged rounds equal the single round."""
    bad = {f: v for f, v in m["mismatch"].items() if v}
    if bad:
        raise AssertionError(f"{what}: kernel and plain version differ on "
                             f"{bad} (of {m['n']} rays per round)")
    if m["unfinished"] or m["merged"]:
        raise AssertionError(f"{what}: {m['unfinished']} rays unfinished, "
                             f"{m['merged']} differ from the single round")
    if m["hits"] == 0:
        raise AssertionError(f"{what}: no ray hit")


# variant-layout-camera[-order][-step]: the K1 step in scanline order,
# then the inside camera in vxtpu's 4x8 block order and in the TPU probe's
# float step; identity-layout
PROBE_CASES = ([f"{v}-{lay}-{c}" for v in probe.VARIANTS
                for lay in probe.LAYOUTS for c in ("outside", "inside")]
               + [f"{v}-{lay}-inside-{opt}" for opt in ("block4x8", "tpu")
                  for v in probe.VARIANTS for lay in probe.LAYOUTS]
               + [f"identity-{lay}" for lay in probe.LAYOUTS])


def probe_table(layout, grid):
    """The world's table in a probe layout."""
    if layout == "morton16":
        return build_packed_morton(grid.occupancy, cap=64).words
    packed = build_packed(grid.occupancy)
    return packed.bricks if layout == "bricked16" else packed.words


def probe_identity_expected(o, d, dims, n_iters, layout) -> torch.Tensor:
    """acc of the nomath probe over ``probe.identity_table(layout)``,
    computed from the index formula alone: each ray steps diagonally from
    its clipped floor, and the word of coarse cell c is its index (the
    bits of c interleaved, or row-major for both row-major layouts) mod
    2^15."""
    X, Y, Z = dims
    lim = torch.tensor([X - 1, Y - 1, Z - 1], device=o.device)
    v = torch.minimum(torch.clamp(torch.floor(o), min=0.0).long(), lim)
    sg = torch.where(d >= 0, 1, -1).long()
    acc = torch.zeros(o.shape[0], dtype=torch.float32, device=o.device)
    for _ in range(n_iters):
        v = torch.minimum(torch.clamp(v + sg, min=0), lim)
        c = v >> 1
        if layout == "morton16":
            idx = sum(((c[:, a] >> b) & 1) << (3 * b + a)
                      for b in range(10) for a in range(3))
        else:
            idx = (c[:, 0] * (Y // 2) + c[:, 1]) * (Z // 2) + c[:, 2]
        word = idx % (1 << 15)
        cb = word if layout == "morton16" else word & 255
        ci = ((v[:, 0] & 1) << 2) | ((v[:, 1] & 1) << 1) | (v[:, 2] & 1)
        acc = acc + ((cb >> ci) & 1).to(torch.float32)
    return acc


def run_probe_case(name: str, device, D: int = 64, h: int = 256,
                   w: int = 256, n_iters: int = probe.N_ITERS) -> dict:
    """march_probe (the kernel) vs march_probe_reference:
    variant-layout-camera[-order][-step] on the D^3 terrain (seed 11; a
    block order's acc put back in pixel order, against the plain version
    on the rays in pixel order), or identity-layout (the nomath and full
    variants over probe.identity_table, the nomath one also against
    probe_identity_expected), outside camera."""
    kind, layout, *rest = name.split("-")
    dims = (D,) * 3
    o, d = generate_rays(_cameras(D, device)[rest[0] if rest else "outside"],
                         h, w)
    opts = rest[1:]
    step = "tpu" if "tpu" in opts else "k1"
    order = next((x for x in opts if x in probe.ORDERS), "scanline")
    if kind == "identity":
        table = probe.identity_table(layout, dims, device)
        runs = ("nomath", "full")
    else:
        table = probe_table(layout, procgen.terrain(dims, seed=11,
                                                    device=device))
        runs = (kind,)
    po, pd, inverse = probe.ordered_rays(o, d, (h, w), order)
    # acc of static is 0 where the start cell is empty (every ray of the
    # outside camera starts on the grid's face, in the air)
    m = dict(n=int(o.shape[0]), acc=0, max_abs=0.0, acc_sum=0.0,
             may_be_zero=kind == "static")
    for variant in runs:
        got = probe.march_probe(po, pd, table, dims, n_iters, variant, layout,
                                step=step)
        if inverse is not None:
            got = got[inverse]
        want = probe.march_probe_reference(o, d, table, dims, n_iters,
                                           variant, layout, step)
        m["acc"] += int((got != want).sum())
        m["max_abs"] = max(m["max_abs"], float((got - want).abs().max()))
        m["acc_sum"] += float(got.double().sum())
        if variant == "nomath" and kind == "identity":
            m["expected"] = int((got != probe_identity_expected(
                o, d, dims, n_iters, layout)).sum())
    return m


def check_probe_case(m: dict, what: str) -> None:
    """acc bit for bit on every ray (and the identity table's words)."""
    if m["acc"] or m.get("expected", 0):
        raise AssertionError(f"{what}: acc differs on {m['acc']} of "
                             f"{m['n']} rays (max {m['max_abs']:.3g}); "
                             f"identity words wrong on "
                             f"{m.get('expected', 0)}")
    if m["acc_sum"] <= 0 and not m["may_be_zero"]:
        raise AssertionError(f"{what}: acc is 0 on every ray")


PACKED_T_ATOL = 1e-6
# scene[_XxYxZ]-camera[-variant]; without a size the scene is D^3
PACKED_CASES = ([f"{s}-{c}" for s in ("box", "sphere", "terrain")
                 for c in ("outside", "inside")]
                + ["terrain-outside-tmax", "terrain-outside-shadow",
                   "terrain-outside-n117", "terrain-outside-shadow-n1961",
                   "terrain_64x64x32-outside", "terrain_64x64x32-inside",
                   "terrain_48x80x32-outside", "terrain_36x44x20-outside",
                   "sphere_48x80x32-outside-shadow"])
# ray counts of the n<N> variants (h, w): 117 rays fill no block of 256;
# 1961 leave a partial last block after 7 whole ones
PACKED_RAYS = {"n117": (9, 13), "n1961": (37, 53)}


def packed_mismatch(a: km.HitRecord, b: km.HitRecord) -> dict:
    """record_mismatch plus the largest |t difference| over all rays."""
    m = record_mismatch(a, b)
    m["t_abs"] = float((a.t - b.t).abs().max()) if a.t.numel() else 0.0
    return m


def run_packed_case(name: str, device, D: int = 64, h: int = 256,
                    w: int = 256) -> dict:
    """march_packed (the kernel) vs march_packed_reference on one scene and
    ray set: a camera's rays, capped at t_max = 1.2 D ('tmax'), or the
    shadow rays toward a light from the plain march's hits ('shadow');
    'n117' and 'n1961' take PACKED_RAYS' h x w rays, no multiple of the
    kernel's 256-thread block."""
    scene, cam_name, *rest = name.split("-")
    scene, _, size = scene.partition("_")
    dims = tuple(int(x) for x in size.split("x")) if size else (D,) * 3
    if scene == "box":
        X, Y, Z = dims
        grid = procgen.solid_box(dims, (X // 4, Y // 4, Z // 4),
                                 (3 * X // 4, 3 * Y // 4, 5 * Z // 8),
                                 device=device)
    elif scene == "sphere":
        grid = procgen.shell_sphere(dims, device=device)
    else:
        grid = procgen.terrain(dims, seed=11, device=device)
    acc = build_packed(grid.occupancy)
    for v in rest:
        h, w = PACKED_RAYS.get(v, (h, w))
    o, d = generate_rays(_cameras_dims(dims, device)[cam_name], h, w)
    ms = sum(dims) + 2
    t_max = None
    if "tmax" in rest:
        t_max = torch.full((o.shape[0],), 1.2 * max(dims), device=device)
    elif "shadow" in rest:
        X, Y, Z = dims
        light = torch.tensor((0.8 * X, -0.3 * Y, 1.9 * Z), device=device)
        prim = kp.march_packed_reference(o, d, acc, dims, ms)
        o, d, t_max = shadow_ray_batch(prim, o, d, light)
    rec = kp.march_packed(o, d, acc, dims, ms, t_max=t_max)
    ref = kp.march_packed_reference(o, d, acc, dims, ms, t_max=t_max)
    m = packed_mismatch(rec, ref)
    m["hits"] = int(rec.hit.sum())
    m["steps_total"] = int(ref.steps.sum(dtype=torch.int64))
    return m


def check_packed(m: dict, what: str) -> None:
    """Exact agreement: no ray may differ in hit, voxel, normal or steps,
    and t within PACKED_T_ATOL."""
    for k in ("hit", "voxel", "normal", "steps"):
        if m[k]:
            raise AssertionError(f"{what}: {k} differs on {m[k]} of "
                                 f"{m['n']} rays")
    if m["t_abs"] > PACKED_T_ATOL:
        raise AssertionError(f"{what}: t differs by {m['t_abs']:.3g}")


def check_packed_case(m: dict, what: str) -> None:
    check_packed(m, what)
    if m["hits"] == 0:
        raise AssertionError(f"{what}: no ray hit")


def golden_march_inputs(D: int = 64, n: int = 4096, seed: int = 5):
    """The fixed inputs of the JAX cross-check of K5 (numpy float32): rays
    o, d [n, 3] (a quarter start inside the grid, 64 point away from it)
    and t_max [n] (the last quarter capped inside the grid, the rest 1e30).
    tools/make_torch_golden.py runs vxtpu's march_pallas on them over the
    D^3 terrain of seed 7; chip_smoke.py and the CPU tests run the port."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5 * D, 1.5 * D, (n, 3))
    o[: n // 4] = rng.uniform(0.1 * D, 0.9 * D, (n // 4, 3))
    d = rng.uniform(0.1 * D, 0.9 * D, (n, 3)) - o
    d[n // 2: n // 2 + 64] *= -1.0
    d = d / np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                    + d[:, 2] * d[:, 2])[:, None]
    t_max = np.full((n,), 1e30)
    t_max[3 * n // 4:] = rng.uniform(0.0, D, n - 3 * n // 4)
    return (o.astype(np.float32), d.astype(np.float32),
            t_max.astype(np.float32))


def march_checksums(hit, t, voxel, normal, steps, dims) -> dict:
    """Checksums of a HitRecord given as numpy arrays: hits, total steps,
    the sum of every ray's row-major voxel index, the sum of t over hits
    (float64) and of normal . (1, 2, 4) over hits."""
    hit = np.asarray(hit).astype(bool)
    v = np.asarray(voxel).astype(np.int64)
    _, Y, Z = dims
    nrm = np.asarray(normal, np.float64)[hit]
    return dict(hits=int(hit.sum()),
                steps=int(np.asarray(steps, np.int64).sum()),
                voxel_index_sum=int(((v[:, 0] * Y + v[:, 1]) * Z
                                     + v[:, 2]).sum()),
                t_sum=float(np.asarray(t, np.float64)[hit].sum()),
                normal_sum=float((nrm @ np.array([1.0, 2.0, 4.0])).sum()))


def table_checksums(words: torch.Tensor) -> dict:
    """Checksums of a flat integer word table: cells, sum, a sum weighted
    by (index mod 1000003) + 1, occupied cells (child bits != 0) and the
    sum of the distance fields (word >> 8)."""
    w = words.to(torch.int64)
    i = torch.arange(w.numel(), dtype=torch.int64, device=w.device)
    return dict(cells=int(w.numel()), sum=int(w.sum()),
                weighted_sum=int(((i % 1000003 + 1) * w).sum()),
                occupied=int(((w & 255) != 0).sum()),
                dist_sum=int((w >> 8).sum()))


FWD_ATOL = 1e-6
BWD_RTOL = 1e-5
BWD_ATOL_REL = 1e-6

# "<rays>-<lit>": the backward with the ray cotangents (kRayGrads);
# "<rays>-<lit>-scatter": the pure scatter (the trainer's main path)
SAMPLE_CASES = [f"{r}-{m}{v}" for v in ("", "-scatter")
                for r in ("outside", "inside", "dt0", "random", "masked")
                for m in ("unlit", "lit")]


def allclose_excess(got, want, rtol, atol) -> float:
    """max(|got - want| / (atol + rtol |want|)): <= 1 means allclose."""
    lim = atol + rtol * want.abs()
    return float(((got - want).abs() / lim).max()) if got.numel() else 0.0


def grads_excess(got, want) -> float:
    """Worst allclose excess over a backward's outputs (gradient tables
    and ray cotangents), atol scaled by each output's max |g|."""
    worst = 0.0
    for g, w in zip(got, want):
        atol = BWD_ATOL_REL * max(float(w.abs().max()), 1e-30)
        worst = max(worst, allclose_excess(g, w, BWD_RTOL, atol))
    return worst


def channels(grad: torch.Tensor) -> tuple:
    """A [D^3, 4] table (or its gradient) as its four channels sigma, r,
    g, b: what grads_excess holds each to its own max |g|."""
    return tuple(grad.t())


def sample_fields(D, device, seed=0):
    """A random channel-interleaved Morton table [D^3, 4] (sigma, r, g, b
    drawn one after the other)."""
    g = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randn(D ** 3, generator=g) * s
                        for s in (2.0, 1.0, 1.0, 1.0)], dim=1).to(device)


def masked_sample_fields(D, device, G=4):
    """``sample_fields`` as a fitted masked scene holds it: densities high
    in the D^3 terrain's (seed 11) solid voxels and low elsewhere; with its
    occupancy mask (G = 4, tau 0.01, dilate 1, read from the table) and
    the mask's distance field."""
    tab = sample_fields(D, device)
    solid = ks.build_field_morton(procgen.terrain(
        (D,) * 3, seed=11, device=device).occupancy.to(torch.float32)) > 0
    tab[:, 0] = torch.where(solid, tab[:, 0].abs() + 2.0, -8.0)
    mask = occmask.occupancy_mask_from_soft(MortonSoftGrid(tab), G)
    return tab, mask, occmask.mask_distance_field(mask)


def sample_rays(kind, D, n, device, seed=1):
    """Rays for the sampling kernels: 'outside' an image-ordered camera
    view from outside the grid ('masked' the same rays, sampled on their
    occupied bands only); 'inside' one from inside; 'dt0' half the rays
    missing the grid (dt == 0) and a quarter with dt forced to 0;
    'random' scattered origins and directions (incoherent)."""
    g = torch.Generator().manual_seed(seed)
    side = int(round(n ** 0.5))
    if kind in ("outside", "inside", "dt0", "masked"):
        cam = _cameras(D, device)["inside" if kind == "inside"
                                  else "outside"]
        o, d = generate_rays(cam, side, n // side)
        if kind == "dt0":
            d = torch.where((torch.arange(o.shape[0], device=device)
                             % 2 == 0)[:, None], -d, d).contiguous()
    else:
        o = (torch.rand(n, 3, generator=g) * 1.6 - 0.3) * D
        d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g),
                                          dim=1)
        o, d = o.to(device), d.to(device)
    return o, d


def run_sample_case(name: str, device, D: int = 64, n: int = 16384,
                    S: int = 64) -> dict:
    """sample_fields_fwd / _bwd (the kernels) vs their plain versions on
    one ray set, on the interleaved table of ``sample_fields`` (for
    'masked' rays ``masked_sample_fields``, each ray sampled on its
    occupied band: rays that cross no occupied cell get dt == 0); the
    backward also against a second kernel run. S = 64 is
    four chunks of the kRayGrads variant; its ray cotangents are held to
    the plain version bit for bit (``rays_unequal``)."""
    kind, mode, *variant = name.split("-")
    lit = mode == "lit"
    ray_grads = not variant
    o, d = sample_rays(kind, D, n, device)
    bounds = None
    if kind == "masked":
        tab, mask, mask_df = masked_sample_fields(D, device)
        bounds = occmask.mask_segment_bounds(mask, 4, o, d, df_flat=mask_df)
    else:
        tab = sample_fields(D, device)
    t0, dt, valid = _enter_dt_soft(o, d, (D,) * 3, S, bounds)
    if kind == "dt0":
        dt = torch.where(torch.arange(n, device=device) % 4 == 1, 0.0, dt)
    t0, dt = t0.contiguous(), dt.contiguous()
    got = ks.sample_fields_fwd(tab, o, d, t0, dt, S, D, lit)
    want = ks.sample_fields_fwd_reference(tab, o, d, t0, dt, S, D, lit)
    fwd_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    g = torch.Generator().manual_seed(2)
    cots = tuple(torch.randn(S, n, generator=g).to(device)
                 for _ in range(7 if lit else 4))
    kb = ks.sample_fields_bwd(tab, o, d, t0, dt, cots, D, lit, ray_grads)
    kb2 = ks.sample_fields_bwd(tab, o, d, t0, dt, cots, D, lit, ray_grads)
    pb = ks.sample_fields_bwd_reference(tab, o, d, t0, dt, cots, D, lit,
                                        ray_grads)
    pb = (channels(pb[0]), *pb[1:])
    flat = [*kb[0], *kb[1:]] if ray_grads else [*kb[0]]
    flat2 = [*kb2[0], *kb2[1:]] if ray_grads else [*kb2[0]]
    flatp = [*pb[0], *pb[1:]] if ray_grads else [*pb[0]]
    if not ray_grads and any(x is not None for x in (*kb[1:], *pb[1:])):
        raise AssertionError(f"{name}: ray outputs without ray_grads")
    return dict(
        n=n, S=S, active=int((dt > 0).sum()), ray_grads=ray_grads,
        shared_storage=len({x.untyped_storage().data_ptr()
                            for x in kb[0]}) == 1,
        fwd_max_abs=fwd_err,
        bwd_excess=grads_excess(flat, flatp),
        tables_excess=grads_excess(flat[:4], flatp[:4]),
        rays_excess=grads_excess(flat[4:], flatp[4:]),
        rays_unequal=sum(int((a != b).sum())
                         for a, b in zip(flat[4:], flatp[4:])),
        rays_max_abs=max((float((a - b).abs().max())
                          for a, b in zip(flat[4:], flatp[4:])), default=0.0),
        bwd_max_abs=max(float((a - b).abs().max())
                        for a, b in zip(flat, flatp)),
        rerun_excess=grads_excess(flat2, flat),
        finite=all(bool(torch.isfinite(x).all()) for x in (*got, *flat)),
        zero_rays_clean=bool(all((x[:, dt == 0] == 0).all() for x in got)),
        masked=bounds is not None,
        empty_bands=int(((dt == 0) & valid).sum()),
    )


def check_sample_case(m: dict, what: str) -> None:
    if not m["finite"]:
        raise AssertionError(f"{what}: non-finite output")
    if m["fwd_max_abs"] > FWD_ATOL:
        raise AssertionError(f"{what}: forward differs by "
                             f"{m['fwd_max_abs']:.3g} > {FWD_ATOL}")
    for k in ("bwd_excess", "rerun_excess"):
        if m[k] > 1.0:
            raise AssertionError(f"{what}: {k} {m[k]:.3g} (> 1 means beyond "
                                 f"rtol {BWD_RTOL} / atol {BWD_ATOL_REL} "
                                 f"x max|g|)")
    if m["rays_unequal"]:
        raise AssertionError(f"{what}: {m['rays_unequal']} ray cotangents "
                             f"differ from the plain version's")
    if not m["shared_storage"]:
        raise AssertionError(f"{what}: the gradient tables are not rows of "
                             f"one buffer")
    if not m["zero_rays_clean"]:
        raise AssertionError(f"{what}: a ray with dt == 0 sampled non-zero")
    if m["active"] == 0:
        raise AssertionError(f"{what}: no ray crosses the grid")
    if m["masked"] and not m["empty_bands"]:
        raise AssertionError(f"{what}: no ray that crosses the grid has an "
                             f"empty band")


def golden_sample_inputs(D: int = 16, n: int = 1024, S: int = 8,
                         seed: int = 3):
    """The fixed inputs of the JAX cross-check of K3 (numpy, float32):
    four fields [D, D, D] (sigma, r, g, b), rays o, d [n, 3] and their
    segments t0, dt [n] (computed on the CPU), S. tools/make_torch_golden.py
    runs vxtpu's sample_fields_fwd on them; chip_smoke.py runs the kernel."""
    rng = np.random.default_rng(seed)
    fields = [(rng.normal(size=(D,) * 3) * s).astype(np.float32)
              for s in (2.0, 1.0, 1.0, 1.0)]
    o = rng.uniform(-0.5 * D, 1.5 * D, (n, 3))
    o[: n // 4] = rng.uniform(0.1 * D, 0.9 * D, (n // 4, 3))
    d = rng.uniform(0.1 * D, 0.9 * D, (n, 3)) - o
    d[n // 2: n // 2 + 64] *= -1.0                     # some miss the grid
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = o.astype(np.float32)
    t0, dt, _ = _enter_dt_soft(torch.from_numpy(o), torch.from_numpy(d),
                               (D,) * 3, S, None)
    return fields, o, d, t0.numpy(), dt.numpy(), S


TV_RTOL = 1e-6
TV_ATOL_REL = 1e-6
# case -> (tv_sigma, tv_rgb, upstream gradient, an existing .grad); the
# trainer's weights (TrainConfig: tv_sigma, tv_rgb) are 1e-4 and 1e-5
TV_CASES = {"both": (1e-4, 1e-5, 1.0, False),
            "rgb_zero": (1e-4, 0.0, 1.0, False),
            "sigma_zero": (0.0, 1e-5, 1.0, False),
            "upstream_3.7": (1e-4, 1e-5, 3.7, False),
            "accumulated": (1e-4, 1e-5, 1.0, True)}
TV_WEIGHTS = TV_CASES["both"][:2]


def tv_table(D, device, seed=0):
    """A random [D^3, 4] table, sigma twice the spread of r, g, b, drawn
    on ``device`` (a 512^3 table is 537 M numbers)."""
    g = torch.Generator(device=device).manual_seed(seed)
    tab = torch.randn((D ** 3, 4), generator=g, device=device)
    tab[:, 0] *= 2.0
    return tab


def run_tv_case(D, device, case="upstream_3.7", seed=0):
    """The TV prior's kernel pair against its plain version on one table,
    in one of TV_CASES: the value (twice, for the bit-for-bit repeat) and
    the gradient of the upstream gradient x the prior, accumulated onto
    an existing .grad (random, of the prior gradient's magnitude) where
    the case has one."""
    w_s, w_rgb, up, accumulate = TV_CASES[case]
    tab = tv_table(D, device, seed)
    before = (tv_table(D, device, seed + 1) * (8e-4 / (3 * D ** 3))
              if accumulate else None)

    def grad_of(prior):
        x = tab.clone().requires_grad_(True)
        if before is not None:
            x.grad = before.clone()
        v = prior(x, w_s, w_rgb)
        (up * v).backward()
        return float(v.detach()), x.grad

    kernel_tv.reset_launch_counts()
    v, gk = grad_of(kernel_tv.tv_prior)
    again = float(kernel_tv.tv_prior(tab, w_s, w_rgb))
    launches = dict(kernel_tv.LAUNCHES)
    w, gp = grad_of(tv_prior_morton)
    scale = float((gp if before is None else gp - before).abs().max())
    return dict(D=D, case=case, device=torch.device(device).type, value=v,
                again=again, plain=w, value_rel=abs(v - w) / abs(w),
                grad_err=float((gk - gp).abs().max()) / scale,
                grad_scale=scale, launches=launches)


def check_tv_case(m: dict, what: str) -> None:
    what = f"{what} ({m['case']})"
    if m["value"] != m["again"]:
        raise AssertionError(f"{what}: two launches gave {m['value']!r} and "
                             f"{m['again']!r}")
    if not m["value_rel"] <= TV_RTOL:
        raise AssertionError(f"{what}: value {m['value']!r}, plain "
                             f"{m['plain']!r} (rel {m['value_rel']:.3g})")
    if not m["grad_err"] <= TV_ATOL_REL:
        raise AssertionError(f"{what}: gradient off by {m['grad_err']:.3g} "
                             f"x max |g|")
    if m["device"] == "cuda" and m["launches"] != {
            "tv_fwd_kernel": 2, "tv_fwd_finish_kernel": 2,
            "tv_bwd_kernel": 1}:
        raise AssertionError(f"{what}: launches {m['launches']}, not one of "
                             f"each kernel a forward and one a backward")


ADAM_RTOL = 1e-6
ADAM_ATOL_REL = 1e-6
ADAM_STEPS = 5
# case -> run_adam_case's keywords: the parameters' shapes, the elements
# by which each parameter and gradient starts past a 16-byte boundary (1:
# the kernel's scalar path), a state resumed at count 7
ADAM_CASES = {"n1": dict(shapes=[(1,)]),
              "n3": dict(shapes=[(3,)]),
              "n4": dict(shapes=[(4,)]),
              "n1027": dict(shapes=[(1027,)]),
              "table64": dict(shapes=[(64 ** 3, 4)]),
              "unaligned": dict(shapes=[(1027,)], offset=1),
              "resume7": dict(shapes=[(64 ** 3, 4)], resume=True),
              "camera": dict(shapes=[(3,), (), (), ()])}


def _placed(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of x that starts ``offset`` floats into a fresh buffer."""
    buf = torch.empty(x.numel() + offset, device=x.device)
    out = buf[offset:].view(x.shape)
    out.copy_(x)
    return out


def run_adam_case(device, shapes, offset=0, resume=False, steps=ADAM_STEPS):
    """kernel_adam.Adam twice and torch.optim.Adam's foreach step once over
    the same ``steps`` steps at the fit's lr: parameters of ``shapes``
    (normal), gradients drawn anew each step from one seed (the k-th
    parameter's scaled by 10^-k), and with ``resume`` a state at count 7. Each run's results are
    compared as they come, so at most three parameter sets live at once.
    Returns the worst allclose excess over the parameters and moments
    (ADAM_RTOL, ADAM_ATOL_REL), their largest |difference|, the elements
    that differ at all, whether the second run equalled the first bit for
    bit, and the first run's launches."""

    def draw(gen, shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    def run(cls, **kw):
        gen = torch.Generator(device=device).manual_seed(0)
        ps = [_placed(draw(gen, s), offset).requires_grad_(True)
              for s in shapes]
        opt = cls(ps, lr=5e-2, betas=BETAS, eps=ADAM_EPS, **kw)
        if resume:
            for p in ps:
                opt.state[p] = {
                    "step": torch.tensor(7.0),
                    "exp_avg": draw(gen, p.shape, 0.1),
                    "exp_avg_sq": draw(gen, p.shape, 0.1) ** 2}
        for _ in range(steps):
            for k, p in enumerate(ps):
                p.grad = _placed(draw(gen, p.shape, 10.0 ** -k), offset)
            opt.step()
        out = []
        for p in ps:
            out += [p.detach(), opt.state[p]["exp_avg"],
                    opt.state[p]["exp_avg_sq"]]
        return out

    kernel_adam.reset_launch_counts()
    got = run(kernel_adam.Adam)
    launches = kernel_adam.LAUNCHES["adam_step_kernel"]
    rerun_equal = all(torch.equal(a, b)
                      for a, b in zip(got, run(kernel_adam.Adam)))
    excess = max_abs = 0.0
    unequal = 0
    for a, b in zip(got, run(torch.optim.Adam, foreach=True)):
        atol = ADAM_ATOL_REL * max(float(b.abs().max()), 1e-30)
        excess = max(excess, allclose_excess(a, b, ADAM_RTOL, atol))
        max_abs = max(max_abs, float((a - b).abs().max()))
        unequal += int((a != b).sum())
    return dict(device=torch.device(device).type, shapes=shapes,
                offset=offset, resume=resume, steps=steps, excess=excess,
                max_abs=max_abs, unequal=unequal, rerun_equal=rerun_equal,
                launches=launches,
                elements=3 * sum(int(np.prod(s)) for s in shapes))


def check_adam_case(m: dict, what: str) -> None:
    if not m["rerun_equal"]:
        raise AssertionError(f"{what}: a second run differs")
    if not m["excess"] <= 1.0:
        raise AssertionError(f"{what}: off torch's step by allclose excess "
                             f"{m['excess']:.3g} (max |d| {m['max_abs']:.3g})")
    want = m["steps"] * len(m["shapes"])
    if m["device"] == "cuda" and m["launches"] != want:
        raise AssertionError(f"{what}: {m['launches']} adam_step_kernel "
                             f"launches, not {want} (one a parameter a step)")
