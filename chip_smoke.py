#!/usr/bin/env python3
"""Drive vxtpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--save DIR]

Run from the root of a checkout; it needs one CUDA device and nvcc.
Phases, each printing what it found (any failure raises, exit code != 0):

  1. device  the card's name and power limit (nvidia-smi);
  2. build   compile the CUDA kernels of vxtpu_torch/csrc with nvcc;
  3. kernels each kernel against its plain PyTorch version on the card,
             64^3 scenes at 256x256 (vxtpu_torch.kernel_check);
  4. main    the full-size path: 512^3 terrain (seed 7), Morton tables,
             and five 1080x1920 frames through render_frame_fused
             (outside camera lambert; full + shadows + fog in-kernel and
             composed; the bench's inside camera, which sits in solid rock,
             lambert; an inside camera in the air, lambert). Launch counts,
             finiteness,
             hit fraction, agreement with the plain versions, median
             frame times and total march steps;
  5. cross   the 512^3 world fingerprint and the frame of the 128^3 entry
             scene against the JAX package's data in vxtpu_torch/data;
  6. train   the config-4 trainer (c4_512_diff as its config defines it):
             512^3 terrain (seed 7) -> SoftGrid.from_hard truth -> one
             256x256 target view at S = 256 (plain soft renderer, in ray
             chunks) -> five fit_soft steps from SoftGrid.zeros through the
             field-sampling kernels K3/K4. Launch counts, the loss per step
             (finite and falling), median step time, peak memory, one
             step's loss and gradient through the plain versions against
             the kernels', a lit forward and backward at 512^3, K3/K4 alone
             against their plain versions and torch's grid_sample (the
             library yardstick, used nowhere in the port), and a profiled
             step's device time by kernel;
  7. cross   the fit at 32^3 against the JAX package's loss trajectory and
             K3's outputs against its checksums (vxtpu_torch/data).

Phases 3 and 6 also hold K3/K4 against their plain versions: forward
|d| <= 1e-6; backward within rtol 1e-5 / atol 1e-6 x max|g| (the float
atomics of the scatter sum in a varying order).

The line before the last is one JSON object with the kernels' counts,
errors, times and bounds; the last line is {"ok": true, "device": {...}}.
--save DIR writes the main-path frames there as PNGs.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FULL = 512
H, W = 1080, 1920
RUNS = 5

# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM
# bytes/s and float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# float32 operations per active sample, counted from csrc/sample.cu. The
# forward: position (8), corner set-up (9), four trilinear ladders
# (4 x 24); lit adds the gradient ladder (39). The backward: position and
# set-up (17), corner weights (19), 32 cotangent products, four value
# f-gradients (4 x 37), the chain to the ray (41); lit adds the weight
# derivatives (96) and the second-order terms (60).
FWD_OPS, FWD_OPS_LIT = 113, 39
BWD_OPS, BWD_OPS_LIT = 257, 156
# float32 operations per ray (set-up, shading) and per DDA step of K1
MARCH_OPS_RAY, MARCH_OPS_STEP = 60, 20


def _require_checkout() -> None:
    if not (ROOT / "vxtpu_torch" / "csrc" / "march.cu").exists():
        raise SystemExit("chip_smoke.py: vxtpu_torch/ not found next to this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def median_ms(fn, device, runs=RUNS) -> float:
    """Median wall time of fn() over ``runs`` runs after one warm-up; on
    the GPU measured with CUDA events around each run."""
    import torch

    fn()
    _sync(device)
    times = []
    for _ in range(runs):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("phase 1 device: torch.cuda.is_available() is false; "
                         "chip_smoke.py needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {smi}")
    print(f"phase 1 device: torch {torch.__version__} cuda "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s), "
          f"using {name}")
    return torch.device("cuda", 0), name, smi


def phase_build() -> float:
    from vxtpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    dt = time.perf_counter() - t0
    log = _build.library_path().with_suffix(".log")
    for line in log.read_text().splitlines() if log.exists() else []:
        if "registers" in line or "spill" in line:
            print(f"phase 2 build: ptxas {line.strip()}")
    print(f"phase 2 build: {_build.library_path().name} in {dt:.1f} s")
    return dt


def phase_kernels(device, D=64, h=256, w=256) -> dict:
    """Returns the largest |rgb| difference seen per kernel."""
    from vxtpu_torch import kernel_check as kc

    err = {"march_shade_kernel": 0.0, "shade_kernel": 0.0}
    for name in kc.MARCH_CASES:
        m = kc.run_march_case(name, device, D, h, w)
        print(f"phase 3 kernels: march {name}: {m['hits']} hits; mismatches "
              f"hit {m['hit']} voxel {m['voxel']} normal {m['normal']} "
              f"steps {m['steps']} of {m['n']}; t rel {m['t_rel']:.3g}")
        kc.check_march_case(m, f"march {name}")
    for name in kc.SHADE_CASES:
        m = kc.run_shade_case(name, device, D, h, w)
        rec = (f"; record mismatches hit {m['rec_hit']} voxel "
               f"{m['rec_voxel']} steps {m['rec_steps']}"
               if "rec_n" in m else "")
        print(f"phase 3 kernels: shade {name}: {m['hits']} hits; rgb beyond "
              f"{kc.RGB_ATOL} on {m['rgb']} of {m['n']} pixels, max "
              f"{m['max_abs']:.3g}{rec}")
        kc.check_shade_case(m, f"shade {name}")
        uses_shade_kernel = name in ("shade_kernel",
                                     "full_shadows_fog_composed")
        k = "shade_kernel" if uses_shade_kernel else "march_shade_kernel"
        err[k] = max(err[k], m["max_abs"])
    err.update(sample_fwd_kernel=0.0, sample_bwd_kernel=0.0)
    for name in kc.SAMPLE_CASES:
        m = kc.run_sample_case(name, device, D, n=min(h * w, 16384))
        print(f"phase 3 kernels: sample {name}: {m['active']} of {m['n']} "
              f"rays cross the grid, S {m['S']}; forward max |d| "
              f"{m['fwd_max_abs']:.3g}; backward vs plain: max |d| "
              f"{m['bwd_max_abs']:.3g}, allclose excess "
              f"{m['bwd_excess']:.3g} (tables {m['tables_excess']:.3g}, "
              f"rays {m['rays_excess']:.3g}); second run excess "
              f"{m['rerun_excess']:.3g}")
        kc.check_sample_case(m, f"sample {name}")
        err["sample_fwd_kernel"] = max(err["sample_fwd_kernel"],
                                       m["fwd_max_abs"])
        err["sample_bwd_kernel"] = max(err["sample_bwd_kernel"],
                                       m["bwd_max_abs"])
    return err


def _main_scene(device, D):
    """The bench's 512^3 scene scaled to a D^3 grid."""
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.world.lights import Lights

    s = D / FULL
    cam_out = Camera.make(pos=(-360.0 * s, 256.0 * s, 560.0 * s),
                          fov_y_deg=55.0, device=device).look_at(
                              (256.0 * s, 256.0 * s, 140.0 * s))
    cam_in = Camera.make(pos=(256.0 * s, 256.0 * s, 120.0 * s),
                         fov_y_deg=55.0, device=device).look_at(
                             (500.0 * s, 400.0 * s, 90.0 * s))
    # the bench's inside camera sits in solid rock (the terrain there tops
    # out near z = 255): every ray hits its entry voxel. This one is in
    # the air above the same column, inside the grid
    cam_air = Camera.make(pos=(256.0 * s, 256.0 * s, 300.0 * s),
                          fov_y_deg=55.0, device=device).look_at(
                              (500.0 * s, 400.0 * s, 200.0 * s))
    light = Lights.single((100.0 * s, -150.0 * s, 700.0 * s), intensity=2.0,
                          device=device)
    lambert = RenderSettings(shading="lambert")
    full = RenderSettings(shading="full", shadows=True, fog=True)
    # (name, camera, settings, in-kernel shadows)
    return light, [("lambert", cam_out, lambert, True),
                   ("full_shadows_fog", cam_out, full, True),
                   ("full_shadows_fog_composed", cam_out, full, False),
                   ("inside_lambert", cam_in, lambert, True),
                   ("inside_air_lambert", cam_air, lambert, True)]


def _in_solid(grid, cam) -> bool:
    v = [int(x) for x in cam.pos.floor().tolist()]
    return all(0 <= c < n for c, n in zip(v, grid.dims)) and \
        bool(grid.occupancy[v[0], v[1], v[2]] > 0)


def phase_main(device, D=FULL, h=H, w=W, runs=RUNS, save=None) -> dict:
    import torch

    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render import kernel_march as km
    from vxtpu_torch.render.fused import render_frame_fused, render_rays_fused
    from vxtpu_torch.utils import save_png
    from vxtpu_torch.world import procgen
    from vxtpu_torch.world.packed import (build_material_morton,
                                          build_packed_morton)

    dims = (D,) * 3
    t0 = time.perf_counter()
    grid = procgen.terrain(dims, seed=7, device=device)
    accel = build_packed_morton(grid.occupancy, cap=64)
    mats = build_material_morton(grid.occupancy)
    _sync(device)
    print(f"phase 4 main: {D}^3 terrain + tables in "
          f"{time.perf_counter() - t0:.2f} s; occupancy table "
          f"{accel.words.numel() * 2 / 2**20:.0f} MiB int16, material table "
          f"{mats.numel() * 4 / 2**20:.0f} MiB int32")
    light, requests = _main_scene(device, D)

    # the main path, counted: every launch from here to the read below
    km.reset_launch_counts()
    frames = {}
    for name, cam, settings, inkernel in requests:
        before = km.LAUNCHES["march_shade_kernel"]
        frames[name] = render_frame_fused(accel, mats, dims, cam, light,
                                          settings, h, w,
                                          inkernel_shadows=inkernel)
        _sync(device)
        if device.type == "cuda" and \
                km.LAUNCHES["march_shade_kernel"] <= before:
            raise AssertionError(f"{name}: march_shade_kernel not launched")
        if frames[name].shape != (h, w, 3) or \
                not bool(torch.isfinite(frames[name]).all()):
            raise AssertionError(f"{name}: frame not finite or misshapen")
    launches = dict(km.LAUNCHES)
    print(f"phase 4 main: launches during the {len(requests)} requests: "
          f"{launches}")
    if device.type == "cuda" and min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    if not torch.equal(frames["full_shadows_fog"],
                       frames["full_shadows_fog_composed"]):
        diff = float((frames["full_shadows_fog"]
                      - frames["full_shadows_fog_composed"]).abs().max())
        if diff > kc.RGB_ATOL:
            raise AssertionError(f"in-kernel and composed shadows differ by "
                                 f"{diff}")
    if save:
        Path(save).mkdir(parents=True, exist_ok=True)
        for name, img in frames.items():
            save_png(str(Path(save) / f"{name}.png"), img)

    # measurement and comparison with the plain versions (not counted)
    err = {"march_shade_kernel": 0.0, "shade_kernel": 0.0}
    times = {}
    for name, cam, settings, inkernel in requests:
        o, d = generate_rays(cam, h, w)
        rgb, rec = render_rays_fused(o, d, accel, mats, dims, light,
                                     settings, inkernel_shadows=inkernel)
        if not torch.equal(rgb, frames[name].reshape(-1, 3)):
            raise AssertionError(f"{name}: the kernel is not deterministic")
        hit_frac = float(rec.hit.float().mean())
        if _in_solid(grid, cam):
            # a camera inside a solid voxel: every ray hits at t = 0
            if hit_frac != 1.0 or bool(rec.steps.any()):
                raise AssertionError(f"{name}: camera in solid, yet hit "
                                     f"fraction {hit_frac}")
        elif not 0.0 < hit_frac < 1.0:
            raise AssertionError(f"{name}: hit fraction {hit_frac}")
        ms = settings.resolve_max_steps(dims)
        lights_arr = km.pack_lights(light)
        spec = km.ShadeSpec.from_settings(settings, light,
                                          shadows=settings.shadows)

        def plain(o=o, d=d, spec=spec, lights_arr=lights_arr, ms=ms):
            return km.march_shade_reference(o, d, accel, dims, ms, None, spec,
                                            mats, lights_arr)

        rec_p, rgb_p = plain()
        rm = kc.record_mismatch(rec, rec_p)
        im = kc.image_mismatch(rgb, rgb_p)
        kc.check_records(rm, f"main {name}")
        kc.check_image(im, f"main {name}")
        k = "march_shade_kernel" if inkernel else "shade_kernel"
        err[k] = max(err[k], im["max_abs"])
        steps = int(rec.steps.sum(dtype=torch.int64))
        steps_p = int(rec_p.steps.sum(dtype=torch.int64))
        line = (f"phase 4 main: {name}: hit fraction {hit_frac:.4f}"
                f"{' (camera inside solid)' if _in_solid(grid, cam) else ''}"
                f"; vs "
                f"plain: rgb beyond {kc.RGB_ATOL} on {im['rgb']} px (max "
                f"{im['max_abs']:.3g}), hit/voxel/normal/steps mismatches "
                f"{rm['hit']}/{rm['voxel']}/{rm['normal']}/{rm['steps']}; "
                f"rec.steps total kernel {steps} plain {steps_p}")
        t_k = median_ms(lambda c=cam, s=settings, i=inkernel:
                        render_frame_fused(accel, mats, dims, c, light, s, h,
                                           w, inkernel_shadows=i), device,
                        runs)
        times[name] = {"ms": t_k, "hits": int(rec.hit.sum())}
        line += f"; frame {t_k:.3f} ms ({h * w / t_k / 1e3:.1f} Mrays/s)"
        if inkernel:
            kspec = km.ShadeSpec.from_settings(settings, light,
                                               shadows=settings.shadows)
            t_kern = median_ms(lambda o=o, d=d, sp=kspec: km.march(
                o, d, accel, dims, ms, shade_spec=sp, mats=mats,
                lights_arr=lights_arr), device, runs)
            times[name]["kernel_ms"] = t_kern
            line += f"; kernel alone {t_kern:.3f} ms"
            # the composed frame's plain version is this same function
            t_p = median_ms(lambda c=cam, f=plain: f(*generate_rays(c, h, w)),
                            device, runs)
            times[name]["plain_ms"] = t_p
            line += (f", plain {t_p:.1f} ms "
                     f"({h * w / t_p / 1e3:.2f} Mrays/s)")
        times[name]["steps"] = steps
        print(line)

        if name == "full_shadows_fog_composed":
            # the shade kernel alone at this shape, vs shade_reference
            vis = torch.stack([km.shadow_visibility_reference(
                rec, o, d, accel, dims, ms, light.pos[li])
                for li in range(light.count)], dim=-1)
            vspec = km.ShadeSpec.from_settings(settings, light, use_vis=True,
                                               shadows=False)
            got = km.shade(rec, o, d, vis, mats, lights_arr, vspec)
            want = km.shade_reference(rec, o, d, vis, mats, lights_arr, vspec)
            sm = kc.image_mismatch(got, want)
            kc.check_image(sm, "main shade kernel")
            err["shade_kernel"] = max(err["shade_kernel"], sm["max_abs"])
            t_s = median_ms(lambda: km.shade(rec, o, d, vis, mats, lights_arr,
                                             vspec), device, runs)
            t_sp = median_ms(lambda: km.shade_reference(
                rec, o, d, vis, mats, lights_arr, vspec), device, runs)
            times["shade_kernel"] = {"ms": t_s, "plain_ms": t_sp}
            print(f"phase 4 main: shade kernel alone at {h}x{w}: {t_s:.3f} "
                  f"ms, plain {t_sp:.3f} ms; rgb beyond {kc.RGB_ATOL} on "
                  f"{sm['rgb']} px (max {sm['max_abs']:.3g})")
    return {"launches": launches, "err": err, "times": times, "grid": grid,
            "accel": accel}


DATA = ROOT / "vxtpu_torch" / "data"


def cross_fingerprint(grid, accel) -> None:
    """Voxel count per material and occupied coarse cells of the 512^3
    world against the JAX package's, each within 0.1%."""
    import torch

    fp = json.loads((DATA / "terrain512_seed7.json").read_text())
    counts = torch.bincount(grid.occupancy.reshape(-1).to(torch.int64),
                            minlength=8).tolist()
    worst = 0.0
    for mid, want in fp["material_counts"].items():
        got = counts[int(mid)]
        rel = abs(got - want) / max(want, 1)
        worst = max(worst, rel)
        if rel > 1e-3:
            raise AssertionError(f"material {mid}: {got} voxels, JAX {want}")
    cells = int((accel.words > 0).sum())
    cells_rel = abs(cells - fp["occupied_coarse_cells"]) / \
        fp["occupied_coarse_cells"]
    if cells_rel > 1e-3:
        raise AssertionError(f"occupied coarse cells {cells}, JAX "
                             f"{fp['occupied_coarse_cells']}")
    print(f"phase 5 cross: 512^3 fingerprint: counts {counts[:6]} vs JAX "
          f"{[fp['material_counts'][str(i)] for i in range(6)]} (worst rel "
          f"{worst:.2g}); occupied coarse cells {cells} vs "
          f"{fp['occupied_coarse_cells']}")


def cross_entry_frame(device) -> None:
    """The entry scene's frame against the JAX package's: within 2/255 on
    at least 99.5% of pixels."""
    import numpy as np

    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.render.fused import render_frame_fused
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.utils import load_png, to_uint8_image
    from vxtpu_torch.world import procgen
    from vxtpu_torch.world.lights import Lights
    from vxtpu_torch.world.packed import (build_material_morton,
                                          build_packed_morton)

    dims = (128, 128, 128)
    g = procgen.terrain(dims, seed=7, device=device)
    # entry() aims a 55-degree camera but renders through Camera.make's
    # default 60-degree field of view, and so does the JAX data
    cam = Camera.make(pos=(-90.0, 64.0, 140.0), fov_y_deg=60.0,
                      device=device).look_at((64.0, 64.0, 35.0))
    img = render_frame_fused(
        build_packed_morton(g.occupancy, cap=64),
        build_material_morton(g.occupancy), dims, cam,
        Lights.single((25.0, -38.0, 180.0), intensity=2.0, device=device),
        RenderSettings(shading="full", shadows=True, fog=True), 256, 512)
    got = to_uint8_image(img).astype(np.int32)
    want = load_png(str(DATA / "entry_frame.png")).astype(np.int32)
    if got.shape != want.shape:
        raise AssertionError(f"entry frame {got.shape} vs JAX {want.shape}")
    close = (np.abs(got - want).max(axis=-1) <= 2).mean()
    print(f"phase 5 cross: entry frame 128^3 256x512 full+shadows+fog: "
          f"{close * 100:.3f}% of pixels within 2/255 of JAX's (max "
          f"{np.abs(got - want).max()}/255)")
    if close < 0.995:
        raise AssertionError(f"entry frame: only {close:.4f} of pixels "
                             f"within 2/255 of JAX's")


class StepTimer:
    """Marks the end of each step: CUDA events on the card, the host clock
    after a synchronise on the CPU. ``ms()``: the time between marks."""

    def __init__(self, device):
        self.device = device
        self.marks = []

    def __call__(self, i=None, loss=None) -> None:
        import torch

        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def ms(self) -> list:
        if self.device.type == "cuda":
            self.marks[-1].synchronize()
            return [a.elapsed_time(b)
                    for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


CHUNK = 8192


def _render_target(truth, o, d, settings, S):
    """The plain soft renderer over ray chunks, without autograd."""
    import torch

    from vxtpu_torch.render import soft

    with torch.no_grad():
        return torch.cat([soft.render_soft_rays(
            truth, o[i:i + CHUNK], d[i:i + CHUNK], settings, S)[0]
            for i in range(0, o.shape[0], CHUNK)])


def _grads(model_tabs, plain, o, d, settings, S, lights=None, target=None,
           cot=None, tc=None):
    """Loss (or colour) and gradients to the Morton tables through the
    kernel path, or through the kernels' plain versions."""
    import torch

    from vxtpu_torch.render.soft_kernel import (MortonSoftGrid,
                                                render_soft_rays_kernel)
    from vxtpu_torch.train.loss import mse, tv_loss_morton

    ps = [t.detach().clone().requires_grad_(True) for t in model_tabs]
    out = render_soft_rays_kernel(MortonSoftGrid(*ps), o, d, settings, S,
                                  lights=lights, plain=plain)
    if target is not None:
        loss = (mse(out, target) + tc.tv_sigma * tv_loss_morton(ps[0])
                + tc.tv_rgb * tv_loss_morton(ps[1]))
        return loss.detach(), torch.autograd.grad(loss, ps)
    return out.detach(), torch.autograd.grad(out, ps, cot)


def _device_us(e) -> float:
    us = getattr(e, "self_device_time_total", None)
    return us if us is not None else getattr(e, "self_cuda_time_total", 0.0)


def _profile_step(step, device, big, steps=2):
    """One profiled window of ``steps`` steps (torch.profiler): device time
    per step (ms) by kernel name, the device time of the aten ops whose
    inputs have >= ``big`` elements (work on the dense [D^3] tables other
    than Adam's: zero-fills, gradient accumulation, copies), and the wall
    time per step."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3 / steps
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if (e.key.startswith(("Optimizer.", "ProfilerStep"))
                or getattr(e, "is_user_annotation", False)):
            continue            # record_function ranges, not kernels
        if _device_us(e):
            kernels[e.key] = kernels.get(e.key, 0.0) + \
                _device_us(e) / 1e3 / steps
    dense = {}
    for e in prof.key_averages(group_by_input_shape=True):
        if (e.device_type != torch.autograd.DeviceType.CPU
                or not e.key.startswith("aten::") or "foreach" in e.key):
            continue
        shapes = [sh for sh in (e.input_shapes or []) if isinstance(sh, list)]
        if _device_us(e) and any(sh and math.prod(sh) >= big
                                 for sh in shapes):
            key = f"{e.key} {shapes}"
            dense[key] = dense.get(key, 0.0) + _device_us(e) / 1e3 / steps
    return kernels, dense, wall


def _group_kernels(kernels: dict, dense: float) -> dict:
    """Device ms per step by part: K3, K4, Adam (its multi-tensor
    kernels), the dense-table glue, and the rest (the [S, N] math of
    render_soft_rays_kernel and its autograd)."""
    groups = {"K3 sample_fwd_kernel": 0.0, "K4 sample_bwd_kernel": 0.0,
              "Adam": 0.0, "dense-table glue": dense,
              "[S,N] math": -dense}
    for name, ms in kernels.items():
        low = name.lower()
        if "sample_fwd_kernel" in name:
            groups["K3 sample_fwd_kernel"] += ms
        elif "sample_bwd_kernel" in name:
            groups["K4 sample_bwd_kernel"] += ms
        elif "adam" in low or "multi_tensor" in low:
            groups["Adam"] += ms
        else:
            groups["[S,N] math"] += ms
    return groups


def _touched_words(o, d, t0, dt, S, D) -> int:
    """Distinct table words the active samples' corners read."""
    import torch

    from vxtpu_torch.render import kernel_sample as ks

    seen = torch.zeros(D ** 3, dtype=torch.bool, device=o.device)
    act = (dt > 0)[None, :].expand(S, -1)
    _, px, py, pz = ks._positions(o, d, t0, dt, S)
    codes, _, _, _ = ks._corner_setup(px, py, pz, D)
    for c in codes:
        seen[c[act]] = True
    return int(seen.sum())


def sample_bounds(n, S, D, active_samples, touched, lit=False) -> dict:
    """Least times (ms) of K3 and K4 for one call: the larger of the bytes
    each must move over the HBM rate and its float32 operations over the
    float32 peak. Each input is read once and each output written once:
    K3 reads the rays (32 B each) and the table words its samples touch (4
    tables), and writes nout [S, N] planes; K4 reads the rays, nout
    [S, N] cotangent planes and the touched words, and writes the four
    dense [D^3] gradient tables and the ray cotangents (32 B each)."""
    nout = 7 if lit else 4
    fwd_bytes = n * 32 + 4 * 4 * touched + nout * S * n * 4
    bwd_bytes = n * 32 + nout * S * n * 4 + 4 * 4 * touched \
        + 4 * 4 * D ** 3 + n * 32
    fwd_ops = active_samples * (FWD_OPS + (FWD_OPS_LIT if lit else 0))
    bwd_ops = active_samples * (BWD_OPS + (BWD_OPS_LIT if lit else 0))

    def bound(b, f):
        tb, tf = b / PEAK_BYTES * 1e3, f / PEAK_F32 * 1e3
        return dict(bytes=b, ops=f, bound_ms=max(tb, tf),
                    bound_by="bytes" if tb >= tf else "operations")

    return dict(fwd=bound(fwd_bytes, fwd_ops), bwd=bound(bwd_bytes, bwd_ops))


def phase_train(device, D=FULL, h=256, w=256, S=256, steps=5,
                runs=RUNS) -> dict:
    """Phase 6: the c4_512_diff fit through the sampling kernels."""
    import torch

    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.app.configs import CONFIGS
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render import kernel_sample as ks
    from vxtpu_torch.render import soft
    from vxtpu_torch.render.soft_kernel import MortonSoftGrid, _enter_dt_soft
    from vxtpu_torch.train import loop
    from vxtpu_torch.world import procgen
    from vxtpu_torch.world.lights import Lights

    cfg4 = CONFIGS["c4_512_diff"]
    settings = cfg4.settings
    dims = (D,) * 3
    t0 = time.perf_counter()
    truth = soft.SoftGrid.from_hard(procgen.terrain(
        dims, seed=cfg4.seed, with_rgb=True, device=device))
    cam = Camera.make(pos=(-0.7 * D, 0.5 * D, 1.1 * D),
                      device=device).look_at((0.5 * D, 0.5 * D, 0.27 * D))
    o, d = generate_rays(cam, h, w)
    target = _render_target(truth, o, d, settings, S)
    _sync(device)
    print(f"phase 6 train: {D}^3 truth (from_hard) and a {h}x{w} target "
          f"at S = {S} in {time.perf_counter() - t0:.2f} s; target mean "
          f"{float(target.mean()):.4f}")

    # the main path, counted: five fit_soft steps
    tc = loop.TrainConfig(field_kernel=True, num_samples=S, ray_batch=0,
                          steps=steps, seed=cfg4.seed)
    timer = StepTimer(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ks.reset_launch_counts()
    timer()
    fitted, _, losses, _ = loop.fit_soft(
        soft.SoftGrid.zeros(dims, device=device), cam,
        target.reshape(h, w, 3), settings, tc, step_hook=timer)
    _sync(device)
    launches = dict(ks.LAUNCHES)
    step_ms = timer.ms()
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else float("nan"))
    print(f"phase 6 train: launches during the {steps} steps: {launches}")
    print(f"phase 6 train: losses {losses}")
    print(f"phase 6 train: step ms {[round(x, 3) for x in step_ms]} "
          f"(the first includes the Morton conversion); median of steps "
          f"2..{steps} {statistics.median(step_ms[1:]):.3f} ms; peak memory "
          f"{peak:.2f} GiB")
    if device.type == "cuda" and min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the train path never launched: "
                             f"{launches}")
    if not all(v == v and abs(v) != float("inf") for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")

    # measurement and comparison with the plain versions (not counted)
    err = {}
    m = MortonSoftGrid.from_soft(fitted)
    tabs_fit = (m.sigma_tab, m.rgb_tab)
    del fitted, m
    tflat = target.reshape(-1, 3)
    lk, gk = _grads(tabs_fit, False, o, d, settings, S, target=tflat, tc=tc)
    lp, gp = _grads(tabs_fit, True, o, d, settings, S, target=tflat, tc=tc)
    ex = kc.grads_excess(gk, gp)
    rel = abs(float(lk) - float(lp)) / abs(float(lp))
    print(f"phase 6 train: one step at the fitted state, kernels vs plain "
          f"versions: loss {float(lk):.8f} vs {float(lp):.8f} (rel "
          f"{rel:.3g}); gradient allclose excess {ex:.3g}, max |d| "
          f"{max(float((a - b).abs().max()) for a, b in zip(gk, gp)):.3g}")
    if rel > 1e-6 or ex > 1.0:
        raise AssertionError("train step: kernels and plain versions differ")
    err["sample_bwd_kernel"] = max(float((a - b).abs().max())
                                   for a, b in zip(gk, gp))
    del gk, gp

    light = Lights.single((0.2 * D, -0.3 * D, 1.4 * D), intensity=2.0,
                          device=device)
    m = MortonSoftGrid.from_soft(truth)
    truth_tabs = (m.sigma_tab, m.rgb_tab)
    del truth, m
    g = torch.Generator().manual_seed(0)
    cot = torch.randn(h * w, 3, generator=g).to(device)
    rk, gk = _grads(truth_tabs, False, o, d, settings, S, lights=light,
                    cot=cot)
    rp, gp = _grads(truth_tabs, True, o, d, settings, S, lights=light,
                    cot=cot)
    lit_ex = kc.grads_excess(gk, gp)
    lit_d = float((rk - rp).abs().max())
    print(f"phase 6 train: lit render_soft_rays_kernel at {D}^3, {h}x{w}, "
          f"S = {S}, the config's light: colour max |d| {lit_d:.3g}; "
          f"gradient allclose excess {lit_ex:.3g}")
    if lit_d > 1e-5 or lit_ex > 1.0:
        raise AssertionError("lit path: kernels and plain versions differ")
    err["sample_bwd_kernel"] = max(err["sample_bwd_kernel"], max(
        float((a - b).abs().max()) for a, b in zip(gk, gp)))
    del gk, gp

    # K3 and K4 alone at the main path's shape, on the truth's tables
    tabs = tuple(t.contiguous() for t in (truth_tabs[0], *truth_tabs[1]))
    st, sdt, _ = _enter_dt_soft(o, d, dims, S, None)
    st, sdt = st.contiguous(), sdt.contiguous()
    got = ks.sample_fields_fwd(tabs, o, d, st, sdt, S, D)
    want = ks.sample_fields_fwd_reference(tabs, o, d, st, sdt, S, D)
    err["sample_fwd_kernel"] = max(float((a - b).abs().max())
                                   for a, b in zip(got, want))
    if err["sample_fwd_kernel"] > kc.FWD_ATOL:
        raise AssertionError(f"K3 at the main shape differs by "
                             f"{err['sample_fwd_kernel']}")
    del got, want
    cots = tuple(torch.randn(S, h * w, generator=g).to(device)
                 for _ in range(4))
    times = {}
    times["sample_fwd_kernel"] = dict(
        ms=median_ms(lambda: ks.sample_fields_fwd(tabs, o, d, st, sdt, S, D),
                     device, runs),
        plain_ms=median_ms(lambda: ks.sample_fields_fwd_reference(
            tabs, o, d, st, sdt, S, D), device, 3))
    times["sample_bwd_kernel"] = dict(
        ms=median_ms(lambda: ks.sample_fields_bwd(tabs, o, d, st, sdt, cots,
                                                  D), device, runs),
        plain_ms=median_ms(lambda: ks.sample_fields_bwd_reference(
            tabs, o, d, st, sdt, cots, D), device, 3))
    lib = library_yardstick(tabs, o, d, st, sdt, S, D, cots, device, runs)
    times["sample_fwd_kernel"]["library_ms"] = lib["fwd_ms"]
    times["sample_bwd_kernel"]["library_ms"] = lib["bwd_ms"]
    active = int((sdt > 0).sum()) * S
    touched = _touched_words(o, d, st, sdt, S, D)
    bounds = sample_bounds(h * w, S, D, active, touched)
    for k, b in (("sample_fwd_kernel", bounds["fwd"]),
                 ("sample_bwd_kernel", bounds["bwd"])):
        times[k].update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        print(f"phase 6 train: {k} alone at N = {h * w}, S = {S}: "
              f"{times[k]['ms']:.3f} ms, plain {times[k]['plain_ms']:.3f} "
              f"ms, grid_sample {times[k]['library_ms']:.3f} ms; bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes']:.4g} "
              f"B, {b['ops']:.4g} flop; {touched} table words touched, "
              f"{active} active samples)")

    # where a step's time goes (profiler device times)
    model = MortonSoftGrid(*[t.detach().clone().requires_grad_(True)
                             for t in tabs_fit])
    opt = loop.make_optimizer(tc, [model.sigma_tab, model.rgb_tab])

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loop._loss_fn(model, cam, o, d, tflat, (h, w), settings, tc)
        loss.backward()
        opt.step()

    if device.type == "cuda":
        kernels, dense, wall = _profile_step(step, device, big=D ** 3)
        groups = _group_kernels(kernels, sum(dense.values()))
        busy = sum(kernels.values())
        print(f"phase 6 train: profiled step: wall {wall:.3f} ms, device "
              f"busy {busy:.3f} ms ({busy / wall * 100:.1f}%); by group "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()))
        for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
            print(f"phase 6 train:   kernel {ms:8.3f} ms  {name[:90]}")
        for name, ms in sorted(dense.items(), key=lambda kv: -kv[1])[:6]:
            print(f"phase 6 train:   dense op {ms:8.3f} ms  {name[:90]}")
        times["profile"] = dict(groups=groups, wall_ms=wall, busy_ms=busy)
    return {"launches": launches, "err": err, "times": times,
            "losses": losses, "step_ms": step_ms}


def library_yardstick(tabs, o, d, t0, dt, S, D, cots, device, runs) -> dict:
    """torch.nn.functional.grid_sample on the same samples: 5-D, bilinear
    (trilinear), align_corners=False, border padding, on a row-major
    [1, 4, D, D, D] volume; forward, and its autograd backward to the
    volume and the sample positions. A timing yardstick only: it gives the
    same values inside [0.5, D - 0.5]^3 but not in the half-voxel shell at
    the low faces, where vxtpu's corner clamp differs; the grid's last axis
    is (x, y, z) -> (W, H, D), so a world point p goes in as (pz, py, px)."""
    import torch
    import torch.nn.functional as F

    from vxtpu_torch.render import kernel_sample as ks

    vol = torch.stack([ks.field_from_morton(t, D) for t in tabs])[None]
    _, px, py, pz = ks._positions(o, d, t0, dt, S)
    grid = (torch.stack([pz, py, px], dim=-1) * (2.0 / D) - 1.0)
    grid = grid[None, :, :, None, :].contiguous()          # [1,S,N,1,3]

    def fwd():
        return F.grid_sample(vol, grid, mode="bilinear",
                             padding_mode="border", align_corners=False)

    out = fwd()
    inside = ((px > 0.5) & (px < D - 0.5) & (py > 0.5) & (py < D - 0.5)
              & (pz > 0.5) & (pz < D - 0.5) & (dt > 0)[None, :])
    same = max(float((out[0, c, :, :, 0] - ks.sample_fields_fwd(
        tabs, o, d, t0, dt, S, D)[c])[inside].abs().max()) for c in range(4))
    fwd_ms = median_ms(fwd, device, runs)
    vg = vol.detach().requires_grad_(True)
    gg = grid.detach().requires_grad_(True)
    res = F.grid_sample(vg, gg, mode="bilinear", padding_mode="border",
                        align_corners=False)
    cot = torch.stack(cots)[None, :, :, :, None]

    def bwd():
        return torch.autograd.grad(res, (vg, gg), cot, retain_graph=True)

    bwd_ms = median_ms(bwd, device, runs)
    print(f"phase 6 train: grid_sample yardstick: agrees with K3 within "
          f"{same:.3g} inside [0.5, D - 0.5]^3; forward {fwd_ms:.3f} ms, "
          f"backward {bwd_ms:.3f} ms")
    return dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms, inside_max_abs=same)


def cross_train(device) -> dict:
    """The fit at 32^3 against the JAX package's loss trajectory (rtol
    1e-4), and K3 on fixed inputs against vxtpu's sample_fields_fwd
    checksums (each channel's sum within 1e-5 of its sum of |x|)."""
    import torch

    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.app.configs import CONFIGS
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.render import kernel_sample as ks
    from vxtpu_torch.render import soft
    from vxtpu_torch.train import loop
    from vxtpu_torch.world import procgen

    gold = json.loads((DATA / "c4_fit32_seed7.json").read_text())
    fit = gold["fit"]
    n = fit["dims"]
    dims = (n,) * 3
    settings = CONFIGS["c4_512_diff"].settings
    truth = soft.SoftGrid.from_hard(procgen.terrain(
        dims, seed=fit["seed"], with_rgb=True, device=device))
    cam = Camera.make(pos=(-0.7 * n, 0.5 * n, 1.1 * n),
                      device=device).look_at((0.5 * n, 0.5 * n, 0.27 * n))
    with torch.no_grad():
        target = soft.render_soft_image(truth, cam, settings, fit["height"],
                                        fit["width"], fit["num_samples"])
    tsum = float(target.double().sum())
    tc = loop.TrainConfig(steps=fit["steps"], num_samples=fit["num_samples"],
                          ray_batch=0, seed=fit["seed"], field_kernel=True)
    ks.reset_launch_counts()
    _, _, losses, _ = loop.fit_soft(soft.SoftGrid.zeros(dims, device=device),
                                    cam, target, settings, tc)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, fit["losses"]))
    print(f"phase 7 cross: fit {n}^3 {fit['height']}x{fit['width']} S "
          f"{fit['num_samples']}: losses {losses} vs JAX {fit['losses']} "
          f"(worst rel {rel:.3g}); target sum {tsum:.6f} vs JAX "
          f"{fit['target_sum']:.6f}; launches {dict(ks.LAUNCHES)}")
    if rel > 1e-4:
        raise AssertionError(f"the 32^3 fit differs from JAX's by rel {rel}")
    if device.type == "cuda" and min(ks.LAUNCHES.values()) == 0:
        raise AssertionError("the 32^3 fit did not run the kernels")

    sf = gold["sample_fwd"]
    fields, o, d, t0, dt, S = kc.golden_sample_inputs()
    tabs = tuple(ks.build_field_morton(torch.from_numpy(f).to(device))
                 for f in fields)
    outs = ks.sample_fields_fwd(tabs, *(torch.from_numpy(x).to(device)
                                        for x in (o, d, t0, dt)), S,
                                sf["D"], lit=sf["lit"])
    worst = 0.0
    for x, want, scale in zip(outs, sf["sum"], sf["abs_sum"]):
        worst = max(worst, abs(float(x.double().sum()) - want) / scale)
    print(f"phase 7 cross: K3 lit on the fixed {sf['n']} rays, S {S}: "
          f"channel sums within {worst:.3g} of JAX's (relative to the sum "
          f"of |x|)")
    if worst > 1e-5:
        raise AssertionError(f"K3 checksums differ from JAX's by {worst}")
    return {"losses": losses, "rel": rel}


def k1_k2_bounds(times, h, w, n_lights=1) -> dict:
    """Least times (ms) of K1 (lambert frame) and K2 (the shade kernel
    alone). Bytes: each ray's inputs (o, d: 24 B) and outputs (K1: hit,
    t, voxel, normal, steps, rgb = 45 B; K2 reads hit, t, voxel, normal
    and the visibility and writes rgb), plus one material word per hit
    ray. The occupancy words each march reads are not counted (so this is
    a lower bound). Operations: MARCH_OPS_RAY per ray and MARCH_OPS_STEP
    per DDA step."""
    n = h * w
    lam = times["lambert"]
    k1_bytes = n * (24 + 45) + lam["hits"] * 4
    k1_ops = n * MARCH_OPS_RAY + lam["steps"] * MARCH_OPS_STEP
    comp = times["full_shadows_fog_composed"]
    k2_bytes = n * (24 + 29 + 4 * n_lights + 12) + comp["hits"] * 4
    k2_ops = n * MARCH_OPS_RAY * (1 + n_lights)
    out = {}
    for k, b, f in (("march_shade_kernel", k1_bytes, k1_ops),
                    ("shade_kernel", k2_bytes, k2_ops)):
        tb, tf = b / PEAK_BYTES * 1e3, f / PEAK_F32 * 1e3
        out[k] = dict(bound_ms=max(tb, tf),
                      bound_by="bytes" if tb >= tf else "operations")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--save", default=None,
                   help="directory for the main-path frames as PNGs")
    args = p.parse_args(argv)
    _require_checkout()
    device, name, smi = phase_device()
    phase_build()
    err3 = phase_kernels(device)
    main_run = phase_main(device, save=args.save)
    cross_fingerprint(main_run["grid"], main_run["accel"])
    del main_run["grid"], main_run["accel"]
    cross_entry_frame(device)
    train = phase_train(device)
    cross_train(device)

    import torch

    times = main_run["times"]
    tt = train["times"]
    bounds = k1_k2_bounds(times, H, W)
    kernels = [
        {"name": "march_shade_kernel", "route": "cuda",
         "source": "vxtpu_torch/csrc/march.cu",
         "replaces": "vxtpu/render/kernel_pallas_v2.py:434",
         "launches": main_run["launches"]["march_shade_kernel"],
         "max_abs_err": max(err3["march_shade_kernel"],
                            main_run["err"]["march_shade_kernel"]),
         "ms": times["lambert"]["kernel_ms"],
         "plain_ms": times["lambert"]["plain_ms"],
         **bounds["march_shade_kernel"], "library_ms": None},
        {"name": "shade_kernel", "route": "cuda",
         "source": "vxtpu_torch/csrc/march.cu",
         "replaces": "vxtpu/render/kernel_pallas_v2.py:1219",
         "launches": main_run["launches"]["shade_kernel"],
         "max_abs_err": max(err3["shade_kernel"],
                            main_run["err"]["shade_kernel"]),
         "ms": times["shade_kernel"]["ms"],
         "plain_ms": times["shade_kernel"]["plain_ms"],
         **bounds["shade_kernel"], "library_ms": None},
    ]
    for k, line in (("sample_fwd_kernel", 213), ("sample_bwd_kernel", 434)):
        kernels.append({
            "name": k, "route": "cuda",
            "source": "vxtpu_torch/csrc/sample.cu",
            "replaces": f"vxtpu/render/kernel_sample.py:{line}",
            "launches": train["launches"][k],
            "max_abs_err": max(err3[k], train["err"][k]),
            "ms": tt[k]["ms"], "plain_ms": tt[k]["plain_ms"],
            "bound_ms": tt[k]["bound_ms"], "bound_by": tt[k]["bound_by"],
            "library_ms": tt[k]["library_ms"]})
    print(json.dumps({"kernels": kernels, "gpu": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
