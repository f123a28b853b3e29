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
             scene against the JAX package's data in vxtpu_torch/data.

The line before the last is one JSON object with the kernels' counts,
errors and times; the last line is {"ok": true, "device": {...}}.
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
        times[name] = {"ms": t_k}
        line += f"; frame {t_k:.3f} ms ({h * w / t_k / 1e3:.1f} Mrays/s)"
        if inkernel:
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
    cross_entry_frame(device)

    import torch

    times = main_run["times"]
    kernels = [
        {"name": "march_shade_kernel", "route": "cuda",
         "source": "vxtpu_torch/csrc/march.cu",
         "replaces": "vxtpu/render/kernel_pallas_v2.py:434",
         "launches": main_run["launches"]["march_shade_kernel"],
         "max_abs_err": max(err3["march_shade_kernel"],
                            main_run["err"]["march_shade_kernel"]),
         "ms": times["lambert"]["ms"],
         "plain_ms": times["lambert"]["plain_ms"]},
        {"name": "shade_kernel", "route": "cuda",
         "source": "vxtpu_torch/csrc/march.cu",
         "replaces": "vxtpu/render/kernel_pallas_v2.py:1219",
         "launches": main_run["launches"]["shade_kernel"],
         "max_abs_err": max(err3["shade_kernel"],
                            main_run["err"]["shade_kernel"]),
         "ms": times["shade_kernel"]["ms"],
         "plain_ms": times["shade_kernel"]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels, "gpu": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
