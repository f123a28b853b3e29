"""Write the JAX-side cross-check data that vxtpu_torch is held to on the
GPU (``chip_smoke.py`` phase 5), where JAX is not installed.

Runs on the CPU with the JAX package:

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py

and writes, under ``vxtpu_torch/data/``:

  terrain512_seed7.json   the fingerprint of
                          vxtpu.world.procgen.terrain((512,)*3, seed=7):
                          voxel count per material id and the number of
                          occupied 2x2x2 coarse cells;
  entry_frame.png         the frame of __graft_entry__.entry()'s scene
                          (128^3 terrain, seed 7, 256x512, full + shadows
                          + fog, light (25, -38, 180) at intensity 2)
                          rendered by vxtpu's fused path in interpret mode;
  c4_fit32_seed7.json     config 4's fit cut to 32^3 (terrain seed 7,
                          one 64x64 view, S = 16, 5 steps, default TV
                          weights) through vxtpu's fit_soft(field_kernel=
                          True): the loss per step; and the checksums of
                          vxtpu's sample_fields_fwd (lit, interpret mode)
                          on the fixed inputs of
                          vxtpu_torch.kernel_check.golden_sample_inputs;
  packed_seed7.json       checksums of vxtpu's row-major build_packed
                          words for the 256^3 terrain of seed 7, and of
                          the HitRecord of vxtpu's march_pallas
                          (interpret mode) over the 64^3 terrain of seed 7
                          on the fixed rays of
                          vxtpu_torch.kernel_check.golden_march_inputs.

``--only c4`` writes only c4_fit32_seed7.json (a few minutes: the Pallas
kernels run in interpret mode); ``--only packed`` writes only
packed_seed7.json.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OUT = ROOT / "vxtpu_torch" / "data"


def fingerprint() -> dict:
    from vxtpu.world import procgen

    occ = np.asarray(procgen.terrain((512, 512, 512), seed=7).occupancy)
    counts = np.bincount(occ.reshape(-1), minlength=8)
    coarse = occ.reshape(256, 2, 256, 2, 256, 2).any(axis=(1, 3, 5))
    return {
        "source": "vxtpu.world.procgen.terrain((512, 512, 512), seed=7)",
        "material_counts": {str(i): int(c) for i, c in enumerate(counts)},
        "occupied_coarse_cells": int(coarse.sum()),
    }


def entry_frame() -> np.ndarray:
    from __graft_entry__ import entry

    # entry() builds the compiled-kernel frame; render the same scene and
    # tables in interpret mode so that it runs on the CPU
    _, args = entry()
    from vxtpu.camera.camera import Camera
    from vxtpu.render.fused import render_frame_fused
    from vxtpu.render.settings import RenderSettings
    from vxtpu.world.lights import Lights
    from vxtpu.world.packed import PackedMorton

    words, mats, pos, yaw, pitch = args
    cam = Camera.make((0.0, 0.0, 0.0)).replace(pos=pos, yaw=yaw, pitch=pitch)
    img = render_frame_fused(
        PackedMorton(words=words), mats, (128, 128, 128), cam,
        Lights.single((25.0, -38.0, 180.0), intensity=2.0),
        RenderSettings(shading="full", shadows=True, fog=True), 256, 512,
        interpret=True)
    return np.asarray(img)


C4 = dict(dims=32, height=64, width=64, num_samples=16, steps=5, seed=7)


def c4_fit() -> dict:
    """vxtpu's config-4 fit at 32^3 through the Pallas field kernels, as
    cmd_train runs it (single view)."""
    from vxtpu.app.configs import CONFIGS
    from vxtpu.camera.camera import Camera
    from vxtpu.render.soft import SoftGrid, render_soft_image
    from vxtpu.train.loop import TrainConfig, fit_soft
    from vxtpu.world import procgen

    n = C4["dims"]
    dims = (n,) * 3
    settings = CONFIGS["c4_512_diff"].settings
    truth = SoftGrid.from_hard(procgen.terrain(dims, seed=C4["seed"],
                                               with_rgb=True))
    cam = Camera.make(pos=(-0.7 * n, 0.5 * n, 1.1 * n)).look_at(
        (0.5 * n, 0.5 * n, 0.27 * n))
    target = render_soft_image(truth, cam, settings, C4["height"],
                               C4["width"], C4["num_samples"])
    cfg = TrainConfig(steps=C4["steps"], num_samples=C4["num_samples"],
                      ray_batch=0, seed=C4["seed"], field_kernel=True)
    _, _, losses, _ = fit_soft(SoftGrid.zeros(dims), cam, target, settings,
                               cfg)
    return dict(C4, losses=[float(v) for v in losses],
                target_sum=float(np.asarray(target, np.float64).sum()))


def sample_checksums() -> dict:
    """Per-channel sum and sum of |x| (float64) of vxtpu's
    sample_fields_fwd, lit, on the fixed inputs."""
    import jax.numpy as jnp

    from vxtpu.render.kernel_sample import (build_field_morton,
                                            sample_fields_fwd)
    from vxtpu_torch.kernel_check import golden_sample_inputs

    fields, o, d, t0, dt, S = golden_sample_inputs()
    D = fields[0].shape[0]
    tabs = tuple(build_field_morton(jnp.asarray(f)) for f in fields)
    outs = sample_fields_fwd(tabs, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(t0), jnp.asarray(dt), S, D, lit=True,
                             interpret=True)
    outs = [np.asarray(x, np.float64) for x in outs]
    return dict(D=D, n=int(o.shape[0]), S=S, lit=True,
                sum=[float(x.sum()) for x in outs],
                abs_sum=[float(np.abs(x).sum()) for x in outs])


PACKED = dict(table_dims=256, D=64, n=4096, seed=5, terrain_seed=7)


def packed_checksums() -> dict:
    """Checksums of vxtpu's build_packed table at 256^3 and of its
    march_pallas record at 64^3 (interpret mode)."""
    import jax.numpy as jnp
    import torch

    from vxtpu.render.kernel_pallas import march_pallas
    from vxtpu.world import procgen
    from vxtpu.world.packed import build_packed
    from vxtpu_torch.kernel_check import (golden_march_inputs,
                                          march_checksums, table_checksums)

    T = PACKED["table_dims"]
    g = procgen.terrain((T,) * 3, seed=PACKED["terrain_seed"])
    cells = (T // 2) ** 3
    words = np.asarray(build_packed(g.occupancy).words).reshape(-1)[:cells]
    table = dict(dims=T, checksums=table_checksums(
        torch.from_numpy(words.astype(np.int64))))

    D = PACKED["D"]
    dims = (D,) * 3
    o, d, t_max = golden_march_inputs(D, PACKED["n"], PACKED["seed"])
    acc = build_packed(procgen.terrain(dims,
                                       seed=PACKED["terrain_seed"]).occupancy)
    max_steps = 3 * D + 2
    rec = march_pallas(jnp.asarray(o), jnp.asarray(d), acc, dims, max_steps,
                       t_max=jnp.asarray(t_max), interpret=True)
    march = dict(D=D, n=PACKED["n"], seed=PACKED["seed"],
                 terrain_seed=PACKED["terrain_seed"], max_steps=max_steps,
                 checksums=march_checksums(rec.hit, rec.t, rec.voxel,
                                           rec.normal, rec.steps, dims))
    return dict(source="vxtpu.world.packed.build_packed and "
                       "vxtpu.render.kernel_pallas.march_pallas("
                       "interpret=True)", table=table, march=march)


def main() -> int:
    import argparse

    from vxtpu_torch.utils import save_png

    p = argparse.ArgumentParser()
    p.add_argument("--only", choices=["c4", "packed"], default=None)
    args = p.parse_args()
    OUT.mkdir(parents=True, exist_ok=True)
    if args.only in (None, "packed"):
        t0 = time.perf_counter()
        pk = packed_checksums()
        (OUT / "packed_seed7.json").write_text(json.dumps(pk, indent=1)
                                               + "\n")
        print(f"packed checksums in {time.perf_counter() - t0:.1f} s: {pk}")
        if args.only:
            return 0
    t0 = time.perf_counter()
    c4 = dict(source="vxtpu.train.loop.fit_soft(field_kernel=True) and "
                     "vxtpu.render.kernel_sample.sample_fields_fwd("
                     "interpret=True)",
              fit=c4_fit(), sample_fwd=sample_checksums())
    (OUT / "c4_fit32_seed7.json").write_text(json.dumps(c4, indent=1) + "\n")
    print(f"c4 fit and sample checksums in {time.perf_counter() - t0:.1f} s:"
          f" {c4}")
    if args.only:
        return 0
    t0 = time.perf_counter()
    fp = fingerprint()
    (OUT / "terrain512_seed7.json").write_text(json.dumps(fp, indent=1) + "\n")
    print(f"fingerprint in {time.perf_counter() - t0:.1f} s: {fp}")
    t0 = time.perf_counter()
    img = entry_frame()
    save_png(str(OUT / "entry_frame.png"), img)
    print(f"entry frame {img.shape} in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
