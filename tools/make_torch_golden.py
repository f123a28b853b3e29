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
                          rendered by vxtpu's fused path in interpret mode.
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


def main() -> int:
    from vxtpu_torch.utils import save_png

    OUT.mkdir(parents=True, exist_ok=True)
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
