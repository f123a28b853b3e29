"""The control that sets the upper reading of a pipeline cell's
``px_off_share``: the plain reference (``reference/pipeline.py``) put in
the program's place, computed in a lower precision than the configuration
states (``--mode bfloat16``), against the reference as the configuration
states it, at the cell's own size.

    python3 vxbench/control_pipeline.py --workload c3_256_pipeline.orbit \
        --mode bfloat16 --seeds 11 12 13

prints one JSON line a seed with the numbers the cell compares. The
benchmark's own runs never run it. On the GPU only, unless ``--device
cpu`` (with ``--small``, the sizes the tests use).
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from vxbench import camera, harness, world  # noqa: E402
from vxbench.reference import pipeline as rpipe  # noqa: E402

# sizes of the CPU tests
SMALL = dict(dims=(32, 32, 32), height=24, width=32)


def pipeline_control(cell, seed: int, mode: str, device, sizes: dict,
                     frames: int = 1) -> dict:
    """px_off_share of the reference in ``mode``'s precision against the
    reference in the configuration's, over ``frames`` frames at camera
    times drawn from the seed (one is enough to read the share)."""
    cfg, tr = cell.config, cell.traffic
    dims = tuple(sizes.get("dims", cfg["dims"]))
    h, w = sizes.get("height", cfg["height"]), sizes.get("width",
                                                         cfg["width"])
    occ, rgb = world.terrain(dims, cfg["scene_seed"], device)
    top = world.top_height(occ)
    words, rgb_flat = rpipe.packed_table(occ), rgb.reshape(-1, 3)
    lights = [(tuple(p * n for p, n in zip(li["pos"], dims)),
               tuple(li["rgb"]), float(li["intensity"]))
              for li in cfg["lights"]]
    rng = random.Random(seed)
    loop = int(round(tr["period_s"] * tr["fps"]))
    tol = float(cfg["check"]["pixel_tol"])
    off = n = 0
    for _ in range(frames):
        t_cam = rng.randrange(loop) / tr["fps"]
        pos, yaw, pitch, fov = camera.pose(tr, dims, top, t_cam, device)
        o, d = camera.rays(pos, yaw, pitch, fov, h, w)
        imgs = [rpipe.render(o.to(dt), d.to(dt), words, rgb_flat, dims,
                             lights, cfg["settings"]).float()
                for dt in (getattr(torch, cfg["check"]["dtype"]),
                           getattr(torch, mode))]
        off += int(((imgs[0] - imgs[1]).abs().amax(dim=-1) > tol).sum())
        n += h * w
    return {"px_off_share": off / n}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True, choices=("bfloat16", "float16"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(harness.load_manifest(ROOT), args.workload)
    if cell.config["kind"] != "pipeline_render":
        print(f"{args.workload} is no pipeline cell: run vxbench/control.py",
              file=sys.stderr)
        return 2
    for seed in args.seeds:
        nums = pipeline_control(cell, seed, args.mode, device,
                                SMALL if args.small else {})
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "numbers": nums,
                          "limits": cell.config["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
