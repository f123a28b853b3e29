"""The control and the planted faults that set the upper readings of a
config-5 cell's numbers, at the cell's own size:

- ``--mode bfloat16`` (or ``float16``): the plain reference
  (``reference/config5.py``) put in the program's place, computed in a
  lower precision than the configuration states, against the reference
  as the configuration states it, both following the checked frame from
  the program's state at its start;
- ``--mode <fault>``: the cell's run with the fault planted in the program
  (``drivers/config5_fit.py:_planted``: ``camera_grad_dropped``,
  ``normal_grad_dropped``, ``half_rays``, ``state_unchanged``), checked as
  the benchmark checks it.

    python3 vxbench/control_config5.py --workload c5_1080p_pod.anim_fit \
        --mode bfloat16 --seeds 11 12 13

prints one JSON line a seed with the numbers the cell compares. The
window is ``--seconds`` long (default 0: one frame after frame 0, so the
checked frame is frame 2). The benchmark's own runs never run it. On the
GPU only, unless ``--device cpu`` (with ``--small``, the sizes the tests
use).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from vxbench import harness  # noqa: E402
from vxbench.drivers import Run  # noqa: E402
from vxbench.drivers import config5_fit as drv  # noqa: E402

FAULTS = ("camera_grad_dropped", "normal_grad_dropped", "half_rays",
          "state_unchanged")
# sizes of the CPU tests
SMALL = dict(dims=(16, 16, 16), height=8, width=8, num_samples=8, frames=3,
             ray_block=32)


def config5_control(cell, seed: int, mode: str, device, sizes: dict,
                    seconds: float = 0.0) -> dict:
    """The cell's numbers with ``mode`` (a fault, or a dtype of the
    reference) in the program's place."""
    r = Run(cell=cell, seed=seed, seconds=seconds, trace=False,
            device=device, t_start=time.perf_counter(), sizes=sizes,
            faults=(mode,) if mode in FAULTS else ())
    if mode in FAULTS:
        checks = drv.run(r).checks
    else:
        p = drv.program_run(r, until_start=True)
        block = int(sizes.get("ray_block", p["cfg"]["check"]["ray_block"]))
        want = drv.frame_numbers(p["start"], p["cfg"], device, block)
        got = drv.frame_numbers(p["start"], p["cfg"], device, block,
                                getattr(torch, mode))
        checks = drv.checks_of(got, want, p["cfg"]["limits"])
    return {k: c["value"] for k, c in checks.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True,
                   choices=("bfloat16", "float16") + FAULTS)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(harness.load_manifest(ROOT), args.workload)
    if cell.config["kind"] != "config5_fit":
        print(f"{args.workload} is no config-5 cell: run vxbench/control.py",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    for seed in args.seeds:
        nums = config5_control(cell, seed, args.mode, device,
                               SMALL if args.small else {}, args.seconds)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "numbers": nums,
                          "limits": cell.config["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
