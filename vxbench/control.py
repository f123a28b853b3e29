"""The controls and faults that set each number's upper reading: the
plain reference put in the program's place, computed in a lower precision
than the configuration states (``--mode bfloat16``) or with half of the
batch left out (``--mode half_batch``, training cells), against the
reference as the configuration states it, at the cell's own size.

    python3 vxbench/control.py --workload <cell> --mode bfloat16 \
        --seeds 11 12 13

prints one JSON line a seed with the numbers the cell compares. The
benchmark's own runs never run it. On the GPU only, unless ``--device
cpu`` (with ``--small``, the sizes the tests use).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from vxbench import camera, harness, world  # noqa: E402
from vxbench.drivers import gap  # noqa: E402
from vxbench.drivers import soft_fit  # noqa: E402
from vxbench.reference import march as rmarch  # noqa: E402
from vxbench.reference import soft as rsoft  # noqa: E402

# sizes of the CPU tests
SMALL = {"fused_render": dict(dims=(32, 32, 32), height=24, width=32),
         "soft_fit": dict(dims=(16, 16, 16), height=8, width=8, samples=8,
                          target_samples=8, ray_block=32)}


def render_control(cell, seed: int, mode: str, device, sizes: dict,
                   frames: int = 1) -> dict:
    """px_off_share of the reference in ``mode``'s precision against the
    reference in the configuration's, over ``frames`` frames at camera
    times drawn from the seed (one is enough to read the share)."""
    import random

    cfg, tr = cell.config, cell.traffic
    dims = tuple(sizes.get("dims", cfg["dims"]))
    h, w = sizes.get("height", cfg["height"]), sizes.get("width",
                                                         cfg["width"])
    occ, rgb = world.terrain(dims, cfg["scene_seed"], device)
    top = world.top_height(occ)
    words, albedo = rmarch.cell_table(occ), rmarch.rgb8_albedo(rgb)
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
        imgs = [rmarch.render(o.to(dt), d.to(dt), words, albedo, dims,
                              lights, cfg["settings"]).float()
                for dt in (getattr(torch, cfg["check"]["dtype"]),
                           getattr(torch, mode))]
        off += int(((imgs[0] - imgs[1]).abs().amax(dim=-1) > tol).sum())
        n += h * w
    return {"px_off_share": off / n}


def train_control(cell, seed: int, mode: str, device, sizes: dict) -> dict:
    """The training cell's numbers with the reference in ``mode`` in the
    program's place: loss_gap, grad_gap and change_gap over the first
    three steps; with the mask, refresh_loss_gap of a refresh from the
    starting grid."""
    cfg, tr = cell.config, cell.traffic
    dims = tuple(sizes.get("dims", cfg["dims"]))
    D = dims[0]
    h, w = sizes.get("height", cfg["height"]), sizes.get("width",
                                                         cfg["width"])
    S = sizes.get("samples", tr["samples"])
    block = sizes.get("ray_block", cfg["check"]["ray_block"])
    o, d = soft_fit.view_rays(cfg, dims, h, w, device)
    truth = soft_fit.truth_table(dims, seed, device)
    target = rsoft.render_blocks(truth, o, d, D,
                                 sizes.get("target_samples",
                                           cfg["target_samples"]),
                                 cfg["settings"], block)
    del truth
    tab0 = soft_fit.start_table(tr, dims, seed, device)
    G = int(tr.get("mask_scale", 4))
    masked = bool(tr["occ_mask"])
    ones = torch.ones((D // G,) * 3, dtype=torch.uint8, device=device)
    mask_fn = ((lambda p: soft_fit.band_kwargs(ones, G, o, d)) if masked
               else None)
    base = getattr(torch, cfg["check"]["dtype"])
    ref = soft_fit.reference_steps(tab0, o, d, target, D, S, cfg, 3, base,
                                   block, mask_fn)
    low = soft_fit.reference_steps(
        tab0, o, d, target, D, S, cfg, 3,
        base if mode == "half_batch" else getattr(torch, mode), block,
        mask_fn, half_batch=mode == "half_batch")
    out = {"loss_gap": max(gap(p, q) for p, q in zip(low[0], ref[0])),
           "grad_gap": soft_fit.leaf_gap(low[1], ref[1], ref[1]),
           "change_gap": soft_fit.leaf_gap(low[2], ref[2], ref[1])}
    if masked:
        t = cfg["train"]
        variant = ((base, True) if mode == "half_batch"
                   else (getattr(torch, mode), False))
        losses = []
        for dt, half in ((base, False), variant):
            p = tab0.to(dt)
            n = o.shape[0] // 2 if half else o.shape[0]
            mask = rsoft.occupancy_mask(p, D, G, float(tr["mask_tau"]))
            losses.append(rsoft.loss(
                p, o[:n], d[:n], target[:n], D, S, cfg["settings"],
                (t["tv_sigma"], t["tv_rgb"]), block,
                **soft_fit.band_kwargs(mask, G, o[:n], d[:n])))
        out["refresh_loss_gap"] = gap(losses[1], losses[0])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True,
                   choices=("bfloat16", "float16", "half_batch"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(harness.load_manifest(ROOT), args.workload)
    kind = cell.config["kind"]
    sizes = SMALL[kind] if args.small else {}
    fn = render_control if kind == "fused_render" else train_control
    for seed in args.seeds:
        nums = fn(cell, seed, args.mode, device, sizes)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "numbers": nums,
                          "limits": cell.config["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
