#!/usr/bin/env python3
"""Drive vxtpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--save DIR] [--k5-times | --k1-times |
                           --k6-times | --tv-times | --adam-times |
                           --scale-out | --bench]
                          [--sass FILE]

Run from the root of a checkout; it needs one CUDA device and nvcc.
Phases, each printing what it found (any failure raises, exit code != 0):

  1. device  the card's name and power limit (nvidia-smi);
  2. build   compile the CUDA kernels of vxtpu_torch/csrc with nvcc;
  3. kernels each kernel against its plain PyTorch version on the card,
             64^3 scenes at 256x256 (vxtpu_torch.kernel_check), each
             instantiation of K1 (march_shade_kernel) on every ray and
             pixel, the TV prior's kernel pair (train/kernel_tv.py),
             Adam's kernel against torch's foreach step
             (train/kernel_adam.py);
  4. main    the full-size path: 512^3 terrain (seed 7), Morton tables,
             and five 1080x1920 frames through render_frame_fused
             (outside camera lambert; full + shadows + fog in-kernel and
             composed; the bench's inside camera, which sits in solid rock,
             lambert; an inside camera in the air, lambert). Launch counts
             (K1's by instantiation), finiteness, hit fraction, agreement
             with the plain versions (K1: hit, voxel, normal and steps on
             every ray, rgb within 1e-5 on every pixel), median frame
             times, the kernel alone (events and profiler device time)
             and total march steps;
  5. cross   the 512^3 world fingerprint and the frame of the 128^3 entry
             scene against the JAX package's data in vxtpu_torch/data;
  6. train   the config-4 trainer (c4_512_diff as its config defines it):
             512^3 terrain (seed 7) -> SoftGrid.from_hard truth -> one
             256x256 target view at S = 256 (plain soft renderer, in ray
             chunks) -> five fit_soft steps from SoftGrid.zeros through the
             field-sampling kernels K3/K4 (K4's pure scatter: the rays
             carry no gradient), the TV prior's kernel pair and Adam's
             kernel. Launch counts per K4 variant, per TV kernel and of
             Adam's kernel (one a step), the loss
             per step (finite and falling), median step time, peak
             memory; two steps refining the camera pose (K4 with
             kRayGrads, counted); one step's loss and gradient through
             the plain versions against the kernels', a lit forward and
             backward at 512^3, K3 and both K4 variants alone against
             their plain versions and torch's grid_sample (the library
             yardstick, used nowhere in the port), and a profiled step's
             device time by group (K3, K4, Adam, the TV prior, the other
             dense-table glue, the [S, N] math); the ray sum alone warm
             and with the L2 flushed before each launch, and K4's
             wrapper's zero-fill of the dense gradient on its own line
             (K4's bound counts only the rows its samples touch). The
             scene is one channel-interleaved [D^3, 4] Morton table that
             K3 reads and K4 scatters into; then tv_times and
             adam_times (below) at 512^3;
  7. cross   the fit at 32^3 against the JAX package's loss trajectory and
             K3's outputs against its checksums (vxtpu_torch/data);
  8. pipeline the composable render pipeline (render / animate / bench
             --kernel pallas) through the row-major march kernel K5:
             K5 against its plain version (64^3 and non-cubic cases, ray
             counts that leave a partial last block, then every primary
             and shadow ray of the c3_256_shadows frame, exactly); the c3
             frame (256^3 terrain seed 7, per-voxel RGB,
             1024x1024, full + shadows + fog) through render_image, with
             and without the face-texture atlas; K5 against K1 (march-
             only) on the 512^3/1080p lambert frame of phase 4; K1 alone
             on those rays in each launch mode (march only, lambert, full
             + shadows + fog) and K1' round 0, each against its plain
             version and its own bound, with its device time (profiler,
             CUDA graph) and the blocks an SM of each K1 instantiation
             (k1_times, k1_occupancy); K5's
             device time per launch on the c3 primary and shadow rays and
             at 512^3 (profiler; cross-checked by the same launches
             replayed from a CUDA graph; one window's launches listed),
             its bounds at each with the table words its marches read (2
             B each: the bricked table), and the blocks it holds an SM;
             the animate
             and bench commands; K5 and the row-major table against the
             JAX package's checksums (vxtpu_torch/data/packed_seed7.json).
             Runs between phases 5 and 6, on phase 4's 512^3 world;
  9. resume  the last two TPU kernels, on phase 4's 512^3 world (run after
             phase 8): the resume-mode march K1' (march_resume_kernel)
             against its plain version at 64^3 (budgets 0, 1, 3, 24, and
             the resume from the plain round 0) and on all 1080x1920
             lambert rays (budget 24, then a resume); the march-cost probe
             K6 (march_probe_kernel, k6_probe) against its plain version
             for every variant and layout (morton16, rowmajor32,
             bricked16) at 64^3, also in the 4x8 block ray order and in
             the TPU probe's float step (with the identity-table words),
             and on the 1080x1920 rays at 48 iterations for every variant
             x layout x ray order (scanline, block32x32, block4x8) and
             both steps, the two steps' plain versions equal; the sorted
             multi-round march march_sorted on the lambert and the
             inside_air_lambert rays against single-round K1 march-only,
             with a forced drain; the warp coherence of the single round,
             of the survivors in launch order and of the sorted resume
             round; the times: K1' round 0 and resume rounds beside K1
             march-only (profiler device times), the sorted march and
             an argsort alone (sorted_probe), K6's device ms and ns per
             ray-iteration for each ray order x variant x layout x {128,
             256, 512} threads (cost_probe, K1's step) with its reads per
             ray-iteration and bound (the distinct table words its plain
             version reads), the float step (the form first ported) on
             full/morton16/256/scanline beside it, each K6
             instantiation's registers and blocks of 256 threads an SM,
             and the instructions of full's SASS loops (cuobjdump);
 10. xla+mask the CLI's default march and the masked trainer (run after
             phase 9; neither uses phase 4's world: the c3 frame is 256^3
             with per-voxel RGB, the masked fit's truth 512^3 with RGB).
             (a) the c3_256_shadows frame (256^3 terrain seed 7, per-voxel
             RGB, 1024x1024, full + shadows + fog) through the batched
             march (render/kernel_xla.py, plain tensor code) over the
             distance field (cap 24) and over the 2-level pyramid: its
             primary and shadow rays against K5's (hit flags agree on
             >= 99.8%; where both hit, t within rtol 1e-4 / atol 1e-3,
             voxel >= 99.8% and normal >= 99.5% equal), the frame against
             the K5 pipeline frame (pixels beyond 1/255), median frame
             time, mean steps a ray, chunks (host syncs) a march, device
             kernels and busy time a frame (profiler), and the render
             (both accelerations) and bench commands with --kernel xla;
             (b) the occupancy-masked c4 fit: 512^3 truth (seed 7,
             from_hard), one 256x256 target at S = 256, the warm state
             (0.8 x the truth), its 128^3 mask (G = 4, tau 0.01, dilate
             1), its distance field and compute_mask_bounds: the occupied
             share, band over full segment, the bounds pass alone; the
             bounds conservative on all 65,536 rays; S = 64 on the bands
             against S = 256 on the whole segment (mean |d rgb| < 0.015);
             one masked step through K3/K4 against their plain versions;
             the masked step at S = 64 and the unmasked at S = 256 (ms,
             peak memory, loss, K3/K4 launches); K3 and K4's scatter alone
             at the masked shape with their bounds; five fit_soft steps
             from zeros with the mask rebuilt at steps 2 and 4 (counted:
             K3 and K4 once a step; losses finite and falling); and
             train --field-kernel --occmask at c4's size.
 11. scale-out the platform checks and the sharded paths (run last, on a
             1-rank NCCL process group of this process: NCCL cannot put
             two ranks on one card). (a) validate_platform (sm_90, the
             card's memory) and the info command; (b) config 5 through
             run_config5 as c5_1080p_pod defines it (512^3 truth, seed 7,
             per-voxel RGB; 1080x1920, S = 192, full shading with one
             light, the custom backward of render/vjp.py), its first 3
             of 24 frames x 2 steps: losses finite, yaw and pitch errors
             below 0.03, frame ms, peak memory; then from its final
             state the step's time (events), the forward and the
             backward alone, a profiled step's device time by group and
             the target render; and the custom backward against autograd
             through the plain renderer on 4,096 of the frame's rays;
             (c) phase 4's 512^3/1080p lambert and full + shadows + fog
             frames through render_frame_fused_sharded, equal to
             render_frame_fused on every pixel (K1 launches counted);
             (d) the sharded field-kernel step (K3/K4) at c4's size from
             zeros and the masked one (S = 64 on the bands) from the
             warm state: loss and table gradient against the
             single-device kernel path with phase 6's limits, then one
             step each (launches counted); (e) at 64^3, 256x256: the
             pipeline frame (K5), the fused frame (K1) and config 5's
             step with 4 buckets on 2 gloo ranks that share the card
             (engine/platform.run_local) against the 1-rank run (frames
             on every pixel, the step's loss and gradients allclose),
             dryrun_multichip(2), and scaling --kernel fused at world 1.
 12. bench   the reference march, the wavefront march and the bench (run
             after phase 7, before phase 11). (a) at 64^3, 256x256, from
             phase 4's outside camera and its camera in the air: the
             per-ray reference march (render/kernel_ref.py) against
             march_xla_df and K1 march-only (phase 10's limits), the
             native C++ oracle (native/oracle.py) against it (hit,
             voxel, normal and steps equal on every ray, t within rel
             1e-5); (b) the
             bench's forward section at full size (512^3 seed 7, cap-96
             distance field, 1080x1920 outside camera): the wavefront
             march (render/kernel_wavefront.py) against march_xla_df on
             every ray (hit flags equal; t within rtol 1e-5 / atol 1e-4,
             voxel and normal equal on hits) and K1 march-only (phase
             10's limits); its counters and host syncs, march and frame
             times, the frame's device kernels and busy time; (c) the
             bench's field-kernel train step at its sizes (128^3, 256x256
             lit rays, S = 64, the camera refined: the lit K3, K4
             kRayGrads and the ray sum), from zeros and from 0.8 x the
             truth, against the same step through the kernels' plain
             versions: loss, table and camera gradients, the rays'
             cotangents, with phase 6's limits; (d) python
             -m vxtpu_torch.bench as a subprocess (its two JSON lines:
             every section, a clock beside every time, K1 launched in
             each mode and K3/K4 in the field-kernel step), then render
             and bench --kernel wavefront (c3_256_shadows at its size)
             and --kernel ref (--dims 64).

Phases 3 and 6 also hold K3/K4 against their plain versions: forward
|d| <= 1e-6; both K4 variants' gradient tables within rtol 1e-5 / atol
1e-6 x max|g| of the plain version and of a second run (the float
atomics of the scatter sum in a varying order), the kRayGrads variant's
ray cotangents equal bit for bit.

Phase 8 holds K5 to its plain version exactly: hit, voxel, normal and
steps equal on every ray, |t difference| <= 1e-6.

Phase 9 holds K1' to its plain version exactly (hit, t, voxel, normal,
steps, done, dist on every ray), march_sorted to single-round K1 exactly
(hit, t, voxel, normal, steps), and K6's acc to its plain version bit for
bit (in every ray order, put back in pixel order, and in both steps).

Phase 10 holds the masked step's loss and gradient through K3/K4 to
their plain versions with phase 6's limits, and the batched march to K5
with the limits above.

Phase 11 holds the sharded frames to the unsharded ones on every pixel,
the sharded K3/K4 steps to the single-device step with phase 6's limits,
and the custom backward (to autograd) and 2 gloo ranks' config-5 step
(to 1 rank's) within rtol 2e-4 / atol 2e-5 x max|g| (the loss within
rel 1e-5): on CUDA index_add_ sums in a varying order.

The line before the last is one JSON object with the kernels' counts,
errors, times and bounds (the bounds of K1, K1' and K5 count the
distinct table words their marches read, counted on the plain march;
the bounds without them are kept as bound_rays_only_ms; K3's and K4's
scatter also carry "masked": phase 10's launches and the kernel alone at
the masked step's shape); the last line
is {"ok": true, "device": {...}}. K1, K3 and K4 carry "sharded": their
launches in phase 11, and "bench": their launches in the bench's fused
and field-kernel sections (phase 12, counted by the bench); every time
has its clock beside it ("events", "profiler-device").
--save DIR writes the main-path frames there as PNGs. --scale-out runs
phases 1 and 2, then phase 11 alone, and prints one JSON line; --bench
runs phases 1 and 2, then phase 12 alone, and prints one JSON line.
--tv-times runs phases 1 and 2, then tv_times alone: the TV prior's kernel
pair against its plain version at 64^3 and 512^3 in every case of
kernel_check.TV_CASES, and its device time a call at 512^3 beside its
bounds and the plain version's time; it prints one JSON line.
--adam-times runs phases 1 and 2, then adam_times alone: Adam's kernel
against torch's foreach step in every case of kernel_check.ADAM_CASES and
over three steps of a 512^3 table, and its device time a launch at 512^3
beside its bound (the table, its gradient and both moments read once,
three of them written once), the plain version's and the foreach step's
a call; it prints one JSON line.
--k6-times runs phases 1 and 2, then phase 9's K6 part alone
(k6_probe) on phase 4's 512^3 world, and prints one JSON line.
--k5-times runs phases 1 and 2, then K5 alone on its three ray sets as
phase 8 times it
(k5_rays, k5_times), and prints one JSON line; --k1-times runs phases 1
and 2, then K1 alone in each launch mode and K1' round 0 on phase 4's
512^3 rays as phase 8 times them (k1_world, k1_times), the registers and
spills of each K1 instantiation (ptxas) and its blocks an SM (the CUDA
occupancy API), and prints one JSON line. Copied into a checkout of
another commit, either times that commit's kernel the same way, so that
two commits can be compared in turns on one card (--k1-times needs a
commit whose kernel_check has check_exact). --sass FILE writes the
kernel's SASS listing there and prints its opcodes by count (K1's by
instantiation).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import re
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
# (4 x 24); lit adds the gradient ladder (39). The backward's pure scatter
# (kRayGrads = false): position and set-up (17), corner weights (19), 32
# cotangent products; lit adds the weight derivatives (96). With the ray
# cotangents also four value f-gradients (4 x 37) and the chain to the ray
# (41); lit adds the second-order terms (60).
FWD_OPS, FWD_OPS_LIT = 113, 39
SCATTER_OPS, SCATTER_OPS_LIT = 68, 96
BWD_OPS, BWD_OPS_LIT = 257, 156
# float32 operations per ray (set-up, shading) and per DDA step of K1
MARCH_OPS_RAY, MARCH_OPS_STEP = 60, 20
# the two variants of K4 (csrc/sample.cu), as kernel_sample.LAUNCHES keys
BWD = {False: "sample_bwd_kernel<kRayGrads=false>",
       True: "sample_bwd_kernel<kRayGrads=true>"}
# float32 operations of K5 (csrc/march_packed.cu) per ray (inverse
# directions, slab clip, entry voxel) and per iteration (three axis exits,
# their minimum, the next voxel's position, floor and clamps, the tests)
K5_OPS_RAY, K5_OPS_STEP = 40, 45
# float32 operations per table row of the TV prior's kernels
# (csrc/tv.cu): the forward's 12 differences, 12 squares and 12 adds; the
# backward's 12 differences, 12 adds and 4 products
TV_FWD_OPS, TV_BWD_OPS = 36, 28
# float32 operations per element of Adam's kernel (csrc/adam.cu): g - m,
# three fused multiply-adds (2 each), g g, beta2 v, sqrt, two divides and
# the add of eps
ADAM_OPS = 13
# float32 operations the K6 work needs (csrc/probe.cu, the K1 step), per
# ray: inverse directions (an |d| test, a divide and a select an axis: 9)
# and the start voxel (clamp and truncate: 9); per iteration by variant:
# the DDA / empty-box target (three integer faces converted, less o, times
# 1/d: 9; their minimum and the axis tests 5; the target's position 9;
# clamp and truncate 9) and the acc add (1; nofetch converts and scales x:
# 2). The integer work (faces, cell index, child bit) is not counted. The
# TPU probe's float step does more for the same work (57 an iteration
# counted before: each face rebuilt in float, a floor)
PROBE_OPS_RAY = 18
PROBE_OPS_ITER = {"empty": 1, "nofetch": 34, "nomath": 1, "full": 33,
                  "static": 33}


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


def device_rounds(row: dict, fn, reps: int, kernel: str, rounds: int) -> str:
    """device_time over ``rounds`` profiler windows: row["device_ms"] their
    median, row["device_ms_rounds"] each one, row["device_ms_clock"] the
    clocks behind them; returns their text for the phase's line."""
    from vxtpu_torch.render import probe

    got = [probe.device_ms(fn, reps, kernel) for _ in range(rounds)]
    row["device_ms_rounds"] = [ms for ms, _ in got]
    row["device_ms"] = statistics.median(row["device_ms_rounds"])
    row["device_ms_clock"] = "+".join(sorted({c for _, c in got}))
    return (f"{row['device_ms']:.5f} ms per launch ({row['device_ms_clock']}"
            f", windows of {reps}: "
            + ", ".join(f"{t:.5f}" for t in row["device_ms_rounds"]) + ")")


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


def _kernel_name(mangled: str) -> str:
    """A kernel's name, with its integer template arguments, from its
    mangled name."""
    m = re.search(r"([A-Za-z_]+_kernel)(I((?:L[ib]n?\d+E)+)E)?", mangled)
    if not m:
        return mangled
    # the Itanium ABI writes a negative argument as n<digits>
    args = [a.replace("n", "-") for a in
            re.findall(r"L[ib](n?\d+)E", m.group(3) or "")]
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def ptxas_usage() -> dict:
    """Kernel name -> its registers, stack frame and spill bytes, from the
    ptxas lines of the build log."""
    from vxtpu_torch import _build

    log = _build.library_path().with_suffix(".log")
    usage, name, frame = {}, "?", {}
    for line in log.read_text().splitlines() if log.exists() else []:
        if "Compiling entry function" in line:
            name = _kernel_name(line.split("'")[1])
        elif "spill" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            frame = dict(zip(("stack", "spill_stores", "spill_loads"), nums))
        elif "registers" in line:
            usage[name] = dict(
                registers=int(re.search(r"Used (\d+) registers",
                                        line).group(1)),
                line=f"{line.split(':', 1)[1].strip()}", **frame)
    return usage


def phase_build() -> dict:
    from vxtpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    dt = time.perf_counter() - t0
    usage = ptxas_usage()
    for name, u in usage.items():
        print(f"phase 2 build: ptxas {name}: {u['line']}; "
              f"{u.get('stack', '?')} bytes stack frame, "
              f"{u.get('spill_stores', '?')} bytes spill stores, "
              f"{u.get('spill_loads', '?')} bytes spill loads")
    print(f"phase 2 build: {_build.library_path().name} in {dt:.1f} s")
    return usage


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
    for name in kc.K1_CASES:
        m = kc.run_k1_case(name, device, D, h, w)
        im = m["image"]
        print(f"phase 3 kernels: K1 instantiation {m['variant']} ({name}): "
              f"{m['hits']} hits of {m['n']}; mismatches hit {m['hit']} "
              f"voxel {m['voxel']} normal {m['normal']} steps {m['steps']}"
              + (f"; rgb beyond {kc.RGB_ATOL} on {im['rgb']} px, max "
                 f"{im['max_abs']:.3g}" if im else ""))
        kc.check_k1_case(m, f"K1 {name}")
        if im:
            err["march_shade_kernel"] = max(err["march_shade_kernel"],
                                            im["max_abs"])
    err.update({"sample_fwd_kernel": 0.0, BWD[False]: 0.0, BWD[True]: 0.0,
                "sample_ray_sum_kernel": 0.0})
    for name in kc.SAMPLE_CASES:
        m = kc.run_sample_case(name, device, D, n=min(h * w, 16384))
        rays = (f", rays {m['rays_excess']:.3g}, {m['rays_unequal']} ray "
                f"cotangents unequal" if m["ray_grads"] else
                ", no ray outputs")
        print(f"phase 3 kernels: sample {name}: {m['active']} of {m['n']} "
              f"rays sampled ({m['empty_bands']} cross the grid on an empty "
              f"band), S {m['S']}; forward max |d| "
              f"{m['fwd_max_abs']:.3g}; backward (kRayGrads="
              f"{str(m['ray_grads']).lower()}) vs plain: max |d| "
              f"{m['bwd_max_abs']:.3g}, allclose excess "
              f"{m['bwd_excess']:.3g} (tables {m['tables_excess']:.3g}"
              f"{rays}); second run excess {m['rerun_excess']:.3g}")
        kc.check_sample_case(m, f"sample {name}")
        err["sample_fwd_kernel"] = max(err["sample_fwd_kernel"],
                                       m["fwd_max_abs"])
        err[BWD[m["ray_grads"]]] = max(err[BWD[m["ray_grads"]]],
                                       m["bwd_max_abs"])
        if m["ray_grads"]:
            err["sample_ray_sum_kernel"] = max(err["sample_ray_sum_kernel"],
                                               m["rays_max_abs"])
    for case in kc.TV_CASES:
        m = kc.run_tv_case(D, device, case)
        print(f"phase 3 kernels: TV prior at {D}^3 ({case}): value "
              f"{m['value']!r}, plain {m['plain']!r} (rel "
              f"{m['value_rel']:.3g}), second launch {m['again']!r}; "
              f"gradient off by {m['grad_err']:.3g} x max |g|")
        kc.check_tv_case(m, f"TV prior at {D}^3")
        _add_tv_err(err, m)
    err["adam_step_kernel"] = 0.0
    for name, case in kc.ADAM_CASES.items():
        m = kc.run_adam_case(device, **case)
        print(f"phase 3 kernels: Adam ({name}): {m['steps']} steps against "
              f"torch's foreach step: allclose excess {m['excess']:.3g}, "
              f"max |d| {m['max_abs']:.3g}, {m['unequal']} of "
              f"{m['elements']} values not bit-equal; second run equal "
              f"{m['rerun_equal']}; launches {m['launches']}")
        kc.check_adam_case(m, f"Adam ({name})")
        err["adam_step_kernel"] = max(err["adam_step_kernel"], m["max_abs"])
    return err


def _add_tv_err(err: dict, m: dict) -> None:
    """Adds a run_tv_case's errors to a kernel -> max error dict: the
    value's relative error to the forward pair, the gradient's (x max |g|)
    to the backward."""
    for k, e in (("tv_fwd_kernel", "value_rel"),
                 ("tv_fwd_finish_kernel", "value_rel"),
                 ("tv_bwd_kernel", "grad_err")):
        err[k] = max(err.get(k, 0.0), m[e])


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


class _WordLog:
    """Stands for a march table in a plain march: indexing it reads the
    table and marks the words read, so that a march's bound can count the
    distinct table words its rays touch."""

    def __init__(self, words):
        import torch

        self.words = words
        self.seen = torch.zeros(words.numel(), dtype=torch.bool,
                                device=words.device)

    def __getitem__(self, idx):
        self.seen[idx] = True
        return self.words[idx]

    def count(self) -> int:
        return int(self.seen.sum())


@contextlib.contextmanager
def _logged_fetch(module, words):
    """Within the block the plain march of ``module`` (kernel_march or
    kernel_packed, whose ``_fetch`` reads every table word of a march)
    reads ``words`` through a _WordLog, which it yields. The plain march
    visits the same cells as the kernel: they agree on every step."""
    log = _WordLog(words)
    real = module._fetch
    module._fetch = lambda _words, *args: real(log, *args)
    try:
        yield log
    finally:
        module._fetch = real


def phase_main(device, D=FULL, h=H, w=W, runs=RUNS, save=None) -> dict:
    import torch

    from vxtpu_torch import bench
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
    launches = {k: km.LAUNCHES[k] for k in ("march_shade_kernel",
                                             "shade_kernel")}
    variants = {k: v for k, v in km.VARIANT_LAUNCHES.items() if v}
    print(f"phase 4 main: launches during the {len(requests)} requests: "
          f"{launches}; march_shade_kernel by instantiation: {variants}")
    if device.type == "cuda" and (
            min(launches.values()) == 0 or
            set(variants) != {"march", "lambert", "full_shadows"}):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}, {variants}")
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

        # the distinct table words the marches read, for K1's bound
        with _logged_fetch(km, accel.words) as log:
            rec_p, rgb_p = plain()
        rm = kc.record_mismatch(rec, rec_p)
        im = kc.image_mismatch(rgb, rgb_p)
        kc.check_exact(rm, im, f"main {name}")
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
                f"rec.steps total kernel {steps} plain {steps_p}; "
                f"{log.count()} distinct occupancy words read")
        t_k = median_ms(lambda c=cam, s=settings, i=inkernel:
                        render_frame_fused(accel, mats, dims, c, light, s, h,
                                           w, inkernel_shadows=i), device,
                        runs)
        times[name] = {"ms": t_k, "hits": int(rec.hit.sum()),
                       "table_words": log.count()}
        line += f"; frame {t_k:.3f} ms ({h * w / t_k / 1e3:.1f} Mrays/s)"
        if inkernel:
            kspec = km.ShadeSpec.from_settings(settings, light,
                                               shadows=settings.shadows)
            kfn = lambda o=o, d=d, sp=kspec: km.march(
                o, d, accel, dims, ms, shade_spec=sp, mats=mats,
                lights_arr=lights_arr)
            t_kern = median_ms(kfn, device, runs)
            times[name]["kernel_ms"] = t_kern
            line += f"; kernel alone {t_kern:.3f} ms (events)"
            if device.type == "cuda":
                line += ", device " + bench.device_time(
                    times[name], "kernel_device_ms", kfn, device, 20,
                    "march_shade_kernel") + " over 20 launches"
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
            dev = "not measured"
            if device.type == "cuda":
                dev = bench.device_time(
                    times["shade_kernel"], "device_ms",
                    lambda: km.shade(rec, o, d, vis, mats, lights_arr, vspec),
                    device, runs, "shade_kernel")
            print(f"phase 4 main: shade kernel alone at {h}x{w}: {t_s:.3f} "
                  f"ms (events), device {dev}; plain {t_sp:.3f} ms "
                  f"(events); rgb beyond {kc.RGB_ATOL} on "
                  f"{sm['rgb']} px (max {sm['max_abs']:.3g})")
    return {"launches": launches, "variant_launches": variants, "err": err,
            "times": times, "grid": grid, "accel": accel}


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


def k5_bound(n, steps, with_tmax, table_words=0, word_bytes=2) -> dict:
    """Least time (ms) of one K5 launch over n rays that take ``steps``
    iterations in all: each ray's inputs (o, d: 24 B; t_max: 4 B) read
    once and its outputs (hit 1, t 4, voxel 12, normal 12, steps 4 B)
    written once, and the ``table_words`` distinct words its marches read
    (counted on the plain march), ``word_bytes`` each, over the HBM rate:
    2 for the bricked 16-bit table the kernel reads; 4 gives the bound
    over int32 words, the yardstick of K5 before it had the bricked copy.
    Operations: K5_OPS_RAY per ray and K5_OPS_STEP per iteration over the
    float32 peak."""
    return _bound(n * (24 + (4 if with_tmax else 0) + 33)
                  + word_bytes * table_words,
                  n * K5_OPS_RAY + steps * K5_OPS_STEP)


def graph_ms(fn, reps=20, windows=5) -> float:
    """Device time (ms) per call of ``fn`` without the host's launch cost,
    the cross-check of the profiler: ``reps`` calls captured in one CUDA
    graph, then the median over ``windows`` replays of CUDA events around
    one replay, over ``reps``. The gaps between the graph's kernels stay
    in it, so it reads a little above the profiler's device time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def sass_listing(kernel: str) -> dict | None:
    """Function -> its SASS lines as (line, address, opcode, operands),
    for every function whose name holds ``kernel``, from ``cuobjdump
    -sass`` of the built library (the toolkit's cuobjdump beside nvcc; a
    template's instantiations apart); None where cuobjdump is missing."""
    from vxtpu_torch import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(_build.library_path())],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    funcs, ins = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fname = line.split("Function :", 1)[1].strip()
            ins = funcs.setdefault(_kernel_name(fname), []) \
                if kernel in fname else None
        elif ins is not None:
            m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_]*)(\S*)\s*(.*)", line)
            if m:
                ins.append((line, int(m.group(1), 16), m.group(2),
                            m.group(4)))
    return funcs


def sass_functions(kernel: str, listing: Path) -> dict:
    """Function -> {opcode: count} in sass_listing(kernel), whose lines
    are written to ``listing``."""
    funcs = sass_listing(kernel)
    if funcs is None:
        raise FileNotFoundError("cuobjdump not found beside nvcc")
    lines = []
    for fn, seq in funcs.items():
        lines += [f"// {fn}"] + [x[0] for x in seq]
    listing.parent.mkdir(parents=True, exist_ok=True)
    listing.write_text("\n".join(lines) + "\n")
    out = {}
    for fn, seq in funcs.items():
        ops = out.setdefault(fn, {})
        for _, _, op, _ in seq:
            ops[op] = ops.get(op, 0) + 1
    return {f: dict(sorted(o.items(), key=lambda kv: -kv[1]))
            for f, o in out.items()}


def sass_opcodes(kernel: str, listing: Path) -> dict:
    """Opcode -> count over the functions of sass_functions."""
    ops = {}
    for fops in sass_functions(kernel, listing).values():
        for k, v in fops.items():
            ops[k] = ops.get(k, 0) + v
    return dict(sorted(ops.items(), key=lambda kv: -kv[1]))


def k5_rays(device) -> dict:
    """K5's ray sets at the main paths' shapes, built as phase 8 builds
    them: name -> (o, d, t_max, accel, dims, max_steps). ``c3``: the
    c3_256_shadows frame's primary rays (256^3 terrain seed 7, 1024x1024);
    ``c3_shadow``: their shadow rays toward the config's light (t_max
    set); ``512``: phase 4's 512^3 seed-7 1080x1920 lambert rays."""
    from vxtpu_torch.app.configs import CONFIGS
    from vxtpu_torch.app.run import build_scene
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render import kernel_packed as kp
    from vxtpu_torch.render.pipeline import shadow_ray_batch
    from vxtpu_torch.world import procgen
    from vxtpu_torch.world.packed import build_packed

    cfg = CONFIGS["c3_256_shadows"]
    dims = (256,) * 3
    _, accel, cam, lights = build_scene(cfg, dims, "packed", device)
    ms = cfg.settings.resolve_max_steps(dims)
    o, d = generate_rays(cam, 1024, 1024)
    sp, sd, stm = shadow_ray_batch(kp.march_packed(o, d, accel, dims, ms),
                                   o, d, lights.pos[0])
    big = procgen.terrain((FULL,) * 3, seed=7, device=device)
    _, requests = _main_scene(device, FULL)
    _, bcam, lam, _ = requests[0]
    bo, bd = generate_rays(bcam, H, W)
    return {"c3": (o, d, None, accel, dims, ms),
            "c3_shadow": (sp, sd, stm, accel, dims, ms),
            "512": (bo, bd, None, build_packed(big.occupancy), big.dims,
                    lam.resolve_max_steps(big.dims))}


def k5_times(rays: dict, device, reps=20, rounds=3, record=False,
             prefix="K5 alone") -> dict:
    """K5 alone on each ray set of ``rays`` (name -> (o, d, t_max, accel,
    dims, max_steps)): K5 against its plain version (raises on any
    mismatch), the iterations, the distinct table words the plain march
    reads, the bound with them at 2 B (``bound_ms``) and at 4 B
    (``bound_int32_ms``); on the GPU, K5's device time per launch (the
    median of ``rounds`` profiler windows of ``reps`` launches,
    render/probe.py:device_ms), the same launches replayed from one CUDA
    graph (``graph_ms``) and, with ``record``, the device time of each
    launch of one more profiler window (``launch_us``)."""
    import torch

    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.render import kernel_packed as kp
    from vxtpu_torch.render import probe

    out = {}
    for name, (o, d, tm, acc, dims, ms) in rays.items():
        with _logged_fetch(kp, acc.words) as log:
            ref = kp.march_packed_reference(o, d, acc, dims, ms, t_max=tm)
        m = kc.packed_mismatch(kp.march_packed(o, d, acc, dims, ms, t_max=tm),
                               ref)
        kc.check_packed(m, f"K5 {name}")
        steps = int(ref.steps.sum(dtype=torch.int64))
        bound = k5_bound(o.shape[0], steps, tm is not None, log.count())
        row = dict(n=o.shape[0], steps=steps, table_words=log.count(),
                   t_abs=m["t_abs"], bound_ms=bound["bound_ms"],
                   bound_by=bound["bound_by"],
                   bound_int32_ms=k5_bound(o.shape[0], steps, tm is not None,
                                           log.count(), 4)["bound_ms"],
                   bound_rays_only_ms=k5_bound(o.shape[0], steps,
                                               tm is not None)["bound_ms"])
        line = ""
        if device.type == "cuda":
            fn = lambda: kp.march_packed(o, d, acc, dims, ms, t_max=tm)
            line = "; device " + device_rounds(row, fn, reps,
                                               "march_packed_kernel", rounds)
            row["graph_ms"] = graph_ms(fn, reps)
            line += (f", CUDA graph {row['graph_ms']:.5f} (events); bound / "
                     f"time {row['bound_ms'] / row['device_ms']:.3f}")
            if record:
                row["launch_us"] = probe.launch_us(fn, reps,
                                                   "march_packed_kernel")
                line += (f"; one more window, {len(row['launch_us'])} of "
                         f"{reps} launches recorded, us: "
                         + " ".join(f"{u:.2f}" for u in row["launch_us"]))
        print(f"{prefix} {name}: {row['n']} rays, {steps} iterations, "
              f"{row['table_words']} table words; 0 mismatches, max |dt| "
              f"{m['t_abs']:.3g}; bound {row['bound_ms']:.5f} ms by "
              f"{row['bound_by']} (table words at 2 B; "
              f"{row['bound_int32_ms']:.5f} at 4 B, "
              f"{row['bound_rays_only_ms']:.5f} without){line}")
        out[name] = row
    return out


# K1's launch modes as k1_times times them: name -> (the settings of
# _main_scene's outside frame that launch it, in-kernel shadows). march:
# march only (the composed frame's primary and shadow marches); lambert:
# the headline frame's one launch; full_shadows_fog: entry()'s launch
K1_MODES = ("march", "lambert", "full_shadows_fog")


def k1_world(device, grid=None, h=H, w=W) -> dict:
    """Phase 4's world and rays, for K1 alone: ``grid`` (by default the
    FULL^3 seed-7 terrain), its Morton occupancy and material tables, the
    outside camera's h x w rays and the light."""
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.world import procgen
    from vxtpu_torch.world.packed import (build_material_morton,
                                          build_packed_morton)

    if grid is None:
        grid = procgen.terrain((FULL,) * 3, seed=7, device=device)
    dims = grid.dims
    light, requests = _main_scene(device, dims[0])
    by_name = {name: (cam, st) for name, cam, st, _ in requests}
    o, d = generate_rays(by_name["lambert"][0], h, w)
    return dict(dims=dims, accel=build_packed_morton(grid.occupancy, cap=64),
                mats=build_material_morton(grid.occupancy), o=o, d=d,
                light=light, lambert=by_name["lambert"][1],
                full=by_name["full_shadows_fog"][1])


def k1_bound(n, steps, table_words, shaded, hits=0, shadow_rays=0) -> dict:
    """Least time (ms) of one K1 launch over n rays: each ray's inputs (o,
    d: 24 B) read once and its outputs (hit 1, t 4, voxel 12, normal 12,
    steps 4 B; shaded, rgb 12 B more) written once, one material word (4
    B) per hit ray when shaded, and the ``table_words`` distinct int16
    occupancy words its marches read (counted on the plain march), over
    the HBM rate. Operations: MARCH_OPS_RAY per ray and per shadow ray,
    MARCH_OPS_STEP per DDA step of either march (``steps``: all of
    them)."""
    b = n * (24 + (45 if shaded else 33)) + (4 * hits if shaded else 0)
    return _bound(b + 2 * table_words,
                  (n + shadow_rays) * MARCH_OPS_RAY + steps * MARCH_OPS_STEP)


def k1_times(world: dict, device, reps=20, rounds=3, record=False,
             prefix="K1 alone") -> dict:
    """K1 alone in each launch mode of K1_MODES on ``world`` (k1_world),
    and K1' round 0 (budget 24) on the same rays: each against its plain
    version on every ray (hit, voxel, normal and steps equal, t within
    rtol 1e-5, rgb within 1e-5 on every pixel; K1' exact on every field;
    raises otherwise), the steps and distinct table words its plain
    version reads, its bound (k1_bound, k1r_bound); on the GPU its device
    time per launch (the median of ``rounds`` profiler windows of ``reps``
    launches, render/probe.py:device_ms), the same launches replayed from
    a CUDA graph (``graph_ms``), bound / time (``share``) and, with
    ``record``, the device time of each launch of one more window
    (``launch_us``)."""
    import torch

    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.render import kernel_march as km
    from vxtpu_torch.render import probe

    o, d, acc, mats, dims = (world[k] for k in ("o", "d", "accel", "mats",
                                                "dims"))
    light = world["light"]
    lights_arr = km.pack_lights(light)
    n = o.shape[0]
    specs = {"march": (world["lambert"], None),
             "lambert": (world["lambert"], km.ShadeSpec.from_settings(
                 world["lambert"], light, shadows=False)),
             "full_shadows_fog": (world["full"], km.ShadeSpec.from_settings(
                 world["full"], light, shadows=True))}
    out = {}
    for mode in (*K1_MODES, "resume_round0"):
        settings, spec = specs.get(mode, specs["march"])
        ms = settings.resolve_max_steps(dims)
        if mode == "resume_round0":
            kernel = "march_resume_kernel"
            fn = lambda ms=ms: km.march(o, d, acc, dims, ms, iter_budget=24,
                                        extended=True)
            with _logged_fetch(km, acc.words) as log:
                want, ext_p = km.march_reference(o, d, acc, dims, ms,
                                                 iter_budget=24, extended=True)
            got, ext_k = fn()
            bad = kc.resume_mismatch(got, ext_k, want, ext_p)
            steps = int(want.steps.sum(dtype=torch.int64))
            bound = k1r_bound(n, steps, False, False, log.count())
            row = dict(n=n, steps=steps, table_words=log.count(),
                       mismatches=bad, bound_ms=bound["bound_ms"],
                       bound_by=bound["bound_by"])
            what = f"{bad} (every field)"
            if any(bad.values()):
                raise AssertionError(f"K1' round 0 differs from its plain "
                                     f"version: {bad}")
        else:
            kernel = "march_shade_kernel"
            fn = lambda ms=ms, spec=spec: km.march(
                o, d, acc, dims, ms, shade_spec=spec, mats=mats,
                lights_arr=lights_arr)
            with _logged_fetch(km, acc.words) as log:
                want = km.march_shade_reference(o, d, acc, dims, ms, None,
                                                spec, mats, lights_arr)
            got = fn()
            rm = kc.record_mismatch(got[0] if spec else got,
                                    want[0] if spec else want)
            im = kc.image_mismatch(got[1], want[1]) if spec else None
            kc.check_exact(rm, im, f"K1 {mode} against its plain version")
            rec = want[0] if spec else want
            steps = int(rec.steps.sum(dtype=torch.int64))
            hits = int(rec.hit.sum())
            # the steps of each phase a warp runs: the primary march, then
            # one shadow march per light
            phases = [rec.steps]
            shadow_rays = 0
            if spec is not None and spec.runs_shadow_marches:
                for li in range(light.count):
                    p_, ldir, dist, facing = km.shadow_rays(
                        rec, o, d, light.pos[li])
                    srec = km.march_reference(
                        p_, ldir, acc, dims, ms,
                        torch.where(rec.hit, dist - 2.0 * km.SHADOW_EPS, 0.0),
                        active=facing)
                    shadow_rays += int(facing.sum())
                    phases.append(srec.steps)
            shadow_steps = sum(int(x.sum(dtype=torch.int64))
                               for x in phases[1:])
            bound = k1_bound(n, steps + shadow_steps, log.count(),
                             spec is not None, hits, shadow_rays)
            row = dict(n=n, steps=steps, hits=hits, shadow_rays=shadow_rays,
                       shadow_steps=shadow_steps, table_words=log.count(),
                       coherence=probe.warp_coherence(*phases),
                       shadow_coherence=probe.warp_coherence(*phases[1:])
                       if shadow_rays else None,
                       t_rel=rm["t_rel"],
                       rgb_max_abs=im["max_abs"] if im else None,
                       bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
            what = (f"0 mismatches in hit, voxel, normal, steps (t rel "
                    f"{rm['t_rel']:.3g}"
                    + (f", max |drgb| {im['max_abs']:.3g}" if im else "")
                    + f"); warp coherence {row['coherence']:.4f}"
                    + (f" (the shadow marches alone "
                       f"{row['shadow_coherence']:.4f})"
                       if shadow_rays else ""))
        line = ""
        if device.type == "cuda":
            line = "; device " + device_rounds(row, fn, reps, kernel,
                                               rounds)
            row["graph_ms"] = graph_ms(fn, reps)
            row["share"] = row["bound_ms"] / row["device_ms"]
            line += (f", CUDA graph {row['graph_ms']:.5f} (events); bound / "
                     f"time {row['share']:.3f}")
            if record:
                row["launch_us"] = probe.launch_us(fn, reps, kernel)
                line += (f"; one more window, {len(row['launch_us'])} of "
                         f"{reps} launches recorded, us: "
                         + " ".join(f"{u:.2f}" for u in row["launch_us"]))
        print(f"{prefix} {mode}: {n} rays, {steps} steps"
              + (f" + {row['shadow_steps']} on {row['shadow_rays']} shadow "
                 f"rays" if row.get("shadow_rays") else "")
              + f", {row['table_words']} table words; {what}; bound "
              f"{row['bound_ms']:.5f} ms by {row['bound_by']}{line}")
        out[mode] = row
    return out


def k1_occupancy() -> dict:
    """K1 variant -> blocks of 256 threads an SM holds at 512^3, through
    the CUDA API; "not available" where the library has no entry for
    it."""
    from vxtpu_torch import _build
    from vxtpu_torch.render import kernel_march as km

    lib = _build.load()
    if not hasattr(lib, "vx_march_shade_blocks_per_sm"):
        return {"march_shade_kernel": "not available"}
    return {v: lib.vx_march_shade_blocks_per_sm(i, FULL)
            for i, v in enumerate(km.K1_VARIANTS)}


def _run_cli(argv) -> list:
    """Run a vxtpu_torch command in this process; its stdout lines."""
    import contextlib
    import io

    from vxtpu_torch.app import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(argv)
    if rc != 0:
        raise AssertionError(f"{argv}: exit code {rc}")
    return buf.getvalue().splitlines()


def phase_pipeline(device, big_grid, D=256, h=1024, w=1024, bh=H, bw=W,
                   runs=RUNS, save=None, frames=24, case_d=64,
                   case_hw=256, cli_size=()) -> dict:
    """Phase 8: the composable pipeline through K5 (see the module
    docstring). big_grid: phase 4's world, for the K5-vs-K1 frame."""
    import tempfile

    import torch

    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.app.configs import CONFIGS
    from vxtpu_torch.app.run import build_scene
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render import kernel_march as km
    from vxtpu_torch.render import kernel_packed as kp
    from vxtpu_torch.render.pipeline import (render_image, render_rays,
                                             shadow_ray_batch)
    from vxtpu_torch.utils import save_png
    from vxtpu_torch.world.atlas import build_procedural_atlas
    from vxtpu_torch.world.packed import build_packed

    err = 0.0
    for name in kc.PACKED_CASES:
        m = kc.run_packed_case(name, device, D=case_d, h=case_hw, w=case_hw)
        print(f"phase 8 pipeline: K5 {name}: {m['hits']} hits of {m['n']}; "
              f"mismatches hit {m['hit']} voxel {m['voxel']} normal "
              f"{m['normal']} steps {m['steps']}; max |dt| {m['t_abs']:.3g}; "
              f"{m['steps_total']} iterations")
        kc.check_packed_case(m, f"K5 {name}")
        err = max(err, m["t_abs"])

    cfg = CONFIGS["c3_256_shadows"]
    dims = (D,) * 3
    t0 = time.perf_counter()
    grid, accel, cam, lights = build_scene(cfg, dims, "packed", device)
    _sync(device)
    print(f"phase 8 pipeline: {cfg.name} at {D}^3: terrain + row-major table "
          f"in {time.perf_counter() - t0:.2f} s; table "
          f"{accel.words.numel() * 4 / 2**20:.0f} MiB int32, its bricked copy "
          f"(K5's) {accel.bricks.numel() * 2 / 2**20:.0f} MiB 16-bit")
    settings = cfg.settings
    ms = settings.resolve_max_steps(dims)
    o, d = generate_rays(cam, h, w)
    rec = kp.march_packed(o, d, accel, dims, ms)
    sp, sd, stm = shadow_ray_batch(rec, o, d, lights.pos[0])
    # K5 against its plain version on every primary and shadow ray of the
    # frame, exactly; their bounds; on the card K5's device times
    k5 = k5_times({"c3": (o, d, None, accel, dims, ms),
                   "c3_shadow": (sp, sd, stm, accel, dims, ms)}, device,
                  record=True, prefix="phase 8 pipeline: K5 alone")
    err = max(err, k5["c3"]["t_abs"], k5["c3_shadow"]["t_abs"])

    # the main path, counted: the frame, and the frame with the atlas
    atlas = build_procedural_atlas(tex_size=16, device=device)
    kp.reset_launch_counts()
    img = render_image(kp.make_march_packed, grid, cam, lights, settings, h,
                       w, accel)
    img_atlas = render_image(kp.make_march_packed, grid, cam, lights,
                             settings, h, w, accel, atlas=atlas)
    _sync(device)
    launches = dict(kp.LAUNCHES)
    hit_frac = float(rec.hit.float().mean())
    for what, im in (("frame", img), ("atlas frame", img_atlas)):
        if im.shape != (h, w, 3) or not bool(torch.isfinite(im).all()):
            raise AssertionError(f"c3 {what}: not finite or misshapen")
    print(f"phase 8 pipeline: launches during the two c3 frames (plain, "
          f"atlas): {launches}; finite; hit fraction {hit_frac:.4f}; the "
          f"atlas changes {int((img != img_atlas).any(-1).sum())} pixels")
    if device.type == "cuda" and launches["march_packed_kernel"] != 4:
        raise AssertionError(f"expected 2 K5 launches per frame: {launches}")
    if not 0.0 < hit_frac < 1.0:
        raise AssertionError(f"c3 hit fraction {hit_frac}")
    if save:
        Path(save).mkdir(parents=True, exist_ok=True)
        save_png(str(Path(save) / "c3_pipeline.png"), img)
        save_png(str(Path(save) / "c3_pipeline_atlas.png"), img_atlas)

    # measurement (not counted)
    frame_ms = median_ms(lambda: render_image(
        kp.make_march_packed, grid, cam, lights, settings, h, w, accel),
        device, runs)
    k5_ms = median_ms(lambda: kp.march_packed(o, d, accel, dims, ms), device,
                      runs)
    k5_shadow_ms = median_ms(lambda: kp.march_packed(sp, sd, accel, dims, ms,
                                                     t_max=stm), device, runs)
    plain_ms = median_ms(lambda: kp.march_packed_reference(
        o, d, accel, dims, ms), device, 3)
    times = dict(ms=k5_ms, plain_ms=plain_ms, shadow_ms=k5_shadow_ms,
                 frame_ms=frame_ms, **k5)
    print(f"phase 8 pipeline: c3 frame {frame_ms:.3f} ms "
          f"({h * w / frame_ms / 1e3:.1f} Mrays/s); K5 a call (events) on "
          f"the primary rays {k5_ms:.3f} ms, on the shadow rays "
          f"{k5_shadow_ms:.3f} ms; plain {plain_ms:.1f} ms")
    if device.type == "cuda":
        kernels, dense, wall = _profile_step(
            lambda: render_image(kp.make_march_packed, grid, cam, lights,
                                 settings, h, w, accel), device, big=h * w)
        busy = sum(kernels.values())
        k5_dev = sum(v for k, v in kernels.items() if "march_packed" in k)
        print(f"phase 8 pipeline: profiled c3 frame: wall {wall:.3f} ms, "
              f"device busy {busy:.3f} ms ({busy / wall * 100:.1f}%), K5 "
              f"(2 launches) {k5_dev:.3f} ms, the rest (torch shading, rays, "
              f"shadow set-up) {busy - k5_dev:.3f} ms")
        for name, kms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
            print(f"phase 8 pipeline:   kernel {kms:8.3f} ms  {name[:90]}")
        times["profile"] = dict(wall_ms=wall, busy_ms=busy, k5_ms=k5_dev)
    del grid, img, img_atlas, rec

    # K5 against K1 (march-only) on phase 4's lambert frame
    B = big_grid.dims[0]
    bdims = big_grid.dims
    light, requests = _main_scene(device, B)
    _, bcam, lam, _ = requests[0]
    bo, bd = generate_rays(bcam, bh, bw)
    bpacked = build_packed(big_grid.occupancy)
    occ_flat = big_grid.occupancy.reshape(-1)
    m5 = kp.make_march_packed(occ_flat, bdims, lam, bpacked)
    m1 = km.make_march(occ_flat, bdims, lam)
    albedo = big_grid.albedo()
    rgb5, r5 = render_rays(m5, bo, bd, albedo, bdims, light, lam)
    rgb1, r1 = render_rays(m1, bo, bd, albedo, bdims, light, lam)
    either = r5.hit | r1.hit
    same = ((r5.hit == r1.hit) & (r5.t == r1.t)
            & (r5.voxel == r1.voxel).all(-1)
            & (r5.normal == r1.normal).all(-1))
    n_hit = int(either.sum())
    share = float((same & either).sum()) / max(n_hit, 1)
    misses = ~either
    miss_vox = int(((r5.voxel != r1.voxel).any(-1) & misses).sum())
    miss_steps = int(((r5.steps != r1.steps) & misses).sum())
    img_same = int(((rgb5 - rgb1).abs() > kc.RGB_ATOL).any(-1).sum())
    b5 = median_ms(lambda: m5(bo, bd), device, runs)
    b1 = median_ms(lambda: m1(bo, bd), device, runs)
    f5 = median_ms(lambda: render_rays(m5, bo, bd, albedo, bdims, light,
                                       lam), device, runs)
    f1 = median_ms(lambda: render_rays(m1, bo, bd, albedo, bdims, light,
                                       lam), device, runs)
    print(f"phase 8 pipeline: K5 vs K1 at {B}^3 {bh}x{bw} lambert: hit, t, "
          f"voxel and normal agree on {share * 100:.4f}% of the {n_hit} rays "
          f"that either hits; of the {int(misses.sum())} misses, voxel "
          f"differs on {miss_vox} and steps on {miss_steps} (K5's contract); "
          f"rgb beyond {kc.RGB_ATOL} on {img_same} px. A call (events): K5 "
          f"{b5:.3f} ms on a {bpacked.bricks.numel() * 2 / 2**20:.0f} MiB "
          f"bricked table, K1 march-only {b1:.3f} ms; pipeline frame K5 "
          f"{f5:.3f} ms, K1 {f1:.3f} ms")
    if share < 0.999:
        raise AssertionError(f"K5 and K1 agree on only {share:.5f} of the "
                             f"hit rays")
    k5b = k5_times({"512": (bo, bd, None, bpacked, bdims,
                            lam.resolve_max_steps(bdims))}, device,
                   record=True, prefix="phase 8 pipeline: K5 alone")["512"]
    err = max(err, k5b["t_abs"])
    times["big"] = dict(k5_ms=b5, k1_ms=b1, frame_k5_ms=f5, frame_k1_ms=f1,
                        agree=share, k5=k5b)
    del bpacked, m5, m1, r5, r1, rgb5, rgb1
    # K1 alone on the same rays in each of its launch modes, each against
    # its own bound (and K1' round 0)
    times["k1"] = k1_times(k1_world(device, big_grid, bh, bw), device,
                           record=True, prefix="phase 8 pipeline: K1 alone")
    if device.type == "cuda":
        from vxtpu_torch import _build

        times["blocks_per_sm"] = _build.load().vx_march_packed_blocks_per_sm()
        times["k1_occupancy"] = k1_occupancy()
        print(f"phase 8 pipeline: K5 holds {times['blocks_per_sm']} blocks of "
              f"256 threads an SM; K1 at {B}^3 by instantiation: "
              f"{times['k1_occupancy']}")

    # the commands themselves
    with tempfile.TemporaryDirectory() as tmp:
        kp.reset_launch_counts()
        out = _run_cli(["animate", "--config", "c1_64_flat", "--kernel",
                        "pallas", "--frames", str(frames), "--out",
                        str(Path(tmp) / "anim"), "--device", device.type,
                        *cli_size])
        fps = json.loads(out[0])
        n_png = len(list((Path(tmp) / "anim").glob("frame_*.png")))
        print(f"phase 8 pipeline: animate: {out[0]}; {n_png} PNGs; "
              f"launches {dict(kp.LAUNCHES)}")
        if fps.get("sink") != "native" or n_png != frames:
            raise AssertionError(f"animate: {out}")
        if device.type == "cuda" and kp.LAUNCHES["march_packed_kernel"] == 0:
            raise AssertionError("animate did not launch K5")
    kp.reset_launch_counts()
    out = _run_cli(["bench", "--config", cfg.name, "--kernel", "pallas",
                    "--device", device.type, *cli_size])
    bench = json.loads(out[-1])
    print(f"phase 8 pipeline: bench: {out[-1]}; launches "
          f"{dict(kp.LAUNCHES)}")
    if not bench.get("value", 0) > 0:
        raise AssertionError(f"bench: {out}")
    # the default --accel (distfield) makes the factory rebuild the
    # row-major table in every frame, as vxtpu does; --accel packed builds
    # it once
    out = _run_cli(["bench", "--config", cfg.name, "--kernel", "pallas",
                    "--accel", "packed", "--device", device.type, *cli_size])
    print(f"phase 8 pipeline: bench --accel packed: {out[-1]}")
    times.update(fps=fps, bench=bench, bench_packed=json.loads(out[-1]))

    # the JAX package's checksums
    gold = json.loads((DATA / "packed_seed7.json").read_text())
    if D == gold["table"]["dims"]:
        got = kc.table_checksums(accel.words)
        want = gold["table"]["checksums"]
        print(f"phase 8 pipeline: {D}^3 seed-7 row-major table checksums "
              f"{got} vs JAX {want}")
        if got != want:
            raise AssertionError("the row-major table differs from JAX's")
    gm = gold["march"]
    gdims = (gm["D"],) * 3
    go, gd, gt = (torch.from_numpy(x).to(device)
                  for x in kc.golden_march_inputs(gm["D"], gm["n"],
                                                  gm["seed"]))
    from vxtpu_torch.world import procgen

    gacc = build_packed(procgen.terrain(gdims, seed=gm["terrain_seed"],
                                        device=device).occupancy)
    grec = kp.march_packed(go, gd, gacc, gdims, gm["max_steps"], t_max=gt)
    gsum = kc.march_checksums(*(x.cpu().numpy() for x in (
        grec.hit, grec.t, grec.voxel, grec.normal, grec.steps)), gdims)
    print(f"phase 8 pipeline: K5 on the {gm['n']} fixed rays at "
          f"{gm['D']}^3: {gsum} vs JAX {gm['checksums']}")
    for k in ("hits", "steps", "voxel_index_sum", "normal_sum"):
        if gsum[k] != gm["checksums"][k]:
            raise AssertionError(f"K5 checksum {k} differs from JAX's")
    if abs(gsum["t_sum"] - gm["checksums"]["t_sum"]) > \
            1e-6 * abs(gm["checksums"]["t_sum"]):
        raise AssertionError("K5 t checksum differs from JAX's")
    return {"launches": launches, "err": err, "times": times}


def k1r_bound(n, steps, resumed, with_tmax, table_words=0) -> dict:
    """Least time (ms) of one K1' launch over n rays that take ``steps``
    DDA steps in all: each ray's inputs (o, d: 24 B; t_max: 4 B; the
    resume state voxel, dist, steps: 20 B) read once and its outputs (hit
    1, t 4, voxel 12, normal 12, steps 4, done 1, dist 4 B) written once,
    and the ``table_words`` distinct int16 occupancy words its marches
    read (counted on the plain march, as for K1), over the HBM rate.
    Operations: MARCH_OPS_RAY per ray and MARCH_OPS_STEP per step over the
    float32 peak."""
    b = n * (24 + (4 if with_tmax else 0) + (20 if resumed else 0) + 38)
    b += 2 * table_words
    f = n * MARCH_OPS_RAY + steps * MARCH_OPS_STEP
    tb, tf = b / PEAK_BYTES * 1e3, f / PEAK_F32 * 1e3
    return dict(bytes=b, ops=f, bound_ms=max(tb, tf),
                bound_by="bytes" if tb >= tf else "operations")


def probe_bound(n, n_iters, variant, table_bytes) -> dict:
    """Least time (ms) of one K6 launch over n rays: 28 B of ray I/O per
    ray (o, d read, acc written; empty's acc depends on no input, so 4 B)
    plus, for the variants that read it, ``table_bytes``: the distinct
    table words the run's rays read (counted on the plain version), once,
    over the HBM rate; PROBE_OPS_RAY (not for empty) + n_iters x
    PROBE_OPS_ITER[variant] float32 operations per ray over the float32
    peak."""
    empty = variant == "empty"
    reads = variant in ("nomath", "full", "static")
    b = n * (4 if empty else 28) + (table_bytes if reads else 0)
    f = n * ((0 if empty else PROBE_OPS_RAY)
             + n_iters * PROBE_OPS_ITER[variant])
    tb, tf = b / PEAK_BYTES * 1e3, f / PEAK_F32 * 1e3
    return dict(bytes=b, ops=f, bound_ms=max(tb, tf),
                bound_by="bytes" if tb >= tf else "operations")


def sass_loops(kernel: str) -> dict | None:
    """Function -> its loops in sass_listing(kernel): for each backward
    branch, the instructions from its target to it (``size``) and the
    float-to-int conversions among them (``f2i``: three an iteration of
    the probe's step, so ``size`` x 3 / ``f2i`` is an iteration's
    instructions where the compiler unrolled the loop). None where
    cuobjdump is missing."""
    funcs = sass_listing(kernel)
    if funcs is None:
        return None
    loops = {}
    for fn, seq in funcs.items():
        found = []
        for _, addr, op, rest in seq:
            t = re.search(r"0x([0-9a-f]+)", rest.split(";")[0])
            # a backward branch; the one to itself after EXIT is no loop
            if op == "BRA" and t and int(t.group(1), 16) < addr:
                body = [o for _, a, o, _ in seq
                        if int(t.group(1), 16) <= a <= addr]
                found.append(dict(size=len(body),
                                  f2i=body.count("F2I")))
        loops[fn] = found
    return loops


def k6_occupancy(dims) -> dict:
    """(variant, layout, step) -> registers (ptxas) and blocks of 256
    threads an SM (the CUDA occupancy API) of each K6 instantiation."""
    from vxtpu_torch.render import probe

    usage = ptxas_usage()
    out = {}
    for si, step in enumerate(probe.STEPS):
        for li, layout in enumerate(probe.LAYOUTS):
            for vi, v in enumerate(probe.VARIANTS):
                u = usage.get(f"march_probe_kernel<{vi}, {li}, {si}>", {})
                out[f"{v}/{layout}/{step}"] = dict(
                    registers=u.get("registers"),
                    blocks_per_sm=probe.blocks_per_sm(v, layout, step, 256,
                                                      dims))
    return out


def k6_probe(device, grid, h=H, w=W, case_d=64, case_hw=256, reps=10,
             threads=None, orders=None) -> dict:
    """Phase 9's K6 part: the probe against its plain version at
    ``case_d``^3 (kernel_check.PROBE_CASES); on ``grid`` (phase 4's world)
    and phase 4's outside h x w rays, the cost probe (counted: K1's step
    over the three layouts in each ray order and block size, then the TPU
    probe's float step, the form first ported, on the Morton table in
    scanline order at 256 threads), then, not counted, both steps against
    their plain versions on every ray in every order, the reads and words
    each variant's rays read, each row's bound, each instantiation's
    registers and blocks an SM and the SASS loops of full."""
    import torch

    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render import probe
    from vxtpu_torch.render.dda import ray_grid_clip
    from vxtpu_torch.world.packed import build_packed, build_packed_morton

    err = 0.0
    for name in kc.PROBE_CASES:
        m = kc.run_probe_case(name, device, case_d, case_hw, case_hw)
        print(f"phase 9 resume: K6 {name}: acc differs on {m['acc']} of "
              f"{m['n']} rays (max {m['max_abs']:.3g}), sum "
              f"{m['acc_sum']:.6g}"
              + (f"; identity words wrong on {m['expected']}"
                 if "expected" in m else ""))
        kc.check_probe_case(m, f"K6 {name}")
        err = max(err, m["max_abs"])

    dims = grid.dims
    D = dims[0]
    packed = build_packed(grid.occupancy)
    tables = {"morton16": build_packed_morton(grid.occupancy, cap=64).words,
              "rowmajor32": packed.words, "bricked16": packed.bricks}
    del packed
    _, requests = _main_scene(device, D)
    cam = next(c for name, c, _, _ in requests if name == "lambert")
    o, d = generate_rays(cam, h, w)
    n = o.shape[0]
    orders = tuple(probe.ORDERS) if orders is None else tuple(orders)
    threads = tuple(threads or probe.THREADS)
    parent = ("tpu", "scanline", "morton16", 256)
    # the same rays started where they enter the grid (a miss keeps its
    # origin): the outside rays all start at one voxel, the camera's
    # clipped floor, so only these spread a warp's rays over the grid as
    # K1's primary rays are spread, and can show what a ray order does
    # to the reads
    t_in, _, hits = ray_grid_clip(o, d, dims)
    eo = torch.where(hits[:, None], o + (t_in + 1e-3)[:, None] * d, o)
    entry_tables = {k: tables[k] for k in ("morton16", "bricked16")}

    # the main path, counted: the cost probe
    probe.reset_launch_counts()
    t0 = time.perf_counter()
    if device.type == "cuda":
        cost = probe.cost_probe(o, d, tables, dims, reps=reps,
                                threads=threads, orders=orders,
                                image_shape=(h, w))
        cost += probe.cost_probe(o, d, {"morton16": tables["morton16"]},
                                 dims, reps=reps, threads=(256,),
                                 steps=("tpu",))
        entry = probe.cost_probe(eo, d, entry_tables, dims, reps=reps,
                                 variants=("nofetch", "full"),
                                 threads=(256,), orders=orders,
                                 image_shape=(h, w))
    else:
        entry = []
        for layout, table in entry_tables.items():
            probe.march_probe(eo, d, table, dims, probe.N_ITERS, "full",
                              layout)
        cost = []
        for order in orders:
            po, pd, _ = probe.ordered_rays(o, d, (h, w), order)
            for layout, table in tables.items():
                for v in probe.VARIANTS:
                    probe.march_probe(po, pd, table, dims, probe.N_ITERS, v,
                                      layout)
    _sync(device)
    cost_s = time.perf_counter() - t0
    launches = probe.LAUNCHES["march_probe_kernel"]
    print(f"phase 9 resume: launches during the cost probe ({len(orders)} "
          f"orders x {len(tables)} layouts x {len(probe.VARIANTS)} variants"
          + (f" x {len(threads)} block sizes, the TPU float step"
             if cost else "") + f", the rays from their grid entry, "
          f"{cost_s:.1f} s): march_probe_kernel {launches}")
    if device.type == "cuda" and launches == 0:
        raise AssertionError("the cost probe did not launch "
                             "march_probe_kernel")

    # both steps against their plain versions on every ray, in every order
    # (a block order's acc put back in pixel order); the reads and the
    # words each variant's rays read (not counted)
    ordered = {k: probe.ordered_rays(o, d, (h, w), k) for k in orders}
    work, acc_sum = {}, {}
    for layout, table in tables.items():
        for v in probe.VARIANTS:
            runs = {}
            for step in probe.STEPS:
                stats = {}
                want = probe.march_probe_reference(
                    o, d, table, dims, probe.N_ITERS, v, layout, step, stats)
                runs[step] = want
                work[(step, layout, v)] = dict(
                    reads=int(stats["reads"].sum(dtype=torch.int64)),
                    words=int(stats["touched"].sum()))
                for order in (orders if step == "k1" else ("scanline",)):
                    po, pd, inv = ordered.get(order) or (o, d, None)
                    got = probe.march_probe(po, pd, table, dims,
                                            probe.N_ITERS, v, layout,
                                            step=step)
                    got = got if inv is None else got[inv]
                    bad = int((got != want).sum())
                    err = max(err, float((got - want).abs().max()))
                    if bad:
                        raise AssertionError(
                            f"K6 {v} {layout} {step} {order} at {D}^3: acc "
                            f"differs from the plain version on {bad} rays")
            if not torch.equal(runs["k1"], runs["tpu"]):
                raise AssertionError(f"K6 {v} {layout}: the K1 step's plain "
                                     f"acc differs from the float step's")
            acc_sum[(v, layout)] = float(runs["k1"].double().sum())
    for layout, table in entry_tables.items():
        stats = {}
        want = probe.march_probe_reference(eo, d, table, dims, probe.N_ITERS,
                                           "full", layout, "k1", stats)
        bad = int((probe.march_probe(eo, d, table, dims, probe.N_ITERS,
                                     "full", layout) != want).sum())
        if bad:
            raise AssertionError(f"K6 full {layout} from the grid entry: acc "
                                 f"differs from the plain version on {bad} "
                                 f"rays")
        work[("entry", layout, "full")] = dict(
            reads=int(stats["reads"].sum(dtype=torch.int64)),
            words=int(stats["touched"].sum()))
        work[("entry", layout, "nofetch")] = dict(reads=0, words=0)
    print(f"phase 9 resume: K6 on all {n} rays at {D}^3, {probe.N_ITERS} "
          f"iterations: acc equal to the plain version bit for bit for "
          f"every variant x layout x order (K1 step) and every variant x "
          f"layout (float step), and the two steps' plain versions equal; "
          f"acc sums "
          + ", ".join(f"{v}/{lay} {x:.6g}" for (v, lay), x in acc_sum.items()))
    for (step, layout, v), wk in work.items():
        if v in ("nomath", "full", "static"):
            print(f"phase 9 resume: K6 {v} {layout} {step}: "
                  f"{wk['reads'] / (n * probe.N_ITERS):.6f} reads per "
                  f"ray-iteration, {wk['words']} distinct table words")

    out = dict(err=err, launches=launches, work={
        "/".join(k): x for k, x in work.items()})
    if device.type != "cuda":
        return out
    for row in entry:
        row["rays"] = "entry"
    for row in cost + entry:
        wk = work[(row.get("rays", row["step"]), row["layout"],
                   row["variant"])]
        row["reads_per_ray_iter"] = wk["reads"] / (n * probe.N_ITERS)
        row["bound"] = probe_bound(
            n, probe.N_ITERS, row["variant"],
            wk["words"] * tables[row["layout"]].element_size())
        row["share"] = row["bound"]["bound_ms"] / row["ms"]
        print(f"phase 9 resume: K6 {row.get('rays', 'camera'):6s} "
              f"{row['step']:3s} {row['order']:10s} "
              f"{row['variant']:7s} {row['layout']:10s} "
              f"{row['threads']:3d} threads: {row['ms']:.4f} ms device "
              f"({row['clock']}; {row['events_ms']:.4f} ms events), "
              f"{row['ns_per_ray_iter']:.6f} ns per ray-iteration, "
              f"{row['reads_per_ray_iter']:.4f} reads per ray-iteration; "
              f"bound {row['bound']['bound_ms']:.4f} ms by "
              f"{row['bound']['bound_by']} (share {row['share']:.3f})")
    key = lambda r: (r["step"], r["order"], r["layout"], r["threads"])
    full = {key(r): r for r in cost if r["variant"] == "full"}
    new, old = full[("k1", "scanline", "morton16", 256)], full[parent]
    out.update(cost=cost, entry=entry, full_ms=new["ms"],
               full_clock=new["clock"],
               parent_ms=old["ms"], parent_clock=old["clock"],
               bound=new["bound"],
               reads_per_ray_iter=new["reads_per_ray_iter"],
               plain_ms=median_ms(lambda: probe.march_probe_reference(
                   o, d, tables["morton16"], dims), device, 3),
               occupancy=k6_occupancy(dims), sass_loops=sass_loops(
                   "march_probe_kernel"))
    print(f"phase 9 resume: K6 full/morton16/256/scanline: K1 step "
          f"{new['ms']:.4f} ms ({new['clock']}), the float step (the form "
          f"first ported) {old['ms']:.4f} ms ({old['clock']}) in the same "
          f"run; plain version {out['plain_ms']:.1f} ms")
    for name, x in out["occupancy"].items():
        print(f"phase 9 resume: K6 {name}: {x['registers']} registers, "
              f"{x['blocks_per_sm']} blocks of 256 threads an SM")
    if out["sass_loops"] is None:
        print("phase 9 resume: K6 SASS: cuobjdump not found beside nvcc")
    for fn, loops in (out["sass_loops"] or {}).items():
        print(f"phase 9 resume: K6 SASS {fn}: loops (instructions, F2I) "
              + ", ".join(f"({x['size']}, {x['f2i']})" for x in loops))
    return out


def phase_resume(device, big_grid, h=H, w=W, case_d=64, case_hw=256,
                 budgets=None, runs=RUNS, reps=10, drain_r0=8,
                 drain_frac=256, threads=None, orders=None) -> dict:
    """Phase 9: K1' and K6 (see the module docstring). big_grid: phase
    4's world."""
    import torch

    from vxtpu_torch import bench
    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render import kernel_march as km
    from vxtpu_torch.render import probe
    from vxtpu_torch.world.packed import build_packed_morton, morton3

    t_phase = time.perf_counter()
    budgets = kc.RESUME_BUDGETS if budgets is None else budgets
    err = {"march_resume_kernel": 0.0}
    for name in kc.MARCH_CASES:
        m = kc.run_resume_case(name, device, case_d, case_hw, case_hw,
                               budgets)
        print(f"phase 9 resume: K1' {name}: survivors by budget "
              f"{m['survivors']}; mismatches {m['mismatch']}; merged rounds "
              f"vs the single round differ on {m['merged']} of {m['n']}")
        kc.check_resume_case(m, f"K1' {name}")

    dims = big_grid.dims
    D = dims[0]
    accel = build_packed_morton(big_grid.occupancy, cap=64)
    _, requests = _main_scene(device, D)
    cams = {name: (cam, st) for name, cam, st, _ in requests}
    ms = cams["lambert"][1].resolve_max_steps(dims)
    sets = ("lambert", "inside_air_lambert")
    rays = {k: generate_rays(cams[k][0], h, w) for k in sets}
    o, d = rays["lambert"]
    n = o.shape[0]

    # the main path, counted: the sorted march of both ray sets (K6's
    # cost probe is counted in k6_probe)
    km.reset_launch_counts()
    stats = {k: {} for k in sets}
    srec = {k: km.march_sorted(*rays[k], accel, dims, ms, stats=stats[k])
            for k in sets}
    _sync(device)
    launches = dict(km.LAUNCHES)
    print(f"phase 9 resume: launches during march_sorted of the {len(sets)} "
          f"ray sets at {D}^3 {h}x{w}: {launches}")
    if device.type == "cuda" and launches["march_resume_kernel"] == 0:
        raise AssertionError("march_sorted did not launch "
                             "march_resume_kernel")

    # comparisons with the plain versions and single-round K1 (not
    # counted)
    single = {k: km.march(*rays[k], accel, dims, ms) for k in sets}
    for k in sets:
        bad = kc.exact_mismatch(srec[k], single[k])
        st = stats[k]
        print(f"phase 9 resume: march_sorted {k}: {st['survivors']} of {n} "
              f"rays live after round 0 ({st['rounds']} resume round(s) of "
              f"{st['buffer']}); vs single-round K1 march-only: "
              f"hit/t/voxel/normal/steps differ on {bad} rays")
        if bad:
            raise AssertionError(f"march_sorted {k} differs from the single "
                                 f"round on {bad} rays")
    dstats = {}
    drained = km.march_sorted(o, d, accel, dims, ms, round0_iters=drain_r0,
                              survivor_frac=drain_frac, stats=dstats)
    bad = kc.exact_mismatch(drained, single["lambert"])
    print(f"phase 9 resume: march_sorted lambert, round0_iters {drain_r0}, "
          f"survivor_frac {drain_frac}: buffer {dstats['buffer']}, "
          f"{dstats['rounds']} resume rounds for {dstats['survivors']} "
          f"survivors; differs from the single round on {bad} rays")
    if bad or dstats["rounds"] < 2:
        raise AssertionError(f"forced drain: {dstats['rounds']} rounds, "
                             f"{bad} rays differ")
    del drained

    # K1' against its plain version on every lambert ray
    r0k, e0k = km.march(o, d, accel, dims, ms, iter_budget=24, extended=True)
    with _logged_fetch(km, accel.words) as log0:
        r0p, e0p = km.march_reference(o, d, accel, dims, ms, iter_budget=24,
                                      extended=True)
    m0 = kc.resume_mismatch(r0k, e0k, r0p, e0p)
    state = (r0p.voxel, torch.where(e0p["done"], -1, e0p["dist"]),
             r0p.steps)
    r1k, e1k = km.march(o, d, accel, dims, ms, resume_state=state,
                        extended=True)
    with _logged_fetch(km, accel.words) as log1:
        r1p, e1p = km.march_reference(o, d, accel, dims, ms,
                                      resume_state=state, extended=True)
    m1 = kc.resume_mismatch(r1k, e1k, r1p, e1p)
    merged = kc.exact_mismatch(kc.merge_rounds(e0k["done"], r0k, r1k),
                               single["lambert"])
    err["march_resume_kernel"] = max(
        float((r0k.t - r0p.t).abs().max()), float((r1k.t - r1p.t).abs().max()))
    print(f"phase 9 resume: K1' on all {n} lambert rays at {D}^3: round 0 "
          f"(budget 24) mismatches {m0}; resume mismatches {m1}; the two "
          f"rounds vs single-round K1 differ on {merged} rays")
    if any(m0.values()) or any(m1.values()) or merged or \
            not bool(e1k["done"].all()):
        raise AssertionError("K1' differs from its plain version on the "
                             "lambert rays")
    del r0p, e0p, r1p, e1p

    # warp coherence (host arithmetic on steps)
    coh = {}
    for k in sets:
        st = stats[k]
        live0 = ~st["round0_done"]
        coh[k] = dict(
            single=probe.warp_coherence(single[k].steps),
            survivors=st["survivors"],
            unsorted=probe.warp_coherence(
                (srec[k].steps - st["round0_steps"])[live0]),
            sorted=probe.warp_coherence(st["resume_steps"][0])
            if st["resume_steps"] else 1.0)
        print(f"phase 9 resume: warp coherence {k} (steps / 32 x warp max): "
              f"single round in launch order {coh[k]['single']:.4f}; the "
              f"{st['survivors']} survivors of round 0, their resume steps "
              f"in launch order {coh[k]['unsorted']:.4f}, in the sorted "
              f"resume round's order {coh[k]['sorted']:.4f}")

    times = dict(coherence=coh, launches=launches)
    steps0 = int((r0k.steps).sum(dtype=torch.int64))
    alive = ~e0k["done"]
    steps1 = int((r1k.steps - r0k.steps)[alive].sum(dtype=torch.int64))
    words0, words1 = log0.count(), log1.count()
    times["bound0"] = k1r_bound(n, steps0, False, False, words0)
    times["bound0_rays_only_ms"] = k1r_bound(n, steps0, False,
                                             False)["bound_ms"]
    if device.type == "cuda":
        round0 = lambda: km.march(o, d, accel, dims, ms, iter_budget=24,
                                  extended=True)
        resume_all = lambda: km.march(o, d, accel, dims, ms,
                                      resume_state=state, extended=True)
        # the survivors alone, in launch order and in Morton order
        ids = torch.nonzero(alive).squeeze(1)
        v = r0k.voxel
        key = torch.where(alive, morton3(v[:, 0] >> 1, v[:, 1] >> 1,
                                         v[:, 2] >> 1), 1 << 30)
        sids = torch.argsort(key, stable=True)[:ids.numel()]
        bufs = {}
        for tag, sel in (("launch order", ids), ("Morton order", sids)):
            bufs[tag] = (o[sel], d[sel], (v[sel], e0k["dist"][sel],
                                          r0k.steps[sel]))
        t = dict(
            round0_events_ms=median_ms(round0, device, runs),
            round0_plain_ms=median_ms(lambda: km.march_reference(
                o, d, accel, dims, ms, iter_budget=24, extended=True),
                device, 3))
        dev = {"round0_ms": bench.device_time(
                   t, "round0_ms", round0, device, reps,
                   "march_resume_kernel"),
               "resume_all_ms": bench.device_time(
                   t, "resume_all_ms", resume_all, device, reps,
                   "march_resume_kernel"),
               "k1_ms": bench.device_time(t, "k1_ms", lambda: km.march(
                   o, d, accel, dims, ms), device, reps,
                   "march_shade_kernel")}
        for tag, (bo, bd, bs) in bufs.items():
            key = f"survivors_{tag.split()[0]}_ms"
            dev[key] = bench.device_time(
                t, key, lambda bo=bo, bd=bd, bs=bs: km.march(
                    bo, bd, accel, dims, ms, resume_state=bs, extended=True),
                device, reps, "march_resume_kernel")
        t["resume_launch_us"] = probe.launch_us(resume_all, reps,
                                                "march_resume_kernel")
        print(f"phase 9 resume: K1' resume of all rays, one more profiler "
              f"window: {len(t['resume_launch_us'])} of {reps} launches "
              f"recorded, us: "
              + " ".join(f"{u:.2f}" for u in t["resume_launch_us"]))
        b1 = k1r_bound(n, steps1, True, False, words1)
        times.update(t)
        times["bound1"] = b1
        print(f"phase 9 resume: device time per launch at {D}^3 {h}x{w} "
              f"({reps} launches): K1' round 0 (budget 24) "
              f"{dev['round0_ms']} (events {t['round0_events_ms']:.3f} "
              f"ms; bound {times['bound0']['bound_ms']:.4f} ms by "
              f"{times['bound0']['bound_by']} with the {words0} table words "
              f"its plain march reads, {times['bound0_rays_only_ms']:.4f} ms "
              f"without; plain "
              f"{t['round0_plain_ms']:.1f} ms); K1' resume of all rays "
              f"{dev['resume_all_ms']} (bound {b1['bound_ms']:.4f} ms by "
              f"{b1['bound_by']} with {words1} table words); the "
              f"{ids.numel()} survivors alone in "
              f"launch order {dev['survivors_launch_ms']}, in Morton "
              f"order {dev['survivors_Morton_ms']}; K1 march-only "
              f"{dev['k1_ms']}; round-0 steps {steps0}, resume steps "
              f"{steps1}")
        sp = probe.sorted_probe(o, d, accel, dims, ms, reps=runs)
        times["sorted_probe"] = sp
        print(f"phase 9 resume: sorted_probe at {D}^3 {h}x{w} (events, "
              f"{runs} calls): argsort of {sp['n']} keys "
              f"{sp['argsort_ms']:.3f} ms; single-round K1 march-only "
              f"{sp['single_ms']:.3f} ms ({sp['single_device_ms']:.4f} ms "
              f"device, {sp['single_device_clock']}); march_sorted "
              + "; ".join(f"round0_iters {r0}: {x['ms']:.3f} ms, "
                          f"{x['survivors']} survivors, {x['rounds']} "
                          f"round(s)" for r0, x in sp["sorted"].items()))
    del single, srec, r0k, e0k, r1k, e1k
    k6 = k6_probe(device, big_grid, h, w, case_d, case_hw, reps, threads,
                  orders)
    err["march_probe_kernel"] = k6.pop("err")
    times["k6"] = k6
    secs = time.perf_counter() - t_phase
    print(f"phase 9 resume: {secs:.1f} s")
    return {"err": err, "times": times, "seconds": secs}


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


def _grads(tab, plain, o, d, settings, S, lights=None, target=None,
           cot=None, tc=None, mask=None, bounds=None):
    """Loss (or colour) and the gradient to the Morton table's four
    channels (sigma, r, g, b) through the kernel path, or through the
    kernels' plain versions; ``mask`` and ``bounds``: the masked model."""
    import torch

    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.render.soft_kernel import (MortonSoftGrid,
                                                render_soft_rays_kernel)
    from vxtpu_torch.train.kernel_tv import tv_prior
    from vxtpu_torch.train.loss import mse, tv_prior_morton

    p = tab.detach().clone().requires_grad_(True)
    out = render_soft_rays_kernel(MortonSoftGrid(p), o, d, settings, S,
                                  lights=lights, plain=plain, mask=mask,
                                  seg_bounds=bounds)
    if target is not None:
        prior = tv_prior_morton if plain else tv_prior
        loss = mse(out, target) + prior(p, tc.tv_sigma, tc.tv_rgb)
        g, = torch.autograd.grad(loss, [p])
        return loss.detach(), kc.channels(g)
    g, = torch.autograd.grad(out, [p], cot)
    return out.detach(), kc.channels(g)


def _device_us(e) -> float:
    us = getattr(e, "self_device_time_total", None)
    return us if us is not None else getattr(e, "self_cuda_time_total", 0.0)


def _profile_step(step, device, big, steps=2):
    """One profiled window of ``steps`` steps (torch.profiler): device time
    per step (ms) by kernel name; the device time of the aten ops whose
    inputs have >= ``big`` elements (work on the dense [D^3] tables other
    than Adam's: zero-fills, gradient accumulation, copies, the TV
    prior), as op -> (ms, the most dimensions of its inputs); and the
    wall time per step."""
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
            ms = dense.get(key, (0.0, 0))[0] + _device_us(e) / 1e3 / steps
            dense[key] = (ms, max(len(sh) for sh in shapes))
    return kernels, dense, wall


def _group_kernels(kernels: dict, dense: dict) -> dict:
    """Device ms per step by part: K3, K4 (its scatter, and its ray sums
    where they run), Adam (adam_step_kernel), the TV prior (its
    kernels, train/kernel_tv.py; in the plain version the dense ops on its
    [D^3/8, 2, 2, 2, 4] view of the table, forward and backward: the only
    inputs of 4 or more dimensions in a step), the other dense-table glue
    (K4's zero-fill, gradient accumulation), and the rest (the [S, N] math
    of render_soft_rays_kernel and its autograd)."""
    from vxtpu_torch.train import kernel_adam, kernel_tv

    tv = sum(ms for ms, ndim in dense.values() if ndim >= 4)
    glue = sum(ms for ms, ndim in dense.values() if ndim < 4)
    groups = {"K3 sample_fwd_kernel": 0.0, "K4 sample_bwd_kernel": 0.0,
              "Adam": 0.0, "TV prior": tv, "dense-table glue": glue,
              "[S,N] math": -(tv + glue)}
    for name, ms in kernels.items():
        low = name.lower()
        if "sample_fwd_kernel" in name:
            groups["K3 sample_fwd_kernel"] += ms
        elif "sample_bwd_kernel" in name or "sample_ray_sum_kernel" in name:
            groups["K4 sample_bwd_kernel"] += ms
        elif any(k in name for k in kernel_adam.LAUNCHES):
            groups["Adam"] += ms
        elif any(k in name for k in kernel_tv.LAUNCHES):
            groups["TV prior"] += ms
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


def _bound(b, f) -> dict:
    tb, tf = b / PEAK_BYTES * 1e3, f / PEAK_F32 * 1e3
    return dict(bytes=b, ops=f, bound_ms=max(tb, tf),
                bound_by="bytes" if tb >= tf else "operations")


def tv_times(device, D=FULL, reps=10, rounds=3) -> dict:
    """The Morton TV prior's kernel pair (train/kernel_tv.py) at 64^3 and
    D^3 against its plain version in each of kernel_check.TV_CASES
    (run_tv_case; raises on a difference; "err" the largest errors by
    kernel), then on one random D^3 table the device times, each the
    median of ``rounds`` profiler windows of ``reps`` calls
    (render/probe.py:device_ms): each kernel's a launch ("fwd_kernel",
    "fwd_finish", "bwd": tv_bwd_kernel), a forward call's ("fwd": the
    sum of its two kernels), beside their bounds (the forward reads the
    table once, the backward reads it and writes its gradient once), and
    the plain version's a call, its forward alone and forward with
    backward (autograd)."""
    import torch

    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.render import probe
    from vxtpu_torch.train import kernel_tv
    from vxtpu_torch.train.loss import tv_prior_morton

    out = {"checks": {}, "err": {}}
    for dim in (64, D):
        for case in kc.TV_CASES:
            m = kc.run_tv_case(dim, device, case)
            kc.check_tv_case(m, f"TV prior at {dim}^3")
            out["checks"][f"{dim}/{case}"] = m
            _add_tv_err(out["err"], m)
            print(f"TV prior at {dim}^3 ({case}): value {m['value']!r}, "
                  f"plain {m['plain']!r} (rel {m['value_rel']:.3g}), second "
                  f"launch equal; gradient off by {m['grad_err']:.3g} x max "
                  f"|g|")
            torch.cuda.empty_cache()
    tab = kc.tv_table(D, device, seed=1)
    g = torch.ones((), device=device)
    w = kc.TV_WEIGHTS
    q = tab.clone().requires_grad_(True)
    rows = tab.shape[0]
    fwd = _bound(rows * 16, rows * TV_FWD_OPS)
    # each kernel's time a launch, over the launches the profiler recorded
    # (it can drop some); the plain version's a call, over every call
    calls = {
        "fwd_kernel": ("tv_fwd_kernel", lambda: kernel_tv.tv_fwd(tab, *w),
                       fwd),
        # the partials read and the value written
        "fwd_finish": ("tv_fwd_finish_kernel",
                       lambda: kernel_tv.tv_fwd(tab, *w),
                       _bound(kernel_tv.FWD_PARTS * 16 + 4,
                              kernel_tv.FWD_PARTS * 4)),
        "bwd": ("tv_bwd_kernel", lambda: kernel_tv.tv_bwd(tab, g, *w),
                _bound(rows * 32, rows * TV_BWD_OPS)),
        "plain_fwd": ("", lambda: tv_prior_morton(tab, *w), None),
        "plain_fwd_bwd": ("", lambda: torch.autograd.grad(
            tv_prior_morton(q, *w), [q]), None)}
    for name, (kernel, fn, bound) in calls.items():
        runs = [probe.device_ms(fn, reps, kernel, per_call=not kernel)
                for _ in range(rounds)]
        out[name] = dict(device_ms=statistics.median(r[0] for r in runs),
                         clock=runs[0][1], rounds_ms=[r[0] for r in runs],
                         bound=bound)
        torch.cuda.empty_cache()
    # a forward call: its two kernels
    out["fwd"] = dict(device_ms=out["fwd_kernel"]["device_ms"]
                      + out["fwd_finish"]["device_ms"],
                      clock=out["fwd_kernel"]["clock"], bound=fwd)
    for name in [*calls, "fwd"]:
        row = out[name]
        bound = row.pop("bound")
        ms = row["device_ms"]
        if bound is not None:
            row.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                       share=bound["bound_ms"] / ms)
            if row["share"] > 1.05:
                raise AssertionError(f"TV prior at {D}^3, {name}: {ms} ms "
                                     f"is below its bound {row['bound_ms']} "
                                     f"ms: the time misses part of the work")
        print(f"TV prior at {D}^3, {name}: {ms:.4f} ms "
              f"({row['clock']})" + (f"; bound {row['bound_ms']:.4f} ms "
                                     f"({row['bound_by']}), share "
                                     f"{row['share']:.3f}" if bound else ""))
    return out


def adam_bound(D) -> dict:
    """Adam's update of the [D^3, 4] float32 table: the table, its
    gradient and the two moments read once, the table and the moments
    written once (7 x 16 B a row), ADAM_OPS an element."""
    return _bound(7 * 16 * D ** 3, ADAM_OPS * 4 * D ** 3)


def adam_times(device, D=FULL, reps=10, rounds=3, steps=3) -> dict:
    """Adam's kernel (train/kernel_adam.py) against torch's foreach step in
    each of kernel_check.ADAM_CASES and over ``steps`` steps of a random
    [D^3, 4] table (run_adam_case; raises on a difference; "err" the
    largest |difference|), then on one random [D^3, 4] table, gradient and
    moments the device times, each the median of ``rounds`` profiler
    windows of ``reps`` calls (render/probe.py:device_ms): the kernel's a
    launch ("kernel", beside adam_bound; a share above 1.05 raises), the
    plain version's a call ("plain": torch's single-tensor ops) and
    torch.optim.Adam's foreach step a call ("foreach", the library
    yardstick: the path the kernel replaces)."""
    import torch

    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.render import probe
    from vxtpu_torch.train import kernel_adam
    from vxtpu_torch.train.loop import ADAM_EPS, BETAS

    out = {"checks": {}, "err": 0.0}
    cases = {**kc.ADAM_CASES,
             f"table{D}": dict(shapes=[(D ** 3, 4)], steps=steps)}
    for name, case in cases.items():
        m = kc.run_adam_case(device, **case)
        kc.check_adam_case(m, f"Adam ({name})")
        out["checks"][name] = {k: m[k] for k in (
            "excess", "max_abs", "unequal", "elements", "rerun_equal",
            "launches")}
        out["err"] = max(out["err"], m["max_abs"])
        print(f"Adam ({name}): {m['steps']} steps against torch's foreach "
              f"step: allclose excess {m['excess']:.3g}, max |d| "
              f"{m['max_abs']:.3g}, {m['unequal']} of {m['elements']} values "
              f"not bit-equal; second run equal; {m['launches']} launches")
        torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(1)
    p, g, m, v = (torch.randn((D ** 3, 4), generator=gen, device=device)
                  for _ in range(4))
    v.square_()
    q = p.clone().requires_grad_(True)
    q.grad = g
    lib = torch.optim.Adam([q], lr=5e-2, betas=BETAS, eps=ADAM_EPS,
                           foreach=True)
    args = (BETAS, ADAM_EPS)
    # (kernel name, per call, fn, bound): the kernel's time a launch over
    # the launches recorded; the others' a call, over every call (the
    # foreach step's by its kernels' name, as the profiler mirrors the
    # step's record_function range on the device timeline)
    calls = {
        "kernel": ("adam_step_kernel", False, lambda: kernel_adam.adam_step(
            p, g, m, v, 10, 5e-2, *args), adam_bound(D)),
        "plain": ("", True, lambda: kernel_adam.adam_step_reference(
            p, g, m, v, 10, 5e-2, *args), None),
        "foreach": ("multi_tensor_apply_kernel", True, lib.step, None)}
    for name, (kernel, per_call, fn, bound) in calls.items():
        runs = [probe.device_ms(fn, reps, kernel, per_call=per_call)
                for _ in range(rounds)]
        row = out[name] = dict(device_ms=statistics.median(
            r[0] for r in runs), clock=runs[0][1],
            rounds_ms=[r[0] for r in runs])
        ms = row["device_ms"]
        if bound is not None:
            row.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                       bytes=bound["bytes"], share=bound["bound_ms"] / ms)
            if row["share"] > 1.05:
                raise AssertionError(f"Adam at {D}^3: {ms} ms is below its "
                                     f"bound {row['bound_ms']} ms: the time "
                                     f"misses part of the work")
        print(f"Adam at {D}^3, {name}: {ms:.4f} ms ({row['clock']}; rounds "
              + ", ".join(f"{t:.4f}" for t in row["rounds_ms"]) + ")"
              + (f"; bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
                 f"{row['bytes']:.4g} B), share {row['share']:.3f}"
                 if bound else ""))
    del p, g, m, v, q, lib
    torch.cuda.empty_cache()
    return out


def sample_bounds(n, S, D, active_samples, touched, lit=False,
                  ray_grads=True) -> dict:
    """Least times (ms) of K3 and K4 for one call: the larger of the bytes
    each must move over the HBM rate and its float32 operations over the
    float32 peak. Each input is read once and each output written once:
    K3 reads the rays (32 B each) and the table rows its samples touch
    (16 B each: four channels, whatever their layout), and writes nout
    [S, N] planes; K4 reads the rays and nout [S, N] cotangent planes and
    adds into the gradient rows its samples touch (16 B each, written
    once; the wrapper's zero-fill of the dense [D^3, 4] gradient is not
    the kernel's work: zero_fill_bound), and with ``ray_grads`` also reads
    the touched rows and writes the ray cotangents (32 B each)."""
    nout = 7 if lit else 4
    fwd_bytes = n * 32 + 4 * 4 * touched + nout * S * n * 4
    bwd_bytes = n * 32 + nout * S * n * 4 + 4 * 4 * touched
    if ray_grads:
        bwd_bytes += 4 * 4 * touched + n * 32
    fwd_ops = active_samples * (FWD_OPS + (FWD_OPS_LIT if lit else 0))
    bwd_ops = active_samples * (
        (BWD_OPS + (BWD_OPS_LIT if lit else 0)) if ray_grads
        else (SCATTER_OPS + (SCATTER_OPS_LIT if lit else 0)))
    return dict(fwd=_bound(fwd_bytes, fwd_ops), bwd=_bound(bwd_bytes, bwd_ops))


def zero_fill_bound(D) -> dict:
    """The wrapper's zero-fill of K4's dense [D^3, 4] float32 gradient:
    16 B a row written."""
    return _bound(16 * D ** 3, 0)


def zero_fill_times(D, device, runs, prefix) -> dict:
    """Device time of the zero-fill that K4's wrapper makes before the
    kernel (torch.zeros of the [D^3, 4] gradient), beside its bound;
    prints one line."""
    import torch

    from vxtpu_torch import bench

    row = dict(**zero_fill_bound(D))
    # the fill's own kernel (at::native::FillFunctor), per recorded launch
    dev = bench.device_time(
        row, "device_ms", lambda: torch.zeros((D ** 3, 4),
                                              device=device), device, runs,
        "FillFunctor")
    print(f"{prefix}: K4's wrapper zero-fills the [{D}^3, 4] gradient "
          f"before the kernel: device {dev}; bound {row['bound_ms']:.4f} ms "
          f"by bytes ({row['bytes']:.4g} B written)")
    return row


def ray_sum_bound(n, chunks) -> dict:
    """sample_ray_sum_kernel: reads the [chunks, 8, N] partial sums, writes
    32 B per ray, one add per partial."""
    return _bound(chunks * 8 * n * 4 + n * 32, chunks * 8 * n)


def phase_train(device, D=FULL, h=256, w=256, S=256, steps=5,
                runs=RUNS) -> dict:
    """Phase 6: the c4_512_diff fit through the sampling kernels."""
    import torch

    from vxtpu_torch import bench
    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.app.configs import CONFIGS
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render import kernel_sample as ks
    from vxtpu_torch.render import soft
    from vxtpu_torch.render.soft_kernel import MortonSoftGrid, _enter_dt_soft
    from vxtpu_torch.train import kernel_adam, kernel_tv, loop
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

    # the main path, counted: five fit_soft steps (the rays carry no
    # gradient, so K4 runs its pure scatter)
    tc = loop.TrainConfig(field_kernel=True, num_samples=S, ray_batch=0,
                          steps=steps, seed=cfg4.seed)
    timer = StepTimer(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ks.reset_launch_counts()
    kernel_tv.reset_launch_counts()
    kernel_adam.reset_launch_counts()
    timer()
    fitted, _, losses, _ = loop.fit_soft(
        soft.SoftGrid.zeros(dims, device=device), cam,
        target.reshape(h, w, 3), settings, tc, step_hook=timer)
    _sync(device)
    launches = dict(ks.LAUNCHES)
    tv_launches = dict(kernel_tv.LAUNCHES)
    adam_launches = dict(kernel_adam.LAUNCHES)
    step_ms = timer.ms()
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else float("nan"))
    print(f"phase 6 train: launches during the {steps} steps: {launches}; "
          f"TV prior {tv_launches}; Adam {adam_launches}")
    print(f"phase 6 train: losses {losses}")
    print(f"phase 6 train: step ms {[round(x, 3) for x in step_ms]} "
          f"(the first includes the Morton conversion); median of steps "
          f"2..{steps} {statistics.median(step_ms[1:]):.3f} ms; peak memory "
          f"{peak:.2f} GiB")
    if device.type == "cuda" and launches != {
            "sample_fwd_kernel": steps, BWD[False]: steps, BWD[True]: 0,
            "sample_ray_sum_kernel": 0}:
        raise AssertionError(f"the train steps did not run K3 and K4's pure "
                             f"scatter once each a step, and nothing else "
                             f"of K4's: {launches}")
    if device.type == "cuda" and tv_launches != dict.fromkeys(
            kernel_tv.LAUNCHES, steps):
        raise AssertionError(f"the train steps did not run each TV prior "
                             f"kernel once a step: {tv_launches}")
    if device.type == "cuda" and adam_launches != {"adam_step_kernel": steps}:
        raise AssertionError(f"the train steps did not run Adam's kernel "
                             f"once a step (one table): {adam_launches}")
    _check_losses(losses)

    # the kRayGrads variant's own path: fit_soft refining the camera pose,
    # whose rays carry gradients (two steps, counted; Adam once a step for
    # the table and each of the camera's four tensors)
    ks.reset_launch_counts()
    kernel_adam.reset_launch_counts()
    _, cam_fit, cam_losses, _ = loop.fit_soft(
        soft.SoftGrid.zeros(dims, device=device), cam,
        target.reshape(h, w, 3), settings,
        loop.TrainConfig(field_kernel=True, num_samples=S, ray_batch=0,
                         steps=2, seed=cfg4.seed, optimize_camera=True))
    _sync(device)
    cam_launches = dict(ks.LAUNCHES)
    moved = float((cam_fit.pos - cam.pos).abs().max())
    print(f"phase 6 train: camera refinement, 2 steps: launches "
          f"{cam_launches}; losses {cam_losses}; pose moved {moved:.3g}")
    if device.type == "cuda" and not (
            cam_launches[BWD[True]] == 2 and cam_launches[BWD[False]] == 0
            and cam_launches["sample_ray_sum_kernel"] == 2):
        raise AssertionError(f"the camera refinement did not run K4 with "
                             f"kRayGrads: {cam_launches}")
    if device.type == "cuda" and kernel_adam.LAUNCHES != {
            "adam_step_kernel": 2 * (1 + len(loop.CAM_FIELDS))}:
        raise AssertionError(f"the camera refinement did not run Adam's "
                             f"kernel once a parameter a step: "
                             f"{kernel_adam.LAUNCHES}")
    if not moved > 0.0:
        raise AssertionError("the camera refinement did not move the pose")
    _check_losses(cam_losses)

    # measurement and comparison with the plain versions (not counted)
    err = {}
    tab_fit = MortonSoftGrid.from_soft(fitted).tab
    del fitted
    tflat = target.reshape(-1, 3)
    lk, gk = _grads(tab_fit, False, o, d, settings, S, target=tflat, tc=tc)
    lp, gp = _grads(tab_fit, True, o, d, settings, S, target=tflat, tc=tc)
    ex = kc.grads_excess(gk, gp)
    rel = abs(float(lk) - float(lp)) / abs(float(lp))
    print(f"phase 6 train: one step at the fitted state, kernels vs plain "
          f"versions: loss {float(lk):.8f} vs {float(lp):.8f} (rel "
          f"{rel:.3g}); gradient allclose excess {ex:.3g}, max |d| "
          f"{max(float((a - b).abs().max()) for a, b in zip(gk, gp)):.3g}")
    if rel > 1e-6 or ex > 1.0:
        raise AssertionError("train step: kernels and plain versions differ")
    err[BWD[False]] = max(float((a - b).abs().max())
                          for a, b in zip(gk, gp))
    del gk, gp

    light = Lights.single((0.2 * D, -0.3 * D, 1.4 * D), intensity=2.0,
                          device=device)
    tab = MortonSoftGrid.from_soft(truth).tab
    del truth
    g = torch.Generator().manual_seed(0)
    cot = torch.randn(h * w, 3, generator=g).to(device)
    rk, gk = _grads(tab, False, o, d, settings, S, lights=light, cot=cot)
    rp, gp = _grads(tab, True, o, d, settings, S, lights=light, cot=cot)
    lit_ex = kc.grads_excess(gk, gp)
    lit_d = float((rk - rp).abs().max())
    print(f"phase 6 train: lit render_soft_rays_kernel at {D}^3, {h}x{w}, "
          f"S = {S}, the config's light: colour max |d| {lit_d:.3g}; "
          f"gradient allclose excess {lit_ex:.3g}")
    if lit_d > 1e-5 or lit_ex > 1.0:
        raise AssertionError("lit path: kernels and plain versions differ")
    err[BWD[False]] = max(err[BWD[False]], max(
        float((a - b).abs().max()) for a, b in zip(gk, gp)))
    del gk, gp

    # K3 and both K4 variants alone at the main path's shape, on the
    # truth's table
    st, sdt, _ = _enter_dt_soft(o, d, dims, S, None)
    st, sdt = st.contiguous(), sdt.contiguous()
    got = ks.sample_fields_fwd(tab, o, d, st, sdt, S, D)
    want = ks.sample_fields_fwd_reference(tab, o, d, st, sdt, S, D)
    err["sample_fwd_kernel"] = max(float((a - b).abs().max())
                                   for a, b in zip(got, want))
    if err["sample_fwd_kernel"] > kc.FWD_ATOL:
        raise AssertionError(f"K3 at the main shape differs by "
                             f"{err['sample_fwd_kernel']}")
    del got, want
    cots = tuple(torch.randn(S, h * w, generator=g).to(device)
                 for _ in range(4))
    args = (tab, o, d, st, sdt, cots, D)
    times = {}
    for rg in (False, True):
        kb = ks.sample_grads(*args, ray_grads=rg)
        kb2 = ks.sample_grads(*args, ray_grads=rg)
        pb = ks.sample_fields_bwd_reference(*args, ray_grads=rg)
        tab_ex = kc.grads_excess(kc.channels(kb[0]), kc.channels(pb[0]))
        rerun = kc.grads_excess(kc.channels(kb2[0]), kc.channels(kb[0]))
        unequal = sum(int((a != b).sum()) for a, b in zip(kb[1:], pb[1:])
                      if a is not None)
        unequal2 = sum(int((a != b).sum()) for a, b in zip(kb2[1:], kb[1:])
                       if a is not None)
        err[BWD[rg]] = max(err.get(BWD[rg], 0.0),
                           float((kb[0] - pb[0]).abs().max()))
        if rg:
            err["sample_ray_sum_kernel"] = max(
                float((a - b).abs().max()) for a, b in zip(kb[1:], pb[1:]))
        rays = (f"ray cotangents unequal {unequal} (second run "
                f"{unequal2})" if rg else f"ray outputs {kb[1:]}")
        print(f"phase 6 train: K4 kRayGrads={str(rg).lower()} at N = "
              f"{h * w}, S = {S} vs plain: tables excess {tab_ex:.3g}, "
              f"second run {rerun:.3g}; {rays}")
        if tab_ex > 1.0 or rerun > 1.0 or unequal or unequal2 or (
                not rg and any(x is not None for x in kb[1:])):
            raise AssertionError(f"K4 kRayGrads={rg} at the main shape "
                                 f"differs from its plain version")
        del kb, kb2, pb
    times["sample_fwd_kernel"] = dict(
        ms=median_ms(lambda: ks.sample_fields_fwd(tab, o, d, st, sdt, S, D),
                     device, runs),
        plain_ms=median_ms(lambda: ks.sample_fields_fwd_reference(
            tab, o, d, st, sdt, S, D), device, 3))
    for rg in (False, True):
        times[BWD[rg]] = dict(
            ms=median_ms(lambda: ks.sample_grads(*args, ray_grads=rg),
                         device, runs),
            plain_ms=median_ms(lambda: ks.sample_fields_bwd_reference(
                *args, ray_grads=rg), device, 3))
    lib = library_yardstick(tab, o, d, st, sdt, S, D, cots, device, runs)
    times["sample_fwd_kernel"]["library_ms"] = lib["fwd_ms"]
    times[BWD[False]]["library_ms"] = lib["bwd_vol_ms"]
    times[BWD[True]]["library_ms"] = lib["bwd_ms"]
    active = int((sdt > 0).sum()) * S
    touched = _touched_words(o, d, st, sdt, S, D)
    bounds = sample_bounds(h * w, S, D, active, touched)
    bounds_scatter = sample_bounds(h * w, S, D, active, touched,
                                   ray_grads=False)
    chunks = -(-S // ks.RAY_CHUNK)
    times["sample_ray_sum_kernel"] = ray_sum_times(h * w, chunks, device,
                                                   runs)
    dev = {k: "not measured" for k in times}
    if device.type == "cuda":
        dev["sample_fwd_kernel"] = bench.device_time(
            times["sample_fwd_kernel"], "device_ms",
            lambda: ks.sample_fields_fwd(tab, o, d, st, sdt, S, D), device,
            runs, "sample_fwd_kernel")
        for rg in (False, True):
            dev[BWD[rg]] = bench.device_time(
                times[BWD[rg]], "device_ms",
                lambda: ks.sample_grads(*args, ray_grads=rg), device, runs,
                f"sample_bwd_kernel<{str(rg).lower()}, false>")
        rs = times["sample_ray_sum_kernel"]
        dev["sample_ray_sum_kernel"] = (
            f"{rs['device_ms']:.4f} ms warm ({rs['device_ms_clock']}; "
            f"{rs['warm_graph_ms']:.4f} ms a launch replayed from a CUDA "
            f"graph), {rs['cold_device_ms']:.4f} ms with L2 flushed "
            f"({rs['cold_device_ms_clock']})")
    for k, b in (("sample_fwd_kernel", bounds["fwd"]),
                 (BWD[False], bounds_scatter["bwd"]),
                 (BWD[True], bounds["bwd"]),
                 ("sample_ray_sum_kernel", ray_sum_bound(h * w, chunks))):
        times[k].update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
        lib_ms = times[k]["library_ms"]
        print(f"phase 6 train: {k} alone at N = {h * w}, S = {S}: "
              f"{times[k]['ms']:.3f} ms (events, the wrapper), device "
              f"{dev[k]}; plain "
              f"{times[k]['plain_ms']:.3f} ms, library "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms; bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes']:.4g} "
              f"B, {b['ops']:.4g} flop; {touched} table words touched, "
              f"{active} active samples)")
    times["zero_fill"] = zero_fill_times(D, device, runs, "phase 6 train")

    # where a step's time goes (profiler device times)
    model = MortonSoftGrid(tab_fit.detach().clone().requires_grad_(True))
    opt = loop.make_optimizer(tc, [model.tab])

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loop._loss_fn(model, cam, o, d, tflat, (h, w), settings, tc)
        loss.backward()
        opt.step()

    if device.type == "cuda":
        kernels, dense, wall = _profile_step(step, device, big=D ** 3)
        groups = _group_kernels(kernels, dense)
        busy = sum(kernels.values())
        print(f"phase 6 train: profiled step: wall {wall:.3f} ms, device "
              f"busy {busy:.3f} ms ({busy / wall * 100:.1f}%); by group "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()))
        for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
            print(f"phase 6 train:   kernel {ms:8.3f} ms  {name[:90]}")
        for name, (ms, _) in sorted(dense.items(),
                                    key=lambda kv: -kv[1][0])[:8]:
            print(f"phase 6 train:   dense op {ms:8.3f} ms  {name[:90]}")
        times["profile"] = dict(groups=groups, wall_ms=wall, busy_ms=busy)
        # the TV prior's kernel pair alone at D^3, in every case
        del model, opt
        torch.cuda.empty_cache()
        times["tv"] = tv_times(device, D)
        times["adam"] = adam_times(device, D)
    return {"launches": launches, "cam_launches": cam_launches, "err": err,
            "tv_launches": tv_launches, "adam_launches": adam_launches,
            "times": times, "losses": losses, "step_ms": step_ms}


def _check_losses(losses) -> None:
    if not all(v == v and abs(v) != float("inf") for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")


def ray_sum_times(n, chunks, device, runs) -> dict:
    """sample_ray_sum_kernel alone on random partial sums: its device time,
    its plain version's and torch.sum over the chunks (the library
    yardstick); the kernel must equal the plain version bit for bit."""
    import torch

    from vxtpu_torch import bench
    from vxtpu_torch.render import kernel_sample as ks

    g = torch.Generator().manual_seed(4)
    part = torch.randn(chunks, 8, n, generator=g).to(device)
    got, want = ks.ray_sums(part), ks.ray_sums_reference(part)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("sample_ray_sum_kernel differs from the "
                             "chunk-order sum")
    out = dict(ms=median_ms(lambda: ks.ray_sums(part), device, runs),
               plain_ms=median_ms(lambda: ks.ray_sums_reference(part),
                                  device, runs),
               library_ms=median_ms(lambda: torch.sum(part, dim=0), device,
                                    runs))
    if device.type == "cuda":
        bench.device_time(out, "device_ms", lambda: ks.ray_sums(part),
                          device, runs, "sample_ray_sum_kernel")
        # warm again from a CUDA graph's replay: the profiler often
        # records none of these short launches
        out.update(warm_graph_ms=graph_ms(lambda: ks.ray_sums(part)),
                   warm_graph_ms_clock="events")
        # the partial sums (35.7 MB at the main shape) stay in the 50 MB
        # L2 between launches: timed again with it flushed, a 128 MB
        # buffer written before each launch (its fill is not counted)
        flush = torch.empty(32 << 20, dtype=torch.float32, device=device)
        bench.device_time(out, "cold_device_ms", lambda: (
            flush.fill_(1.0), ks.ray_sums(part)), device, runs,
            "sample_ray_sum_kernel")
        del flush
    return out


def library_yardstick(tab, o, d, t0, dt, S, D, cots, device, runs,
                      prefix="phase 6 train") -> dict:
    """torch.nn.functional.grid_sample on the same samples: 5-D, bilinear
    (trilinear), align_corners=False, border padding, on a row-major
    [1, 4, D, D, D] volume; forward, its autograd backward to the volume
    and the sample positions (K4 with kRayGrads), and to the volume alone
    (the grid not requiring grad: the pure scatter). A timing yardstick
    only: it gives the same values inside [0.5, D - 0.5]^3 but not in the
    half-voxel shell at the low faces, where vxtpu's corner clamp differs;
    the grid's last axis is (x, y, z) -> (W, H, D), so a world point p goes
    in as (pz, py, px)."""
    import torch
    import torch.nn.functional as F

    from vxtpu_torch.render import kernel_sample as ks

    sigma, rgb = ks.fields_from_interleaved(tab, D)
    vol = torch.cat([sigma[None], rgb])[None]
    del sigma, rgb
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
        tab, o, d, t0, dt, S, D)[c])[inside].abs().max()) for c in range(4))
    del out
    fwd_ms = median_ms(fwd, device, runs)
    cot = torch.stack(cots)[None, :, :, :, None]
    vg = vol.detach().requires_grad_(True)
    ms = {}
    for key, gg in (("bwd_ms", grid.detach().requires_grad_(True)),
                    ("bwd_vol_ms", grid)):
        res = F.grid_sample(vg, gg, mode="bilinear", padding_mode="border",
                            align_corners=False)
        wrt = (vg, gg) if gg.requires_grad else (vg,)
        ms[key] = median_ms(lambda: torch.autograd.grad(
            res, wrt, cot, retain_graph=True), device, runs)
        del res
    print(f"{prefix}: grid_sample yardstick: agrees with K3 within "
          f"{same:.3g} inside [0.5, D - 0.5]^3; forward {fwd_ms:.3f} ms, "
          f"backward to the volume and the grid {ms['bwd_ms']:.3f} ms, to "
          f"the volume alone {ms['bwd_vol_ms']:.3f} ms")
    return dict(fwd_ms=fwd_ms, inside_max_abs=same, **ms)


def cross_train(device) -> dict:
    """The fit at 32^3 against the JAX package's loss trajectory (rtol
    1e-4), and K3 on fixed inputs against vxtpu's sample_fields_fwd
    checksums (each channel's sum within 1e-5 of its sum of |x|)."""
    import numpy as np
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
    if device.type == "cuda" and not (ks.LAUNCHES["sample_fwd_kernel"]
                                      and ks.LAUNCHES[BWD[False]]):
        raise AssertionError("the 32^3 fit did not run the kernels")

    sf = gold["sample_fwd"]
    fields, o, d, t0, dt, S = kc.golden_sample_inputs()
    tab = ks.build_interleaved_morton(
        torch.from_numpy(fields[0]).to(device),
        torch.from_numpy(np.stack(fields[1:])).to(device))
    outs = ks.sample_fields_fwd(tab, *(torch.from_numpy(x).to(device)
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


def xla_agreement(rec, ref) -> dict:
    """A batched-march HitRecord against K5's on the same rays, at
    tests/test_distfield.py's limits: the share of rays whose hit flags
    agree; on rays both hit, how many t differ beyond rtol 1e-4 / atol
    1e-3 (all of them, and those that hit the same voxel), and the shares
    of equal voxels and normals. A ray that grazes an edge may hit
    another voxel, and then another t, in each march."""
    both = rec.hit & ref.hit
    nb = max(int(both.sum()), 1)
    same = (rec.voxel == ref.voxel).all(-1) & both
    t_bad = ((rec.t - ref.t).abs() > 1e-3 + 1e-4 * ref.t.abs()) & both
    return dict(
        hit_agree=float((rec.hit == ref.hit).float().mean()),
        both=int(both.sum()), t_bad=int(t_bad.sum()),
        t_bad_same_voxel=int((t_bad & same).sum()),
        voxel=float(same.sum()) / nb,
        normal=float((((rec.normal - ref.normal).abs() < 1e-6).all(-1)
                      & both).sum()) / nb)


def check_xla_agreement(m: dict, what: str, against: str = "K5") -> None:
    if not (m["hit_agree"] >= 0.998 and m["t_bad_same_voxel"] == 0
            and m["voxel"] >= 0.998 and m["normal"] >= 0.995
            and m["both"] > 0):
        raise AssertionError(f"{what}: the march disagrees with {against}: "
                             f"{m}")


def _profile_launches(fn, device) -> dict:
    """One profiled call of fn: the device kernels it launched, their
    device time and the wall time (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
    n, busy = 0, 0.0
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith(("Optimizer.", "ProfilerStep"))):
            continue
        if _device_us(e):
            n += e.count
            busy += _device_us(e) / 1e3
    return dict(launches=n, busy_ms=busy, wall_ms=wall)


def phase_xla(device, D=256, h=1024, w=1024, runs=3, save=None,
              cli_size=(), card="") -> dict:
    """Phase 10 (a): the c3 frame through the batched march over the
    distance field and over the 2-level pyramid, held against K5 on the
    primary and shadow rays and as a frame; the render and bench
    commands with --kernel xla. ``card``: the GPU's name and power limit,
    printed beside the times."""
    import math
    import tempfile

    import torch

    from vxtpu_torch.app.configs import CONFIGS
    from vxtpu_torch.app.run import build_scene
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render import kernel_march as km
    from vxtpu_torch.render import kernel_packed as kp
    from vxtpu_torch.render import kernel_sample as ks
    from vxtpu_torch.render.dda import dda_step_mask
    from vxtpu_torch.render.kernel_xla import make_march_xla
    from vxtpu_torch.render.pipeline import render_image, shadow_ray_batch
    from vxtpu_torch.utils import save_png
    from vxtpu_torch.world import distfield
    from vxtpu_torch.world.packed import build_packed
    from vxtpu_torch.world.pyramid import build_pyramid

    cfg = CONFIGS["c3_256_shadows"]
    settings = cfg.settings
    dims = (D,) * 3
    t0 = time.perf_counter()
    grid, _, cam, lights = build_scene(cfg, dims, "none", device)
    accels = {"distfield": distfield.build(grid.occupancy, cap=24),
              "pyramid": build_pyramid(grid.occupancy,
                                       settings.pyramid_levels)}
    packed = build_packed(grid.occupancy)
    _sync(device)
    print(f"phase 10 xla+mask: {cfg.name} at {D}^3: terrain, distance field "
          f"(cap 24), {settings.pyramid_levels}-level pyramid and row-major "
          f"table in {time.perf_counter() - t0:.2f} s")
    occ_flat = grid.occupancy.reshape(-1)
    ms = settings.resolve_max_steps(dims)
    o, d = generate_rays(cam, h, w)
    ref = kp.march_packed(o, d, packed, dims, ms)
    sp, sd, stm = shadow_ray_batch(ref, o, d, lights.pos[0])
    ref_s = kp.march_packed(sp, sd, packed, dims, ms, t_max=stm)
    img_k5 = render_image(kp.make_march_packed, grid, cam, lights, settings,
                          h, w, packed)
    out = {"k5_mean_steps": float(ref.steps.float().mean())}
    # the tie-break of a DDA step on [N, 3]: vxtpu's cumsum form against
    # the port's argmin (the same mask)
    tn = torch.floor(torch.rand(h * w, 3, generator=torch.Generator(
    ).manual_seed(3)) * 4).to(device)

    def cumsum_mask():
        is_min = tn <= tn.amin(dim=-1, keepdim=True)
        return is_min & (torch.cumsum(is_min.to(torch.int32), dim=-1) == 1)

    if not torch.equal(cumsum_mask(), dda_step_mask(tn)):
        raise AssertionError("dda_step_mask differs from the cumsum form")
    out["tie_break_ms"] = {"cumsum": median_ms(cumsum_mask, device, runs),
                           "argmin": median_ms(lambda: dda_step_mask(tn),
                                               device, runs)}
    tb = out["tie_break_ms"]
    print(f"phase 10 xla+mask: a step's axis tie-break on [{h * w}, 3] "
          f"[{card}] (events): vxtpu's cumsum form {tb['cumsum']:.3f} ms, "
          f"argmin {tb['argmin']:.3f} ms (equal masks)")
    for name, acc in accels.items():
        march = make_march_xla(occ_flat, dims, settings, acc)
        # the main path, counted: one frame (it runs no hand-written
        # kernel)
        for mod in (km, kp, ks):
            mod.reset_launch_counts()
        img = render_image(make_march_xla, grid, cam, lights, settings, h, w,
                           acc)
        _sync(device)
        counts = {k: v for mod in (km, kp, ks) for k, v in
                  mod.LAUNCHES.items() if v}
        if img.shape != (h, w, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"xla {name} frame: not finite or misshapen")
        rec = march(o, d)
        srec = march(sp, sd, t_max=stm)
        m = xla_agreement(rec, ref)
        ms_ = xla_agreement(srec, ref_s)
        px = float(((img - img_k5).abs() > 1.0 / 255).any(-1).float().mean())
        chunks = [math.ceil(int(r.steps.max()) / settings.step_chunk)
                  for r in (rec, srec)]
        frame_ms = median_ms(lambda: render_image(
            make_march_xla, grid, cam, lights, settings, h, w, acc), device,
            runs)
        march_ms = median_ms(lambda: march(o, d), device, runs)
        prof = (_profile_launches(lambda: render_image(
            make_march_xla, grid, cam, lights, settings, h, w, acc), device)
            if device.type == "cuda" else {})
        print(f"phase 10 xla+mask: c3 xla/{name} vs K5, primary rays: hit "
              f"agree {m['hit_agree']:.6f}, both hit {m['both']}, t beyond "
              f"tolerance {m['t_bad']} ({m['t_bad_same_voxel']} on the same "
              f"voxel), voxel equal {m['voxel']:.6f}, normal "
              f"equal {m['normal']:.6f}; shadow rays: hit agree "
              f"{ms_['hit_agree']:.6f}, t beyond {ms_['t_bad']} "
              f"({ms_['t_bad_same_voxel']} on the same voxel); frame vs "
              f"the K5 pipeline frame: {px:.6f} of pixels beyond 1/255")
        steps_p = float(rec.steps.float().mean())
        steps_s = float(srec.steps.float().mean())
        print(f"phase 10 xla+mask: c3 xla/{name} [{card}]: frame "
              f"{frame_ms:.2f} ms "
              f"(median of {runs}, events), primary march alone "
              f"{march_ms:.2f} ms; mean steps a ray {steps_p:.3f} primary, "
              f"{steps_s:.3f} shadow (K5 {out['k5_mean_steps']:.3f} "
              f"iterations); chunks "
              f"of {settings.step_chunk} steps: {chunks[0]} primary, "
              f"{chunks[1]} shadow (a host sync each); hand-written kernel "
              f"launches in a frame {counts or 0}"
              + (f"; profiled frame: {prof['launches']} device kernels, "
                 f"busy {prof['busy_ms']:.2f} of {prof['wall_ms']:.2f} ms"
                 if prof else ""))
        check_xla_agreement(m, f"c3 xla/{name} primary rays")
        check_xla_agreement(ms_, f"c3 xla/{name} shadow rays")
        if counts:
            raise AssertionError(f"the batched march launched a hand-written "
                                 f"kernel: {counts}")
        out[name] = dict(agree=m, shadow_agree=ms_, pixels_beyond=px,
                         frame_ms=frame_ms, march_ms=march_ms,
                         mean_steps=steps_p, shadow_mean_steps=steps_s,
                         chunks=chunks, profile=prof)
        if save:
            Path(save).mkdir(parents=True, exist_ok=True)
            save_png(str(Path(save) / f"c3_xla_{name}.png"), img)
    del grid, accels, packed, img_k5
    with tempfile.TemporaryDirectory() as tmp:
        for extra in ([], ["--accel", "pyramid"]):
            line = _run_cli(["render", "--config", cfg.name, "--kernel", "xla",
                             *extra, "--device", device.type, "--out",
                             str(Path(tmp) / "f.png"), *cli_size])[-1]
            print(f"phase 10 xla+mask: render --kernel xla {' '.join(extra)}"
                  f": {line}")
    line = _run_cli(["bench", "--config", cfg.name, "--kernel", "xla",
                     "--iters", "2", "--device", device.type, *cli_size])[-1]
    print(f"phase 10 xla+mask: bench --kernel xla: {line}")
    out["bench"] = json.loads(line)
    return out


def phase_mask(device, D=FULL, h=256, w=256, S=256, S_mask=64, steps=5,
               runs=RUNS, cli_size=None, card="") -> dict:
    """Phase 10 (b): the occupancy-masked c4 fit through K3/K4 (see the
    module docstring). ``card``: the GPU's name and power limit, printed
    beside the times."""
    import math
    import tempfile

    import torch

    from vxtpu_torch import bench
    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.app.configs import CONFIGS
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.engine.sharding import (camera_frame_rays,
                                             compute_mask_bounds)
    from vxtpu_torch.render import kernel_sample as ks
    from vxtpu_torch.render import occmask, soft
    from vxtpu_torch.render.soft_kernel import (MortonSoftGrid,
                                                _enter_dt_soft,
                                                render_soft_rays_kernel)
    from vxtpu_torch.train import loop
    from vxtpu_torch.world import procgen

    G = 4
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
    tflat = target.reshape(-1, 3)
    # the warm state of tools/bench_train_masked.py: 0.8 x the truth
    warm = MortonSoftGrid.from_soft(soft.SoftGrid(truth.sigma_raw * 0.8,
                                                  truth.rgb_raw * 0.8))
    del truth
    mask = occmask.occupancy_mask_from_soft(warm, G, 0.01, 1)
    mask_df = occmask.mask_distance_field(mask)
    o_c, d_c = camera_frame_rays(cam, h, w)
    bounds = compute_mask_bounds(mask, mask_df, cam, o_c, d_c, G)
    _sync(device)
    t_full, dt_full, valid = _enter_dt_soft(o, d, dims, 1, None)
    t_band, dt_band, _ = _enter_dt_soft(o, d, dims, 1, bounds)
    seg = valid & (dt_full > 0)
    ratio = float((dt_band[seg] / dt_full[seg]).mean())
    occ_frac = float(mask.float().mean())
    bounds_ms = median_ms(lambda: compute_mask_bounds(mask, mask_df, cam, o_c,
                                                      d_c, G), device, runs)
    bprof = (_profile_launches(lambda: compute_mask_bounds(
        mask, mask_df, cam, o_c, d_c, G), device)
        if device.type == "cuda" else {})
    print(f"phase 10 xla+mask: {D}^3 truth, {h}x{w} target at S = {S}, warm "
          f"state and its {tuple(mask.shape)} mask in "
          f"{time.perf_counter() - t0:.2f} s; mask occupied "
          f"{occ_frac:.4f}; band / full segment {ratio:.4f} (mean over the "
          f"{int(seg.sum())} rays that cross the grid; "
          f"{int((seg & (dt_band == 0)).sum())} of them have no band); the "
          f"bounds pass alone [{card}] {bounds_ms:.2f} ms (events)"
          + (f", {bprof['launches']} device kernels, busy "
             f"{bprof['busy_ms']:.2f} of {bprof['wall_ms']:.2f} ms"
             if bprof else ""))

    # (2) the bounds are conservative: every mask-occupied sample of the
    # full segment lies in [t0, t1]
    t_b0, t_b1 = bounds
    viol = 0
    for i in range(0, o.shape[0], CHUNK):
        sl = slice(i, i + CHUNK)
        ts = t_full[sl, None] + dt_full[sl, None] * (
            (torch.arange(S, device=device) + 0.5) / S)[None, :]
        p = o[sl, None, :] + ts[..., None] * d[sl, None, :]
        occ = occmask.mask_at(mask, G, p) > 0
        inside = (ts >= t_b0[sl, None] - 1e-3) & (ts <= t_b1[sl, None] + 1e-3)
        viol += int((occ & ~inside & valid[sl, None]).sum())
    print(f"phase 10 xla+mask: bounds conservative on {o.shape[0]} rays x "
          f"{S} full-segment samples: {viol} occupied samples outside "
          f"[t0, t1]")
    if viol:
        raise AssertionError(f"{viol} mask-occupied samples outside the bands")

    # (3) quadrature: S_mask samples on the band against S on the whole
    # segment, both masked
    with torch.no_grad():
        few = render_soft_rays_kernel(warm, o, d, settings, S_mask,
                                      mask=mask, seg_bounds=bounds)
        full = render_soft_rays_kernel(warm, o, d, settings, S, mask=mask)
    quad = float((few - full).abs().mean())
    del few, full
    print(f"phase 10 xla+mask: quadrature: S = {S_mask} on the band vs S = "
          f"{S} on the whole segment, mean |d rgb| {quad:.5f} (limit 0.015)")
    if not quad < 0.015:
        raise AssertionError(f"masked quadrature error {quad}")

    # (1) one masked step through the kernels against their plain versions
    tc_mask = loop.TrainConfig(field_kernel=True, occ_mask=True,
                               num_samples=S_mask, ray_batch=0,
                               seed=cfg4.seed)
    tc_dense = loop.TrainConfig(field_kernel=True, num_samples=S,
                                ray_batch=0, seed=cfg4.seed)
    lk, gk = _grads(warm.tab, False, o, d, settings, S_mask, target=tflat,
                    tc=tc_mask, mask=mask, bounds=bounds)
    lp, gp = _grads(warm.tab, True, o, d, settings, S_mask, target=tflat,
                    tc=tc_mask, mask=mask, bounds=bounds)
    ex = kc.grads_excess(gk, gp)
    rel = abs(float(lk) - float(lp)) / abs(float(lp))
    err = {BWD[False]: max(float((a - b).abs().max())
                           for a, b in zip(gk, gp))}
    del gk, gp
    print(f"phase 10 xla+mask: one masked step at S = {S_mask}, kernels vs "
          f"plain versions: loss {float(lk):.8f} vs {float(lp):.8f} (rel "
          f"{rel:.3g}); gradient allclose excess {ex:.3g}")
    if rel > 1e-6 or ex > 1.0:
        raise AssertionError("masked step: kernels and plain versions differ")

    # the steps, timed at the warm state: masked at S_mask (alone, and with
    # its bounds pass, as the trainer runs it), unmasked at S
    step_rows = {}
    for name, tc, masked in (("masked", tc_mask, True),
                             ("dense", tc_dense, False)):
        model = MortonSoftGrid(warm.tab.detach().clone().requires_grad_(True))
        opt = loop.make_optimizer(tc, [model.tab])
        last = {}

        def step(with_bounds=False):
            b = bounds
            if with_bounds:
                b = compute_mask_bounds(mask, mask_df, cam, o_c, d_c, G)
            opt.zero_grad(set_to_none=True)
            loss = loop._loss_fn(model, cam, o, d, tflat, (h, w), settings,
                                 tc, mask if masked else None,
                                 b if masked else None)
            loss.backward()
            opt.step()
            last["loss"] = loss.detach()

        ks.reset_launch_counts()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        step()
        _sync(device)
        counts = dict(ks.LAUNCHES)
        peak = (torch.cuda.max_memory_allocated(device) / 2**30
                if device.type == "cuda" else float("nan"))
        row = dict(ms=median_ms(step, device, runs), peak_gib=peak,
                   loss=float(last["loss"]), launches=counts)
        if masked:
            row["with_bounds_ms"] = median_ms(lambda: step(True), device,
                                              runs)
        step_rows[name] = row
        print(f"phase 10 xla+mask: {name} step at S = {tc.num_samples} "
              f"[{card}]: {row['ms']:.2f} ms"
              + (f" ({row['with_bounds_ms']:.2f} ms with its bounds pass)"
                 if masked else "")
              + f", peak {peak:.2f} GiB, loss {row['loss']:.6f}, launches "
                f"{counts}")
        if device.type == "cuda" and not (
                counts["sample_fwd_kernel"] == 1 and counts[BWD[False]] == 1):
            raise AssertionError(f"{name} step: K3/K4 launches {counts}")
        del model, opt

    # K3 and K4's scatter alone at the masked step's shape
    st, sdt, _ = _enter_dt_soft(o, d, dims, S_mask, bounds)
    st, sdt = st.contiguous(), sdt.contiguous()
    tab = warm.tab
    got = ks.sample_fields_fwd(tab, o, d, st, sdt, S_mask, D)
    want = ks.sample_fields_fwd_reference(tab, o, d, st, sdt, S_mask, D)
    err["sample_fwd_kernel"] = max(float((a - b).abs().max())
                                   for a, b in zip(got, want))
    if err["sample_fwd_kernel"] > kc.FWD_ATOL:
        raise AssertionError(f"K3 at the masked shape differs by "
                             f"{err['sample_fwd_kernel']}")
    del got, want
    g = torch.Generator().manual_seed(0)
    cots = tuple(torch.randn(S_mask, h * w, generator=g).to(device)
                 for _ in range(4))
    args = (tab, o, d, st, sdt, cots, D)
    kb = ks.sample_grads(*args, ray_grads=False)
    pb = ks.sample_fields_bwd_reference(*args, ray_grads=False)
    tab_ex = kc.grads_excess(kc.channels(kb[0]), kc.channels(pb[0]))
    err[BWD[False]] = max(err[BWD[False]], float((kb[0] - pb[0]).abs().max()))
    del kb, pb
    if tab_ex > 1.0:
        raise AssertionError(f"K4 at the masked shape: excess {tab_ex}")
    active = int((sdt > 0).sum()) * S_mask
    touched = _touched_words(o, d, st, sdt, S_mask, D)
    bnd = sample_bounds(h * w, S_mask, D, active, touched, ray_grads=False)
    lib = library_yardstick(tab, o, d, st, sdt, S_mask, D, cots, device, runs,
                            prefix="phase 10 xla+mask")
    alone = {
        "sample_fwd_kernel": dict(
            ms=median_ms(lambda: ks.sample_fields_fwd(
                tab, o, d, st, sdt, S_mask, D), device, runs),
            plain_ms=median_ms(lambda: ks.sample_fields_fwd_reference(
                tab, o, d, st, sdt, S_mask, D), device, 3),
            library_ms=lib["fwd_ms"], bound_ms=bnd["fwd"]["bound_ms"],
            bound_by=bnd["fwd"]["bound_by"]),
        BWD[False]: dict(
            ms=median_ms(lambda: ks.sample_grads(*args, ray_grads=False),
                         device, runs),
            plain_ms=median_ms(lambda: ks.sample_fields_bwd_reference(
                *args, ray_grads=False), device, 3),
            library_ms=lib["bwd_vol_ms"], bound_ms=bnd["bwd"]["bound_ms"],
            bound_by=bnd["bwd"]["bound_by"])}
    dev = {k: "not measured" for k in alone}
    if device.type == "cuda":
        dev["sample_fwd_kernel"] = bench.device_time(
            alone["sample_fwd_kernel"], "device_ms",
            lambda: ks.sample_fields_fwd(tab, o, d, st, sdt, S_mask, D),
            device, runs, "sample_fwd_kernel")
        dev[BWD[False]] = bench.device_time(
            alone[BWD[False]], "device_ms",
            lambda: ks.sample_grads(*args, ray_grads=False), device, runs,
            "sample_bwd_kernel<false, false>")
    for k, r in alone.items():
        print(f"phase 10 xla+mask: {k} alone at N = {h * w}, S = {S_mask} on "
              f"the bands [{card}]: {r['ms']:.3f} ms (events), device "
              f"{dev[k]}; plain "
              f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.4f} ms; "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} ({touched} "
              f"table words touched, {active} active samples)")
    alone[BWD[False]]["zero_fill"] = zero_fill_times(D, device, runs,
                                                     "phase 10 xla+mask")
    del args, cots, warm, tab

    # (4) the path, counted: a short masked fit from zeros, the mask
    # rebuilt twice
    tc_fit = loop.TrainConfig(field_kernel=True, occ_mask=True,
                              num_samples=S_mask, ray_batch=0, steps=steps,
                              seed=cfg4.seed, mask_refresh=2)
    timer = StepTimer(device)
    ks.reset_launch_counts()
    timer()
    _, _, losses, _ = loop.fit_soft(
        soft.SoftGrid.zeros(dims, device=device), cam, target.reshape(h, w, 3),
        settings, tc_fit, step_hook=timer)
    _sync(device)
    launches = dict(ks.LAUNCHES)
    fit_ms = timer.ms()
    print(f"phase 10 xla+mask: masked fit, {steps} steps from zeros at S = "
          f"{S_mask}, mask rebuilt at steps 2 and 4: launches {launches}; "
          f"losses {losses}; step ms [{card}] "
          f"{[round(x, 2) for x in fit_ms]}")
    if device.type == "cuda" and not (
            launches["sample_fwd_kernel"] == steps
            and launches[BWD[False]] == steps):
        raise AssertionError(f"the masked fit did not run K3 and K4 once a "
                             f"step: {launches}")
    _check_losses(losses)

    # the command
    if cli_size is None:
        cli_size = ["--dims", "0", "--height", "0", "--width", "0"]
    ks.reset_launch_counts()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_smoke_fit_") as tmp:
        t0 = time.perf_counter()
        line = _run_cli(["train", "--field-kernel", "--occmask", "--samples",
                         str(S_mask), "--steps", str(steps), "--device",
                         device.type, "--out", tmp, *cli_size])[-1]
    print(f"phase 10 xla+mask: train --field-kernel --occmask {' '.join(cli_size)}"
          f" --samples {S_mask} --steps {steps}: {line} in "
          f"{time.perf_counter() - t0:.1f} s; launches {dict(ks.LAUNCHES)}")
    if not math.isfinite(json.loads(line)["value"]):
        raise AssertionError(f"train --occmask: {line}")
    return dict(occupied=occ_frac, band_ratio=ratio, bounds_ms=bounds_ms,
                bounds_profile=bprof, quadrature=quad, loss_rel=rel,
                steps=step_rows, alone=alone, err=err, launches=launches,
                losses=losses, fit_ms=fit_ms)


# phase 12: bench. The per-ray reference march and the native oracle at
# 64^3, the wavefront march at the bench's full size, the bench's field
# step against the kernels' plain versions, and the commands.


def hit_agreement(rec, ref) -> dict:
    """Rays whose hit flags or steps differ; on rays both hit, those whose
    t differs beyond rtol 1e-5 / atol 1e-4 (tests/test_wavefront.py's
    limits) or whose voxel or normal differs. A miss's voxel is where the
    march stopped, which the wavefront march packs in 10 bits an axis (a
    step to -1 reads 1023), so misses are not compared there."""
    both = rec.hit & ref.hit
    t_bad = (rec.t - ref.t).abs() > 1e-4 + 1e-5 * ref.t.abs()
    return dict(
        n=int(rec.hit.numel()), hits=int(ref.hit.sum()),
        hit=int((rec.hit != ref.hit).sum()), t=int((t_bad & both).sum()),
        voxel=int(((rec.voxel != ref.voxel).any(-1) & both).sum()),
        normal=int(((rec.normal != ref.normal).any(-1) & both).sum()),
        steps=int((rec.steps != ref.steps).sum()))


def _native_record(nat: dict, device):
    import torch

    from vxtpu_torch.render.types import HitRecord

    return HitRecord(**{k: torch.from_numpy(v).to(device)
                        for k, v in nat.items()})


def bench_ref(device, D=64, h=256, w=256) -> dict:
    """(a) The reference march against the batched distance-field march
    and K1 march-only (phase 10's limits), the native oracle against the
    reference march (both the textbook DDA: hit, voxel, normal and steps
    equal on every ray, t within rel 1e-5: kernel_check.check_exact), at
    D^3 from the bench's outside camera and a camera in the air inside
    the grid."""
    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.native.oracle import march_native
    from vxtpu_torch.render import kernel_march as km
    from vxtpu_torch.render.kernel_ref import march_ref
    from vxtpu_torch.render.kernel_xla import march_xla_df
    from vxtpu_torch.world import distfield, procgen
    from vxtpu_torch.world.packed import build_packed_morton

    grid = procgen.terrain((D,) * 3, seed=7, device=device)
    dims = grid.dims
    occ_flat = grid.occupancy.reshape(-1)
    df_flat = distfield.build(grid.occupancy, cap=24).field.reshape(-1)
    accel = build_packed_morton(grid.occupancy, cap=64)
    ms = sum(dims) + 2
    _, scenes = _main_scene(device, D)
    cams = {name: cam for name, cam, _, _ in scenes
            if name in ("lambert", "inside_air_lambert")}
    out = {}
    for name, cam in cams.items():
        o, d = generate_rays(cam, h, w)
        t0 = time.perf_counter()
        ref = march_ref(o, d, occ_flat, dims, ms)
        _sync(device)
        ref_s = time.perf_counter() - t0
        rows = dict(
            xla_df=xla_agreement(march_xla_df(o, d, df_flat, dims, ms), ref),
            k1=xla_agreement(km.march(o, d, accel, dims, ms), ref))
        nat = kc.record_mismatch(_native_record(
            march_native(o, d, grid.occupancy, dims, ms), device), ref)
        rows["native"] = nat
        print(f"phase 12 bench: march_ref at {D}^3 {h}x{w} {name}: "
              f"{int(ref.hit.sum())} hits, {int(ref.steps.sum())} steps in "
              f"{ref_s:.2f} s (wall+sync); vs march_xla_df: hit agree "
              f"{rows['xla_df']['hit_agree']:.6f}, t beyond "
              f"{rows['xla_df']['t_bad']}, voxel {rows['xla_df']['voxel']:.6f}"
              f", normal {rows['xla_df']['normal']:.6f}; vs K1 march-only: "
              f"hit agree {rows['k1']['hit_agree']:.6f}, t beyond "
              f"{rows['k1']['t_bad']}, voxel {rows['k1']['voxel']:.6f}, "
              f"normal {rows['k1']['normal']:.6f}; native oracle vs "
              f"march_ref: rays unlike in hit {nat['hit']}, voxel "
              f"{nat['voxel']}, normal {nat['normal']}, steps "
              f"{nat['steps']} of {nat['n']}, t rel {nat['t_rel']:.3g}")
        for key, what in (("xla_df", "march_xla_df"), ("k1", "K1")):
            check_xla_agreement(rows[key], f"march_ref {name} vs {what}",
                                what)
        kc.check_exact(nat, None, f"the native oracle vs march_ref ({name})")
        out[name] = rows
    return out


def bench_wavefront(device, D=FULL, h=H, w=W, runs=3) -> dict:
    """(b) The wavefront march on every primary ray of the bench's
    forward section (D^3 terrain seed 7, cap-96 distance field, the
    outside camera) against march_xla_df over the same field (hit flags
    and steps equal on every ray; t, voxel and normal on hits:
    hit_agreement), against itself with a forced drain (every field on
    every ray: kernel_check.check_exact) and against K1 march-only (phase
    10's limits); its counters, host syncs, times and the frame's device
    kernels and busy time."""
    import torch

    from vxtpu_torch import bench
    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render import kernel_march as km
    from vxtpu_torch.render import kernel_wavefront as kw
    from vxtpu_torch.render.kernel_xla import march_xla_df
    from vxtpu_torch.render.pipeline import render_image
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.world import distfield, procgen
    from vxtpu_torch.world.lights import Lights
    from vxtpu_torch.world.packed import build_packed_morton

    t0 = time.perf_counter()
    grid = procgen.terrain((D,) * 3, seed=7, device=device)
    _sync(device)
    t1 = time.perf_counter()
    df = distfield.build(grid.occupancy, cap=96)
    _sync(device)
    t2 = time.perf_counter()
    dims = grid.dims
    df_flat = df.field.reshape(-1)
    settings = RenderSettings(shading="lambert", step_chunk=8)
    ms = settings.resolve_max_steps(dims)
    scale = D / FULL
    cam = bench.camera(bench.OUTSIDE, device, scale)
    lights = Lights.single(bench.scaled(bench.LIGHT, scale), intensity=2.0,
                           device=device)
    o, d = generate_rays(cam, h, w)
    vc = kw.count_valid_rays(o, d, dims)
    print(f"phase 12 bench: {D}^3 terrain in {t1 - t0:.2f} s, its cap-96 "
          f"distance field (95 dilation passes) in {t2 - t1:.2f} s "
          f"(wall+sync, set-up); {vc} of {h * w} rays meet the grid")
    rec, st = kw.march_wavefront(o, d, df_flat, dims, ms, valid_count=vc,
                                 stats=True)
    ref = march_xla_df(o, d, df_flat, dims, ms)
    eq = hit_agreement(rec, ref)
    k1 = xla_agreement(rec, km.march(o, d, build_packed_morton(
        grid.occupancy, cap=64), dims, ms))
    print(f"phase 12 bench: wavefront vs march_xla_df on all {eq['n']} "
          f"rays: hit flags unlike on {eq['hit']}, steps on {eq['steps']}; "
          f"of the {eq['hits']} hits t beyond rtol 1e-5 / atol 1e-4 on "
          f"{eq['t']}, voxel unlike on {eq['voxel']}, normal on "
          f"{eq['normal']}; vs K1 "
          f"march-only: hit agree {k1['hit_agree']:.6f}, t beyond "
          f"{k1['t_bad']} ({k1['t_bad_same_voxel']} on the same voxel), "
          f"voxel {k1['voxel']:.6f}, normal {k1['normal']:.6f}")
    if any(eq[k] for k in ("hit", "t", "voxel", "normal", "steps")):
        raise AssertionError(f"the wavefront march differs from "
                             f"march_xla_df: {eq}")
    check_xla_agreement(k1, "the wavefront march vs K1", "K1")
    # a forced drain: after one full-width round, rounds of 65,536 slots,
    # each replaying the one step captured for that size
    rec_d, st_d = kw.march_wavefront(o, d, df_flat, dims, ms,
                                     schedule=((h * w, 8),),
                                     drain_buf=min(65536, h * w),
                                     drain_steps=8, stats=True)
    same = kc.record_mismatch(rec_d, rec)
    print(f"phase 12 bench: wavefront with a forced drain "
          f"({st_d['drain_rounds']} rounds of {st_d['drain_buf']} slots, "
          f"{st_d['host_syncs']} host "
          f"syncs) vs the default schedule: rays unlike in hit {same['hit']},"
          f" voxel {same['voxel']}, normal {same['normal']}, steps "
          f"{same['steps']}; t rel {same['t_rel']:.3g}")
    kc.check_exact(same, None, "the wavefront march with a forced drain")
    counters = dict(valid=int(st["valid"]), schedule=st["schedule"],
                    round_counts=[int(c) for c in st["round_counts"]],
                    round_steps=st["round_steps"],
                    drain_buf=st["drain_buf"],
                    drain_rounds=st["drain_rounds"],
                    drain_steps_total=st["drain_steps_total"],
                    gathered_lanes=st["gathered_lanes"],
                    host_syncs=st["host_syncs"],
                    steps=int(rec.steps.sum()))
    print(f"phase 12 bench: wavefront counters {json.dumps(counters)}")
    march = functools.partial(kw.march_wavefront, o, d, df_flat, dims, ms,
                              valid_count=vc)
    factory = functools.partial(kw.make_march_wavefront, valid_count=vc)
    frame = functools.partial(render_image, factory, grid, cam, lights,
                              settings, h, w, df)
    # the frame, counted: it launches no hand-written kernel
    km.reset_launch_counts()
    img = frame()
    _sync(device)
    counts = {k: v for k, v in km.LAUNCHES.items() if v}
    if img.shape != (h, w, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("wavefront frame: not finite or misshapen")
    times = dict(march_ms=median_ms(march, device, runs),
                 frame_ms=median_ms(frame, device, runs),
                 df_march_ms=median_ms(lambda: march_xla_df(
                     o, d, df_flat, dims, ms, step_chunk=8), device, runs))
    prof = (_profile_launches(frame, device) if device.type == "cuda"
            else {})
    print(f"phase 12 bench: wavefront at {D}^3 {h}x{w} lambert: march "
          f"{times['march_ms']:.2f} ms, frame {times['frame_ms']:.2f} ms, "
          f"march_xla_df (step_chunk 8) {times['df_march_ms']:.2f} ms "
          f"(median of {runs}, events); {st['host_syncs']} host syncs a "
          f"march; hand-written kernel launches in a frame {counts or 0}"
          + (f"; profiled frame: {prof['launches']} device kernels, busy "
             f"{prof['busy_ms']:.2f} of {prof['wall_ms']:.2f} ms "
             f"(profiler-device of wall+sync, "
             f"{prof['busy_ms'] / prof['wall_ms']:.4f})" if prof else ""))
    if counts:
        raise AssertionError(f"the wavefront march launched a hand-written "
                             f"kernel: {counts}")
    return dict(agree=eq, k1=k1, counters=counters, times=times,
                profile=prof)


def bench_field_step(device, D=128, h=256, w=256, S=64) -> dict:
    """(c) The bench's field-kernel train step at the bench's sizes (D^3
    truth, h x w lit rays, S samples, the camera refined: the lit K3, K4
    with ray cotangents and the ray sum) against the same step through
    the kernels' plain versions, from the bench's zeros and from 0.8 x the
    truth: the loss of make_sharded_train_step(field_kernel=True) on a
    1-rank group within rel 1e-6, its gradients to the table and to the
    camera, and the world rays' cotangents, with phase 6's limits
    (kernel_check.grads_excess)."""
    import torch
    import torch.distributed as dist

    from vxtpu_torch import bench
    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.engine import platform, sharding
    from vxtpu_torch.render import kernel_sample as ks
    from vxtpu_torch.render.soft import SoftGrid
    from vxtpu_torch.render.soft_kernel import (MortonSoftGrid,
                                                render_soft_rays_kernel)

    joined = not dist.is_initialized()
    platform.init_multihost(device=device)
    try:
        mesh = sharding.make_mesh(1)
        sc = bench.train_scene(device, mesh, D, h, w, S)
        truth, cam, o_c, d_c, target = (sc.pop(k) for k in (
            "truth", "cam", "o_c", "d_c", "target"))
        init_fn, step_fn = sharding.make_sharded_train_step(
            sc["settings"], S, mesh, optimize_camera=True, grad_buckets=1,
            lights=sc["lights"], field_kernel=True)
        models = {
            "zeros": MortonSoftGrid.from_soft(SoftGrid.zeros(
                sc["dims"], device=device)),
            "0.8 x truth": MortonSoftGrid.from_soft(SoftGrid(
                truth.sigma_raw * 0.8, truth.rgb_raw * 0.8))}
        del truth

        def direct(model, plain):
            """The step's loss through the kernels (or their plain
            versions) and its gradients to the table, the camera's fields
            and the world rays."""
            st = init_fn(model, cam)
            o_w, d_w = sharding._world_rays(st.camera(), o_c, d_c)
            pred = render_soft_rays_kernel(st.model(), o_w, d_w,
                                           sc["settings"], S,
                                           lights=sc["lights"], plain=plain)
            loss = torch.sum((pred - target) ** 2) / (target.numel())
            grads = torch.autograd.grad(
                loss, [*st.params, *st.cam_params, o_w, d_w],
                allow_unused=True, materialize_grads=True)
            return float(loss.detach()), grads

        out = {}
        for name, model in models.items():
            ks.reset_launch_counts()
            loss, grads = step_fn.value_and_grad(model, cam, init_fn(
                model, cam), o_c, d_c, target)
            _sync(device)
            launches = {k: v for k, v in ks.LAUNCHES.items() if v}
            _, gk = direct(model, False)
            lp, gp = direct(model, True)
            row = dict(
                loss=float(loss), loss_plain=lp,
                loss_rel=abs(float(loss) - lp) / abs(lp),
                table=kc.grads_excess(kc.channels(grads[0]),
                                      kc.channels(gp[0])),
                camera=kc.grads_excess(grads[1:], gp[1:-2]),
                rays=kc.grads_excess(gk[-2:], gp[-2:]),
                camera_max_abs=max(float(g.abs().max()) for g in gp[1:-2]),
                launches=launches)
            del grads, gk, gp
            print(f"phase 12 bench: the bench's field step at {D}^3 {h}x{w} "
                  f"S = {S} lit, camera refined, from {name}: kernels vs "
                  f"plain versions: loss {row['loss']:.8f} vs {lp:.8f} (rel "
                  f"{row['loss_rel']:.3g}); allclose excess of the table "
                  f"gradient {row['table']:.3g}, the camera's "
                  f"{row['camera']:.3g} (its max |g| "
                  f"{row['camera_max_abs']:.3g}), the rays' cotangents "
                  f"{row['rays']:.3g}; launches {launches}")
            if row["loss_rel"] > 1e-6 or max(row[k] for k in (
                    "table", "camera", "rays")) > 1.0:
                raise AssertionError(f"the bench's field step from {name}: "
                                     f"kernels and plain versions differ")
            if device.type == "cuda" and launches != {
                    "sample_fwd_kernel": 1, BWD[True]: 1,
                    "sample_ray_sum_kernel": 1}:
                raise AssertionError(f"the bench's field step did not run "
                                     f"K3, K4 kRayGrads and the ray sum "
                                     f"once each: {launches}")
            out[name] = row
        return out
    finally:
        if joined:
            platform.shutdown()


def bench_commands(device, card="", bench_sizes=None, cli_size=None,
                   ref_size=None) -> dict:
    """(d) python -m vxtpu_torch.bench as a subprocess (at its full
    size; ``bench_sizes`` runs its sections small in this process
    instead, for a rehearsal on the CPU), its two JSON lines checked;
    render and bench --kernel wavefront (c3_256_shadows at its own size)
    and --kernel ref (--dims 64)."""
    import tempfile

    from vxtpu_torch import bench

    t0 = time.perf_counter()
    if bench_sizes is None:
        out = subprocess.run([sys.executable, "-m", "vxtpu_torch.bench"],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=900)
        lines = out.stdout.strip().splitlines()
        if out.returncode != 0 or len(lines) < 2:
            raise AssertionError(f"vxtpu_torch.bench exited "
                                 f"{out.returncode}: {out.stderr[-2000:]}")
        details, line = json.loads(lines[-2]), json.loads(lines[-1])
    else:
        details, line = bench.run(device, sizes=bench_sizes)
    secs = time.perf_counter() - t0
    print(f"phase 12 bench: python -m vxtpu_torch.bench in {secs:.1f} s "
          f"[{card}]: {json.dumps(line)}")
    print(f"phase 12 bench: its details: {json.dumps(details)}")
    lf, lt = details["launches_fused"], details["launches_train_field"]
    missing = (bench.times_without_clock(details)
               + bench.times_without_clock(line))
    if missing:
        raise AssertionError(f"bench times without a clock: {missing}")
    for key in ("value", "wavefront_mrays", "pallas2_mrays", "train_step_ms",
                "train_step_masked_ms", "train_step_field_ms"):
        if not math.isfinite(line[key]) or line[key] <= 0:
            raise AssertionError(f"bench {key}: {line.get(key)}")
    if device.type == "cuda" and not (
            all(lf["variants"][v] for v in ("march", "lambert",
                                            "full_shadows"))
            and lt["sample_fwd_kernel"] and lt[BWD[True]]
            and lt["sample_ray_sum_kernel"]):
        raise AssertionError(f"the bench did not launch K1 in each mode and "
                             f"K3/K4: {lf}, {lt}")
    cli = {}
    cli_size = cli_size or []
    ref_size = ref_size or ["--dims", "64"]
    with tempfile.TemporaryDirectory() as tmp:
        for kernel, size in (("wavefront", cli_size), ("ref", ref_size)):
            r = _run_cli(["render", "--config", "c3_256_shadows", "--kernel",
                          kernel, "--device", device.type, "--out",
                          str(Path(tmp) / f"{kernel}.png"), *size])[-1]
            b = _run_cli(["bench", "--config", "c3_256_shadows", "--kernel",
                          kernel, "--iters", "2", "--device", device.type,
                          *size])[-1]
            print(f"phase 12 bench: render --kernel {kernel} "
                  f"{' '.join(size)}: {r}")
            print(f"phase 12 bench: bench --kernel {kernel} "
                  f"{' '.join(size)} [{card}] (wall+sync): {b}")
            cli[kernel] = json.loads(b)
            if not math.isfinite(cli[kernel]["value"]):
                raise AssertionError(f"bench --kernel {kernel}: {b}")
    return dict(details=details, line=line, seconds=secs, cli=cli,
                launches={**lf, **lt})


def phase_bench(device, card="", wavefront=None, ref=None, field=None,
                commands=None) -> dict:
    """Phase 12: the reference march, the wavefront march and the bench
    (see the module docstring). The keyword dicts pass sizes to the parts
    (a CPU rehearsal runs them small)."""
    import torch

    t0 = time.perf_counter()
    out = {"ref": bench_ref(device, **(ref or {}))}
    out["wavefront"] = bench_wavefront(device, **(wavefront or {}))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["field_step"] = bench_field_step(device, **(field or {}))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["commands"] = bench_commands(device, card, **(commands or {}))
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 12 bench: {out['seconds']:.1f} s")
    return out


# phase 11: scale-out. The sharded paths run on a 1-rank process group of
# this process (NCCL on the card: it cannot put two ranks on one card)
# and, at 64^3, on 2 gloo ranks that share the card (run_local).

C5_FRAMES = 3           # config 5's first frames (of its 24-frame orbit)
C5_SUBSET = 4096        # rays of the custom-backward-vs-autograd check
# the custom backward against autograd (tests/test_vjp.py's tolerance)
VJP_RTOL, VJP_ATOL_REL = 2e-4, 2e-5


class _FrameClock:
    """A MetricsSink for run_config5: the host time of each frame's
    emission (after the frame's last synchronising read)."""

    def __init__(self):
        self.t = [time.perf_counter()]

    def emit(self, **kv):
        self.t.append(time.perf_counter())

    def frame_ms(self) -> list:
        return [(b - a) * 1e3 for a, b in zip(self.t, self.t[1:])]


def _vjp_excess(got, want) -> float:
    from vxtpu_torch import kernel_check as kc

    return max(kc.allclose_excess(g, w, VJP_RTOL, VJP_ATOL_REL * max(
        float(w.abs().max()), 1e-30)) for g, w in zip(got, want))


def _subset_grads(fast, soft_grid, cam, o_c, d_c, target, settings, S,
                  lights):
    """Loss and the gradients to (sigma, rgb, cam pos, yaw, pitch) of the
    mean squared error over rays (o_c, d_c) in camera frame: through the
    custom backward (``fast``) or autograd through the plain renderer."""
    import torch

    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.engine.sharding import _world_rays
    from vxtpu_torch.render.soft import SoftGrid, render_soft_rays
    from vxtpu_torch.render.vjp import render_soft_rays_fast

    leaves = [x.detach().clone().requires_grad_(True)
              for x in (soft_grid.sigma_raw, soft_grid.rgb_raw, cam.pos,
                        cam.yaw, cam.pitch)]
    s = SoftGrid(leaves[0], leaves[1])
    o_w, d_w = _world_rays(Camera(*leaves[2:], cam.fov_y), o_c, d_c)
    if fast:
        pred = render_soft_rays_fast(s, o_w, d_w, settings, S, lights)
    else:
        pred = render_soft_rays(s, o_w, d_w, settings, S, lights)[0]
    loss = torch.sum((pred - target) ** 2) / (target.numel())
    return loss.detach(), torch.autograd.grad(loss, leaves)


def scale_config5(device, D=FULL, h=H, w=W, S=192, frames=C5_FRAMES,
                  subset=C5_SUBSET, card="") -> dict:
    """(b) config 5 through run_config5 on the 1-rank group: its first
    ``frames`` frames, the step's time and where it goes, and the custom
    backward against autograd on a subset of the last frame's rays."""
    import torch

    from vxtpu_torch.app.configs import CONFIGS
    from vxtpu_torch.camera import paths
    from vxtpu_torch.engine import sharding
    from vxtpu_torch.render.soft import SoftGrid
    from vxtpu_torch.render.vjp import render_soft_rays_fast
    from vxtpu_torch.train.config5 import Config5, run_config5
    from vxtpu_torch.world import procgen
    from vxtpu_torch.world.lights import Lights

    cfg = Config5(dims=(D,) * 3, height=h, width=w, num_samples=S,
                  ckpt_every=0)
    settings = CONFIGS["c5_1080p_pod"].settings
    mesh = sharding.make_mesh()
    clock = _FrameClock()
    marks = {}

    def mark(name):
        _sync(device)
        marks[name] = time.perf_counter()

    mark("start")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    res = run_config5(cfg, settings, mesh=mesh, sink=clock,
                      end_frame=frames)
    mark("run")
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    frame_ms = clock.frame_ms()
    print(f"phase 11 scale-out: config 5 at {D}^3, {h}x{w}, S = {S}, lit "
          f"({settings.shading}), custom backward, {mesh.size} rank, first "
          f"{frames} of {cfg.frames} frames x {cfg.steps_per_frame} steps: "
          f"losses {res['losses']}; PSNR {res['psnrs']}; yaw error "
          f"{res['yaw_err']:.5f}, pitch error {res['pitch_err']:.5f} (from "
          f"{cfg.pose_error}, -{cfg.pose_error}); frame ms [{card}] (target "
          f"render + steps + PSNR render; the first with first-use costs) "
          f"{[round(x, 1) for x in frame_ms]}; peak "
          f"{peak if peak is None else round(peak, 2)} GiB")
    if not all(math.isfinite(v) for v in res["losses"]):
        raise AssertionError(f"config 5: non-finite loss {res['losses']}")
    if not (abs(res["yaw_err"]) < cfg.pose_error
            and abs(res["pitch_err"]) < cfg.pose_error):
        raise AssertionError("config 5: the pose error did not fall below "
                             f"{cfg.pose_error}")

    # the last frame again, for the times (not counted): its target, the
    # step from the run's final state, forward and backward alone
    dims = cfg.dims
    X, Y, Z = dims
    truth = SoftGrid.from_hard(procgen.terrain(
        dims, seed=cfg.seed, with_rgb=True, device=device),
        sigma_solid=cfg.sigma_solid)
    lights = Lights.single((0.2 * X, -0.3 * Y, 1.4 * Z), intensity=2.0,
                           device=device)
    cam_true = paths.orbit(
        center=(0.5 * X, 0.5 * Y, 0.3 * Z), radius=0.9 * X, height=1.1 * Z,
        period=cfg.frames / cfg.fps, fov_y_deg=55.0, device=device)(
            (frames - 1) / cfg.fps)
    mark("truth")
    ev = StepTimer(device)
    ev()
    target = sharding.render_soft_image_sharded(
        truth, cam_true, settings, h, w, S, mesh, lights=lights).reshape(-1, 3)
    ev()
    target_ms = ev.ms()[0]
    del truth
    soft_f, cam_f = res["soft"], res["cam"]
    init_fn, step_fn = sharding.make_sharded_train_step(
        settings, S, mesh, lr=cfg.lr, cam_lr=cfg.cam_lr, optimize_camera=True,
        grad_buckets=1, lights=lights, use_custom_vjp=True)
    state = init_fn(soft_f, cam_f)
    o_c, d_c = sharding.camera_frame_rays(cam_f, h, w)
    timer = StepTimer(device)
    timer()
    s, c = soft_f, cam_f
    for _ in range(2):
        s, c, state, _ = step_fn(s, c, state, o_c, d_c, target)
        timer()
    step_ms = timer.ms()
    mark("steps")

    o_w, d_w = sharding._world_rays(cam_f, o_c, d_c)
    sg = SoftGrid(soft_f.sigma_raw.detach().clone().requires_grad_(True),
                  soft_f.rgb_raw.detach().clone().requires_grad_(True))
    ev = StepTimer(device)
    ev()
    pred = render_soft_rays_fast(sg, o_w, d_w, settings, S, lights)
    ev()
    (torch.sum((pred - target) ** 2) / (pred.numel())).backward()
    ev()
    fwd_ms, bwd_ms = ev.ms()
    del sg, pred
    mark("alone")

    def one_step():
        nonlocal s, c, state
        s, c, state, _ = step_fn(s, c, state, o_c, d_c, target)

    groups, wall = {}, None
    if device.type == "cuda":
        kernels, wall = _kernel_times(one_step, device)
        for name, ms in kernels.items():
            key = next((g for g, subs in C5_GROUPS if any(
                x in name for x in subs)), "other elementwise")
            groups[key] = groups.get(key, 0.0) + ms
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
        print(f"phase 11 scale-out: config 5 step profiled [{card}]: wall "
              f"{wall:.1f} ms, device ms by group "
              f"{ {k: round(v, 2) for k, v in groups.items()} }; top kernels "
              + "; ".join(f"{ms:.2f} {n[:60]}" for n, ms in top))
    del state
    mark("profile")
    print(f"phase 11 scale-out: config 5 step ms [{card}] (events, from the "
          f"run's final state, 1 bucket) {[round(x, 1) for x in step_ms]}; "
          f"forward alone {fwd_ms:.1f}, backward alone {bwd_ms:.1f}; the "
          f"target render {target_ms:.1f}")

    # the custom backward against autograd through the plain renderer on a
    # subset of the frame's rays (plain autograd cannot hold them all)
    idx = torch.linspace(0, h * w - 1, subset, device=device).long()
    got = _subset_grads(True, soft_f, cam_f, o_c[idx], d_c[idx], target[idx],
                        settings, S, lights)
    want = _subset_grads(False, soft_f, cam_f, o_c[idx], d_c[idx],
                         target[idx], settings, S, lights)
    rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    ex = _vjp_excess(got[1], want[1])
    print(f"phase 11 scale-out: custom backward vs autograd on {subset} rays "
          f"of the frame: loss rel {rel:.3g}; gradient (sigma, rgb, pos, "
          f"yaw, pitch) allclose excess {ex:.3g} (rtol {VJP_RTOL}, atol "
          f"{VJP_ATOL_REL} x max|g|); max |g| "
          f"{[float(g.abs().max()) for g in want[1]]}")
    if rel > 1e-5 or ex > 1.0:
        raise AssertionError("config 5: the custom backward and autograd "
                             "differ")
    mark("subset")
    names = list(marks)
    parts = {b: round(marks[b] - marks[a], 1)
             for a, b in zip(names, names[1:])}
    print(f"phase 11 scale-out: config 5 part seconds {parts}")
    return dict(losses=res["losses"], psnrs=res["psnrs"],
                yaw_err=res["yaw_err"], pitch_err=res["pitch_err"],
                frame_ms=frame_ms, step_ms=step_ms, fwd_ms=fwd_ms,
                bwd_ms=bwd_ms, target_ms=target_ms, peak_gib=peak,
                groups=groups, profiled_wall_ms=wall, vjp_excess=ex,
                vjp_loss_rel=rel)


def _kernel_times(fn, device):
    """Device ms by kernel name of one call of ``fn`` (torch.profiler
    without input shapes: a config-5 step is ~80,000 small kernels), and
    the call's wall ms under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and _device_us(e)):
            kernels[e.key] = kernels.get(e.key, 0.0) + _device_us(e) / 1e3
    return kernels, wall


# device-time groups of the profiled config-5 step (kernel-name parts)
C5_GROUPS = (("index_add_", ("index_add", "indexFunc")),
             ("Adam", ("multi_tensor", "adam", "Adam")),
             ("gather", ("index_elementwise", "gather", "indexSelect",
                         "index_kernel")),
             ("copy and cat", ("CatArray", "copy", "Copy")),
             ("fill", ("fill", "Fill")))


def scale_fused(device, D=FULL, h=H, w=W) -> dict:
    """(c) phase 4's lambert and full + shadows + fog frames through
    render_frame_fused_sharded (K1 in the rank's block), equal to
    render_frame_fused on every pixel."""
    import torch

    from vxtpu_torch.engine import sharding
    from vxtpu_torch.render import kernel_march as km
    from vxtpu_torch.render.fused import render_frame_fused
    from vxtpu_torch.world import procgen
    from vxtpu_torch.world.packed import (build_material_morton,
                                          build_packed_morton)

    dims = (D,) * 3
    grid = procgen.terrain(dims, seed=7, device=device)
    accel = build_packed_morton(grid.occupancy, cap=64)
    mats = build_material_morton(grid.occupancy)
    del grid
    light, requests = _main_scene(device, D)
    picked = [r for r in requests if r[0] in ("lambert", "full_shadows_fog")]
    mesh = sharding.make_mesh()
    km.reset_launch_counts()
    frames = {name: sharding.render_frame_fused_sharded(
        accel, mats, dims, cam, light, st, h, w, mesh, inkernel_shadows=ink)
        for name, cam, st, ink in picked}
    _sync(device)
    launches = dict(km.LAUNCHES)
    out = {}
    for name, cam, st, ink in picked:
        ref = render_frame_fused(accel, mats, dims, cam, light, st, h, w,
                                 inkernel_shadows=ink)
        out[name] = int((frames[name] != ref).any(dim=-1).sum())
    print(f"phase 11 scale-out: sharded fused frames at {D}^3 {h}x{w} on "
          f"{mesh.size} rank: pixels unlike render_frame_fused {out}; K1 "
          f"launches {launches['march_shade_kernel']}")
    if any(out.values()):
        raise AssertionError("sharded fused frames differ from the "
                             "unsharded ones")
    if device.type == "cuda" and launches["march_shade_kernel"] != len(picked):
        raise AssertionError(f"the sharded fused frames did not run K1 once "
                             f"each: {launches}")
    return dict(launches=launches["march_shade_kernel"], mismatches=out)


def scale_train(device, D=FULL, h=256, w=256, S=256, S_mask=64) -> dict:
    """(d) the sharded field-kernel step (K3/K4 in the rank) at c4's size,
    from zeros and, masked at S_mask on the bands, from the warm state
    (0.8 x the truth): their loss and table gradient against the
    single-device kernel path (fit_soft's loss without the TV prior, which
    the sharded step does not have) with phase 6's limits; then one
    step each (counted)."""
    import torch

    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.app.configs import CONFIGS
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.engine import sharding
    from vxtpu_torch.render import kernel_sample as ks
    from vxtpu_torch.render import occmask
    from vxtpu_torch.render.soft import SoftGrid
    from vxtpu_torch.render.soft_kernel import MortonSoftGrid
    from vxtpu_torch.train import loop
    from vxtpu_torch.world import procgen

    cfg4 = CONFIGS["c4_512_diff"]
    settings = cfg4.settings
    dims = (D,) * 3
    truth = SoftGrid.from_hard(procgen.terrain(
        dims, seed=cfg4.seed, with_rgb=True, device=device))
    cam = Camera.make(pos=(-0.7 * D, 0.5 * D, 1.1 * D),
                      device=device).look_at((0.5 * D, 0.5 * D, 0.27 * D))
    o, d = generate_rays(cam, h, w)
    target = _render_target(truth, o, d, settings, S)
    warm = MortonSoftGrid.from_soft(SoftGrid(truth.sigma_raw * 0.8,
                                             truth.rgb_raw * 0.8))
    del truth
    zero = MortonSoftGrid.from_soft(SoftGrid.zeros(dims, device=device))
    o_c, d_c = sharding.camera_frame_rays(cam, h, w)
    o_w, d_w = sharding._world_rays(cam, o_c, d_c)
    mask = occmask.occupancy_mask_from_soft(warm, 4, tau=0.01, dilate=1)
    mdf = occmask.mask_distance_field(mask)
    b0, b1 = sharding.compute_mask_bounds(mask, mdf, cam, o_c, d_c, 4)
    tc0 = loop.TrainConfig(tv_sigma=0.0, tv_rgb=0.0)
    mesh = sharding.make_mesh()
    cases = [("field kernel", zero, S, ()),
             ("masked", warm, S_mask, (mask, b0, b1))]
    ks.reset_launch_counts()
    got = {}
    for name, model, s, margs in cases:
        init_fn, step_fn = sharding.make_sharded_train_step(
            settings, s, mesh, optimize_camera=False, field_kernel=True,
            use_mask=bool(margs))
        state = init_fn(model, cam)
        loss, grads = step_fn.value_and_grad(model, cam, state, o_c, d_c,
                                             target, *margs)
        got[name] = (float(loss), kc.channels(grads[0].clone()))
        del grads
        # the step itself (Adam): its loss is the same forward's
        _, _, _, loss2 = step_fn(model, cam, state, o_c, d_c, target, *margs)
        if float(loss2) != got[name][0]:
            raise AssertionError(f"sharded {name} step: loss {float(loss2)} "
                                 f"against {got[name][0]} before it")
        del state
    _sync(device)
    launches = dict(ks.LAUNCHES)
    err = {}
    for name, model, s, margs in cases:
        bounds = (b0, b1) if margs else None
        lp, gp = _grads(model.tab, False, o_w, d_w, settings, s,
                        target=target, tc=tc0,
                        mask=mask if margs else None, bounds=bounds)
        ls, gs = got[name]
        rel = abs(ls - float(lp)) / abs(float(lp))
        ex = kc.grads_excess(gs, gp)
        err[name] = dict(loss_rel=rel, excess=ex, loss=ls)
        print(f"phase 11 scale-out: sharded {name} step at {D}^3 {h}x{w} S "
              f"= {s} on {mesh.size} rank vs the single-device kernel path: "
              f"loss {ls:.8f} vs {float(lp):.8f} (rel {rel:.3g}); gradient "
              f"allclose excess {ex:.3g}")
        if rel > 1e-6 or ex > 1.0:
            raise AssertionError(f"sharded {name} step differs from the "
                                 f"single-device step")
    print(f"phase 11 scale-out: sharded steps' launches {launches}")
    if device.type == "cuda" and not (
            launches["sample_fwd_kernel"] == 2 * len(cases)
            and launches[BWD[False]] == 2 * len(cases)):
        raise AssertionError(f"the sharded steps did not run K3 and K4 "
                             f"twice each: {launches}")
    return dict(launches=launches, err=err)


def _small_world(D, h, w, S, buckets) -> dict:
    """(e)'s run on the process group's mesh at D^3: the pipeline frame
    (K5) and the fused frame (K1) of phase 4's scene with shadows and fog,
    and config 5's step (lit, custom backward, camera, ``buckets``
    buckets) from zeros: loss and gradients. Numpy out (it crosses
    processes)."""
    import dataclasses

    from vxtpu_torch.app.configs import CONFIGS
    from vxtpu_torch.app.run import kernel_factory
    from vxtpu_torch.camera import paths
    from vxtpu_torch.engine import platform, sharding
    from vxtpu_torch.render.soft import SoftGrid
    from vxtpu_torch.world import procgen
    from vxtpu_torch.world.lights import Lights
    from vxtpu_torch.world.packed import (build_material_morton,
                                          build_packed_morton)

    device = platform.rank_device()
    mesh = sharding.make_mesh()
    dims = (D,) * 3
    grid = procgen.terrain(dims, seed=7, with_rgb=True, device=device)
    light, requests = _main_scene(device, D)
    _, cam, full, _ = next(r for r in requests if r[0] == "full_shadows_fog")
    frame = sharding.render_image_sharded(kernel_factory("pallas"), grid, cam,
                                          light, full, h, w, mesh)
    fused = sharding.render_frame_fused_sharded(
        build_packed_morton(grid.occupancy, cap=64),
        build_material_morton(grid.occupancy), dims, cam, light, full, h, w,
        mesh)
    settings = CONFIGS["c5_1080p_pod"].settings
    X, Y, Z = dims
    lights = Lights.single((0.2 * X, -0.3 * Y, 1.4 * Z), intensity=2.0,
                           device=device)
    truth = SoftGrid.from_hard(grid, sigma_solid=25.0)
    cam5 = paths.orbit(center=(0.5 * X, 0.5 * Y, 0.3 * Z), radius=0.9 * X,
                       height=1.1 * Z, period=1.0, fov_y_deg=55.0,
                       device=device)(0.0)
    target = sharding.render_soft_image_sharded(
        truth, cam5, settings, h, w, S, mesh, lights=lights).reshape(-1, 3)
    est = dataclasses.replace(cam5, yaw=cam5.yaw + 0.03)
    init_fn, step_fn = sharding.make_sharded_train_step(
        settings, S, mesh, cam_lr=2e-3, optimize_camera=True,
        grad_buckets=buckets, lights=lights, use_custom_vjp=True)
    zero = SoftGrid.zeros(dims, device=device)
    o_c, d_c = sharding.camera_frame_rays(est, h, w)
    loss, grads = step_fn.value_and_grad(zero, est, init_fn(zero, est), o_c,
                                         d_c, target)
    return dict(frame=frame.cpu().numpy(), fused=fused.cpu().numpy(),
                loss=float(loss), grads=[g.cpu().numpy() for g in grads])


def scale_gloo(device, D=64, h=256, w=256, S=64, buckets=4,
               cli_size=None) -> dict:
    """(e) 2 gloo ranks on the one card against this process's 1-rank
    run; dryrun_multichip(2); the scaling command at world 1."""
    import numpy as np
    import torch

    from vxtpu_torch.app.dryrun import dryrun_multichip
    from vxtpu_torch.engine.platform import run_local
    from vxtpu_torch.render import kernel_march as km

    t0 = time.perf_counter()
    ref = _small_world(D, h, w, S, buckets)
    outs = run_local(2, _small_world, backend="gloo", device=device.type,
                     timeout=600, args=(D, h, w, S, buckets))
    worst = {}
    for r, out in enumerate(outs):
        for key in ("frame", "fused"):
            n_bad = int((out[key] != ref[key]).any(axis=-1).sum())
            worst[key] = max(worst.get(key, 0), n_bad)
        rel = abs(out["loss"] - ref["loss"]) / abs(ref["loss"])
        worst["loss_rel"] = max(worst.get("loss_rel", 0.0), rel)
        worst["grad_excess"] = max(worst.get("grad_excess", 0.0), _vjp_excess(
            [torch.from_numpy(g) for g in out["grads"]],
            [torch.from_numpy(g) for g in ref["grads"]]))
    print(f"phase 11 scale-out: 2 gloo ranks on the {device.type} at {D}^3 "
          f"{h}x{w} vs 1 rank: pixels unlike (pipeline K5 frame, fused K1 "
          f"frame) {worst['frame']}, {worst['fused']}; config 5 step (S = "
          f"{S}, {buckets} buckets) loss rel {worst['loss_rel']:.3g}, "
          f"gradient allclose excess {worst['grad_excess']:.3g}, in "
          f"{time.perf_counter() - t0:.1f} s")
    if worst["frame"] or worst["fused"] or worst["loss_rel"] > 1e-5 \
            or worst["grad_excess"] > 1.0:
        raise AssertionError("2 gloo ranks differ from 1 rank")
    t0 = time.perf_counter()
    dry = dryrun_multichip(2, device=device)
    dry_s = time.perf_counter() - t0
    if cli_size is None:
        cli_size = ["--dims", str(D), "--height", str(h), "--width", str(w)]
    km.reset_launch_counts()
    line = _run_cli(["scaling", "--kernel", "fused", "--config",
                     "c3_256_shadows", "--iters", "3", "--device",
                     device.type, *cli_size])[-1]
    print(f"phase 11 scale-out: dryrun_multichip(2) in {dry_s:.1f} s; "
          f"scaling --kernel fused {' '.join(cli_size)}: {line}; K1 "
          f"launches {km.LAUNCHES['march_shade_kernel']}")
    if json.loads(line)["devices"] != 1 or not np.isfinite(
            json.loads(line)["mrays"]):
        raise AssertionError(f"scaling: {line}")
    return dict(worst=worst, dryrun=dry, scaling=json.loads(line))


def phase_scale_out(device, card="", c5=None, fused=None, train=None,
                    gloo=None) -> dict:
    """Phase 11: the platform checks and the sharded paths (see the module
    docstring). The keyword dicts pass sizes to the parts (a CPU
    rehearsal runs them small)."""
    from vxtpu_torch.engine import platform

    t0 = time.perf_counter()
    info = platform.init_multihost(device=device)
    try:
        rep = json.loads("\n".join(_run_cli(["info", "--device",
                                             device.type])))
        platform.validate_platform(mesh_devices=1, device=device)
        print(f"phase 11 scale-out: platform {info}; validate_platform "
              f"passed; info {json.dumps(rep)}")
        if device.type == "cuda":
            import torch

            props = torch.cuda.get_device_properties(device)
            if (tuple(rep["capability"]) != (9, 0)
                    or rep["hbm_bytes"] != props.total_memory):
                raise AssertionError(f"info: {rep}")
        out = dict(platform=rep)
        parts = (("config5", scale_config5, dict(card=card, **(c5 or {}))),
                 ("fused", scale_fused, fused or {}),
                 ("train", scale_train, train or {}),
                 ("gloo", scale_gloo, gloo or {}))
        for key, fn, kw in parts:
            t1 = time.perf_counter()
            out[key] = fn(device, **kw)
            print(f"phase 11 scale-out: ({key}) {time.perf_counter() - t1:.1f} "
                  f"s")
    finally:
        platform.shutdown()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 11 scale-out: {out['seconds']:.1f} s")
    return out


def k1_k2_bounds(times, h, w, n_lights=1) -> dict:
    """Least times (ms) of K1 in the lambert frame (k1_bound; without its
    table words, ``bound_rays_only_ms``) and of K2, the shade kernel alone:
    each ray's inputs (o, d, hit, t, voxel, normal and the visibility) read
    once and its rgb written once, plus one material word per hit ray;
    MARCH_OPS_RAY operations per ray and per light."""
    n = h * w
    lam = times["lambert"]
    k1 = k1_bound(n, lam["steps"], lam["table_words"], True, lam["hits"])
    comp = times["full_shadows_fog_composed"]
    k2_bytes = n * (24 + 29 + 4 * n_lights + 12) + comp["hits"] * 4
    k2_ops = n * MARCH_OPS_RAY * (1 + n_lights)
    return {"march_shade_kernel": dict(
                bound_ms=k1["bound_ms"], bound_by=k1["bound_by"],
                bound_rays_only_ms=k1_bound(n, lam["steps"], 0, True,
                                            lam["hits"])["bound_ms"],
                table_words=lam["table_words"]),
            "shade_kernel": {k: v for k, v in _bound(k2_bytes, k2_ops).items()
                             if k.startswith("bound")}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--save", default=None,
                   help="directory for the main-path frames as PNGs")
    p.add_argument("--k5-times", action="store_true",
                   help="phases 1 and 2, then K5 alone on its three ray "
                        "sets (k5_rays, k5_times) and a JSON line of the "
                        "results; copied into a checkout of another commit, "
                        "it times that commit's K5 the same way")
    p.add_argument("--k1-times", action="store_true",
                   help="phases 1 and 2, then K1 alone in each launch mode "
                        "and K1' round 0 on phase 4's 512^3 1080x1920 rays "
                        "(k1_world, k1_times), the blocks an SM of each K1 "
                        "instantiation and a JSON line of the results; "
                        "copied into a checkout of another commit, it times "
                        "that commit's K1 the same way")
    p.add_argument("--k6-times", action="store_true",
                   help="phases 1 and 2, then phase 9's K6 part alone "
                        "(k6_probe) on phase 4's 512^3 world and 1080x1920 "
                        "rays, and a JSON line of its results")
    p.add_argument("--tv-times", action="store_true",
                   help="phases 1 and 2, then the TV prior's kernel pair "
                        "against its plain version at 64^3 and 512^3 and "
                        "its device time a call at 512^3 beside its bounds "
                        "and the plain version's (tv_times), and a JSON "
                        "line of the results")
    p.add_argument("--adam-times", action="store_true",
                   help="phases 1 and 2, then Adam's kernel against "
                        "torch's foreach step in kernel_check.ADAM_CASES "
                        "and on a 512^3 table, and its device time a launch "
                        "at 512^3 beside its bound, the plain version's and "
                        "the foreach step's (adam_times), and a JSON line "
                        "of the results")
    p.add_argument("--scale-out", action="store_true",
                   help="phases 1 and 2, then phase 11 alone (the sharded "
                        "paths, config 5 at full size) and a JSON line of "
                        "its results")
    p.add_argument("--bench", action="store_true",
                   help="phases 1 and 2, then phase 12 alone (the reference "
                        "and wavefront marches and the bench) and a JSON "
                        "line of its results")
    p.add_argument("--sass", default=None, metavar="FILE",
                   help="with --k5-times, --k1-times or --k6-times: write "
                        "that kernel's SASS listing to FILE (and with the "
                        "first two print its opcodes by count)")
    args = p.parse_args(argv)
    _require_checkout()
    device, name, smi = phase_device()
    usage = phase_build()
    if args.scale_out:
        out = phase_scale_out(device, card=smi)
        print(json.dumps({"scale_out": {k: v for k, v in out.items()
                                        if k != "gloo"}, "gpu": smi},
                         default=str))
        return 0
    if args.bench:
        out = phase_bench(device, card=smi)
        print(json.dumps({"bench": out, "gpu": smi}, default=str))
        return 0
    if args.tv_times:
        out = {"gpu": smi, "ptxas": {k: v for k, v in (usage or {}).items()
                                     if k.startswith("tv_")},
               "tv_times": tv_times(device)}
        print(json.dumps(out, default=str))
        return 0
    if args.adam_times:
        out = {"gpu": smi, "ptxas": {k: v for k, v in (usage or {}).items()
                                     if k.startswith("adam_")},
               "adam_times": adam_times(device)}
        print(json.dumps(out, default=str))
        return 0
    if args.k6_times:
        from vxtpu_torch.world import procgen

        if args.sass:
            sass_functions("march_probe_kernel", Path(args.sass))
        out = k6_probe(device, procgen.terrain((FULL,) * 3, seed=7,
                                               device=device))
        print(json.dumps({"k6": out, "gpu": smi}, default=str))
        return 0
    if args.k1_times:
        out = {"gpu": smi, "ptxas": {k: v for k, v in (usage or {}).items()
                                     if "march_shade" in k},
               "occupancy": k1_occupancy()}
        print(f"K1 blocks an SM at {FULL}^3 (CUDA occupancy API): "
              f"{out['occupancy']}")
        if args.sass:
            out["sass"] = sass_functions("march_shade_kernel",
                                         Path(args.sass))
            for fn, ops in out["sass"].items():
                print(f"K1 SASS {fn}: {sum(ops.values())} instructions; "
                      + ", ".join(f"{k} {v}" for k, v in ops.items()))
        out["k1_times"] = k1_times(k1_world(device), device, record=True)
        print(json.dumps(out))
        return 0
    if args.k5_times:
        from vxtpu_torch import _build

        blocks = getattr(_build.load(), "vx_march_packed_blocks_per_sm", None)
        out = {"blocks_per_sm": blocks() if blocks else None, "gpu": smi}
        if args.sass:
            out["sass"] = sass_opcodes("march_packed_kernel", Path(args.sass))
            print(f"K5 SASS: {sum(out['sass'].values())} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in out["sass"].items()))
        out["k5_times"] = k5_times(k5_rays(device), device)
        print(json.dumps(out))
        return 0
    err3 = phase_kernels(device)
    main_run = phase_main(device, save=args.save)
    cross_fingerprint(main_run["grid"], main_run["accel"])
    del main_run["accel"]
    grid = main_run.pop("grid")
    pipe = phase_pipeline(device, grid, save=args.save)
    resume = phase_resume(device, grid)
    del grid
    phase_xla(device, save=args.save, card=smi)
    mask = phase_mask(device, card=smi)
    cross_entry_frame(device)
    train = phase_train(device)
    cross_train(device)
    bench_run = phase_bench(device, card=smi)
    scale = phase_scale_out(device, card=smi)

    import torch

    times = main_run["times"]
    tt = train["times"]
    # the launches of the bench's fused and field-kernel train sections;
    # its field step against the kernels' plain versions (allclose excess)
    bench_launches = bench_run["commands"]["launches"]
    bounds = k1_k2_bounds(times, H, W)
    k1 = pipe["times"]["k1"]
    kernels = [
        {"name": "march_shade_kernel", "route": "cuda",
         "source": "vxtpu_torch/csrc/march.cu",
         "replaces": "vxtpu/render/kernel_pallas_v2.py:434",
         "launches": main_run["launches"]["march_shade_kernel"],
         "variant_launches": main_run["variant_launches"],
         "max_abs_err": max(err3["march_shade_kernel"],
                            main_run["err"]["march_shade_kernel"]),
         "ms": times["lambert"]["kernel_ms"], "ms_clock": "events",
         "device_ms": times["lambert"].get("kernel_device_ms"),
         "device_ms_clock": times["lambert"].get("kernel_device_ms_clock"),
         "plain_ms": times["lambert"]["plain_ms"],
         **bounds["march_shade_kernel"],
         "modes": {m: {k: k1[m][k] for k in ("device_ms", "graph_ms",
                                               "bound_ms", "bound_by",
                                               "share")}
                   for m in K1_MODES},
         "occupancy": pipe["times"]["k1_occupancy"],
         "sharded": {"launches": scale["fused"]["launches"],
                     "mismatched_pixels": scale["fused"]["mismatches"]},
         "bench": {"launches": bench_launches["march_shade_kernel"],
                   "variant_launches": bench_launches["variants"]},
         "library_ms": None},
        {"name": "shade_kernel", "route": "cuda",
         "source": "vxtpu_torch/csrc/march.cu",
         "replaces": "vxtpu/render/kernel_pallas_v2.py:1219",
         "launches": main_run["launches"]["shade_kernel"],
         "max_abs_err": max(err3["shade_kernel"],
                            main_run["err"]["shade_kernel"]),
         "ms": times["shade_kernel"]["ms"], "ms_clock": "events",
         "device_ms": times["shade_kernel"].get("device_ms"),
         "device_ms_clock": times["shade_kernel"].get("device_ms_clock"),
         "plain_ms": times["shade_kernel"]["plain_ms"],
         **bounds["shade_kernel"], "library_ms": None},
    ]
    # K3 and K4's pure scatter: launches of the five c4 steps; K4 with
    # kRayGrads and its ray sums: launches of the camera refinement
    for k, line, run in (
            ("sample_fwd_kernel", "213", train["launches"]),
            (BWD[False], "434", train["launches"]),
            (BWD[True], "434", train["cam_launches"]),
            ("sample_ray_sum_kernel", "434 (its per-ray sums)",
             train["cam_launches"])):
        kernels.append({
            "name": k, "route": "cuda",
            "source": "vxtpu_torch/csrc/sample.cu",
            "replaces": f"vxtpu/render/kernel_sample.py:{line}",
            "launches": run[k],
            "max_abs_err": max(err3.get(k, 0.0), train["err"][k]),
            "ms": tt[k]["ms"], "ms_clock": "events",
            "device_ms": tt[k]["device_ms"],
            "device_ms_clock": tt[k]["device_ms_clock"],
            "bench": {"launches": bench_launches[k], "field_step_vs_plain": {
                n: {e: r[e] for e in ("loss_rel", "table", "camera", "rays")}
                for n, r in bench_run["field_step"].items()}},
            "plain_ms": tt[k]["plain_ms"],
            "bound_ms": tt[k]["bound_ms"], "bound_by": tt[k]["bound_by"],
            "library_ms": tt[k]["library_ms"]})
        if k in BWD.values():
            kernels[-1]["zero_fill"] = tt["zero_fill"]
        if k == "sample_ray_sum_kernel":
            kernels[-1].update({x: tt[k].get(x) for x in (
                "warm_graph_ms", "warm_graph_ms_clock", "cold_device_ms",
                "cold_device_ms_clock")})
        if k in scale["train"]["launches"]:
            # phase 11's sharded field-kernel and masked steps
            kernels[-1]["sharded"] = {
                "launches": scale["train"]["launches"][k],
                "grad_excess": {n: e["excess"] for n, e in
                                scale["train"]["err"].items()}}
        if k in mask["alone"]:
            # phase 10's masked fit: its launches, and the kernel alone at
            # the masked step's shape (S = 64 on the occupied bands)
            kernels[-1]["masked"] = {
                "launches": mask["launches"][k],
                "max_abs_err": mask["err"][k], **mask["alone"][k]}
    # the TV prior's pair: launches of the five c4 steps, errors of phase
    # 3 (64^3) and phase 6 (64^3 and 512^3, every case), times at 512^3
    tv = tt["tv"]
    for k, row, plain in (("tv_fwd_kernel", "fwd_kernel", "plain_fwd"),
                          ("tv_fwd_finish_kernel", "fwd_finish", "plain_fwd"),
                          ("tv_bwd_kernel", "bwd", "plain_fwd_bwd")):
        r = tv[row]
        kernels.append({
            "name": k, "route": "cuda", "source": "vxtpu_torch/csrc/tv.cu",
            "replaces": "none (vxtpu/train/loss.py:tv_loss_morton is plain "
                        "jnp that XLA fuses)",
            "launches": train["tv_launches"][k],
            "max_abs_err": max(err3[k], tv["err"][k]),
            "max_abs_err_is": ("the value's relative error" if "fwd" in k
                               else "the gradient's error x max |g|"),
            "device_ms": r["device_ms"], "device_ms_clock": r["clock"],
            "call_device_ms": tv["fwd" if "fwd" in k else "bwd"]["device_ms"],
            "plain_ms": tv[plain]["device_ms"],
            "plain_ms_is": ("the plain forward" if plain == "plain_fwd"
                            else "the plain forward and backward"),
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    # Adam's kernel: launches of the five c4 steps, errors against torch's
    # foreach step of phase 3 and phase 6 (its cases and the 512^3 table),
    # times at 512^3 (the foreach step as the library yardstick)
    ad = tt["adam"]
    kernels.append({
        "name": "adam_step_kernel", "route": "cuda",
        "source": "vxtpu_torch/csrc/adam.cu",
        "replaces": "none (vxtpu's optax.adam is plain jnp that XLA fuses)",
        "launches": train["adam_launches"]["adam_step_kernel"],
        "max_abs_err": max(err3["adam_step_kernel"], ad["err"]),
        "max_abs_err_is": "against torch.optim.Adam's foreach step, over "
                          "the parameters and both moments",
        "device_ms": ad["kernel"]["device_ms"],
        "device_ms_clock": ad["kernel"]["clock"],
        "plain_ms": ad["plain"]["device_ms"],
        "plain_ms_is": "torch's single-tensor ops, a call",
        "bound_ms": ad["kernel"]["bound_ms"],
        "bound_by": ad["kernel"]["bound_by"],
        "library_ms": ad["foreach"]["device_ms"],
        "library_ms_is": "torch.optim.Adam's foreach step, a call"})
    pt = pipe["times"]
    c3, c3s, big = pt["c3"], pt["c3_shadow"], pt["big"]["k5"]
    kernels.append({
        "name": "march_packed_kernel", "route": "cuda",
        "source": "vxtpu_torch/csrc/march_packed.cu",
        "replaces": "vxtpu/render/kernel_pallas.py:85",
        "launches": pipe["launches"]["march_packed_kernel"],
        "max_abs_err": pipe["err"], "ms": pt["ms"], "ms_clock": "events",
        "device_ms": c3.get("device_ms"),
        "device_ms_clock": c3.get("device_ms_clock"),
        "graph_ms": c3.get("graph_ms"), "graph_ms_clock": "events",
        "plain_ms": pt["plain_ms"], "bound_ms": c3["bound_ms"],
        "bound_by": c3["bound_by"], "bound_int32_ms": c3["bound_int32_ms"],
        "bound_rays_only_ms": c3["bound_rays_only_ms"],
        "table_words": c3["table_words"],
        "shadow_device_ms": c3s.get("device_ms"),
        "shadow_bound_ms": c3s["bound_ms"],
        "big_device_ms": big.get("device_ms"),
        "big_graph_ms": big.get("graph_ms"), "big_bound_ms": big["bound_ms"],
        "blocks_per_sm": pt.get("blocks_per_sm"), "library_ms": None})
    rt = resume["times"]
    kernels.append({
        "name": "march_resume_kernel", "route": "cuda",
        "source": "vxtpu_torch/csrc/march.cu",
        "replaces": "vxtpu/render/kernel_pallas_v2.py:434 (resume mode) "
                    "and :1105 (march_pallas_v2_sorted)",
        "launches": rt["launches"]["march_resume_kernel"],
        "max_abs_err": resume["err"]["march_resume_kernel"],
        "ms": rt["round0_ms"], "ms_clock": rt["round0_ms_clock"],
        "plain_ms": rt["round0_plain_ms"],
        "bound_ms": rt["bound0"]["bound_ms"],
        "bound_by": rt["bound0"]["bound_by"],
        "bound_rays_only_ms": rt["bound0_rays_only_ms"],
        "resume_ms": rt["resume_all_ms"],
        "resume_bound_ms": rt["bound1"]["bound_ms"], "library_ms": None})
    k6 = rt["k6"]
    kernels.append({
        "name": "march_probe_kernel", "route": "cuda",
        "source": "vxtpu_torch/csrc/probe.cu",
        "replaces": ", ".join(f"tools/{f}" for f in (
            "probe_pallas2_cost.py:164", "probe_pallas2_fixed.py:122",
            "probe_r5_fetch.py:175", "probe_r5_fetch2.py:177",
            "probe_r5_fetch3.py:152", "probe_r4_tune.py:181",
            "probe_r4_tile16.py:133", "probe_r4_matfetch.py:96",
            "probe_r4_matfetch.py:102")),
        "launches": k6["launches"],
        "max_abs_err": resume["err"]["march_probe_kernel"],
        "ms": k6["full_ms"], "ms_clock": k6["full_clock"],
        "parent_form_ms": k6["parent_ms"],
        "parent_form_ms_clock": k6["parent_clock"],
        "reads_per_ray_iter": k6["reads_per_ray_iter"],
        "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound"]["bound_ms"],
        "bound_by": k6["bound"]["bound_by"],
        "occupancy": k6["occupancy"]["full/morton16/k1"],
        "library_ms": None})
    print(json.dumps({"kernels": kernels, "gpu": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
