#!/usr/bin/env python3
"""Drive vxtpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--save DIR] [--times [ROW ...] [--sass FILE] |
                           --scale-out | --bench]

Run from the root of a checkout; it needs one CUDA device and nvcc.
Phases, each printing what it found (any failure raises, exit code != 0):

  1. device  the card's name and power limit (nvidia-smi);
  2. build   compile the CUDA kernels of vxtpu_torch/csrc with nvcc;
  3. (none)  each kernel against its plain version on small scenes is
             python -m pytest --noconftest tests/test_torch_cuda.py;
  4. main    the full-size path: 512^3 terrain (seed 7), Morton tables,
             and five 1080x1920 frames through render_frame_fused
             (outside camera lambert; full + shadows + fog in-kernel and
             composed; the bench's inside camera, which sits in solid rock,
             lambert; an inside camera in the air, lambert). Launch counts
             (K1's by instantiation), finiteness, hit fraction, agreement
             with the plain versions (K1: hit, voxel, normal and steps on
             every ray, rgb within 1e-5 on every pixel; K2 on the
             composed frame), median frame times and total march steps;
  5. cross   the 512^3 world fingerprint and the frame of the 128^3 entry
             scene against the JAX package's data in vxtpu_torch/data;
  6. train   the config-4 trainer (c4_512_diff as its config defines it):
             512^3 terrain (seed 7) -> SoftGrid.from_hard truth -> one
             256x256 target view at S = 256 (plain soft renderer, in ray
             chunks) -> five fit_soft steps from SoftGrid.zeros through the
             field-sampling kernels K3/K4 (K4's pure scatter: the rays
             carry no gradient), the TV prior's kernel pair and Adam's
             kernel. Launch counts per K4 variant, per TV kernel and of
             Adam's kernel (one a step), the loss per step (finite and
             falling), peak memory; two steps refining the camera pose
             (K4 with kRayGrads, counted); one step's loss and gradient
             through the plain versions against the kernels', a lit
             forward and backward at 512^3, K3 and both K4 variants
             against their plain versions at the step's shape, and a
             profiled step's device time by group (K3, K4, Adam, the TV
             prior, the other dense-table glue, the [S, N] math). The
             scene is one channel-interleaved [D^3, 4] Morton table that
             K3 reads and K4 scatters into;
  7. cross   the fit at 32^3 against the JAX package's loss trajectory and
             K3's outputs against its checksums (vxtpu_torch/data);
  8. pipeline the composable render pipeline (render / animate / bench
             --kernel pallas) through the row-major march kernel K5: the
             c3 frame (256^3 terrain seed 7, per-voxel RGB, 1024x1024,
             full + shadows + fog) through render_image, with and without
             the face-texture atlas (launches counted); K5 against K1
             (march-only) on the 512^3/1080p lambert frame of phase 4; the
             blocks an SM of K5 and of each K1 instantiation
             (k1_occupancy); the animate and bench commands; K5 and the
             row-major table against the JAX package's checksums
             (vxtpu_torch/data/packed_seed7.json). Runs between phases 5
             and 6, on phase 4's 512^3 world;
  9. resume  the resume-mode march K1' (march_resume_kernel) on phase 4's
             512^3 world (run after phase 8): against its plain version
             on all 1080x1920 lambert rays (budget 24, then a resume); the
             sorted multi-round march march_sorted on the lambert and the
             inside_air_lambert rays against single-round K1 march-only,
             with a forced drain; the warp coherence of the single round,
             of the survivors in launch order and of the sorted resume
             round; the sorted march and an argsort alone (sorted_probe,
             events);
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
             kernels and busy time a frame (profile_kernels), and the
             render (both accelerations) and bench commands with --kernel
             xla;
             (b) the occupancy-masked c4 fit: 512^3 truth (seed 7,
             from_hard), one 256x256 target at S = 256, the warm state
             (0.8 x the truth), its 128^3 mask (G = 4, tau 0.01, dilate
             1), its distance field and compute_mask_bounds (one
             mask_bounds_kernel launch, counted): the occupied share,
             band over full segment, the bounds pass alone; the
             bounds conservative on all 65,536 rays; S = 64 on the bands
             against S = 256 on the whole segment (mean |d rgb| < 0.015);
             one masked step through K3/K4 against their plain versions;
             a masked step at S = 64 and an unmasked one at S = 256 (peak
             memory, loss, K3/K4 launches); K3 and K4's scatter against
             their plain versions at the masked shape; five fit_soft
             steps from zeros with the mask rebuilt at steps 2 and 4
             (counted: K3, K4 and the bounds kernel once a step; losses
             finite and falling);
             and train --field-kernel --occmask at c4's size.
 11. scale-out the platform checks and the sharded paths (run last, on a
             1-rank NCCL process group of this process: NCCL cannot put
             two ranks on one card). (a) validate_platform (sm_90, the
             card's memory) and the info command; (b) config 5 through
             run_config5 as c5_1080p_pod defines it (512^3 truth, seed 7,
             per-voxel RGB; 1080x1920, S = 192, full shading with one
             light, the custom backward of render/vjp.py), its first 3
             of 24 frames x 2 steps: losses finite, yaw and pitch errors
             below 0.03, peak memory; then from its final state the
             custom backward against autograd through the plain
             renderer on 4,096 of the frame's rays (its step and frame
             times are the benchmark cell c5_1080p_pod.anim_fit's);
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
 13. times   the kernel table (kernel_rows; PERF.md section 6; run after
             phase 9): each kernel alone at its main path's shape, timed
             one way (time_row: the device time a launch, the median of
             ROUNDS profiler windows of REPS launches,
             render/probe.py:device_ms; a CUDA graph's replay beside K1,
             K1' round 0, K5 and the warm ray sum), its bound (the larger
             of its bytes over the HBM rate and its float32 operations
             over the float32 peak, vxbench/bounds.py; a share above 1.05
             raises) and its plain and library yardsticks' time a call
             (CUDA events). The rows: K1 in
             each launch mode (march, lambert, full_shadows_fog) and K1'
             round 0 and the resume of every ray on phase 4's 512^3/1080p
             outside rays; K2 on the composed frame's record; K5 on the
             c3 frame's primary and shadow rays and at 512^3; K6's sweep
             (every ray order x layout x variant x block size in K1's
             step, the float step, the rays from their grid entry;
             windows of 10 a configuration; registers, blocks an SM and
             SASS loops); K3 and K4's scatter at the c4 step's shape and
             at the masked one, K4 with kRayGrads, the ray sum warm and
             with the L2 flushed, K4's zero-fill of the dense gradient;
             the bounds pass (mask_bounds_kernel) on the masked step's
             mask and rays, first held to the batched path bit for bit,
             with its registers and spills; the TV prior's three kernels
             and Adam's at 512^3. Where a
             bound counts the table words the plain version reads (K1,
             K1', K5, K6), the row first holds the kernel to its plain
             version on every ray; the TV rows first hold the pair to
             its plain version at 512^3, and Adam's row its kernel to
             torch's foreach step over 3 steps of the 512^3 table.

Phases 6 and 10 hold K3/K4 against their plain versions: forward |d| <=
1e-6; both K4 variants' gradient tables within rtol 1e-5 / atol 1e-6 x
max|g| of the plain version and of a second run (the float atomics of the
scatter sum in a varying order), the kRayGrads variant's ray cotangents
equal bit for bit.

Phase 13 holds K1 to its plain version as phase 4 does, K5 exactly (hit,
voxel, normal and steps equal on every ray, |t difference| <= 1e-6), K1'
exactly (every field on every ray) and K6's acc bit for bit (in every ray
order, put back in pixel order, and in both steps). Phase 9 holds K1' to
its plain version and march_sorted to single-round K1 exactly (hit, t,
voxel, normal, steps).

Phase 10 holds the masked step's loss and gradient through K3/K4 to
their plain versions with phase 6's limits, and the batched march to K5
with the limits above.

Phase 11 holds the sharded frames to the unsharded ones on every pixel,
the sharded K3/K4 steps to the single-device step with phase 6's limits,
and the custom backward (to autograd) and 2 gloo ranks' config-5 step
(to 1 rank's) within rtol 2e-4 / atol 2e-5 x max|g| (the loss within
rel 1e-5): on CUDA index_add_ sums in a varying order.

The line before the last is one JSON object with the kernels' counts
and errors (from the phases) and times and bounds (from phase 13's rows;
the bounds of K1, K1' and K5 count the distinct table words their
marches read, counted on the plain march; the bounds without them are
kept as bound_rays_only_ms; K3's and K4's scatter also carry "masked":
phase 10's launches and the kernel alone at the masked step's shape);
the last line is {"ok": true, "device": {...}}. K1, K3 and K4 carry
"sharded": their launches in phase 11, and "bench": their launches in
the bench's fused and field-kernel sections (phase 12, counted by the
bench); every time has its clock beside it ("events", "profiler-device").
--save DIR writes the main-path frames there as PNGs. --scale-out runs
phases 1 and 2, then phase 11 alone, and prints one JSON line; --bench
runs phases 1 and 2, then phase 12 alone, and prints one JSON line.
--times [ROW ...] runs phases 1 and 2, then phase 13 alone on the named
rows (a row's name, such as k4.scatter, or its kernel's part before the
dot, such as k4; none: every row), and prints one JSON line. Copied into
a checkout of another commit, it times that commit's kernels the same
way, so that two commits can be compared in turns on one card. With
--times, --sass FILE writes the SASS listing of the K1, K5 and K6 kernels
among the rows there, each instantiation after a "// name" line, and
prints each one's opcodes by count.
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
from types import SimpleNamespace
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# the benchmark's yardstick, one copy: the card's peaks, the least time
# of a piece of work and the march's operation counts (the peaks are read
# here by vxbench/tests only)
from vxbench.bounds import (MARCH_OPS_RAY, MARCH_OPS_STEP,  # noqa: E402
                            PEAK_BYTES, PEAK_F32)
from vxbench.bounds import bound as _bound  # noqa: E402

FULL = 512
H, W = 1080, 1920
RUNS = 5
# the c3_256_shadows frame; the c4 fit's view and its samples a ray,
# unmasked and masked
C3_D, C3_HW = 256, 1024
C4_HW, C4_S, C4_S_MASK = 256, 256, 64
# a kernel row's profiler windows (launches a window, windows), and the
# calls a plain or library yardstick is timed over (CUDA events)
REPS, ROUNDS, YARD_REPS = 20, 3, 3

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


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def median_ms(fn, device, runs=RUNS) -> float:
    """Median wall time of fn() over ``runs`` runs after one warm-up; on
    the GPU measured with CUDA events around each run: the wall times of
    paths that have no benchmark cell, and the kernel rows' plain and
    library yardsticks; a kernel alone is timed by time_row's profiler
    windows."""
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


class Row(NamedTuple):
    """A row of the kernel table (PERF.md section 6): a kernel alone at a
    main path's shape. ``inputs`` builds its inputs (a SimpleNamespace)
    from its ``scene`` (SCENES; rows of one scene stand together in
    kernel_rows()),
    as the phases build them; where its bound counts what the plain
    version reads, ``inputs`` runs the plain version and holds the kernel
    to it. ``launch`` runs the kernel once; ``kernel`` is the part of its
    name the profiler records, timed a launch; ``bound`` the least time of
    that launch (_bound: bytes and float32 operations); ``plain`` and
    ``library`` the yardsticks, timed a call; ``graph`` adds the launches
    replayed from a CUDA graph; ``sweep`` times the row as a loop of its
    own (K6). Each callable takes the inputs."""

    name: str
    scene: str | None
    inputs: object
    launch: object
    kernel: str
    bound: object = None
    plain: object = None
    library: object = None
    graph: bool = False
    sweep: object = None


def time_row(row: Row, x, device, reps=REPS) -> dict:
    """``row``'s kernel alone on its inputs ``x``: its device time a launch
    (render/probe.py:device_ms over ROUNDS profiler windows of ``reps``
    launches: ``device_ms`` their median, ``device_ms_rounds`` each
    window's, ``device_ms_clock`` the clocks behind them), with ``graph`` the same launches replayed from a CUDA
    graph (graph_ms), its bound and bound / time (``share``; above 1.05
    the time misses part of the work, and it raises), the plain and
    library yardsticks' time a call (median_ms of YARD_REPS calls: CUDA
    events, as a profiler window of a plain march's many small kernels
    can leave the profiler recording nothing after it), and what the
    inputs found (``x.info``); prints one line."""
    from vxtpu_torch.render import probe

    launch = functools.partial(row.launch, x)
    got = [probe.device_ms(launch, reps, row.kernel) for _ in range(ROUNDS)]
    ms = [t for t, _ in got]
    out = dict(kernel=row.kernel, reps=reps, device_ms=statistics.median(ms),
               device_ms_rounds=ms,
               device_ms_clock="+".join(sorted({c for _, c in got})))
    line = (f"{out['device_ms']:.5f} ms a launch ({out['device_ms_clock']}, "
            f"windows of {reps}: "
            + ", ".join(f"{t:.5f}" for t in out["device_ms_rounds"]) + ")")
    if row.graph:
        out.update(graph_ms=graph_ms(launch, reps), graph_ms_clock="events")
        line += f", CUDA graph {out['graph_ms']:.5f} (events)"
    if row.bound is not None:
        out.update(row.bound(x))
        out["share"] = out["bound_ms"] / out["device_ms"]
        line += (f"; bound {out['bound_ms']:.5f} ms by {out['bound_by']} "
                 f"({out['bytes']:.6g} B, {out['ops']:.6g} flop), share "
                 f"{out['share']:.3f}")
        if out["share"] > 1.05:
            raise AssertionError(f"{row.name}: {out['device_ms']} ms is below "
                                 f"its bound {out['bound_ms']} ms: the time "
                                 f"misses part of the work")
    for key, fn in (("plain", row.plain), ("library", row.library)):
        if fn is not None:
            out[f"{key}_ms"] = median_ms(functools.partial(fn, x), device,
                                         YARD_REPS)
            out[f"{key}_ms_clock"] = "events"
            line += f"; {key} {out[f'{key}_ms']:.4f} ms a call (events)"
    out.update(getattr(x, "info", {}))
    print(f"phase 13 times: {row.name}: {line}"
          + (f"; {json.dumps(x.info)}" if getattr(x, "info", None) else ""))
    return out


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

        rec_p, rgb_p = km.march_shade_reference(o, d, accel, dims, ms, None,
                                                spec, mats, lights_arr)
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
                f"rec.steps total kernel {steps} plain {steps_p}")
        t_k = median_ms(lambda c=cam, s=settings, i=inkernel:
                        render_frame_fused(accel, mats, dims, c, light, s, h,
                                           w, inkernel_shadows=i), device,
                        runs)
        times[name] = {"ms": t_k, "hits": int(rec.hit.sum()),
                       "steps": steps}
        print(line + f"; frame {t_k:.3f} ms ({h * w / t_k / 1e3:.1f} "
                     f"Mrays/s)")

        if name == "full_shadows_fog_composed":
            # the shade kernel at this shape, vs shade_reference
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
            print(f"phase 4 main: shade kernel at {h}x{w}: rgb beyond "
                  f"{kc.RGB_ATOL} on {sm['rgb']} px (max {sm['max_abs']:.3g})")
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


def sass_functions(kernels, listing: Path) -> dict:
    """Function -> {opcode: count} for every function whose name holds one
    of ``kernels`` (sass_listing), whose lines are written to ``listing``
    with a ``// name`` line before each function."""
    funcs = {}
    for kernel in kernels:
        got = sass_listing(kernel)
        if got is None:
            raise FileNotFoundError("cuobjdump not found beside nvcc")
        funcs.update(got)
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


# K1's launch modes, a row each, on _main_scene's outside rays. march:
# march only (the composed frame's primary and shadow marches); lambert:
# the headline frame's one launch; full_shadows_fog: entry()'s launch
K1_MODES = ("march", "lambert", "full_shadows_fog")


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


def phase_pipeline(device, big_grid, D=C3_D, h=C3_HW, w=C3_HW, bh=H, bw=W,
                   save=None, frames=24, cli_size=()) -> dict:
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
    from vxtpu_torch.render.pipeline import render_image, render_rays
    from vxtpu_torch.utils import save_png
    from vxtpu_torch.world.atlas import build_procedural_atlas
    from vxtpu_torch.world.packed import build_packed

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
    times = {}
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
    print(f"phase 8 pipeline: K5 vs K1 at {B}^3 {bh}x{bw} lambert: hit, t, "
          f"voxel and normal agree on {share * 100:.4f}% of the {n_hit} rays "
          f"that either hits; of the {int(misses.sum())} misses, voxel "
          f"differs on {miss_vox} and steps on {miss_steps} (K5's contract); "
          f"rgb beyond {kc.RGB_ATOL} on {img_same} px")
    if share < 0.999:
        raise AssertionError(f"K5 and K1 agree on only {share:.5f} of the "
                             f"hit rays")
    times["big"] = dict(agree=share)
    del bpacked, m5, m1, r5, r1, rgb5, rgb1
    if device.type == "cuda":
        from vxtpu_torch import _build

        times["blocks_per_sm"] = _build.load().vx_march_packed_blocks_per_sm()
        times["k1_occupancy"] = k1_occupancy()
        print(f"phase 8 pipeline: K5 holds {times['blocks_per_sm']} blocks of "
              f"256 threads an SM; K1 at {FULL}^3 by instantiation: "
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
    return {"launches": launches, "times": times}


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
    return _bound(b + 2 * table_words,
                  n * MARCH_OPS_RAY + steps * MARCH_OPS_STEP)


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
    return _bound(b, n * ((0 if empty else PROBE_OPS_RAY)
                          + n_iters * PROBE_OPS_ITER[variant]))


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


def _k6_inputs(w):
    """K6's row: on the world512 scene, the probe's three tables and the
    outside rays, and the same rays started where they enter the grid (a
    miss keeps its origin: the outside rays all start at one voxel, the
    camera's clipped floor, so only these spread a warp's rays over the
    grid as K1's primary rays are spread, and can show what a ray order
    does to the reads). Both steps against their plain versions on every
    ray, in every order (a block order's acc put back in pixel order),
    and the reads and distinct words each variant's rays read (its
    bound's bytes)."""
    import torch

    from vxtpu_torch.render import probe
    from vxtpu_torch.render.dda import ray_grid_clip

    dims, o, d = w.dims, w.o, w.d
    n = o.shape[0]
    tables = {"morton16": w.accel.words, "rowmajor32": w.packed.words,
              "bricked16": w.packed.bricks}
    t_in, _, hits = ray_grid_clip(o, d, dims)
    eo = torch.where(hits[:, None], o + (t_in + 1e-3)[:, None] * d, o)
    entry_tables = {k: tables[k] for k in ("morton16", "bricked16")}
    ordered = {k: probe.ordered_rays(o, d, (H, W), k) for k in probe.ORDERS}
    work, acc_sum, err = {}, {}, 0.0
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
                for order in (probe.ORDERS if step == "k1" else
                              ("scanline",)):
                    po, pd, inv = ordered[order]
                    got = probe.march_probe(po, pd, table, dims,
                                            probe.N_ITERS, v, layout,
                                            step=step)
                    got = got if inv is None else got[inv]
                    bad = int((got != want).sum())
                    err = max(err, float((got - want).abs().max()))
                    if bad:
                        raise AssertionError(
                            f"K6 {v} {layout} {step} {order}: acc differs "
                            f"from the plain version on {bad} rays")
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
    print(f"phase 13 times: K6 on all {n} rays at {dims[0]}^3, "
          f"{probe.N_ITERS} iterations: acc equal to the plain version bit "
          f"for bit for every variant x layout x order (K1 step) and every "
          f"variant x layout (float step), and the two steps' plain versions "
          f"equal; acc sums "
          + ", ".join(f"{v}/{lay} {x:.6g}" for (v, lay), x in acc_sum.items()))
    return SimpleNamespace(dims=dims, o=o, d=d, eo=eo, n=n, tables=tables,
                           entry_tables=entry_tables, work=work, err=err)


def k6_sweep(row: Row, x, device) -> dict:
    """K6's sweep, each launch configuration timed by time_row (windows of
    10 launches; the median of ROUNDS, as a lone window now and then reads
    half the kernel's time) with its own bound (probe_bound: the distinct
    words its plain version reads): K1's step over every ray order x layout x
    variant x block size, the float step (the form first ported) on the
    Morton table in scanline order at 256 threads, and full and nofetch
    from the grid entry; the launches counted; the plain version's time
    beside the headline configuration (K1's step, full, morton16,
    scanline, 256 threads); each instantiation's registers and blocks an
    SM and the SASS loops of the probe."""
    from vxtpu_torch.render import probe

    configs = [("camera", "k1", order, layout, v, th)
               for order in probe.ORDERS for layout in x.tables
               for v in probe.VARIANTS for th in probe.THREADS]
    configs += [("camera", "tpu", "scanline", "morton16", v, 256)
                for v in probe.VARIANTS]
    configs += [("entry", "k1", order, layout, v, 256)
                for order in probe.ORDERS for layout in x.entry_tables
                for v in ("nofetch", "full")]
    headline = ("camera", "k1", "scanline", "morton16", "full", 256)
    ordered = {(src, k): probe.ordered_rays(o, x.d, (H, W), k)
               for src, o in (("camera", x.o), ("entry", x.eo))
               for k in probe.ORDERS}
    probe.reset_launch_counts()
    out, rows = {}, []
    for cfg in configs:
        rays, step, order, layout, v, th = cfg
        po, pd, _ = ordered[(rays, order)]
        table = x.tables[layout]
        wk = x.work[(step if rays == "camera" else "entry", layout, v)]
        reads = wk["reads"] / (x.n * probe.N_ITERS)
        r = time_row(row._replace(
            name=f"k6 {rays} {step} {order} {v} {layout} {th}",
            launch=lambda _x, a=(po, pd, table, x.dims, probe.N_ITERS, v,
                                 layout, th, step): probe.march_probe(*a),
            bound=lambda _x, b=probe_bound(
                x.n, probe.N_ITERS, v, wk["words"] * table.element_size()): b,
            plain=row.plain if cfg == headline else None),
            SimpleNamespace(**vars(x), info=dict(reads_per_ray_iter=reads)),
            device, reps=10)
        r.update(zip(("rays", "step", "order", "layout", "variant",
                      "threads"), cfg),
                 ns_per_ray_iter=r["device_ms"] * 1e6 / (x.n * probe.N_ITERS))
        rows.append(r)
        if cfg == headline:
            out.update(r)
        elif cfg == ("camera", "tpu", "scanline", "morton16", "full", 256):
            out.update(parent_form_ms=r["device_ms"],
                       parent_form_ms_clock=r["device_ms_clock"])
    out.update(rows=rows, err=x.err,
               launches=probe.LAUNCHES["march_probe_kernel"],
               work={"/".join(k): v for k, v in x.work.items()},
               occupancy=k6_occupancy(x.dims),
               sass_loops=sass_loops("march_probe_kernel"))
    print(f"phase 13 times: K6 sweep: {len(rows)} configurations, "
          f"{out['launches']} launches; full/morton16/256/scanline: K1 step "
          f"{out['device_ms']:.4f} ms, the float step (the form first "
          f"ported) {out['parent_form_ms']:.4f} ms")
    if x.o.is_cuda and out["launches"] == 0:
        raise AssertionError("the sweep did not launch march_probe_kernel")
    for name, occ in out["occupancy"].items():
        print(f"phase 13 times: K6 {name}: {occ['registers']} registers, "
              f"{occ['blocks_per_sm']} blocks of 256 threads an SM")
    if out["sass_loops"] is None:
        print(f"phase 13 times: K6 SASS: cuobjdump not found beside nvcc")
    for fn, loops in (out["sass_loops"] or {}).items():
        print(f"phase 13 times: K6 SASS {fn}: loops (instructions, F2I) "
              + ", ".join(f"({lp['size']}, {lp['f2i']})" for lp in loops))
    return out


def phase_resume(device, big_grid, h=H, w=W, runs=RUNS, drain_r0=8,
                 drain_frac=256) -> dict:
    """Phase 9: K1' and the sorted march (see the module docstring).
    big_grid: phase 4's world."""
    import torch

    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render import kernel_march as km
    from vxtpu_torch.render import probe
    from vxtpu_torch.world.packed import build_packed_morton

    t_phase = time.perf_counter()
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

    # the main path, counted: the sorted march of both ray sets
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
    r0p, e0p = km.march_reference(o, d, accel, dims, ms, iter_budget=24,
                                  extended=True)
    m0 = kc.resume_mismatch(r0k, e0k, r0p, e0p)
    state = (r0p.voxel, torch.where(e0p["done"], -1, e0p["dist"]),
             r0p.steps)
    r1k, e1k = km.march(o, d, accel, dims, ms, resume_state=state,
                        extended=True)
    r1p, e1p = km.march_reference(o, d, accel, dims, ms, resume_state=state,
                                  extended=True)
    m1 = kc.resume_mismatch(r1k, e1k, r1p, e1p)
    merged = kc.exact_mismatch(kc.merge_rounds(e0k["done"], r0k, r1k),
                               single["lambert"])
    err = {"march_resume_kernel": max(float((r0k.t - r0p.t).abs().max()),
                                      float((r1k.t - r1p.t).abs().max()))}
    print(f"phase 9 resume: K1' on all {n} lambert rays at {D}^3: round 0 "
          f"(budget 24) mismatches {m0}; resume mismatches {m1}; the two "
          f"rounds vs single-round K1 differ on {merged} rays")
    if any(m0.values()) or any(m1.values()) or merged or \
            not bool(e1k["done"].all()):
        raise AssertionError("K1' differs from its plain version on the "
                             "lambert rays")
    del r0p, e0p, r1p, e1p, r0k, e0k, r1k, e1k

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
    del single, srec

    times = dict(coherence=coh, launches=launches)
    if device.type == "cuda":
        # its single-round march times are K1's row's to give (phase 13)
        sp = {k: v for k, v in probe.sorted_probe(
            o, d, accel, dims, ms, reps=runs).items()
            if k in ("n", "argsort_ms", "sorted")}
        times["sorted_probe"] = sp
        print(f"phase 9 resume: sorted_probe at {D}^3 {h}x{w} (events, "
              f"{runs} calls): argsort of {sp['n']} keys "
              f"{sp['argsort_ms']:.3f} ms; march_sorted "
              + "; ".join(f"round0_iters {r0}: {x['ms']:.3f} ms, "
                          f"{x['survivors']} survivors, {x['rounds']} "
                          f"round(s)" for r0, x in sp["sorted"].items()))
    secs = time.perf_counter() - t_phase
    print(f"phase 9 resume: {secs:.1f} s")
    return {"err": err, "times": times, "seconds": secs}


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


def profile_kernels(fn, device, calls=1, big=None) -> dict:
    """One torch.profiler window of ``calls`` calls of fn after a warm-up
    call: ``kernels``, device ms a call by kernel name (without the
    record_function ranges the profiler mirrors on the device timeline);
    ``launches``, the kernels launched a call; ``busy_ms``, their device
    ms a call; ``wall_ms``, a call's wall time under the profiler; with
    ``big``, ``dense``: the aten ops whose inputs have >= ``big`` elements
    (work on the dense [D^3] tables), op and input shapes -> (device ms a
    call, the most dimensions of its inputs)."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=big is not None) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3 / calls
    kernels, launches = {}, 0
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith(("Optimizer.", "ProfilerStep"))
                or getattr(e, "is_user_annotation", False)
                or not _device_us(e)):
            continue
        kernels[e.key] = kernels.get(e.key, 0.0) + \
            _device_us(e) / 1e3 / calls
        launches += e.count
    out = dict(kernels=kernels, launches=launches // calls,
               busy_ms=sum(kernels.values()), wall_ms=wall)
    if big is not None:
        out["dense"] = {}
        for e in prof.key_averages(group_by_input_shape=True):
            if (e.device_type != torch.autograd.DeviceType.CPU
                    or not e.key.startswith("aten::") or "foreach" in e.key):
                continue
            shapes = [sh for sh in (e.input_shapes or [])
                      if isinstance(sh, list)]
            if _device_us(e) and any(sh and math.prod(sh) >= big
                                     for sh in shapes):
                key = f"{e.key} {shapes}"
                ms = out["dense"].get(key, (0.0, 0))[0] + \
                    _device_us(e) / 1e3 / calls
                out["dense"][key] = (ms, max(len(sh) for sh in shapes))
    return out


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


def adam_bound(D) -> dict:
    """Adam's update of the [D^3, 4] float32 table: the table, its
    gradient and the two moments read once, the table and the moments
    written once (7 x 16 B a row), ADAM_OPS an element."""
    return _bound(7 * 16 * D ** 3, ADAM_OPS * 4 * D ** 3)


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


def mask_bounds_bound(n, cells) -> dict:
    """The bounds pass on n rays over a mask of ``cells`` cells: the rays
    read (o, d: 24 B a ray), the bounds written (8 B a ray) and the
    mask's distance field read once (a byte a cell). Its float work, some
    forty operations a step of dependent steps, is latency and not
    counted."""
    return _bound(32 * n + cells, 0)


def ray_sum_bound(n, chunks) -> dict:
    """sample_ray_sum_kernel: reads the [chunks, 8, N] partial sums, writes
    32 B per ray, one add per partial."""
    return _bound(chunks * 8 * n * 4 + n * 32, chunks * 8 * n)


def phase_train(device, D=FULL, h=C4_HW, w=C4_HW, S=C4_S, steps=5) -> dict:
    """Phase 6: the c4_512_diff fit through the sampling kernels."""
    import torch

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
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ks.reset_launch_counts()
    kernel_tv.reset_launch_counts()
    kernel_adam.reset_launch_counts()
    fitted, _, losses, _ = loop.fit_soft(
        soft.SoftGrid.zeros(dims, device=device), cam,
        target.reshape(h, w, 3), settings, tc)
    _sync(device)
    launches = dict(ks.LAUNCHES)
    tv_launches = dict(kernel_tv.LAUNCHES)
    adam_launches = dict(kernel_adam.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else float("nan"))
    print(f"phase 6 train: launches during the {steps} steps: {launches}; "
          f"TV prior {tv_launches}; Adam {adam_launches}")
    print(f"phase 6 train: losses {losses}; peak memory {peak:.2f} GiB")
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
    del args, cots, tab

    # where a step's time goes (profiler device times)
    model = MortonSoftGrid(tab_fit.detach().clone().requires_grad_(True))
    opt = loop.make_optimizer(tc, [model.tab])

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loop._loss_fn(model, cam, o, d, tflat, (h, w), settings, tc)
        loss.backward()
        opt.step()

    profile = None
    if device.type == "cuda":
        prof = profile_kernels(step, device, calls=2, big=D ** 3)
        groups = _group_kernels(prof["kernels"], prof["dense"])
        busy, wall = prof["busy_ms"], prof["wall_ms"]
        print(f"phase 6 train: profiled step: wall {wall:.3f} ms, device "
              f"busy {busy:.3f} ms ({busy / wall * 100:.1f}%); by group "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in groups.items()))
        for name, ms in sorted(prof["kernels"].items(),
                               key=lambda kv: -kv[1])[:10]:
            print(f"phase 6 train:   kernel {ms:8.3f} ms  {name[:90]}")
        for name, (ms, _) in sorted(prof["dense"].items(),
                                    key=lambda kv: -kv[1][0])[:8]:
            print(f"phase 6 train:   dense op {ms:8.3f} ms  {name[:90]}")
        profile = dict(groups=groups, wall_ms=wall, busy_ms=busy)
    return {"launches": launches, "cam_launches": cam_launches, "err": err,
            "tv_launches": tv_launches, "adam_launches": adam_launches,
            "profile": profile, "losses": losses}


def _check_losses(losses) -> None:
    if not all(v == v and abs(v) != float("inf") for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")


def library_yardstick(x) -> dict:
    """torch.nn.functional.grid_sample on the samples of ``x`` (the inputs
    of K3 and K4 alone): 5-D, bilinear (trilinear), align_corners=False,
    border padding, on a row-major [1, 4, D, D, D] volume; ``fwd`` the
    forward, ``bwd`` its autograd backward to the volume and the sample
    positions (K4 with kRayGrads) and ``bwd_vol`` to the volume alone (the
    grid not requiring grad: the pure scatter), each a callable. A timing
    yardstick only: it gives the same values inside [0.5, D - 0.5]^3
    (``inside_max_abs``: its largest difference from K3 there) but not in
    the half-voxel shell at the low faces, where vxtpu's corner clamp
    differs; the grid's last axis is (x, y, z) -> (W, H, D), so a world
    point p goes in as (pz, py, px)."""
    import torch
    import torch.nn.functional as F

    from vxtpu_torch.render import kernel_sample as ks

    D = x.D
    sigma, rgb = ks.fields_from_interleaved(x.tab, D)
    vol = torch.cat([sigma[None], rgb])[None]
    del sigma, rgb
    _, px, py, pz = ks._positions(x.o, x.d, x.st, x.sdt, x.S)
    grid = (torch.stack([pz, py, px], dim=-1) * (2.0 / D) - 1.0)
    grid = grid[None, :, :, None, :].contiguous()          # [1,S,N,1,3]
    fwd = functools.partial(F.grid_sample, vol, grid, mode="bilinear",
                            padding_mode="border", align_corners=False)
    out = fwd()
    inside = ((px > 0.5) & (px < D - 0.5) & (py > 0.5) & (py < D - 0.5)
              & (pz > 0.5) & (pz < D - 0.5) & (x.sdt > 0)[None, :])
    k3 = ks.sample_fields_fwd(x.tab, x.o, x.d, x.st, x.sdt, x.S, D)
    same = max(float((out[0, c, :, :, 0] - k3[c])[inside].abs().max())
               for c in range(4))
    del out, k3
    cot = torch.stack(x.cots)[None, :, :, :, None]
    vg = vol.detach().requires_grad_(True)
    lib = dict(fwd=fwd, inside_max_abs=same)
    for key, gg in (("bwd", grid.detach().requires_grad_(True)),
                    ("bwd_vol", grid)):
        res = F.grid_sample(vg, gg, mode="bilinear", padding_mode="border",
                            align_corners=False)
        wrt = (vg, gg) if gg.requires_grad else (vg,)
        lib[key] = functools.partial(torch.autograd.grad, res, wrt, cot,
                                     retain_graph=True)
    return lib


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
        prof = (profile_kernels(lambda: render_image(
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


def phase_mask(device, D=FULL, h=C4_HW, w=C4_HW, S=C4_S, S_mask=C4_S_MASK,
               steps=5, runs=RUNS, cli_size=None, card="") -> dict:
    """Phase 10 (b): the occupancy-masked c4 fit through K3/K4 (see the
    module docstring). ``card``: the GPU's name and power limit, printed
    beside the times."""
    import math
    import tempfile

    import torch

    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.app.configs import CONFIGS
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.engine.sharding import (camera_frame_rays,
                                             compute_mask_bounds)
    from vxtpu_torch.render import kernel_bounds
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
    kernel_bounds.reset_launch_counts()
    bounds = compute_mask_bounds(mask, mask_df, cam, o_c, d_c, G)
    _sync(device)
    if device.type == "cuda" and (
            kernel_bounds.LAUNCHES["mask_bounds_kernel"] != 1):
        raise AssertionError(f"the bounds pass: launches "
                             f"{kernel_bounds.LAUNCHES}, not one")
    t_full, dt_full, valid = _enter_dt_soft(o, d, dims, 1, None)
    t_band, dt_band, _ = _enter_dt_soft(o, d, dims, 1, bounds)
    seg = valid & (dt_full > 0)
    ratio = float((dt_band[seg] / dt_full[seg]).mean())
    occ_frac = float(mask.float().mean())
    bounds_ms = median_ms(lambda: compute_mask_bounds(mask, mask_df, cam, o_c,
                                                      d_c, G), device, runs)
    bprof = (profile_kernels(lambda: compute_mask_bounds(
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

    # a step at the warm state, counted: masked at S_mask, unmasked at S
    step_rows = {}
    for name, tc, masked in (("masked", tc_mask, True),
                             ("dense", tc_dense, False)):
        model = MortonSoftGrid(warm.tab.detach().clone().requires_grad_(True))
        opt = loop.make_optimizer(tc, [model.tab])
        ks.reset_launch_counts()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        opt.zero_grad(set_to_none=True)
        loss = loop._loss_fn(model, cam, o, d, tflat, (h, w), settings, tc,
                             mask if masked else None,
                             bounds if masked else None)
        loss.backward()
        opt.step()
        _sync(device)
        counts = dict(ks.LAUNCHES)
        peak = (torch.cuda.max_memory_allocated(device) / 2**30
                if device.type == "cuda" else float("nan"))
        row = dict(peak_gib=peak, loss=float(loss), launches=counts)
        step_rows[name] = row
        print(f"phase 10 xla+mask: {name} step at S = {tc.num_samples}: "
              f"peak {peak:.2f} GiB, loss {row['loss']:.6f}, launches "
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
    del args, cots, warm, tab

    # (4) the path, counted: a short masked fit from zeros, the mask
    # rebuilt twice
    tc_fit = loop.TrainConfig(field_kernel=True, occ_mask=True,
                              num_samples=S_mask, ray_batch=0, steps=steps,
                              seed=cfg4.seed, mask_refresh=2)
    ks.reset_launch_counts()
    kernel_bounds.reset_launch_counts()
    _, _, losses, _ = loop.fit_soft(
        soft.SoftGrid.zeros(dims, device=device), cam, target.reshape(h, w, 3),
        settings, tc_fit)
    _sync(device)
    launches = dict(ks.LAUNCHES, **kernel_bounds.LAUNCHES)
    print(f"phase 10 xla+mask: masked fit, {steps} steps from zeros at S = "
          f"{S_mask}, mask rebuilt at steps 2 and 4: launches {launches}; "
          f"losses {losses}")
    if device.type == "cuda" and not (
            launches["sample_fwd_kernel"] == steps
            and launches[BWD[False]] == steps
            and launches["mask_bounds_kernel"] == steps):
        raise AssertionError(f"the masked fit did not run K3, K4 and the "
                             f"bounds kernel once a step: {launches}")
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
                steps=step_rows, err=err, launches=launches, losses=losses)


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
    prof = (profile_kernels(frame, device) if device.type == "cuda"
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
    ``frames`` frames (losses finite, the pose error falling), and the
    custom backward against autograd on a subset of the last frame's
    rays. Its step and frame times are the benchmark cell's
    (``c5_1080p_pod.anim_fit``)."""
    import torch

    from vxtpu_torch.app.configs import CONFIGS
    from vxtpu_torch.camera import paths
    from vxtpu_torch.engine import sharding
    from vxtpu_torch.render.soft import SoftGrid
    from vxtpu_torch.train.config5 import Config5, run_config5
    from vxtpu_torch.world import procgen
    from vxtpu_torch.world.lights import Lights

    cfg = Config5(dims=(D,) * 3, height=h, width=w, num_samples=S,
                  ckpt_every=0)
    settings = CONFIGS["c5_1080p_pod"].settings
    mesh = sharding.make_mesh()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    res = run_config5(cfg, settings, mesh=mesh, end_frame=frames)
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    print(f"phase 11 scale-out: config 5 at {D}^3, {h}x{w}, S = {S}, lit "
          f"({settings.shading}), custom backward, {mesh.size} rank, first "
          f"{frames} of {cfg.frames} frames x {cfg.steps_per_frame} steps: "
          f"losses {res['losses']}; PSNR {res['psnrs']}; yaw error "
          f"{res['yaw_err']:.5f}, pitch error {res['pitch_err']:.5f} (from "
          f"{cfg.pose_error}, -{cfg.pose_error}); peak [{card}] "
          f"{peak if peak is None else round(peak, 2)} GiB")
    if not all(math.isfinite(v) for v in res["losses"]):
        raise AssertionError(f"config 5: non-finite loss {res['losses']}")
    if not (abs(res["yaw_err"]) < cfg.pose_error
            and abs(res["pitch_err"]) < cfg.pose_error):
        raise AssertionError("config 5: the pose error did not fall below "
                             f"{cfg.pose_error}")

    # the last frame's target, then the custom backward against autograd
    # through the plain renderer on a subset of the frame's rays from the
    # run's final state (plain autograd cannot hold them all)
    X, Y, Z = cfg.dims
    truth = SoftGrid.from_hard(procgen.terrain(
        cfg.dims, seed=cfg.seed, with_rgb=True, device=device),
        sigma_solid=cfg.sigma_solid)
    lights = Lights.single((0.2 * X, -0.3 * Y, 1.4 * Z), intensity=2.0,
                           device=device)
    cam_true = paths.orbit(
        center=(0.5 * X, 0.5 * Y, 0.3 * Z), radius=0.9 * X, height=1.1 * Z,
        period=cfg.frames / cfg.fps, fov_y_deg=55.0, device=device)(
            (frames - 1) / cfg.fps)
    target = sharding.render_soft_image_sharded(
        truth, cam_true, settings, h, w, S, mesh, lights=lights).reshape(-1, 3)
    del truth
    soft_f, cam_f = res["soft"], res["cam"]
    o_c, d_c = sharding.camera_frame_rays(cam_f, h, w)
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
    return dict(losses=res["losses"], psnrs=res["psnrs"],
                yaw_err=res["yaw_err"], pitch_err=res["pitch_err"],
                peak_gib=peak, vjp_excess=ex, vjp_loss_rel=rel)


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


# phase 13: times. The kernel table of PERF.md section 6, a row a kernel
# alone at a main path's shape; --times and a whole run time the same rows.


def _world512(device):
    """Phase 4's world and outside rays, for the rows on it: the FULL^3
    seed-7 terrain's Morton occupancy and material tables and its
    row-major table (K5's, K6's), the H x W rays, the light, and the
    lambert and full + shadows + fog settings."""
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render import kernel_march as km
    from vxtpu_torch.world import procgen
    from vxtpu_torch.world.packed import (build_material_morton,
                                          build_packed, build_packed_morton)

    grid = procgen.terrain((FULL,) * 3, seed=7, device=device)
    light, requests = _main_scene(device, FULL)
    by_name = {name: (cam, st) for name, cam, st, _ in requests}
    o, d = generate_rays(by_name["lambert"][0], H, W)
    lam = by_name["lambert"][1]
    return SimpleNamespace(
        dims=grid.dims, accel=build_packed_morton(grid.occupancy, cap=64),
        mats=build_material_morton(grid.occupancy),
        packed=build_packed(grid.occupancy), o=o, d=d, n=o.shape[0],
        light=light, lights_arr=km.pack_lights(light), lambert=lam,
        full=by_name["full_shadows_fog"][1],
        k5_rays={"512": (o, d, None)}, k5_ms=lam.resolve_max_steps(grid.dims))


def _c3(device):
    """The c3_256_shadows frame's primary rays and their shadow rays toward
    the config's light (t_max set), on its row-major table."""
    from vxtpu_torch.app.configs import CONFIGS
    from vxtpu_torch.app.run import build_scene
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.render import kernel_packed as kp
    from vxtpu_torch.render.pipeline import shadow_ray_batch

    cfg = CONFIGS["c3_256_shadows"]
    dims = (C3_D,) * 3
    _, accel, cam, lights = build_scene(cfg, dims, "packed", device)
    ms = cfg.settings.resolve_max_steps(dims)
    o, d = generate_rays(cam, C3_HW, C3_HW)
    shadow = shadow_ray_batch(kp.march_packed(o, d, accel, dims, ms), o, d,
                              lights.pos[0])
    return SimpleNamespace(packed=accel, dims=dims, k5_ms=ms,
                           k5_rays={"c3": (o, d, None), "c3_shadow": shadow})


def _c4(device, masked=False):
    """The c4 fit's field sampling at its shape (phase 6; phase 10 with
    ``masked``): the FULL^3 truth's Morton table (0.8 x the truth, masked)
    and the C4_HW^2 rays' sample segments (masked: C4_S_MASK samples on
    the bands of the 128^3 mask, kept with its distance field), four
    random cotangent planes, the active samples and the distinct table
    words their corners touch (the bounds'), and torch's grid_sample on
    the same samples."""
    import torch

    from vxtpu_torch.app.configs import CONFIGS
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.camera.rays import generate_rays
    from vxtpu_torch.engine.sharding import (camera_frame_rays,
                                             compute_mask_bounds)
    from vxtpu_torch.render import occmask, soft
    from vxtpu_torch.render.soft_kernel import MortonSoftGrid, _enter_dt_soft
    from vxtpu_torch.world import procgen

    D = FULL
    dims = (D,) * 3
    truth = soft.SoftGrid.from_hard(procgen.terrain(
        dims, seed=CONFIGS["c4_512_diff"].seed, with_rgb=True,
        device=device))
    cam = Camera.make(pos=(-0.7 * D, 0.5 * D, 1.1 * D),
                      device=device).look_at((0.5 * D, 0.5 * D, 0.27 * D))
    o, d = generate_rays(cam, C4_HW, C4_HW)
    S, bounds, mask, mask_df = C4_S, None, None, None
    if masked:
        truth = soft.SoftGrid(truth.sigma_raw * 0.8, truth.rgb_raw * 0.8)
    tab = MortonSoftGrid.from_soft(truth).tab
    del truth
    if masked:
        mask = occmask.occupancy_mask_from_soft(MortonSoftGrid(tab), 4, 0.01,
                                                1)
        mask_df = occmask.mask_distance_field(mask)
        o_c, d_c = camera_frame_rays(cam, C4_HW, C4_HW)
        bounds = compute_mask_bounds(mask, mask_df, cam, o_c, d_c, 4)
        S = C4_S_MASK
    st, sdt, _ = _enter_dt_soft(o, d, dims, S, bounds)
    g = torch.Generator().manual_seed(0)
    x = SimpleNamespace(
        tab=tab, o=o, d=d, st=st.contiguous(), sdt=sdt.contiguous(), S=S,
        D=D, n=o.shape[0], mask=mask, mask_df=mask_df,
        active=int((sdt > 0).sum()) * S,
        cots=tuple(torch.randn(S, o.shape[0], generator=g).to(device)
                   for _ in range(4)))
    x.touched = _touched_words(o, d, x.st, x.sdt, S, D)
    x.lib = library_yardstick(x)
    x.info = dict(table_words_touched=x.touched, active_samples=x.active,
                  library_inside_max_abs=x.lib["inside_max_abs"])
    return x


def _ray_sum(device):
    """The ray sum alone: random [chunks, 8, N] partial sums at the c4
    step's shape (N rays, C4_S samples in chunks of RAY_CHUNK), the kernel
    equal to its plain version bit for bit (raises otherwise), and a
    128 MB buffer whose fill flushes the 50 MB L2 (the partial sums,
    35.7 MB, stay in it between warm launches)."""
    import torch

    from vxtpu_torch.render import kernel_sample as ks

    n, chunks = C4_HW ** 2, -(-C4_S // ks.RAY_CHUNK)
    part = torch.randn(chunks, 8, n, generator=torch.Generator().manual_seed(
        4)).to(device)
    if not all(torch.equal(a, b) for a, b in zip(
            ks.ray_sums(part), ks.ray_sums_reference(part))):
        raise AssertionError("sample_ray_sum_kernel differs from the "
                             "chunk-order sum")
    return SimpleNamespace(part=part, n=n, chunks=chunks, flush=torch.empty(
        32 << 20, dtype=torch.float32, device=device))


def _tv(device):
    """The TV prior alone: the kernel pair against its plain version on a
    random FULL^3 table (run_tv_case; raises on a difference; ``info``
    the value's relative error and the gradient's x max |g|), then a
    random FULL^3 table (seed 1), the trainer's weights, a unit upstream
    gradient, and a copy that requires grad for the plain version's
    backward."""
    import torch

    from vxtpu_torch import kernel_check as kc

    m = kc.run_tv_case(FULL, device)
    kc.check_tv_case(m, f"TV prior at {FULL}^3")
    torch.cuda.empty_cache()
    tab = kc.tv_table(FULL, device, seed=1)
    return SimpleNamespace(tab=tab, D=FULL, w=kc.TV_WEIGHTS,
                           g=torch.ones((), device=device),
                           q=tab.clone().requires_grad_(True),
                           info=dict(value_rel=m["value_rel"],
                                     grad_err=m["grad_err"]))


def _adam(device, steps=3):
    """Adam's update alone: the kernel against torch.optim.Adam's foreach
    step over ``steps`` steps of a random [FULL^3, 4] table (run_adam_case;
    raises on a difference; ``info`` the largest |difference| over the
    table and both moments), then a random [FULL^3, 4] table, gradient and
    moments, the fit's step arguments, and torch.optim.Adam's foreach
    step over a copy of the table (the library yardstick)."""
    import torch

    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.train.loop import ADAM_EPS, BETAS

    chk = kc.run_adam_case(device, shapes=[(FULL ** 3, 4)], steps=steps)
    kc.check_adam_case(chk, f"Adam at {FULL}^3")
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(1)
    p, g, m, v = (torch.randn((FULL ** 3, 4), generator=gen, device=device)
                  for _ in range(4))
    v.square_()
    q = p.clone().requires_grad_(True)
    q.grad = g
    return SimpleNamespace(D=FULL, p=p, g=g, m=m, v=v,
                           args=(10, 5e-2, BETAS, ADAM_EPS),
                           foreach=torch.optim.Adam([q], lr=5e-2, betas=BETAS,
                                                    eps=ADAM_EPS,
                                                    foreach=True),
                           info=dict(max_abs_err=chk["max_abs"],
                                     allclose_excess=chk["excess"],
                                     unequal=chk["unequal"],
                                     elements=chk["elements"]))


SCENES = {"world512": _world512, "c3": _c3, "c4": _c4,
          "c4_masked": functools.partial(_c4, masked=True),
          "ray_sum": _ray_sum, "tv": _tv, "adam": _adam,
          "device": lambda device: SimpleNamespace(device=device, D=FULL)}


def _k1_inputs(mode):
    """The inputs of K1's row in launch ``mode`` (K1_MODES): K1 against its
    plain version on every ray (hit, voxel, normal and steps equal, t
    within rtol 1e-5, rgb within 1e-5 on every pixel; raises otherwise);
    the steps of the primary and the shadow marches, the hits, the shadow
    rays and the distinct table words the plain version reads (the
    bound's); the warp coherence of those steps."""

    def build(w):
        import torch

        from vxtpu_torch import kernel_check as kc
        from vxtpu_torch.render import kernel_march as km
        from vxtpu_torch.render import probe

        st = w.full if mode == "full_shadows_fog" else w.lambert
        x = SimpleNamespace(**vars(w), ms=st.resolve_max_steps(w.dims),
                            spec=None if mode == "march" else
                            km.ShadeSpec.from_settings(st, w.light,
                                                       shadows=st.shadows))
        with _logged_fetch(km, w.accel.words) as log:
            want = km.march_shade_reference(x.o, x.d, x.accel, x.dims, x.ms,
                                            None, x.spec, x.mats,
                                            x.lights_arr)
        got = km.march(x.o, x.d, x.accel, x.dims, x.ms, shade_spec=x.spec,
                       mats=x.mats, lights_arr=x.lights_arr)
        shaded = x.spec is not None
        rec = want[0] if shaded else want
        rm = kc.record_mismatch(got[0] if shaded else got, rec)
        im = kc.image_mismatch(got[1], want[1]) if shaded else None
        kc.check_exact(rm, im, f"K1 {mode} against its plain version")
        # the steps of each phase a warp runs: the primary march, then one
        # shadow march per light
        phases, x.shadow_rays = [rec.steps], 0
        if shaded and x.spec.runs_shadow_marches:
            for li in range(w.light.count):
                p_, ldir, dist, facing = km.shadow_rays(rec, x.o, x.d,
                                                        w.light.pos[li])
                phases.append(km.march_reference(
                    p_, ldir, x.accel, x.dims, x.ms,
                    torch.where(rec.hit, dist - 2.0 * km.SHADOW_EPS, 0.0),
                    active=facing).steps)
                x.shadow_rays += int(facing.sum())
        steps = [int(s.sum(dtype=torch.int64)) for s in phases]
        x.steps, x.words, x.hits = sum(steps), log.count(), int(rec.hit.sum())
        x.info = dict(
            steps=steps[0], shadow_steps=sum(steps[1:]),
            shadow_rays=x.shadow_rays, hits=x.hits, table_words=x.words,
            t_rel=rm["t_rel"], rgb_max_abs=im["max_abs"] if im else None,
            coherence=probe.warp_coherence(*phases),
            shadow_coherence=(probe.warp_coherence(*phases[1:])
                              if x.shadow_rays else None),
            bound_rays_only_ms=k1_bound(x.n, x.steps, 0, shaded, x.hits,
                                        x.shadow_rays)["bound_ms"])
        return x

    return build


def _k1r_inputs(w, resume=False):
    """The inputs of K1''s rows: round 0 (budget 24) on the outside rays
    or, with ``resume``, the resume of every ray from the plain round 0's
    state; against its plain version on every field (raises otherwise);
    the DDA steps it takes and the distinct table words its plain version
    reads (the bound's)."""
    import torch

    from vxtpu_torch import kernel_check as kc
    from vxtpu_torch.render import kernel_march as km

    x = SimpleNamespace(**vars(w), ms=w.lambert.resolve_max_steps(w.dims),
                        kw=dict(iter_budget=24), resumed=resume)
    with _logged_fetch(km, w.accel.words) as log:
        r0, e0 = km.march_reference(x.o, x.d, x.accel, x.dims, x.ms,
                                    extended=True, **x.kw)
    want, ext = r0, e0
    if resume:
        x.kw = dict(resume_state=(r0.voxel, torch.where(e0["done"], -1,
                                                        e0["dist"]), r0.steps))
        with _logged_fetch(km, w.accel.words) as log:
            want, ext = km.march_reference(x.o, x.d, x.accel, x.dims, x.ms,
                                           extended=True, **x.kw)
    bad = kc.resume_mismatch(*km.march(x.o, x.d, x.accel, x.dims, x.ms,
                                       extended=True, **x.kw), want, ext)
    if any(bad.values()):
        raise AssertionError(f"K1' differs from its plain version: {bad}")
    steps = (want.steps - r0.steps)[~e0["done"]] if resume else want.steps
    x.steps, x.words = int(steps.sum(dtype=torch.int64)), log.count()
    x.info = dict(steps=x.steps, table_words=x.words, mismatches=bad,
                  bound_rays_only_ms=k1r_bound(x.n, x.steps, resume,
                                               False)["bound_ms"])
    return x


def _k2_inputs(w):
    """The inputs of K2's row: what the composed full + shadows + fog
    frame hands the shade kernel on the outside rays: the primary record
    (K1 march-only) and the shadow visibility (the plain shadow march)."""
    import torch

    from vxtpu_torch.render import kernel_march as km

    x = SimpleNamespace(**vars(w), ms=w.full.resolve_max_steps(w.dims))
    x.rec = km.march(x.o, x.d, x.accel, x.dims, x.ms)
    x.vis = torch.stack([km.shadow_visibility_reference(
        x.rec, x.o, x.d, x.accel, x.dims, x.ms, w.light.pos[li])
        for li in range(w.light.count)], dim=-1)
    x.vspec = km.ShadeSpec.from_settings(w.full, w.light, use_vis=True,
                                         shadows=False)
    x.hits = int(x.rec.hit.sum())
    return x


def k2_bound(n, hits, lights) -> dict:
    """K2, the shade kernel alone, over n rays: each ray's inputs (o, d,
    hit, t, voxel, normal and the visibility) read once and its rgb
    written once, plus one material word per hit ray; MARCH_OPS_RAY
    operations per ray and per light."""
    return _bound(n * (24 + 29 + 4 * lights + 12) + 4 * hits,
                  n * MARCH_OPS_RAY * (1 + lights))


def _bounds_inputs(x):
    """The bounds pass on the masked c4 step's rays and 128^3 mask: the
    kernel equal to the batched path bit for bit (raises otherwise);
    ``info`` the bands and the kernel's registers and spills (ptxas)."""
    from vxtpu_torch import kernel_check as kc

    m = kc.compare_bounds(x.mask, 4, x.mask_df, x.o, x.d)
    if m["bits_unequal"] or m["empty_unequal"]:
        raise AssertionError(f"mask_bounds_kernel against the batched path: "
                             f"{m}")
    usage = ptxas_usage().get("mask_bounds_kernel", {})
    return SimpleNamespace(
        mask=x.mask, mask_df=x.mask_df, o=x.o, d=x.d, n=x.n,
        cells=x.mask.numel(),
        info=dict(max_abs_err=m["max_abs"], bits_unequal=m["bits_unequal"],
                  bands=m["bands"],
                  registers=usage.get("registers"),
                  spill_stores=usage.get("spill_stores"),
                  spill_loads=usage.get("spill_loads")))


def _k5_inputs(key):
    """The inputs of K5's row on the scene's ray set ``key``: K5 against its
    plain version (hit, voxel, normal and steps equal, |dt| <= 1e-6;
    raises otherwise), the iterations and the distinct table words the
    plain march reads (the bound's, at 2 B a word; ``bound_int32_ms`` at
    4 B, ``bound_rays_only_ms`` without them)."""

    def build(s):
        import torch

        from vxtpu_torch import kernel_check as kc
        from vxtpu_torch.render import kernel_packed as kp

        o, d, tm = s.k5_rays[key]
        x = SimpleNamespace(packed=s.packed, dims=s.dims, ms=s.k5_ms, o=o,
                            d=d, tm=tm, n=o.shape[0])
        with _logged_fetch(kp, x.packed.words) as log:
            ref = kp.march_packed_reference(o, d, x.packed, x.dims, x.ms,
                                            t_max=tm)
        m = kc.packed_mismatch(kp.march_packed(o, d, x.packed, x.dims, x.ms,
                                               t_max=tm), ref)
        kc.check_packed(m, f"K5 {key}")
        x.steps, x.words = int(ref.steps.sum(dtype=torch.int64)), log.count()
        shadow = tm is not None
        x.info = dict(n=x.n, steps=x.steps, table_words=x.words,
                      t_abs=m["t_abs"],
                      bound_int32_ms=k5_bound(x.n, x.steps, shadow, x.words,
                                              4)["bound_ms"],
                      bound_rays_only_ms=k5_bound(x.n, x.steps,
                                                  shadow)["bound_ms"])
        return x

    return build


def tv_bounds(D) -> dict:
    """The TV prior's kernels on a [D^3, 4] float32 table: the forward
    reads the table once (TV_FWD_OPS a row), the backward reads it and
    writes its gradient once (TV_BWD_OPS a row)."""
    return dict(fwd=_bound(16 * D ** 3, TV_FWD_OPS * D ** 3),
                bwd=_bound(32 * D ** 3, TV_BWD_OPS * D ** 3))


def kernel_rows() -> list:
    """The kernel table: a Row a row of PERF.md section 6's table, rows of
    one scene together."""
    import torch

    from vxtpu_torch.render import kernel_march as km
    from vxtpu_torch.render import kernel_packed as kp
    from vxtpu_torch.render import kernel_sample as ks
    from vxtpu_torch.render import occmask, probe
    from vxtpu_torch.train import kernel_adam, kernel_tv
    from vxtpu_torch.train.loss import tv_prior_morton

    def k1(x):
        return km.march(x.o, x.d, x.accel, x.dims, x.ms, shade_spec=x.spec,
                        mats=x.mats, lights_arr=x.lights_arr)

    def k1_plain(x):
        return km.march_shade_reference(x.o, x.d, x.accel, x.dims, x.ms,
                                        None, x.spec, x.mats, x.lights_arr)

    def k1r(x, march=km.march):
        return march(x.o, x.d, x.accel, x.dims, x.ms, extended=True, **x.kw)

    def k5(x, march=kp.march_packed):
        return march(x.o, x.d, x.packed, x.dims, x.ms, t_max=x.tm)

    def k3(x, fwd=ks.sample_fields_fwd):
        return fwd(x.tab, x.o, x.d, x.st, x.sdt, x.S, x.D)

    def k4(ray_grads, bwd=ks.sample_grads):
        return lambda x: bwd(x.tab, x.o, x.d, x.st, x.sdt, x.cots, x.D,
                             ray_grads=ray_grads)

    def k3_bound(x):
        return sample_bounds(x.n, x.S, x.D, x.active, x.touched)["fwd"]

    def k4_bound(ray_grads):
        return lambda x: sample_bounds(x.n, x.S, x.D, x.active, x.touched,
                                       ray_grads=ray_grads)["bwd"]

    def same(x):
        return x

    K3 = dict(launch=k3, kernel="sample_fwd_kernel", bound=k3_bound,
              plain=functools.partial(
                  k3, fwd=ks.sample_fields_fwd_reference),
              library=lambda x: x.lib["fwd"]())
    K4 = dict(launch=k4(False), kernel="sample_bwd_kernel<false, false>",
              bound=k4_bound(False),
              plain=k4(False, ks.sample_fields_bwd_reference),
              library=lambda x: x.lib["bwd_vol"]())
    return [
        *(Row(f"k1.{m}", "world512", _k1_inputs(m), k1, "march_shade_kernel",
              bound=lambda x: k1_bound(x.n, x.steps, x.words,
                                       x.spec is not None, x.hits,
                                       x.shadow_rays),
              plain=k1_plain, graph=True) for m in K1_MODES),
        Row("k1r.round0", "world512", _k1r_inputs, k1r,
            "march_resume_kernel",
            bound=lambda x: k1r_bound(x.n, x.steps, False, False, x.words),
            plain=functools.partial(k1r, march=km.march_reference),
            graph=True),
        Row("k1r.resume", "world512",
            functools.partial(_k1r_inputs, resume=True), k1r,
            "march_resume_kernel",
            bound=lambda x: k1r_bound(x.n, x.steps, True, False, x.words)),
        Row("k2", "world512", _k2_inputs,
            lambda x: km.shade(x.rec, x.o, x.d, x.vis, x.mats, x.lights_arr,
                               x.vspec), "shade_kernel",
            bound=lambda x: k2_bound(x.n, x.hits, x.light.count),
            plain=lambda x: km.shade_reference(x.rec, x.o, x.d, x.vis,
                                               x.mats, x.lights_arr,
                                               x.vspec)),
        Row("k5.512", "world512", _k5_inputs("512"), k5,
            "march_packed_kernel",
            bound=lambda x: k5_bound(x.n, x.steps, False, x.words),
            graph=True),
        Row("k6", "world512", _k6_inputs, None, "march_probe_kernel",
            plain=lambda x: probe.march_probe_reference(
                x.o, x.d, x.tables["morton16"], x.dims),
            sweep=k6_sweep),
        *(Row(f"k5.{k}", "c3", _k5_inputs(k), k5, "march_packed_kernel",
              bound=lambda x: k5_bound(x.n, x.steps, x.tm is not None,
                                       x.words),
              plain=(functools.partial(k5, march=kp.march_packed_reference)
                     if k == "c3" else None), graph=True)
          for k in ("c3", "c3_shadow")),
        Row("k3.c4", "c4", same, **K3),
        Row("k4.scatter", "c4", same, **K4),
        Row("k4.ray_grads", "c4", same, k4(True),
            "sample_bwd_kernel<true, false>", bound=k4_bound(True),
            plain=k4(True, ks.sample_fields_bwd_reference),
            library=lambda x: x.lib["bwd"]()),
        Row("k3.masked", "c4_masked", same, **K3),
        Row("k4.scatter_masked", "c4_masked", same, **K4),
        Row("bounds.c4_masked", "c4_masked", _bounds_inputs,
            lambda x: occmask.mask_segment_bounds(x.mask, 4, x.o, x.d,
                                                  df_flat=x.mask_df),
            "mask_bounds_kernel",
            bound=lambda x: mask_bounds_bound(x.n, x.cells),
            plain=lambda x: occmask.mask_segment_bounds_batched(
                x.mask, 4, x.o, x.d, df_flat=x.mask_df)),
        # warm, the partial sums in L2: no HBM bound (the cold row's)
        Row("k4.ray_sum", "ray_sum", same, lambda x: ks.ray_sums(x.part),
            "sample_ray_sum_kernel",
            plain=lambda x: ks.ray_sums_reference(x.part),
            library=lambda x: torch.sum(x.part, dim=0), graph=True),
        Row("k4.ray_sum_cold", "ray_sum", same,
            lambda x: (x.flush.fill_(1.0), ks.ray_sums(x.part)),
            "sample_ray_sum_kernel",
            bound=lambda x: ray_sum_bound(x.n, x.chunks)),
        # the wrapper's zero-fill of K4's dense gradient (at::native's
        # FillFunctor), which K4's own bound leaves out
        Row("k4.zero_fill", "device", same,
            lambda x: torch.zeros((x.D ** 3, 4), device=x.device),
            "FillFunctor", bound=lambda x: zero_fill_bound(x.D)),
        Row("tv.fwd_kernel", "tv", same,
            lambda x: kernel_tv.tv_fwd(x.tab, *x.w), "tv_fwd_kernel",
            bound=lambda x: tv_bounds(x.D)["fwd"],
            plain=lambda x: tv_prior_morton(x.tab, *x.w)),
        # the partials read and the value written
        Row("tv.fwd_finish", "tv", same,
            lambda x: kernel_tv.tv_fwd(x.tab, *x.w), "tv_fwd_finish_kernel",
            bound=lambda x: _bound(kernel_tv.FWD_PARTS * 16 + 4,
                                   kernel_tv.FWD_PARTS * 4)),
        Row("tv.bwd", "tv", same,
            lambda x: kernel_tv.tv_bwd(x.tab, x.g, *x.w), "tv_bwd_kernel",
            bound=lambda x: tv_bounds(x.D)["bwd"],
            plain=lambda x: torch.autograd.grad(tv_prior_morton(x.q, *x.w),
                                                [x.q])),
        Row("adam", "adam", same,
            lambda x: kernel_adam.adam_step(x.p, x.g, x.m, x.v, *x.args),
            "adam_step_kernel", bound=lambda x: adam_bound(x.D),
            plain=lambda x: kernel_adam.adam_step_reference(
                x.p, x.g, x.m, x.v, *x.args),
            library=lambda x: x.foreach.step()),
    ]


def select_rows(names) -> list:
    """The rows of kernel_rows() named in ``names`` (a row's name, or its
    kernel's part before the dot: "k4" takes every K4 row; empty or None:
    all of them), in the table's order; an unknown name raises."""
    rows = kernel_rows()
    known = {r.name for r in rows} | {r.name.split(".")[0] for r in rows}
    unknown = sorted(set(names or ()) - known)
    if unknown:
        raise SystemExit(f"--times: no row {unknown}; the rows: "
                         + " ".join(r.name for r in rows))
    return [r for r in rows if not names or r.name in names
            or r.name.split(".")[0] in names]


def phase_times(device, rows) -> dict:
    """Phase 13: each of ``rows`` timed alone (time_row; K6 its sweep), a
    scene built once for its rows and dropped after them; row name -> its
    times."""
    import torch

    t0 = time.perf_counter()
    out, scene, built = {}, None, None
    for row in rows:
        if built is None or row.scene != scene:
            built = None
            torch.cuda.empty_cache()
            scene, built = row.scene, SCENES[row.scene](device)
        x = row.inputs(built)
        out[row.name] = (row.sweep or time_row)(row, x, device)
        del x
    del built
    torch.cuda.empty_cache()
    print(f"phase 13 times: {len(rows)} rows in "
          f"{time.perf_counter() - t0:.1f} s")
    return out


TIME_KEYS = ("device_ms", "device_ms_clock", "device_ms_rounds", "graph_ms",
             "graph_ms_clock", "plain_ms", "plain_ms_clock", "library_ms",
             "library_ms_clock", "bound_ms", "bound_by", "bytes", "ops",
             "share")


def _timed(t: dict, *extra) -> dict:
    """A row's times and bound (and ``extra`` keys) for the kernels line."""
    return {k: t[k] for k in (*TIME_KEYS, *extra) if k in t}


def kernels_line(main_run, pipe, resume, mask, train, bench_run, scale,
                 times) -> list:
    """The kernels line of a whole run: each kernel's launches and errors
    from the phases, its times and bounds from phase 13's rows."""
    T = times
    bench_launches = bench_run["commands"]["launches"]
    kernels = [
        {"name": "march_shade_kernel", "route": "cuda",
         "source": "vxtpu_torch/csrc/march.cu",
         "replaces": "vxtpu/render/kernel_pallas_v2.py:434",
         "launches": main_run["launches"]["march_shade_kernel"],
         "variant_launches": main_run["variant_launches"],
         "max_abs_err": main_run["err"]["march_shade_kernel"],
         **_timed(T["k1.lambert"], "bound_rays_only_ms", "table_words"),
         "modes": {m: _timed(T[f"k1.{m}"]) for m in K1_MODES},
         "occupancy": pipe["times"]["k1_occupancy"],
         "sharded": {"launches": scale["fused"]["launches"],
                     "mismatched_pixels": scale["fused"]["mismatches"]},
         "bench": {"launches": bench_launches["march_shade_kernel"],
                   "variant_launches": bench_launches["variants"]}},
        {"name": "shade_kernel", "route": "cuda",
         "source": "vxtpu_torch/csrc/march.cu",
         "replaces": "vxtpu/render/kernel_pallas_v2.py:1219",
         "launches": main_run["launches"]["shade_kernel"],
         "max_abs_err": main_run["err"]["shade_kernel"], **_timed(T["k2"])},
    ]
    # K3 and K4's pure scatter: launches of the five c4 steps; K4 with
    # kRayGrads and its ray sums: launches of the camera refinement
    for k, line, run, row, masked in (
            ("sample_fwd_kernel", "213", train["launches"], "k3.c4",
             "k3.masked"),
            (BWD[False], "434", train["launches"], "k4.scatter",
             "k4.scatter_masked"),
            (BWD[True], "434", train["cam_launches"], "k4.ray_grads", None),
            ("sample_ray_sum_kernel", "434 (its per-ray sums)",
             train["cam_launches"], "k4.ray_sum", None)):
        kernels.append({
            "name": k, "route": "cuda",
            "source": "vxtpu_torch/csrc/sample.cu",
            "replaces": f"vxtpu/render/kernel_sample.py:{line}",
            "launches": run[k], "max_abs_err": train["err"][k],
            **_timed(T[row]),
            "bench": {"launches": bench_launches[k], "field_step_vs_plain": {
                n: {e: r[e] for e in ("loss_rel", "table", "camera", "rays")}
                for n, r in bench_run["field_step"].items()}}})
        if k in BWD.values():
            kernels[-1]["zero_fill"] = _timed(T["k4.zero_fill"])
        if k == "sample_ray_sum_kernel":
            kernels[-1]["cold"] = _timed(T["k4.ray_sum_cold"])
        if k in scale["train"]["launches"]:
            # phase 11's sharded field-kernel and masked steps
            kernels[-1]["sharded"] = {
                "launches": scale["train"]["launches"][k],
                "grad_excess": {n: e["excess"] for n, e in
                                scale["train"]["err"].items()}}
        if masked:
            # phase 10's masked fit: its launches, and the kernel alone at
            # the masked step's shape (C4_S_MASK samples on the bands)
            kernels[-1]["masked"] = {
                "launches": mask["launches"][k],
                "max_abs_err": mask["err"][k], **_timed(T[masked])}
    # the TV prior's pair and Adam's kernel: launches of the five c4
    # steps, errors against their plain versions at FULL^3 (the rows'
    # inputs; tests/test_torch_cuda.py runs every case)
    for k, row, e in (("tv_fwd_kernel", "tv.fwd_kernel", "value_rel"),
                      ("tv_fwd_finish_kernel", "tv.fwd_finish", "value_rel"),
                      ("tv_bwd_kernel", "tv.bwd", "grad_err")):
        kernels.append({
            "name": k, "route": "cuda", "source": "vxtpu_torch/csrc/tv.cu",
            "replaces": "none (vxtpu/train/loss.py:tv_loss_morton is plain "
                        "jnp that XLA fuses)",
            "launches": train["tv_launches"][k],
            "max_abs_err": T[row][e],
            "max_abs_err_is": ("the value's relative error" if "fwd" in k
                               else "the gradient's error x max |g|"),
            **_timed(T[row]),
            "call_device_ms": (T["tv.bwd"]["device_ms"] if k == "tv_bwd_kernel"
                               else T["tv.fwd_kernel"]["device_ms"]
                               + T["tv.fwd_finish"]["device_ms"])})
    kernels.append({
        "name": "adam_step_kernel", "route": "cuda",
        "source": "vxtpu_torch/csrc/adam.cu",
        "replaces": "none (vxtpu's optax.adam is plain jnp that XLA fuses)",
        "launches": train["adam_launches"]["adam_step_kernel"],
        "max_abs_err": T["adam"]["max_abs_err"],
        "max_abs_err_is": "against torch.optim.Adam's foreach step over 3 "
                          "steps of the FULL^3 table, over the parameters "
                          "and both moments",
        **_timed(T["adam"]),
        "plain_ms_is": "torch's single-tensor ops, a call",
        "library_ms_is": "torch.optim.Adam's foreach step, a call"})
    kernels.append({
        "name": "mask_bounds_kernel", "route": "cuda",
        "source": "vxtpu_torch/csrc/bounds.cu",
        "replaces": "none (vxtpu/render/occmask.py:mask_segment_bounds is "
                    "two batched marches of plain jnp)",
        "launches": mask["launches"]["mask_bounds_kernel"],
        "max_abs_err": T["bounds.c4_masked"]["max_abs_err"],
        "max_abs_err_is": "against the batched path on the masked step's "
                          "rays, over t0 and t1 (the row raises unless "
                          "they are equal bit for bit)",
        **_timed(T["bounds.c4_masked"], "bands", "registers", "spill_stores",
                 "spill_loads"),
        "plain_ms_is": "the batched path (two march_xla_df marches), a "
                       "call"})
    kernels.append({
        "name": "march_packed_kernel", "route": "cuda",
        "source": "vxtpu_torch/csrc/march_packed.cu",
        "replaces": "vxtpu/render/kernel_pallas.py:85",
        "launches": pipe["launches"]["march_packed_kernel"],
        "max_abs_err": max(T[k]["t_abs"] for k in ("k5.c3", "k5.c3_shadow",
                                                    "k5.512")),
        **_timed(T["k5.c3"], "bound_int32_ms", "bound_rays_only_ms",
                 "table_words"),
        "shadow": _timed(T["k5.c3_shadow"]), "big": _timed(T["k5.512"]),
        "blocks_per_sm": pipe["times"].get("blocks_per_sm")})
    kernels.append({
        "name": "march_resume_kernel", "route": "cuda",
        "source": "vxtpu_torch/csrc/march.cu",
        "replaces": "vxtpu/render/kernel_pallas_v2.py:434 (resume mode) "
                    "and :1105 (march_pallas_v2_sorted)",
        "launches": resume["times"]["launches"]["march_resume_kernel"],
        "max_abs_err": resume["err"]["march_resume_kernel"],
        **_timed(T["k1r.round0"], "bound_rays_only_ms"),
        "resume": _timed(T["k1r.resume"])})
    k6 = T["k6"]
    kernels.append({
        "name": "march_probe_kernel", "route": "cuda",
        "source": "vxtpu_torch/csrc/probe.cu",
        "replaces": ", ".join(f"tools/{f}" for f in (
            "probe_pallas2_cost.py:164", "probe_pallas2_fixed.py:122",
            "probe_r5_fetch.py:175", "probe_r5_fetch2.py:177",
            "probe_r5_fetch3.py:152", "probe_r4_tune.py:181",
            "probe_r4_tile16.py:133", "probe_r4_matfetch.py:96",
            "probe_r4_matfetch.py:102")),
        "launches": k6["launches"], "max_abs_err": k6["err"],
        **_timed(k6, "parent_form_ms", "parent_form_ms_clock",
                 "reads_per_ray_iter"),
        "occupancy": k6["occupancy"]["full/morton16/k1"]})
    return kernels


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--save", default=None,
                   help="directory for the main-path frames as PNGs")
    p.add_argument("--times", nargs="*", default=None, metavar="ROW",
                   help="phases 1 and 2, then phase 13 alone on the named "
                        "rows of the kernel table (a row, or its kernel: "
                        "k1 k1r k2 k3 k4 k5 k6 bounds tv adam; none: every "
                        "row) and a JSON line of their times; copied into a "
                        "checkout of another commit, it times that "
                        "commit's kernels the same way")
    p.add_argument("--scale-out", action="store_true",
                   help="phases 1 and 2, then phase 11 alone (the sharded "
                        "paths, config 5 at full size) and a JSON line of "
                        "its results")
    p.add_argument("--bench", action="store_true",
                   help="phases 1 and 2, then phase 12 alone (the reference "
                        "and wavefront marches and the bench) and a JSON "
                        "line of its results")
    p.add_argument("--sass", default=None, metavar="FILE",
                   help="with --times: write the SASS listing of the K1, K5 "
                        "and K6 kernels among the rows to FILE and print "
                        "each instantiation's opcodes by count")
    args = p.parse_args(argv)
    _require_checkout()
    rows = select_rows(args.times) if args.times is not None else None
    device, name, smi = phase_device()
    phase_build()
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
    if rows is not None:
        out = {"gpu": smi}
        kernels = sorted({r.kernel for r in rows
                          if r.name.split(".")[0] in ("k1", "k5", "k6")})
        if args.sass and kernels:
            out["sass"] = sass_functions(kernels, Path(args.sass))
            for fn, ops in out["sass"].items():
                print(f"SASS {fn}: {sum(ops.values())} instructions; "
                      + ", ".join(f"{k} {v}" for k, v in ops.items()))
        out["times"] = phase_times(device, rows)
        print(json.dumps(out, default=str))
        return 0
    main_run = phase_main(device, save=args.save)
    cross_fingerprint(main_run["grid"], main_run["accel"])
    del main_run["accel"]
    grid = main_run.pop("grid")
    pipe = phase_pipeline(device, grid, save=args.save)
    resume = phase_resume(device, grid)
    del grid
    times = phase_times(device, select_rows(None))
    phase_xla(device, save=args.save, card=smi)
    mask = phase_mask(device, card=smi)
    cross_entry_frame(device)
    train = phase_train(device)
    cross_train(device)
    bench_run = phase_bench(device, card=smi)
    scale = phase_scale_out(device, card=smi)

    import torch

    print(json.dumps({"kernels": kernels_line(main_run, pipe, resume, mask,
                                              train, bench_run, scale, times),
                      "gpu": smi}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
