"""Run one cell of the benchmark and print its result as the last line
of standard output.

    python3 vxbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a short profiled part of
the window, and the ``busy_s``/``window_s`` of that part. Every run
checks what its window produced against the plain reference and prints
each number compared beside its limit (last on standard error, and last
in the line). It needs as many CUDA devices as the cell asks for, and
exits with 2, printing no result, where there are fewer; with 3 where a
JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# kernel build caches at fixed paths inside the checkout: only a
# checkout's first run compiles (the program builds its CUDA library in
# vxtpu_torch/_build, also inside the checkout)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / ".vxbench_cache" / sub)
os.environ.setdefault("OMP_NUM_THREADS", "2")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_report(chips: int, peak: int, window=None) -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": peak}
    if window is not None:
        out["busy_s"] = window.busy_s()
        out["window_s"] = window.window_s
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from vxbench import harness
    from vxbench.drivers import Run, log

    cell = harness.find_cell(harness.load_manifest(ROOT), args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false; the "
            "benchmark measures the GPU and never falls back to the CPU")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA devices, found "
            f"{torch.cuda.device_count()}")
        return 2
    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    run = Run(cell=cell, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device=dev, t_start=T_START)
    out = harness.driver(cell.config["kind"]).run(run)
    found = harness.forbidden_loaded()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    log(f"setup split (s): {out.setup_split}")
    if args.trace:
        metrics = harness.read_layers(cell, out.layer_ctx)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out.metrics.items() if k in units}
    correct = harness.checks_ok(out.checks) and out.failed == 0
    line = harness.result_line(
        correct, out.attempted, out.failed, metrics,
        device_report(cell.chips, out.memory_peak_bytes, out.window),
        out.checks, out.window.breakdown() if out.window else None)
    print(harness.checks_text(out.checks), file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
