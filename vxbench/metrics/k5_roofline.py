"""k5_roofline: the row-major march K5's share (%) of its roofline in the
pipeline frame: the least time of K5's own work on a few traced frames
(vxbench/bounds_packed.py:k5_work: each primary and shadow ray's inputs
and outputs, the distinct bricked-table words each march reads, the
march's operations for each ray and iteration, as the plain reference
counts them) over the device time of the operations named
march_packed_kernel in those frames' spans. A frame whose K5 launches the
profiler did not all record is left out."""

from vxbench import bounds_packed


def read(ctx):
    if ctx.get("kind") != "frame" or not ctx.get("k5_work"):
        return None
    least = spent = 0.0
    for rays, shadow_rays, steps, words, device_s, recorded, launches in \
            ctx["k5_work"]:
        if recorded != launches or device_s <= 0:
            continue
        least += bounds_packed.k5_work(rays, shadow_rays, steps,
                                       words)["bound_ms"] / 1e3
        spent += device_s
    return 100.0 * least / spent if spent > 0 else None
