"""mfu.frame: the frame's share (%) of the card's peak, by the frame's
own work: the least time of that work (vxbench/bounds.py:frame_work: the
image written once, the distinct table words its rays read, read once,
and the march's operations for each ray, shadow ray and DDA step, as the
benchmark's plain march counts them on a few traced frames) over the
device time of all the kernels of those frames. It counts the frame's
work, not any kernel's own I/O, so it reads the same whatever kernels
render the frame."""

from vxbench import bounds


def read(ctx):
    if ctx.get("kind") != "frame" or not ctx["frame_work"]:
        return None
    least = spent = 0.0
    for words, rays, shadow_rays, steps, device_s in ctx["frame_work"]:
        if device_s <= 0:
            return None
        least += bounds.frame_work(ctx["pixels"], words, rays, shadow_rays,
                                   steps)["bound_ms"] / 1e3
        spent += device_s
    return 100.0 * least / spent
