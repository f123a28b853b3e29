"""mfu.train: the whole training step's share (%) of the card's peak
bandwidth: the least bytes any implementation of the step moves
(vxbench/bounds.py:fit_step_bytes: the [D^3, 4] float32 table and Adam's
two moments, each read and written once, and the rays and their target
read once) over 3.35 TB/s, divided by the traced steps' own time a step.
The fit runs well under one float32 operation a byte, so bandwidth, not
FLOP/s, is its peak."""

from vxbench import bounds


def read(ctx):
    if ctx.get("kind") != "step" or not ctx.get("step_s"):
        return None
    least = bounds.fit_step_bytes(ctx["D"], ctx["rays"]) / bounds.PEAK_BYTES
    return 100.0 * least / ctx["step_s"]
