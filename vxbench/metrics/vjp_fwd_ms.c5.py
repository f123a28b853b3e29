"""vjp_fwd_ms.c5: device ms a step of the work that the custom backward's
forward loop launched (``render/vjp.py``, the program's span
``vxtpu_torch.vjp.forward``: 192 sample steps of trilinear, lit shading
and compositing over the frame's rays), in the traced frame of a config-5
cell. None where the profiler did not record the whole frame."""

from vxbench import launches

SPAN = "vxtpu_torch.vjp.forward"


def read(ctx):
    if launches.c5_frame(ctx) is None:
        return None
    win = ctx["window"]
    return launches.launched_s(win, launches.spans(win, SPAN)) \
        / ctx["steps"] * 1e3
