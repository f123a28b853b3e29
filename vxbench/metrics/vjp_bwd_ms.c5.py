"""vjp_bwd_ms.c5: device ms a step of the work that the custom backward
launched (``render/vjp.py``, the program's span
``vxtpu_torch.vjp.backward``: the re-walk of the samples, each sample's
autograd and its index_add_ into the [D^3, 4] gradient), in the traced
frame of a config-5 cell. None where the profiler did not record the
whole frame."""

from vxbench import launches

SPAN = "vxtpu_torch.vjp.backward"


def read(ctx):
    if launches.c5_frame(ctx) is None:
        return None
    win = ctx["window"]
    return launches.launched_s(win, launches.spans(win, SPAN)) \
        / ctx["steps"] * 1e3
