"""eval_render_ms.c5: device ms a step of the frame's two renders of the
plain soft renderer in chunks (``train/config5.py``'s spans
``vxtpu_torch.config5.target``, the target from the truth, and
``.eval``, the PSNR frame), over the traced frame's steps. None where the
profiler did not record the whole frame or the program records no such
span."""

from vxbench import launches

SPANS = ("vxtpu_torch.config5.target", "vxtpu_torch.config5.eval")


def read(ctx):
    if launches.c5_frame(ctx) is None:
        return None
    win = ctx["window"]
    within = [s for name in SPANS for s in launches.spans(win, name)]
    if not within:
        return None
    return launches.launched_s(win, within) / ctx["steps"] * 1e3
