"""mfu.c5: the config-5 train step's share (%) of its roofline: the least
time of the step's work, whatever implements it
(``vxbench/bounds_c5.py:c5_step_work``: the parameters and Adam's moments
read and written once, the rays and target read once, and the lit sample
model's operations forward and backward for every sample), over the
device time of the work launched in the program's step spans
(``vxtpu_torch.config5.step``) a step of the traced frame. None where the
profiler did not record the whole frame."""

from vxbench import bounds_c5, launches


def read(ctx):
    c5 = launches.c5_frame(ctx)
    if c5 is None:
        return None
    win = ctx["window"]
    spent = launches.launched_s(win, launches.spans(win, launches.C5_STEP))
    if spent <= 0:
        return None
    least = bounds_c5.c5_step_work(c5["D"], c5["rays"],
                                   c5["samples"])["bound_ms"] / 1e3
    return 100.0 * least * ctx["steps"] / spent
