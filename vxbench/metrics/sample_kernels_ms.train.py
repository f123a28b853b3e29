"""sample_kernels_ms.train: device ms a step of the field-sampling kernels
(K3 and K4, csrc/sample.cu, launched by render/kernel_sample.py), from the
profiler's device operations whose names hold one of NAMES."""

NAMES = ("sample_fwd_kernel", "sample_bwd_kernel", "sample_ray_sum_kernel")


def read(ctx):
    if ctx.get("kind") != "step" or not ctx["steps"]:
        return None
    win = ctx["window"]
    s = win.device_s(win.start_us, win.end_us, NAMES)
    if s <= 0:
        return None
    return s / ctx["steps"] * 1e3
