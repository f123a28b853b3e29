"""mask_bounds_ms.train: ms of one bounds pass of the masked fit
(render/occmask.py:mask_segment_bounds) on the window's last mask and
rays, CUDA events around a few passes run after the window."""


def read(ctx):
    if ctx.get("kind") != "step":
        return None
    return ctx.get("mask_bounds_ms")
