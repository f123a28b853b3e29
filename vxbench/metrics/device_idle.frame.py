"""device_idle.frame: the share (%) of the traced part of a frame cell's
window in which no device operation ran: 100 x (1 - union of the
profiler's device intervals / window)."""


def read(ctx):
    if ctx.get("kind") != "frame":
        return None
    win = ctx["window"]
    if not win.ops or win.window_s <= 0:
        return None
    return 100.0 * (1.0 - win.busy_s() / win.window_s)
