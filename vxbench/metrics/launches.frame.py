"""launches.frame: the device operations of a traced frame (kernels,
copies and fills the profiler recorded starting within the benchmark's
``vxbench.frame.<i>`` span, which ends with the frame's synchronise), as
a mean over the traced frames."""


def read(ctx):
    if ctx.get("kind") != "frame":
        return None
    win = ctx["window"]
    frames = [(s, e) for n, s, e in win.spans
              if n.startswith("vxbench.frame.")]
    if not frames or not win.ops:
        return None
    return sum(sum(1 for _, a, _ in win.ops if s <= a <= e)
               for s, e in frames) / len(frames)
