"""shade_host_ms.frame: the host's ms a traced frame inside the program's
``vxtpu_torch.pipeline.shade`` spans (render/pipeline.py: albedo gather,
lighting, fog, sky, clamp), summed over the traced part of the window and
divided by its frames. None where the program records no such span."""

SPAN = "vxtpu_torch.pipeline.shade"


def read(ctx):
    if ctx.get("kind") != "frame" or not ctx.get("frames"):
        return None
    spans = [e - s for n, s, e in ctx["window"].host if n == SPAN]
    if not spans:
        return None
    return sum(spans) / 1e3 / ctx["frames"]
