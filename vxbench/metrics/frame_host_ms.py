"""frame_host_ms: the host's ms a frame from the start of its camera pose
to the frame function's return, before the synchronise (the benchmark's
own span around the program's frame host path), as a mean over the traced
frames."""


def read(ctx):
    if ctx.get("kind") != "frame" or not ctx["host_ms"]:
        return None
    return sum(ctx["host_ms"]) / len(ctx["host_ms"])
