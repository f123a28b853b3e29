"""Device time by the host span that launched it. ``LaunchWindow`` is a
``trace.Window`` that also keeps, for each device operation, when the
host operation that launched it started: the profiler attaches every
kernel, copy and fill to that operation (``FunctionEvent.kernels``, by
their correlation id). So the device time of the work that a program's
span launched can be summed even where the device runs it after the span
has ended, as it does in a device-bound step, whose host runs ahead of
the device.
"""

from __future__ import annotations

import heapq

from vxbench.trace import WINDOW_SPAN, Window, idle_gaps


class LaunchWindow(Window):
    """After the block, ``launched`` holds (name, device_us, host_us) for
    each device operation the profiler attached to a host operation:
    its name, its device time and the start of the host operation that
    launched it."""

    def __init__(self):
        super().__init__()
        self.launched = []

    def _read(self):
        from torch.autograd import DeviceType

        super()._read()
        # a host annotation mirrored on the device's timeline is attached
        # to its host range as if it were a kernel: it is none
        mirrored = {n for n, _, _ in self.host + self.spans}
        mirrored.add(WINDOW_SPAN)
        self.launched = sorted(
            ((k.name, float(k.duration), float(e.time_range.start))
             for e in self._prof.events()
             if e.device_type == DeviceType.CPU and not e.is_async
             for k in e.kernels if k.name not in mirrored),
            key=lambda x: x[2])

    def breakdown(self, top: int = 10) -> dict:
        """``Window.breakdown``'s numbers in O(n log n): each idle gap is
        named by the shortest host range open at its start, found by one
        sweep over the ranges (a frame of ~4 x 10^5 device operations
        has as many gaps)."""
        by_op: dict = {}
        for n, s, e in self.ops:
            by_op[n[:120]] = by_op.get(n[:120], 0.0) + (e - s) / 1e6
        ranges = sorted(self.host + self.spans, key=lambda h: h[1])
        gaps: dict = {}
        open_, i = [], 0
        for s, e in idle_gaps(self.ops, self.start_us, self.end_us):
            while i < len(ranges) and ranges[i][1] <= s:
                n, a, b = ranges[i]
                heapq.heappush(open_, (b - a, b, n))
                i += 1
            while open_ and open_[0][1] <= s:
                heapq.heappop(open_)
            name = open_[0][2] if open_ else "host"
            gaps[name[:120]] = gaps.get(name[:120], 0.0) + (e - s) / 1e6
        return {"device_ops": sorted(by_op.items(),
                                     key=lambda x: -x[1])[:top],
                "idle_gaps": sorted(gaps.items(), key=lambda x: -x[1])[:top]}


def spans(win, name: str) -> list:
    """(start_us, end_us) of the host spans called ``name``."""
    return [(s, e) for n, s, e in win.host if n == name]


def launched_in(win, within: list, parts=None) -> list:
    """The device operations of ``win.launched`` whose launching host
    operation started inside one of the intervals ``within`` (with
    ``parts``, those whose name holds one of them)."""
    return [r for r in win.launched
            if any(s <= r[2] <= e for s, e in within)
            and (parts is None or any(p in r[0] for p in parts))]


def launched_s(win, within: list) -> float:
    """Device seconds of the operations launched inside ``within``."""
    return sum(r[1] for r in launched_in(win, within)) / 1e6


# the config-5 step's spans and its gradient scatter's kernels
C5_STEP = "vxtpu_torch.config5.step"
INDEX_ADD = ("indexFunc", "index_add")


def c5_frame(ctx) -> dict | None:
    """The config-5 numbers of a traced frame (``ctx["c5"]``), or None
    where ``ctx`` is no config-5 step context or the profiler did not
    record the whole frame: every index_add_ that the program's counters
    say its steps made (one a re-walked sample step, adding 8 rows a ray
    of this rank) must be among the device operations launched in the
    step spans."""
    if ctx.get("kind") != "step" or not ctx.get("c5"):
        return None
    c5, win = ctx["c5"], ctx["window"]
    made = c5["rows_added"] / (8 * c5["rays_local"])
    seen = len(launched_in(win, spans(win, C5_STEP), INDEX_ADD))
    return c5 if made > 0 and seen == made else None
