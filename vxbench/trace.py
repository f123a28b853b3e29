"""Reading a torch.profiler window: the device operations and their
intervals, the device's busy time (the union of the intervals), the
operations that took most time and the longest idle gaps named by what
the host was doing. The arithmetic of ``vxtpu_torch/render/probe.py``'s
``launch_us`` (device events of ``prof.events()``), frozen here.
"""

from __future__ import annotations

import torch

WINDOW_SPAN = "vxbench.window"


class Window:
    """A profiled part of a run. ``with Window() as w:`` profiles the
    block (which should end with a synchronise); afterwards ``w.ops`` are
    the device operations (name, start_us, end_us), ``w.host`` the host
    ops, ``w.start_us``/``w.end_us`` the block's span and ``w.spans``
    the benchmark's own spans (record_function ranges named
    ``vxbench.*``: name, start_us, end_us)."""

    def __init__(self):
        self.ops, self.host, self.spans = [], [], []
        self.start_us = self.end_us = 0.0
        self._prof = self._span = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self):
        from torch.autograd import DeviceType

        device = []
        for e in self._prof.events():
            r = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == DeviceType.CUDA:
                device.append(r)
            elif e.name == WINDOW_SPAN:
                self.start_us, self.end_us = r[1], r[2]
            elif e.name.startswith("vxbench."):
                self.spans.append(r)
            else:
                self.host.append(r)
        # a host annotation (record_function: the benchmark's spans, the
        # optimizer's) is mirrored on the device's timeline under its own
        # name; it is no device operation
        host_names = {n for n, _, _ in self.host + self.spans}
        host_names.add(WINDOW_SPAN)
        self.ops = sorted((r for r in device if r[0] not in host_names),
                          key=lambda x: x[1])

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_s(self, lo: float | None = None, hi: float | None = None):
        """Seconds in [lo, hi] (us; default the window) in which some
        device operation ran."""
        return union_us(self.ops, self.start_us if lo is None else lo,
                        self.end_us if hi is None else hi) / 1e6

    def device_s(self, lo: float, hi: float, names=None) -> float:
        """Summed seconds of the device operations that start in [lo, hi]
        (with ``names``, of those whose name holds one of them)."""
        return sum(e - s for n, s, e in self.ops if lo <= s <= hi and (
            names is None or any(k in n for k in names))) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, summed by name, and
        the idle gaps summed by the innermost host op that was running at
        each gap's start (seconds)."""
        by_op: dict = {}
        for n, s, e in self.ops:
            by_op[n[:120]] = by_op.get(n[:120], 0.0) + (e - s) / 1e6
        gaps: dict = {}
        for s, e in idle_gaps(self.ops, self.start_us, self.end_us):
            inner = [h for h in self.host + self.spans if h[1] <= s < h[2]]
            name = min(inner, key=lambda h: h[2] - h[1])[0] if inner \
                else "host"
            gaps[name[:120]] = gaps.get(name[:120], 0.0) + (e - s) / 1e6
        return {"device_ops": sorted(by_op.items(),
                                     key=lambda x: -x[1])[:top],
                "idle_gaps": sorted(gaps.items(), key=lambda x: -x[1])[:top]}


def _merged(ops, lo: float, hi: float):
    out = []
    for _, s, e in sorted(ops, key=lambda x: x[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_us(ops, lo: float, hi: float) -> float:
    """Length (us) of the union of the ops' intervals within [lo, hi]."""
    return sum(e - s for s, e in _merged(ops, lo, hi))


def idle_gaps(ops, lo: float, hi: float) -> list:
    """The intervals of [lo, hi] in which no op ran."""
    gaps, cur = [], lo
    for s, e in _merged(ops, lo, hi):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps

