"""Drivers: one module per kind of configuration (the ``kind`` key of a
configuration's file). ``run(r: Run) -> Outcome`` sets the cell up,
warms up its shapes, measures its window, and checks what the window
produced against the configuration's plain reference."""

from __future__ import annotations

import dataclasses
import sys
import time

import torch


@dataclasses.dataclass
class Run:
    cell: object                 # harness.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float               # time.perf_counter() at process start
    sizes: dict = dataclasses.field(default_factory=dict)  # tests only
    faults: tuple = ()           # faults planted in the program (tests)


@dataclasses.dataclass
class Outcome:
    metrics: dict                # end-to-end metrics: name -> value
    checks: dict                 # name -> {"value", "limit"}
    attempted: int
    failed: int
    memory_peak_bytes: int
    layer_ctx: dict | None = None    # what the per-layer readers read
    window: object = None            # trace.Window of a traced run
    setup_split: dict = dataclasses.field(default_factory=dict)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


class Clock:
    """Set-up phases' seconds, each from the end of the last."""

    def __init__(self, t0: float):
        self.last = t0
        self.split: dict = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.split[name] = round(now - self.last, 6)
        self.last = now


def check(value: float, limit: float) -> dict:
    return {"value": float(value), "limit": float(limit)}


def gap(prog: float, ref: float) -> float:
    """|prog - ref| / |ref|."""
    return abs(prog - ref) / abs(ref) if ref else abs(prog - ref)
