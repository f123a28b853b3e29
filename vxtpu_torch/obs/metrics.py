"""Performance metrics: Mrays/s and fps as JSON lines on stdout and in an
optional JSONL file (counterpart of ``vxtpu/obs/metrics.py``)."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

from vxtpu_torch.obs.log import process_rank


def mrays_per_s(height: int, width: int, frame_s: float) -> float:
    return height * width / frame_s / 1e6


@dataclass
class MetricsSink:
    """JSONL + stdout metric emission. Only rank 0 emits, unless
    ``all_hosts`` is set (then give each rank its own path)."""

    path: str | None = None
    echo: bool = True
    all_hosts: bool = False
    _t0: float = field(default_factory=time.time)

    def _is_emitter(self) -> bool:
        return self.all_hosts or process_rank() == 0

    def emit(self, **kv):
        if not self._is_emitter():
            return
        rec = dict(t=round(time.time() - self._t0, 3), **kv)
        line = json.dumps(rec)
        if self.echo:
            print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
