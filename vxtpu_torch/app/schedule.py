"""Per-frame animation schedules: the scene state of frame t as a pure
function of t (counterpart of ``vxtpu/app/schedule.py``)."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.device import DEFAULT, resolve
from vxtpu_torch.world.lights import Lights


@dataclasses.dataclass(frozen=True)
class Schedule:
    """camera_at(t) -> Camera and lights_at(t) -> Lights, t in seconds."""

    camera_at: Callable[[torch.Tensor], Camera]
    lights_at: Callable[[torch.Tensor], Lights]
    fps: float = 60.0

    def frame_state(self, frame_idx):
        t = torch.as_tensor(frame_idx, dtype=torch.float32) / self.fps
        return self.camera_at(t), self.lights_at(t)


def static_lights(lights: Lights) -> Callable[[torch.Tensor], Lights]:
    return lambda t: lights


def orbiting_light(center, radius: float, height: float, period: float = 4.0,
                   rgb=(1.0, 0.95, 0.85), intensity: float = 2.0,
                   device=DEFAULT):
    """t -> Lights: one point light circling the scene."""
    device = resolve(device)
    f32 = dict(dtype=torch.float32, device=device)
    center = torch.as_tensor(center, **f32)

    def at(t) -> Lights:
        t = torch.as_tensor(t, **f32)
        ang = 2.0 * math.pi * t / period
        pos = center + torch.stack([radius * torch.cos(ang),
                                    radius * torch.sin(ang),
                                    torch.tensor(height, **f32)])
        return Lights(pos=pos[None, :], rgb=torch.tensor([rgb], **f32),
                      intensity=torch.tensor([intensity], **f32))

    return at
