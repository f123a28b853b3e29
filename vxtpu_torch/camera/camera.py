"""Pinhole camera (counterpart of ``vxtpu/camera/camera.py``).

World frame: Z up. yaw = azimuth around +Z measured from +X; pitch =
inclination above the XY plane.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from vxtpu_torch.device import DEFAULT, resolve


@dataclasses.dataclass(frozen=True)
class Camera:
    """pos: float32 [3]; yaw, pitch, fov_y: float32 0-d tensors (radians)."""

    pos: torch.Tensor
    yaw: torch.Tensor
    pitch: torch.Tensor
    fov_y: torch.Tensor

    @staticmethod
    def make(pos, yaw=0.0, pitch=0.0, fov_y_deg=60.0,
             device=DEFAULT) -> "Camera":
        f32 = dict(dtype=torch.float32, device=resolve(device))
        return Camera(
            pos=torch.as_tensor(pos, **f32),
            yaw=torch.as_tensor(yaw, **f32),
            pitch=torch.as_tensor(pitch, **f32),
            fov_y=torch.as_tensor(fov_y_deg, **f32) * (math.pi / 180.0),
        )

    def basis(self):
        """Orthonormal (forward, right, up) world-frame vectors, each [3]."""
        cy, sy = torch.cos(self.yaw), torch.sin(self.yaw)
        cp, sp = torch.cos(self.pitch), torch.sin(self.pitch)
        forward = torch.stack([cp * cy, cp * sy, sp])
        right = torch.stack([sy, -cy, torch.zeros_like(sy)])
        # up = right x forward
        up = torch.stack([
            right[1] * forward[2] - right[2] * forward[1],
            right[2] * forward[0] - right[0] * forward[2],
            right[0] * forward[1] - right[1] * forward[0],
        ])
        return forward, right, up

    def look_at(self, target) -> "Camera":
        """Same position, aimed at target."""
        tv = torch.as_tensor(target, dtype=torch.float32,
                             device=self.pos.device) - self.pos
        yaw = torch.atan2(tv[1], tv[0])
        pitch = torch.atan2(tv[2], torch.sqrt(tv[0] * tv[0] + tv[1] * tv[1]))
        return dataclasses.replace(self, yaw=yaw, pitch=pitch)
