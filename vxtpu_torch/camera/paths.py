"""Scripted camera paths (counterpart of ``vxtpu/camera/paths.py``; only
``orbit`` and ``orbit_views``, which the trainer's multi-view capture
uses)."""

from __future__ import annotations

import dataclasses
import math

import torch

from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.device import DEFAULT, resolve


def orbit(center, radius: float, height: float, period: float = 8.0,
          fov_y_deg: float = 60.0, device=DEFAULT):
    """t -> Camera on a circular orbit around center, aimed at it."""
    device = resolve(device)
    center = torch.as_tensor(center, dtype=torch.float32, device=device)

    def at(t) -> Camera:
        t = torch.as_tensor(t, dtype=torch.float32, device=device)
        ang = 2.0 * math.pi * t / period
        pos = center + torch.stack([
            radius * torch.cos(ang), radius * torch.sin(ang),
            torch.tensor(height, dtype=torch.float32, device=device)])
        cam = Camera.make((0.0, 0.0, 0.0), fov_y_deg=fov_y_deg, device=device)
        return dataclasses.replace(cam, pos=pos).look_at(center)

    return at


def orbit_views(center, radius: float, height: float, n: int,
                fov_y_deg: float = 60.0, device=DEFAULT) -> list:
    """n cameras evenly spaced on an orbit, all aimed at center: the
    multi-view capture rig of the inverse-rendering fit."""
    at = orbit(center, radius, height, period=float(n), fov_y_deg=fov_y_deg,
               device=device)
    return [at(float(i)) for i in range(n)]
