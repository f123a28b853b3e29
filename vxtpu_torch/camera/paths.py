"""Scripted camera paths: functions t -> Camera (counterpart of
``vxtpu/camera/paths.py``): an orbit, a looped flythrough of waypoints,
and the reference's impulse/friction camera physics driven by a scripted
schedule of impulses."""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

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


def flythrough(waypoints: Sequence, look_at, period: float = 10.0,
               fov_y_deg: float = 60.0, device=DEFAULT):
    """t -> Camera on a piecewise-linear loop through the waypoints, aimed
    at a fixed target."""
    device = resolve(device)
    wp = torch.as_tensor(waypoints, dtype=torch.float32, device=device)
    tgt = torch.as_tensor(look_at, dtype=torch.float32, device=device)
    k = wp.shape[0]

    def at(t) -> Camera:
        t = torch.as_tensor(t, dtype=torch.float32, device=device)
        u = torch.remainder(t / period, 1.0) * k
        i0 = torch.remainder(torch.floor(u).to(torch.int64), k)
        i1 = torch.remainder(i0 + 1, k)
        f = u - torch.floor(u)
        pos = wp[i0] * (1.0 - f) + wp[i1] * f
        cam = Camera.make((0.0, 0.0, 0.0), fov_y_deg=fov_y_deg, device=device)
        return dataclasses.replace(cam, pos=pos).look_at(tgt)

    return at


@dataclasses.dataclass(frozen=True)
class ImpulseEvent:
    """A scripted key press: an impulse (forward, right, up) in the
    camera's frame at time t."""

    t: float
    impulse: tuple[float, float, float]


def physics_path(start: Camera, events: Sequence[ImpulseEvent],
                 friction: float = 0.92, dt: float = 1.0 / 60.0,
                 yaw_rate: float = 0.0, pitch_rate: float = 0.0):
    """The reference's camera movement (velocity += impulse; velocity *=
    friction; pos += velocity dt) driven by a schedule of impulses.

    Returns steps(n) -> Camera whose tensors have a leading axis of n
    (the pose after each of n frames), computed by a plain loop."""
    f32 = dict(dtype=torch.float32, device=start.pos.device)
    ev_t = torch.tensor([e.t for e in events], **f32)
    ev_i = torch.tensor([e.impulse for e in events], **f32).reshape(-1, 3)

    def steps(n: int) -> Camera:
        pos, vel = start.pos, torch.zeros(3, **f32)
        yaw, pitch = start.yaw, start.pitch
        out = []
        for i in range(n):
            t = torch.tensor(float(i), **f32) * dt
            fire = (ev_t >= t) & (ev_t < t + dt)     # impulses in [t, t+dt)
            f, r, u = Camera(pos, yaw, pitch, start.fov_y).basis()
            imp = torch.sum(torch.where(
                fire[:, None],
                ev_i[:, 0:1] * f + ev_i[:, 1:2] * r + ev_i[:, 2:3] * u,
                0.0), dim=0)
            vel = (vel + imp) * friction
            pos = pos + vel * dt
            yaw = yaw + yaw_rate * dt
            pitch = pitch + pitch_rate * dt
            out.append((pos, yaw, pitch))
        return Camera(pos=torch.stack([c[0] for c in out]),
                      yaw=torch.stack([c[1] for c in out]),
                      pitch=torch.stack([c[2] for c in out]),
                      fov_y=start.fov_y.expand(n).clone())

    return steps
