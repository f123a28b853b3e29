"""Camera poses along the traffic's paths, and the rays of a pose.

A frozen copy of the formulas of ``vxtpu_torch/camera/paths.py`` (orbit,
flythrough), ``camera/camera.py`` (look_at, basis) and
``camera/rays.py`` (one ray through each pixel centre, row 0 on top), in
the same order of operations. The drivers hand the program the path's
parameters and the plain references compute the poses here, so a fault
in the program's poses or rays shows in the comparison.
"""

from __future__ import annotations

import math

import torch


def look_at(pos: torch.Tensor, target: torch.Tensor):
    """(yaw, pitch) of a camera at pos aimed at target."""
    tv = target - pos
    yaw = torch.atan2(tv[1], tv[0])
    pitch = torch.atan2(tv[2], torch.sqrt(tv[0] * tv[0] + tv[1] * tv[1]))
    return yaw, pitch


def orbit_pos(center: torch.Tensor, radius: float, height: float,
              period: float, t: float) -> torch.Tensor:
    tt = torch.as_tensor(t, dtype=torch.float32, device=center.device)
    ang = 2.0 * math.pi * tt / period
    return center + torch.stack([
        radius * torch.cos(ang), radius * torch.sin(ang),
        torch.tensor(height, dtype=torch.float32, device=center.device)])


def flythrough_pos(waypoints: torch.Tensor, period: float,
                   t: float) -> torch.Tensor:
    k = waypoints.shape[0]
    tt = torch.as_tensor(t, dtype=torch.float32, device=waypoints.device)
    u = torch.remainder(tt / period, 1.0) * k
    i0 = torch.remainder(torch.floor(u).to(torch.int64), k)
    i1 = torch.remainder(i0 + 1, k)
    f = u - torch.floor(u)
    return waypoints[i0] * (1.0 - f) + waypoints[i1] * f


def pose(traffic: dict, dims, top: int, t: float, device):
    """(pos, yaw, pitch, fov_y) at camera time t of the traffic's path:
    ``orbit`` (centre, radius, height as shares of the grid) aimed at its
    centre, or ``flythrough`` (waypoints as shares of X and Y, at
    ``altitude`` voxels above the terrain's top) aimed at a point over
    the grid's centre ``look_below`` x Z under the camera's altitude."""
    X, Y, Z = dims
    f32 = dict(dtype=torch.float32, device=device)
    fov = torch.as_tensor(float(traffic["fov_deg"]), **f32) * (math.pi
                                                               / 180.0)
    args = path_args(traffic, dims, top)
    if traffic["path"] == "orbit":
        center = torch.as_tensor(args["center"], **f32)
        pos = orbit_pos(center, args["radius"], args["height"],
                        args["period"], t)
        target = center
    else:
        wp = torch.as_tensor(args["waypoints"], **f32)
        pos = flythrough_pos(wp, args["period"], t)
        target = torch.as_tensor(args["look_at"], **f32)
    yaw, pitch = look_at(pos, target)
    return pos, yaw, pitch, fov


def path_args(traffic: dict, dims, top: int) -> dict:
    """The path's parameters in world units, as the program's
    ``camera/paths.py`` functions take them."""
    X, Y, Z = dims
    if traffic["path"] == "orbit":
        c = traffic["center"]
        return dict(center=(c[0] * X, c[1] * Y, c[2] * Z),
                    radius=traffic["radius"] * X,
                    height=traffic["height"] * Z,
                    period=float(traffic["period_s"]),
                    fov_y_deg=float(traffic["fov_deg"]))
    if traffic["path"] == "flythrough":
        alt = float(top + traffic["altitude"])
        wp = [(a * X, b * Y, alt) for a, b in traffic["waypoints"]]
        return dict(waypoints=wp,
                    look_at=(0.5 * X, 0.5 * Y,
                             alt - traffic["look_below"] * Z),
                    period=float(traffic["period_s"]),
                    fov_y_deg=float(traffic["fov_deg"]))
    raise ValueError(f"unknown camera path {traffic['path']!r}")


def basis(yaw: torch.Tensor, pitch: torch.Tensor):
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    forward = torch.stack([cp * cy, cp * sy, sp])
    right = torch.stack([sy, -cy, torch.zeros_like(sy)])
    up = torch.stack([
        right[1] * forward[2] - right[2] * forward[1],
        right[2] * forward[0] - right[0] * forward[2],
        right[0] * forward[1] - right[1] * forward[0],
    ])
    return forward, right, up


def rays(pos, yaw, pitch, fov, height: int, width: int):
    """(origins [H*W, 3], unit directions [H*W, 3]) float32, row-major."""
    forward, right, up = basis(yaw, pitch)
    f32 = dict(dtype=torch.float32, device=pos.device)
    i = (torch.arange(height, **f32) + 0.5) / height * 2.0 - 1.0
    j = (torch.arange(width, **f32) + 0.5) / width * 2.0 - 1.0
    tan_half = torch.tan(fov * 0.5)
    aspect = width / height
    yy = -i * tan_half
    xx = j * tan_half * aspect
    d = (forward[None, None, :] + xx[None, :, None] * right[None, None, :]
         + yy[:, None, None] * up[None, None, :])
    norm = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2])
    d = d / norm[..., None]
    o = pos.expand(height, width, 3)
    return o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
