"""The single-device part of ``vxtpu/engine/sharding.py``: camera-frame
rays and the occupancy-band bounds pass of the masked train step. The
sharded render and train step over ``torch.distributed`` are not ported
yet (ROADMAP.md queue 1 #14)."""

from __future__ import annotations

import torch

from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.camera.rays import generate_rays
from vxtpu_torch.render.occmask import mask_segment_bounds


def _world_rays(cam: Camera, o_c: torch.Tensor, d_c: torch.Tensor):
    """Camera-frame rays -> world rays (the train step and the bounds pass
    see the same geometry)."""
    fwd, right, up = cam.basis()
    R = torch.stack([fwd, right, up], dim=1)          # [3 (world), 3 (cam)]
    return cam.pos.expand(o_c.shape) + o_c, d_c @ R.t()


def compute_mask_bounds(mask, mask_df, cam: Camera, o_c, d_c,
                        mask_scale: int = 4):
    """Occupancy-band bounds (t0, t1) of the masked train step for the
    current camera: run once a step, before the step."""
    o_w, d_w = _world_rays(cam, o_c, d_c)
    return mask_segment_bounds(mask, mask_scale, o_w, d_w, df_flat=mask_df)


def camera_frame_rays(cam: Camera, height: int, width: int):
    """Rays in camera-relative form: zero origin offsets and directions as
    coefficients of the (forward, right, up) basis, so a step that turns
    them back into world rays keeps the pose differentiable."""
    o, d = generate_rays(cam, height, width)
    fwd, right, up = cam.basis()
    R = torch.stack([fwd, right, up], dim=1)
    return torch.zeros_like(o), d @ R
