"""Per-pixel ray generation (counterpart of ``vxtpu/camera/rays.py``).

Pixel (row i, col j) of an H x W image, i down, j right; the ray passes
through the pixel centre and row 0 is the top of the image.
"""

from __future__ import annotations

import torch

from vxtpu_torch.camera.camera import Camera


def generate_rays(cam: Camera, height: int, width: int):
    """(origins [H*W, 3], unit directions [H*W, 3]) in row-major pixel
    order, on the camera's device."""
    forward, right, up = cam.basis()
    f32 = dict(dtype=torch.float32, device=cam.pos.device)
    i = (torch.arange(height, **f32) + 0.5) / height * 2.0 - 1.0
    j = (torch.arange(width, **f32) + 0.5) / width * 2.0 - 1.0
    tan_half = torch.tan(cam.fov_y * 0.5)
    aspect = width / height
    yy = -i * tan_half
    xx = j * tan_half * aspect
    d = (forward[None, None, :]
         + xx[None, :, None] * right[None, None, :]
         + yy[:, None, None] * up[None, None, :])
    norm = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2])
    d = d / norm[..., None]
    o = cam.pos.expand(height, width, 3)
    return o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
