"""Losses and metrics of the inverse-rendering loop (counterpart of
``vxtpu/train/loss.py``)."""

from __future__ import annotations

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse(pred, target), min=1e-12))


def tv_loss(vol: torch.Tensor) -> torch.Tensor:
    """Total variation over a [X,Y,Z] or channel-major [C,X,Y,Z] volume
    (the spatial axes are the last three)."""
    dx = torch.diff(vol, dim=-3)
    dy = torch.diff(vol, dim=-2)
    dz = torch.diff(vol, dim=-1)
    return (torch.mean(dx ** 2) + torch.mean(dy ** 2)
            + torch.mean(dz ** 2)) / 3.0


def tv_loss_morton(table: torch.Tensor) -> torch.Tensor:
    """TV-style prior on a flat fine-voxel Morton table [D^3] (or
    [C, D^3]) with no re-layout: the even-parity neighbour pairs only. In
    Morton order the (x, x+1) pair with x even differs in bit 0 of the
    index (bit 1 for y, bit 2 for z), so each aligned group of 8 words is
    a 2x2x2 block; half the pairs of tv_loss at twice the weight (vxtpu's
    regulariser variant, not tv_loss itself)."""
    t = table.reshape(table.shape[:-1] + (-1, 16, 2, 2, 2))
    dx = t[..., 1] - t[..., 0]                       # index bit 0 = x
    dy = t[..., 1, :] - t[..., 0, :]                 # index bit 1 = y
    dz = t[..., 1, :, :] - t[..., 0, :, :]           # index bit 2 = z
    return 2.0 * (torch.mean(dx ** 2) + torch.mean(dy ** 2)
                  + torch.mean(dz ** 2)) / 3.0


def tv_prior_morton(tab: torch.Tensor, tv_sigma: float,
                    tv_rgb: float) -> torch.Tensor:
    """``tv_sigma * tv_loss_morton(sigma) + tv_rgb * tv_loss_morton(rgb)``
    on the channel-interleaved Morton table [D^3, 4] (channel 0 sigma,
    1-3 rgb) with no re-layout: the rgb term is the mean over its three
    channels, as ``tv_loss_morton`` of the planar [3, D^3] table takes
    it."""
    t = tab.reshape(-1, 2, 2, 2, tab.shape[-1])     # z, y, x index bits
    dx = t[:, :, :, 1] - t[:, :, :, 0]
    dy = t[:, :, 1] - t[:, :, 0]
    dz = t[:, 1] - t[:, 0]
    per = sum(torch.mean(x ** 2, dim=(0, 1, 2)) for x in (dx, dy, dz))
    return 2.0 * (tv_sigma * per[0] + tv_rgb * torch.mean(per[1:])) / 3.0
