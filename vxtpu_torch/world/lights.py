"""Point lights as a struct of tensors (counterpart of
``vxtpu/world/lights.py``)."""

from __future__ import annotations

import dataclasses

import torch

from vxtpu_torch.device import DEFAULT, resolve


@dataclasses.dataclass(frozen=True)
class Lights:
    """L point lights; every tensor has leading dim L (L may be 0).

    pos: float32 [L, 3]; rgb: float32 [L, 3]; intensity: float32 [L]."""

    pos: torch.Tensor
    rgb: torch.Tensor
    intensity: torch.Tensor

    @property
    def count(self) -> int:
        return self.pos.shape[0]

    @staticmethod
    def single(pos, rgb=(1.0, 1.0, 1.0), intensity=1.0,
               device=DEFAULT) -> "Lights":
        return Lights.make([pos], [rgb], [intensity], device=device)

    @staticmethod
    def none(device=DEFAULT) -> "Lights":
        return Lights.make([], [], [], device=device)

    @staticmethod
    def make(pos_list, rgb_list, intensity_list,
             device=DEFAULT) -> "Lights":
        f32 = dict(dtype=torch.float32, device=resolve(device))
        return Lights(
            pos=torch.tensor(pos_list, **f32).reshape(-1, 3),
            rgb=torch.tensor(rgb_list, **f32).reshape(-1, 3),
            intensity=torch.tensor(intensity_list, **f32).reshape(-1),
        )
