"""Render configuration (counterpart of ``vxtpu/render/settings.py``).

vxtpu's TPU tuning knobs (``MarchTuning``) have no counterpart here."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """shading:    'flat' | 'lambert' | 'full' (lambert + Blinn-Phong).
    shadows:     march a shadow ray toward each light from the hit point.
    fog:         exponential distance fog toward the sky colour.
    max_steps:   DDA step budget; None -> derived from the grid dims
                 (X + Y + Z + 2: a ray crosses at most that many cell
                 boundaries).
    pyramid_levels: coarse occupancy levels the batched march
                 (``render/kernel_xla.py``) skips empty space with (0 =
                 plain fine DDA; 2 in config 3).
    step_chunk:  the batched march's steps between two checks of whether
                 every ray is done (each check is a host sync).
    ambient, specular_exp, specular_k, fog_density, sky_top, sky_horizon:
                 shading constants.
    """

    shading: str = "lambert"
    shadows: bool = False
    fog: bool = False
    max_steps: int | None = None
    pyramid_levels: int = 0
    step_chunk: int = 32
    ambient: float = 0.15
    specular_exp: float = 32.0
    specular_k: float = 0.35
    fog_density: float = 0.004
    sky_top: tuple[float, float, float] = (0.35, 0.55, 0.85)
    sky_horizon: tuple[float, float, float] = (0.80, 0.88, 0.95)

    def resolve_max_steps(self, dims: tuple[int, int, int]) -> int:
        """The DDA step budget that sizes the march's iteration cap."""
        if self.max_steps is not None:
            return self.max_steps
        return dims[0] + dims[1] + dims[2] + 2
