"""Render configuration (counterpart of ``vxtpu/render/settings.py``).

vxtpu's TPU tuning knobs (``MarchTuning``), the fields only its XLA
marches read (``pyramid_levels``, ``step_chunk``) and the ``max_steps``
override no caller sets have no counterpart here."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """shading:    'flat' | 'lambert' | 'full' (lambert + Blinn-Phong).
    shadows:     march a shadow ray toward each light from the hit point.
    fog:         exponential distance fog toward the sky colour.
    ambient, specular_exp, specular_k, fog_density, sky_top, sky_horizon:
                 shading constants.
    """

    shading: str = "lambert"
    shadows: bool = False
    fog: bool = False
    ambient: float = 0.15
    specular_exp: float = 32.0
    specular_k: float = 0.35
    fog_density: float = 0.004
    sky_top: tuple[float, float, float] = (0.35, 0.55, 0.85)
    sky_horizon: tuple[float, float, float] = (0.80, 0.88, 0.95)

    def resolve_max_steps(self, dims: tuple[int, int, int]) -> int:
        """The DDA step budget that sizes the march's iteration cap: a ray
        crosses at most X + Y + Z cell boundaries."""
        return dims[0] + dims[1] + dims[2] + 2
