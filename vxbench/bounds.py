"""Peaks of one NVIDIA H100 (SXM, NVIDIA's data sheet, dense rates) and
the least time of a piece of work: the larger of its bytes over the HBM
rate and its float32 operations over the float32 peak.

Frozen from ``chip_smoke.py`` (``PEAK_BYTES``, ``PEAK_F32``, ``_bound``
and the march's operation counts, which ``k1_bound`` counts a ray, a
shadow ray and a DDA step), so that a later change to the program cannot
move the yardstick.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12        # HBM3, bytes/s
PEAK_F32 = 67e12            # float32 outside the tensor cores, FLOP/s

# float32 operations of the DDA march: per ray (set-up and shading) and
# per DDA step, for primary and shadow rays alike
MARCH_OPS_RAY, MARCH_OPS_STEP = 60, 20

# bytes of one image pixel written (float32 rgb)
PIXEL_BYTES = 12
# bytes of one occupancy table word (int16)
TABLE_WORD_BYTES = 2


def bound(nbytes: float, ops: float) -> dict:
    """Least time (ms) of work that moves ``nbytes`` and runs ``ops``
    float32 operations, and what bounds it."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return dict(bytes=nbytes, ops=ops, bound_ms=max(tb, tf),
                bound_by="bytes" if tb >= tf else "operations")


def frame_work(pixels: int, table_words: int, rays: int, shadow_rays: int,
               steps: int) -> dict:
    """Least time (ms) of a frame's work, whatever kernels do it: the
    image written once, the distinct table words its rays read, read
    once, and the march's operations for every ray, shadow ray and DDA
    step."""
    return bound(PIXEL_BYTES * pixels + TABLE_WORD_BYTES * table_words,
                 (rays + shadow_rays) * MARCH_OPS_RAY
                 + steps * MARCH_OPS_STEP)


def fit_step_bytes(D: int, rays: int) -> int:
    """The least bytes a step of the soft fit moves: the [D^3, 4] float32
    table and Adam's two moments, each read once and written once, and
    the rays (origin, direction) and their target rgb read once."""
    return 6 * D ** 3 * 16 + rays * (24 + 12)
