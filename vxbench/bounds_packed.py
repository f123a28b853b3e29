"""The least time of the row-major march K5's own work
(``csrc/march_packed.cu:march_packed_kernel``, the composable pipeline's
march): each ray's inputs read once and its outputs written once, the
distinct words of the bricked 16-bit table that its march reads, read
once, and the march's float32 operations for each ray and iteration, on
the peaks of ``bounds.py``.

Ray I/O: o and d in (24 B); hit (1), t (4), voxel (12), normal (12) and
steps (4) out; a shadow ray also reads its t_max (4 B).
"""

from __future__ import annotations

from vxbench.bounds import MARCH_OPS_RAY, MARCH_OPS_STEP, bound

PRIMARY_RAY_BYTES = 24 + 33
SHADOW_RAY_BYTES = 24 + 4 + 33
WORD_BYTES = 2              # a word of the bricked 16-bit table


def k5_work(rays: int, shadow_rays: int, steps: int, words: int) -> dict:
    """Least time (ms) of the K5 launches that march ``rays`` primary and
    ``shadow_rays`` shadow rays in ``steps`` iterations in all and read
    ``words`` distinct table words (summed over the launches)."""
    return bound(PRIMARY_RAY_BYTES * rays + SHADOW_RAY_BYTES * shadow_rays
                 + WORD_BYTES * words,
                 (rays + shadow_rays) * MARCH_OPS_RAY
                 + steps * MARCH_OPS_STEP)
