"""The least time of a config-5 train step's work, whatever implements
it, on the peaks of ``bounds.py``: the bytes of ``bounds.fit_step_bytes``
(the [D^3, 4] float32 parameters and Adam's two moments, each read and
written once, and the rays and their target read once) and the float32
operations of the lit sample model, forward and backward, for every
sample of every ray.

The operations a sample were counted on ``reference/config5.py``'s
``render`` (lit, full shading) and frozen here: the float elements that
its arithmetic operations produce (views, gathers, copies and fills not
counted), over its samples, at 16^3 with 64 rays of 8 samples; the
backward's count adds the 32 additions a sample of the gradient's scatter
(8 corner rows of 4), which that count leaves out with the gathers.
"""

from __future__ import annotations

from vxbench.bounds import bound, fit_step_bytes

C5_OPS_FWD = 254            # float32 operations a sample, forward
C5_OPS_BWD = 274            # and backward (242 counted + 32 scattered)


def c5_step_work(D: int, rays: int, samples: int) -> dict:
    """Least time (ms) of a step of ``rays`` rays of ``samples`` samples
    over a D^3 grid."""
    return bound(fit_step_bytes(D, rays),
                 rays * samples * (C5_OPS_FWD + C5_OPS_BWD))
