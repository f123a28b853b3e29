"""vxtpu_torch's camera paths and light schedules (camera/paths.py,
app/schedule.py) against vxtpu's: flythrough, physics_path (vxtpu's
jitted scan, the port's plain loop), orbiting_light and Schedule.
Tolerance: rtol 1e-5 / atol 1e-5 (float32 trigonometry and sums)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vxtpu.app import schedule as jschedule
from vxtpu.camera import paths as jpaths
from vxtpu.camera.camera import Camera as JCamera
from vxtpu_torch import convert
from vxtpu_torch.app import schedule
from vxtpu_torch.camera import paths

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
WAYPOINTS = [(0.0, 0.0, 10.0), (30.0, 5.0, 12.0), (20.0, 40.0, 20.0),
             (-5.0, 25.0, 8.0)]


def _same_camera(got, want):
    for f in ("pos", "yaw", "pitch", "fov_y"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), **TOL,
                                   err_msg=f)


@pytest.mark.parametrize("t", [0.0, 1.3, 4.99, 7.5, 12.25])
def test_flythrough_matches_vxtpu(t):
    want = jpaths.flythrough(WAYPOINTS, (16.0, 16.0, 4.0), period=10.0,
                             fov_y_deg=50.0)(jnp.float32(t))
    got = paths.flythrough(WAYPOINTS, (16.0, 16.0, 4.0), period=10.0,
                           fov_y_deg=50.0, device=CPU)(t)
    _same_camera(got, want)


@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.4, -0.2)])
def test_physics_path_matches_vxtpu(rates):
    events = [jpaths.ImpulseEvent(t=0.0, impulse=(5.0, 0.0, 0.0)),
              jpaths.ImpulseEvent(t=0.05, impulse=(0.0, 3.0, 1.0)),
              jpaths.ImpulseEvent(t=0.2, impulse=(-2.0, 0.0, 4.0))]
    jstart = JCamera.make((1.0, 2.0, 3.0), yaw=0.3, pitch=-0.1)
    want = jpaths.physics_path(jstart, events, yaw_rate=rates[0],
                               pitch_rate=rates[1])(30)
    start = convert.camera_from_numpy(jstart.pos, jstart.yaw, jstart.pitch,
                                      jstart.fov_y, device=CPU)
    got = paths.physics_path(
        start, [paths.ImpulseEvent(e.t, e.impulse) for e in events],
        yaw_rate=rates[0], pitch_rate=rates[1])(30)
    assert got.pos.shape == (30, 3) and got.fov_y.shape == (30,)
    _same_camera(got, want)


def test_orbiting_light_and_schedule_match_vxtpu():
    jl = jschedule.orbiting_light((8.0, 8.0, 4.0), 20.0, 30.0, period=3.0)
    tl = schedule.orbiting_light((8.0, 8.0, 4.0), 20.0, 30.0, period=3.0,
                                 device=CPU)
    jcam = jpaths.orbit((8.0, 8.0, 4.0), 25.0, 20.0, period=4.0)
    tcam = paths.orbit((8.0, 8.0, 4.0), 25.0, 20.0, period=4.0, device=CPU)
    js = jschedule.Schedule(jcam, jl, fps=24.0)
    ts = schedule.Schedule(tcam, tl, fps=24.0)
    for frame in (0, 7, 50):
        (jc, jlt), (tc, tlt) = js.frame_state(frame), ts.frame_state(frame)
        _same_camera(tc, jc)
        for f in ("pos", "rgb", "intensity"):
            np.testing.assert_allclose(getattr(tlt, f).numpy(),
                                       np.asarray(getattr(jlt, f)), **TOL)
    static = schedule.static_lights(tl(0.0))
    assert static(5.0) is static(0.0)
