"""Parity: vxtpu_torch's camera and rays against vxtpu's."""

import numpy as np
import pytest
import torch

from vxtpu.camera.camera import Camera as JCamera
from vxtpu.camera.rays import generate_rays as jgenerate_rays
from vxtpu_torch import convert
from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.camera.rays import generate_rays


CPU = torch.device("cpu")


def cameras(cls, **kw):
    return {
        "outside": cls.make(pos=(-20.0, 16.0, 40.0), **kw).look_at(
            (16.0, 16.0, 12.0)),
        "inside": cls.make(pos=(16.0, 16.0, 28.0), yaw=2.2, pitch=-0.5, **kw),
        "bench": cls.make(pos=(-360.0, 256.0, 560.0),
                          fov_y_deg=55.0, **kw).look_at((256.0, 256.0, 140.0)),
    }


@pytest.mark.parametrize("name", ["outside", "inside", "bench"])
def test_rays_match_vxtpu(name):
    jcam = cameras(JCamera)[name]
    cam = cameras(Camera, device=CPU)[name]
    for f in ("pos", "yaw", "pitch", "fov_y"):
        np.testing.assert_allclose(getattr(cam, f).numpy(),
                                   np.asarray(getattr(jcam, f)), atol=1e-6)
    jo, jd = jgenerate_rays(jcam, 32, 64)
    o, d = generate_rays(cam, 32, 64)
    assert o.shape == d.shape == (32 * 64, 3)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)


def test_camera_from_numpy_gives_same_rays():
    jcam = cameras(JCamera)["outside"]
    cam = convert.camera_from_numpy(np.asarray(jcam.pos), np.asarray(jcam.yaw),
                                    np.asarray(jcam.pitch),
                                    np.asarray(jcam.fov_y), device=CPU)
    _, jd = jgenerate_rays(jcam, 16, 16)
    _, d = generate_rays(cam, 16, 16)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
