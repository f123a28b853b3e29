"""vxtpu_torch's config-5 run (train/config5.py) against vxtpu's
run_config5 at tests/test_config5.py's CFG (16^3, 8x8 rays, 3 frames x 2
steps), its resume (from its own checkpoint and from the one vxtpu's run
wrote), 2 gloo ranks against 1, and the config5 command
(dryrun_multichip(2) is in tests/test_torch_platform.py).

Tolerances (vxtpu's own sharded-against-single-device ones): losses rtol
2e-4, PSNRs rtol 2e-3; pose errors within 2e-4 rad. The port's runs
against each other: losses rtol 1e-5.

The comparisons with vxtpu run CFG unlit (shading 'flat'). Lit, a run
from the zero grid is ill-conditioned: every density gradient is zero,
so every normal -g / sqrt(|g|^2 + 1e-9) sits where its derivative is
3.2e4, and on the one cell whose x corners coincide at the high face the
two packages' float sums of those large terms leave four voxels'
gradients with opposite signs; Adam's step magnifies that, and frame 2's
loss differs by 5.2e-4 (frames 1 and 3 by at most 3.2e-5). Unlit, every
frame agrees within 3e-6. The lit path is held to vxtpu where it is well
conditioned: tests/test_torch_vjp.py and tests/test_torch_sharding.py.
vxtpu's frame renders are jitted here, as its train step already is:
eager, its shard_map render compiles anew on every call (~35 s a frame
on a CPU)."""

import os
import shutil

import numpy as np
import pytest
import torch

from vxtpu_torch.engine import platform
from vxtpu_torch.render.settings import RenderSettings
from vxtpu_torch.train.config5 import Config5, run_config5

CPU = torch.device("cpu")
CFG = Config5(dims=(16, 16, 16), height=8, width=8, num_samples=24,
              frames=3, steps_per_frame=2, fps=24.0, lr=1e-1, cam_lr=1e-2,
              pose_error=0.05, ckpt_every=2, seed=3)


def _port(out_dir=None, resume=None, end_frame=None,
          shading="lambert") -> dict:
    """The port's run on a 1-rank group of this process."""
    from vxtpu_torch.engine.sharding import make_mesh

    platform.init_multihost(device=CPU)
    try:
        res = run_config5(CFG, RenderSettings(shading=shading),
                          mesh=make_mesh(),
                          out_dir=out_dir, resume=resume,
                          end_frame=end_frame)
    finally:
        platform.shutdown()
    return {k: res[k] for k in ("losses", "psnrs", "yaw_err", "pitch_err")}


def _two_ranks() -> dict:
    from vxtpu_torch.engine.sharding import make_mesh

    res = run_config5(CFG, RenderSettings(), mesh=make_mesh())
    return {k: res[k] for k in ("losses", "psnrs", "yaw_err", "pitch_err")}


def _vxtpu_run(tmp, monkeypatch):
    """vxtpu's unlit run with checkpoints; a sink that keeps a copy of the
    checkpoint written after frame 2 (the emission of frame 3 comes
    before that frame's own save)."""
    import jax

    from vxtpu.engine import sharding as jsharding
    from vxtpu.render.settings import RenderSettings as JSettings
    from vxtpu.train import config5 as jconfig5
    from vxtpu.train.config5 import Config5 as JConfig5
    from vxtpu.train.config5 import run_config5 as jrun

    monkeypatch.setattr(jconfig5, "render_soft_image_sharded", jax.jit(
        jsharding.render_soft_image_sharded, static_argnums=(2, 3, 4, 5, 6)))

    class Sink:
        def emit(self, frame, **kv):
            if frame == 2:
                shutil.copy(tmp / "ckpt.npz", tmp / "ckpt_frame2.npz")

    jcfg = JConfig5(**CFG.__dict__)
    return jrun(jcfg, JSettings(shading="flat"),
                mesh=jsharding.make_mesh(1), out_dir=str(tmp), sink=Sink())


def _agree(got, want, rtol=2e-4):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol,
                               atol=1e-6)
    np.testing.assert_allclose(got["psnrs"], want["psnrs"], rtol=2e-3)
    for k in ("yaw_err", "pitch_err"):
        assert got[k] == pytest.approx(want[k], abs=2e-4), k


def test_run_config5_and_resume_match_vxtpu(tmp_path, monkeypatch):
    want = _vxtpu_run(tmp_path, monkeypatch)
    got = _port(shading="flat")
    print(f"vxtpu {want['losses']} {want['psnrs']}; vxtpu_torch "
          f"{got['losses']} {got['psnrs']}")
    _agree(got, want)
    assert all(np.isfinite(got["losses"]))
    assert abs(got["yaw_err"]) < CFG.pose_error

    # resume from the checkpoint vxtpu wrote after frame 2: the port's
    # third frame against vxtpu's uninterrupted one
    res = _port(resume=str(tmp_path / "ckpt_frame2.npz"), shading="flat")
    assert len(res["losses"]) == 1
    assert res["losses"][0] == pytest.approx(want["losses"][2], rel=2e-4)
    assert res["psnrs"][0] == pytest.approx(want["psnrs"][2], rel=2e-3)
    assert res["yaw_err"] == pytest.approx(want["yaw_err"], abs=2e-4)


@pytest.fixture(scope="module")
def lit_run(tmp_path_factory):
    """The port's lit run of CFG on 1 rank, with its checkpoints."""
    out = tmp_path_factory.mktemp("full")
    res = _port(out_dir=str(out))
    assert os.path.exists(out / "ckpt.npz")
    return res


def test_resume_equals_uninterrupted(tmp_path, lit_run):
    full = lit_run
    first = _port(out_dir=str(tmp_path / "cut"), end_frame=2)
    assert first["losses"] == full["losses"][:2]
    res = _port(resume=str(tmp_path / "cut" / "ckpt.npz"))
    np.testing.assert_allclose(res["losses"], full["losses"][2:], rtol=1e-5)
    assert res["yaw_err"] == pytest.approx(full["yaw_err"], abs=1e-6)


def test_two_gloo_ranks_equal_one_rank(lit_run):
    one = lit_run
    outs = platform.run_local(2, _two_ranks, backend="gloo", device="cpu",
                              timeout=60)
    for out in outs:
        _agree(out, one, rtol=1e-5)


def test_config5_command(tmp_path, capsys):
    import json

    from vxtpu_torch.app import run

    try:
        assert run.main(["config5", "--device", "cpu", "--dims", "16",
                         "--height", "8", "--width", "8", "--samples", "8",
                         "--frames", "2", "--out", str(tmp_path)]) == 0
    finally:
        platform.shutdown()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "config5_final_psnr" and line["frames"] == 2
    assert np.isfinite(line["final_loss"])
    assert (tmp_path / "ckpt.npz").exists()
