"""vxtpu_torch's platform checks and process group (engine/platform.py):
validate_platform's refusals, init_multihost's 1-rank group, its
idempotence and its refusal to go on alone after a failed init, the
info command, the scaling command on 2 gloo ranks, and
dryrun_multichip(2) (config 5's composition, the masked step, the
sharded fused frame and field-kernel step on 2 gloo ranks). Each group
runs in a process spawned for it (run_local, or a spawn-context
process), so this process never holds one."""

import json
import multiprocessing as mp
import os

import pytest
import torch

from vxtpu_torch.engine import platform

CPU = torch.device("cpu")


def test_validate_platform_refuses_an_oversized_scene():
    scene = {"sigma": torch.zeros(1024, 1024, dtype=torch.float32)}
    info = platform.validate_platform(scene, device=CPU)
    assert info.backend == "cpu" and info.num_hosts == 1
    with pytest.raises(RuntimeError, match="scene needs"):
        platform.validate_platform(scene, hbm_headroom=1e-6, device=CPU)


def test_validate_platform_refuses_a_mesh_larger_than_the_world():
    with pytest.raises(RuntimeError, match="mesh of 2 ranks"):
        platform.validate_platform(mesh_devices=2, device=CPU)


def _twice_alone() -> dict:
    """In a fresh process with no launcher environment: two calls."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        os.environ.pop(k, None)
    import torch.distributed as dist

    a = platform.init_multihost(device="cpu")
    group = dist.group.WORLD
    b = platform.init_multihost(device="cpu")
    out = dict(a=a.num_hosts, b=b.num_hosts, rank=dist.get_rank(),
               same=dist.group.WORLD is group,
               backend=dist.get_backend())
    platform.shutdown()
    return out


def _child(fn, queue):
    queue.put(fn())


def _in_fresh_process(fn):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_child, args=(fn, q))
    p.start()
    try:
        return q.get(timeout=60)
    finally:
        p.join(10)
        if p.is_alive():
            p.terminate()


def test_init_multihost_alone_is_a_one_rank_group_and_idempotent():
    out = _in_fresh_process(_twice_alone)
    assert out == dict(a=1, b=1, rank=0, same=True, backend="gloo")


def test_init_multihost_in_run_local_sees_the_world():
    import torch.distributed as dist  # noqa: F401

    outs = platform.run_local(2, platform.platform_report, backend="gloo",
                              device="cpu", timeout=60, args=("cpu",))
    assert [o["num_hosts"] for o in outs] == [2, 2]


def _fails() -> str:
    """init_process_group raising (here for a backend that does not
    exist)."""
    try:
        platform.init_multihost(backend="no-such-backend", device="cpu")
    except RuntimeError as e:
        import torch.distributed as dist

        return f"{dist.is_initialized()} {e}"
    return "no error"


def test_a_failed_init_raises_and_leaves_no_group():
    out = _in_fresh_process(_fails)
    assert out.startswith("False "), out
    assert "refusing to continue as independent single-host replicas" in out


def test_info_prints_json(capsys):
    from vxtpu_torch.app import run

    assert run.main(["info", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["backend"] == "cpu" and rep["num_hosts"] == 1
    assert set(rep) == {"backend", "device_kind", "num_devices",
                        "num_hosts", "hbm_bytes", "capability"}


def test_no_gpu_here_raises_rather_than_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        platform.platform_info()


def test_dryrun_multichip_on_two_gloo_ranks():
    import numpy as np

    from vxtpu_torch.app.dryrun import dryrun_multichip

    res = dryrun_multichip(2, device="cpu")
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    assert np.isfinite(res["masked_loss"]) and np.isfinite(res["field_loss"])


def _scaling_lines() -> list:
    import contextlib
    import io

    from vxtpu_torch.app import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run.main(["scaling", "--device", "cpu", "--kernel", "xla",
                         "--dims", "16", "--height", "16", "--width", "16",
                         "--iters", "1"]) == 0
    return buf.getvalue().splitlines()


def test_scaling_on_two_gloo_ranks():
    """The scaling command in a 2-rank group: one line per sub-group (1
    and 2 ranks) from rank 0, none from rank 1."""
    outs = platform.run_local(2, _scaling_lines, backend="gloo",
                              device="cpu", timeout=60)
    rows = [json.loads(x) for x in outs[0]]
    assert [r["devices"] for r in rows] == [1, 2] and outs[1] == []
    assert rows[0]["efficiency"] == 1.0 and rows[1]["mrays"] > 0
