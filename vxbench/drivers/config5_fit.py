"""Config 5 through the port's own run: one ``train/config5.py:run_config5``
call on a one-rank mesh, as ``python -m vxtpu_torch config5`` runs it on
one card (no checkpoint written): from the zero grid, every frame of the
orbit renders its target from the truth, takes its steps on the grid and
the pose estimate through the custom backward, and renders its PSNR frame.

Set-up: imports, the process group and frame 0, which holds every first
use (the NCCL group's first collective, the Adam kernel's nvcc). The
window opens at frame 0's end and closes at the end of the first whole
frame at or past ``--seconds``; ``train_step_ms`` is its seconds over its
steps. The harness sees the run through the program's own interfaces:
``step_hook`` (a ``Config5Step`` after every step) and the metrics sink,
which ``run_config5`` calls at each frame's end and which ends the run by
raising.

Checked: the frame after the window. At its start (the window's end)
the program's state is copied: the grid, the pose estimate, Adam's
moments and step count. The plain reference (``reference/config5.py``)
then follows that frame from the copy and is compared with what the
program did in it: ``target_gap`` (the frame's target against the
reference's render of the truth, relative L2), ``loss_gap`` (both steps'
losses), ``grad_gap`` (the first step's gradient by leaf, which the
program's Adam moments before and after the step give) and
``change_gap`` (the change of the grid and the pose over the frame, from
the pose the reference starts the frame at), the last two by the worst
leaf against the larger of its own and the median leaf's reference norm.
A traced run profiles the checked frame whole, the program's spans and
counters with it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import torch

from vxbench import camera
from vxbench.drivers import (Clock, Outcome, Run, check, gap, log, peak_bytes,
                             sync)
from vxbench.drivers.soft_fit import leaf_gap
from vxbench import launches
from vxbench.launches import LaunchWindow
from vxbench.reference import config5 as ref


class RunEnds(Exception):
    """Raised by the sink once the checked frame has ended."""


def config5_fields(r: Run) -> dict:
    """Config5's fields: the configuration's, the truth from the run's
    seed, and the tests' sizes."""
    c5 = dict(r.cell.config["config5"])
    c5["dims"] = tuple(r.sizes.get("dims", c5["dims"]))
    for k in ("height", "width", "num_samples", "frames", "lit"):
        c5[k] = r.sizes.get(k, c5[k])
    c5["seed"] = r.seed
    return c5


def effective(cfg: dict, c5) -> dict:
    """The configuration with the Config5 fields the run used (the tests'
    sizes), as the reference reads it."""
    return dict(cfg, config5=dataclasses.asdict(c5))


def _table(sigma, rgb):
    """[D^3, 4] row-major (sigma, r, g, b) of planar sigma [X, Y, Z] and
    rgb [3, X, Y, Z] (the reference's layout)."""
    return torch.cat([sigma.reshape(-1, 1), rgb.reshape(3, -1).t()], dim=1)


def snapshot(info) -> dict:
    """The program's state after a step, copied: the grid as a [D^3, 4]
    table, the camera (pos, yaw, pitch, fov_y), Adam's moments in the
    same layouts and its step count."""
    st = info.state
    grid, cam = st.params, st.cam_params
    opt = st.opt.state

    def moment(key):
        return ([_table(*(opt[p][key] for p in grid))]
                + [opt[p][key].clone() for p in cam])

    steps = {int(opt[p]["step"]) for p in grid + cam}
    if len(steps) != 1:
        raise RuntimeError(f"Adam's step counts differ by leaf: {steps}")
    return dict(tab=_table(*(p.detach() for p in grid)),
                cam=[p.detach().clone() for p in cam],
                m=moment("exp_avg"), v=moment("exp_avg_sq"),
                steps=steps.pop(), frame=info.frame)


def _first_moments(state) -> list:
    return [state.opt.state[p]["exp_avg"].clone()
            for p in state.params + state.cam_params]


def program_run(r: Run, until_start: bool = False) -> dict:
    """The program's run of the cell: the window's numbers, the copy of
    the state the checked frame starts from (``start``) and, unless
    ``until_start`` (which ends the run there), the program's numbers of
    that frame and the traced frame's context. Leaves the process group
    and frees the program's state."""
    clock = Clock(r.t_start)
    from vxtpu_torch.engine import platform, sharding
    from vxtpu_torch.render import vjp
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.train import config5 as c5mod
    clock.mark("import")

    cfg, dev = r.cell.config, r.device
    c5 = c5mod.Config5(**config5_fields(r))
    settings = RenderSettings(**cfg["settings"])
    platform.init_multihost(device=dev)
    mesh = sharding.make_mesh()
    spf, warm = c5.steps_per_frame, int(r.cell.traffic["warm_frames"])
    clock.mark("group")

    st: dict = {"losses": []}
    win = LaunchWindow() if r.trace and not until_start else None

    def hook(info):
        st["last"] = info
        if info.frame != st.get("checked"):
            return
        # the checked frame: copies only, no host sync
        st["losses"].append(info.loss.detach().clone())
        if info.step == 0:
            st["m_after0"] = _first_moments(info.state)
            st["target"] = info.target

    class Sink:
        def emit(self, frame, **kv):
            if frame < warm - 1:
                return
            if frame == warm - 1:
                sync(dev)
                st["setup_s"] = time.perf_counter() - r.t_start
                clock.mark("warm")
                st["w0"] = time.perf_counter()
            elif "checked" not in st:
                if time.perf_counter() - st["w0"] < r.seconds:
                    return
                sync(dev)
                st["w1"] = time.perf_counter()
                st["steps"] = (frame + 1 - warm) * spf
                st["peak"] = peak_bytes(dev)
                st["start"] = snapshot(st["last"])
                st["checked"] = frame + 1
                sync(dev)
                if until_start:
                    raise RunEnds
                if win is not None:
                    vjp.reset_counts()
                    win.__enter__()
            elif frame == st["checked"]:
                sync(dev)
                if win is not None:
                    t = time.perf_counter()
                    win.__exit__(None, None, None)
                    st["counts"] = dict(vjp.COUNTS)
                    log(f"traced frame: {len(win.ops)} device operations, "
                        f"read in {time.perf_counter() - t!r} s")
                raise RunEnds

    try:
        with _planted(r.faults):
            c5mod.run_config5(c5, settings, mesh=mesh, sink=Sink(),
                              step_hook=hook)
        raise RuntimeError("run_config5 ended before the checked frame: "
                           "the window needs more of the orbit's "
                           f"{c5.frames} frames")
    except RunEnds:
        pass
    clock.mark("run")
    last = st.pop("last")
    out = dict(c5=c5, cfg=effective(cfg, c5), start=st["start"],
               steps=st["steps"], window_s=st["w1"] - st["w0"],
               setup_s=st["setup_s"], peak=st["peak"], clock=clock)
    if not until_start:
        out["prog"] = dict(
            losses=[float(x) for x in st["losses"]],
            g0=_grad_norms(st["m_after0"], st["start"]["m"]),
            target=st["target"],
            tab=_table(*(p.detach() for p in last.state.params)),
            cam=[p.detach().clone() for p in last.state.cam_params])
        if win is not None:
            out["ctx"] = dict(
                kind="step", window=win, steps=spf,
                c5=dict(D=c5.dims[0], rays=c5.height * c5.width,
                        rays_local=c5.height * c5.width // mesh.size,
                        samples=c5.num_samples, **st["counts"]))
    del last, st
    platform.shutdown()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run(r: Run) -> Outcome:
    p = program_run(r)
    log(f"steps {p['steps']} in {p['window_s']!r} s; frame "
        f"{p['start']['frame'] + 1} checked")
    from vxbench.harness import rate_per_item
    metrics = {"train_step_ms": rate_per_item(p["window_s"], p["steps"]),
               "setup_s": p["setup_s"]}
    t_ref = time.perf_counter()
    block = int(r.sizes.get("ray_block", p["cfg"]["check"]["ray_block"]))
    want = frame_numbers(p["start"], p["cfg"], r.device, block)
    got = program_numbers(p["prog"], p["start"], want["cam0"])
    checks = checks_of(got, want, p["cfg"]["limits"])
    log(f"reference {time.perf_counter() - t_ref!r} s")
    ctx = p.get("ctx")
    if ctx is not None:
        _log_trace(ctx)
    return Outcome(metrics=metrics, checks=checks, attempted=p["steps"],
                   failed=0, memory_peak_bytes=p["peak"], layer_ctx=ctx,
                   window=None if ctx is None else ctx["window"],
                   setup_split=p["clock"].split)


def _log_trace(ctx: dict) -> None:
    """What the readers of the traced frame rest on: the device time the
    profiler attached to a launching host operation against all of it,
    the index_add_ launches made and recorded in the step spans, and the
    device time launched in the step spans."""
    win, c5 = ctx["window"], ctx["c5"]
    steps = launches.spans(win, launches.C5_STEP)
    log(f"traced frame: device s attached to a launch "
        f"{sum(r[1] for r in win.launched) / 1e6!r} of "
        f"{sum(e - s for _, s, e in win.ops) / 1e6!r} "
        f"({len(win.launched)} of {len(win.ops)} operations); index_add_ "
        f"made {c5['rows_added'] / (8 * c5['rays_local'])!r}, recorded "
        f"{len(launches.launched_in(win, steps, launches.INDEX_ADD))}; "
        f"device s launched in the step spans "
        f"{launches.launched_s(win, steps)!r}; counters {c5}")


def _grad_norms(m1: list, m0: list) -> list:
    """Norms by leaf of the gradient of the step that took Adam's first
    moments from m0 to m1 (m1 = beta1 m0 + (1 - beta1) g), in float64."""
    b1 = ref.BETAS[0]
    g = [(a.double() - b1 * b.double()) / (1.0 - b1)
         for a, b in zip([_table(m1[0], m1[1])] + m1[2:], m0)]
    return ref.leaf_norms(g[0], g[1:])


def is_lit(cfg: dict) -> bool:
    return bool(cfg["config5"]["lit"]) and cfg["settings"]["shading"] != \
        "flat"


def frame_numbers(start: dict, cfg: dict, dev, block: int,
                  dtype=torch.float32) -> dict:
    """The reference's numbers of the frame after ``start``, in
    ``dtype``: its target of the truth, the steps' losses, the first
    gradient's and the frame's change norms by leaf, and the pose it
    starts the frame at."""
    c5 = cfg["config5"]
    dims, h, w, S = tuple(c5["dims"]), c5["height"], c5["width"], \
        c5["num_samples"]
    frame, lit = start["frame"] + 1, is_lit(cfg)
    settings = cfg["settings"]
    lt = ref.light(cfg, dims, dev) if lit else None
    truth = ref.truth_table(dims, c5["seed"], c5["sigma_solid"], dev) \
        .to(dtype)
    o, d = camera.rays(*ref.orbit_pose(cfg, dims, frame, dev), h, w)
    target = ref.render_blocks(truth, o, d, dims[0], S, settings, block,
                               lt).float()
    del truth
    out = ref.follow_frame(start, cfg, settings, dims, h, w, S, frame,
                           target, block, dtype, lit)
    change = ref.leaf_norms(out["tab"].float() - start["tab"],
                            [a.float() - b for a, b in zip(out["cam"],
                                                           out["cam0"])])
    log(f"reference ({dtype}): losses {out['losses']}, gradient norms "
        f"{out['g0']}, change norms {change}")
    return dict(target=target, losses=out["losses"], g0=out["g0"],
                change=change, cam0=out["cam0"])


def program_numbers(prog: dict, start: dict, cam0: list) -> dict:
    """The program's numbers of the checked frame, as ``frame_numbers``
    gives the reference's: the camera's change from the pose ``cam0`` at
    which the reference starts the frame."""
    change = ref.leaf_norms(prog["tab"] - start["tab"],
                            [a - b for a, b in zip(prog["cam"], cam0)])
    log(f"program: losses {prog['losses']}, gradient norms {prog['g0']}, "
        f"change norms {change}")
    return dict(target=prog["target"], losses=prog["losses"],
                g0=prog["g0"], change=change)


def checks_of(got: dict, want: dict, limits: dict) -> dict:
    """The numbers compared, each beside its limit: ``got`` (the program,
    or a control) against ``want`` (the reference)."""
    t_gap = float(torch.linalg.vector_norm((got["target"] - want["target"])
                                           .double())
                  / torch.linalg.vector_norm(want["target"].double()))
    return {
        "target_gap": check(t_gap, limits["target_gap"]),
        "loss_gap": check(max(gap(p, q) for p, q in zip(got["losses"],
                                                        want["losses"])),
                          limits["loss_gap"]),
        "grad_gap": check(leaf_gap(got["g0"], want["g0"], want["g0"]),
                          limits["grad_gap"]),
        "change_gap": check(leaf_gap(got["change"], want["change"],
                                     want["g0"]), limits["change_gap"])}


@contextlib.contextmanager
def _planted(faults):
    """Faults planted in the program, for the tests and the control that
    see ``correct`` come out false (each bites on the CPU and the card):

    ``camera_grad_dropped``: the step's world rays take the pose as a
    constant, so the camera gets no gradient;
    ``normal_grad_dropped``: the lit samples' density-gradient normals
    pass no gradient;
    ``half_rays``: the step renders the first half of its rays and gives
    the second half their colours;
    ``state_unchanged``: Adam's step moves its moments but leaves the
    parameters as they were."""
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.engine import sharding
    from vxtpu_torch.render import vjp
    from vxtpu_torch.train import kernel_adam

    saved = (sharding._world_rays, vjp.grad8,
             sharding.render_soft_rays_fast, kernel_adam.Adam.step)
    if "camera_grad_dropped" in faults:
        world_rays = sharding._world_rays

        def fixed_pose(cam, o_c, d_c):
            return world_rays(Camera(*(getattr(cam, f.name).detach() for f
                                       in dataclasses.fields(cam))), o_c,
                              d_c)
        sharding._world_rays = fixed_pose
    if "normal_grad_dropped" in faults:
        grad8 = vjp.grad8
        vjp.grad8 = lambda *a: tuple(x.detach() for x in grad8(*a))
    if "half_rays" in faults:
        render = sharding.render_soft_rays_fast

        def half(model, o, d, *a, **kw):
            n = o.shape[0] // 2
            pred = render(model, o[:n], d[:n], *a, **kw)
            return torch.cat([pred, pred[:o.shape[0] - n]])
        sharding.render_soft_rays_fast = half
    if "state_unchanged" in faults:
        step = kernel_adam.Adam.step

        def unchanged(self, closure=None):
            ps = [p for g in self.param_groups for p in g["params"]]
            keep = [p.detach().clone() for p in ps]
            out = step(self, closure)
            with torch.no_grad():
                for p, k in zip(ps, keep):
                    p.copy_(k)
            return out
        kernel_adam.Adam.step = unchanged
    try:
        yield
    finally:
        (sharding._world_rays, vjp.grad8, sharding.render_soft_rays_fast,
         kernel_adam.Adam.step) = saved
