"""The soft-voxel fit (config 4) through the port's trainer: one
``train/loop.py:fit_soft`` call, with the field kernels, whose steps
outlast the window, as ``train --field-kernel [--occmask]`` runs it.

Set-up: the truth from the seed's terrain (``world.py``), one target view
rendered by the plain reference, the starting grid (zeros, or a share of
the truth), and the fit's first steps up to the traffic's
``window_after_step``: they warm every shape and, for the masked model,
hold its first mask refresh. The harness sees each step through
``step_hook``, which ends the window by raising, and reads the trainer's
own state there (the table and Adam's moments of the live call).

Checked after the window against the plain reference
(``reference/soft.py``), which the benchmark hands the same inputs: the
losses of steps 0-2, the first gradient as Adam's first moment holds it
after step 0, and the table's change after step 2, each leaf (sigma,
rgb) by its norm; with the occupancy mask also the mask of its first
refresh and that step's loss, the reference following from the
program's table as it stood before the refresh.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import sys
import time

import torch

from vxbench import camera, world
from vxbench.drivers import (Clock, Outcome, Run, check, gap, log, peak_bytes,
                             sync)
from vxbench.reference import soft as ref
from vxbench.trace import Window


class WindowClosed(Exception):
    """Raised by the step hook to end the fit once the window is over."""


def _trainer_frame():
    """The locals of the trainer's loop, the step hook's caller."""
    return sys._getframe(2).f_locals


def truth_table(dims, seed, device):
    """Row-major [D^3, 4] (sigma, r, g, b) of the truth of the seed."""
    occ, rgb = world.terrain(dims, seed, device)
    sigma, rgb_raw = world.soft_truth(occ, rgb)
    del occ, rgb
    return torch.cat([sigma.reshape(-1, 1), rgb_raw.reshape(3, -1).t()],
                     dim=1)


def start_table(tr: dict, dims, seed, device):
    """Row-major [D^3, 4] of the fit's starting grid."""
    if tr["start"] == "zeros":
        t = torch.zeros((dims[0] ** 3, 4), dtype=torch.float32,
                        device=device)
        t[:, 0] = -2.0
        return t
    return truth_table(dims, seed, device) * float(tr["start_truth_scale"])


def view_rays(cfg: dict, dims, h, w, device):
    """The target view's rays (float32 [H*W, 3] each)."""
    v = cfg["view"]
    pos = torch.tensor([a * n for a, n in zip(v["pos"], dims)],
                       dtype=torch.float32, device=device)
    tgt = torch.tensor([a * n for a, n in zip(v["look_at"], dims)],
                       dtype=torch.float32, device=device)
    yaw, pitch = camera.look_at(pos, tgt)
    fov = torch.as_tensor(float(v["fov_deg"]), dtype=torch.float32,
                          device=device) * (3.141592653589793 / 180.0)
    return camera.rays(pos, yaw, pitch, fov, h, w)


def sizes(r: Run):
    c, t = r.cell.config, r.cell.traffic
    dims = tuple(r.sizes.get("dims", c["dims"]))
    return (dims, r.sizes.get("height", c["height"]),
            r.sizes.get("width", c["width"]),
            r.sizes.get("samples", t["samples"]),
            r.sizes.get("target_samples", c["target_samples"]),
            r.sizes.get("mask_refresh", t.get("mask_refresh", 0)),
            r.sizes.get("window_after_step", t["window_after_step"]))


def reference_steps(tab0, o, d, target, D, S, cfg, n_steps, dtype, block,
                    mask_fn=None, half_batch=False):
    """The reference's first n_steps: (losses, gradient norms of step 0
    by leaf, change norms by leaf after n_steps)."""
    p = tab0.to(dtype).clone()
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    rs = cfg["settings"]
    tv = (cfg["train"]["tv_sigma"], cfg["train"]["tv_rgb"])
    if half_batch:
        n = o.shape[0] // 2
        o, d, target = o[:n], d[:n], target[:n]
    losses, g0 = [], None
    for k in range(n_steps):
        kw = mask_fn(p) if mask_fn is not None else {}
        loss, g = ref.loss_and_grad(p, o, d, target, D, S, rs, tv, block,
                                    **kw)
        losses.append(loss)
        if k == 0:
            g0 = ref.leaf_norms(g)
        ref.adam(p, g, m, v, k + 1, cfg["train"]["lr"])
    return losses, g0, ref.leaf_norms(p.float() - tab0)


def leaf_gap(prog: list, ref_norms: list, ref_grad: list) -> float:
    """The worst leaf's |prog - ref| over the larger of the reference's
    norm of that leaf and of the median leaf; leaves whose reference
    gradient is under a thousandth of the median leaf's are left out."""
    med_g = statistics.median(ref_grad)
    med = statistics.median(ref_norms)
    return max((abs(p - q) / max(q, med)
                for p, q, g in zip(prog, ref_norms, ref_grad)
                if g >= 1e-3 * med_g), default=0.0)


def band_kwargs(mask, G, o, d) -> dict:
    """The reference's arguments of the masked model under ``mask``."""
    return dict(bands=ref.bands(mask, G, o, d), mask=mask, G=G)


def run(r: Run) -> Outcome:
    clock = Clock(r.t_start)
    from vxtpu_torch.camera.camera import Camera
    from vxtpu_torch.render import occmask
    from vxtpu_torch.render.settings import RenderSettings
    from vxtpu_torch.render.soft import SoftGrid
    from vxtpu_torch.train import loop
    clock.mark("import")

    cfg, tr, dev = r.cell.config, r.cell.traffic, r.device
    dims, h, w, S, S_target, refresh, open_step = sizes(r)
    D = dims[0]
    G = int(tr.get("mask_scale", 4))
    masked = bool(tr["occ_mask"])
    block = int(r.sizes.get("ray_block", cfg["check"]["ray_block"]))
    o, d = view_rays(cfg, dims, h, w, dev)
    truth = truth_table(dims, r.seed, dev)
    clock.mark("scene")
    target = ref.render_blocks(truth, o, d, D, S_target, cfg["settings"],
                               block)
    del truth
    start = start_table(tr, dims, r.seed, dev)
    soft = SoftGrid(sigma_raw=start[:, 0].reshape(dims).clone(),
                    rgb_raw=start[:, 1:].t().reshape(3, *dims).clone())
    del start
    v = cfg["view"]
    cam = Camera.make(pos=tuple(a * n for a, n in zip(v["pos"], dims)),
                      fov_y_deg=float(v["fov_deg"]), device=dev).look_at(
        tuple(a * n for a, n in zip(v["look_at"], dims)))
    t = cfg["train"]
    tc = loop.TrainConfig(
        lr=t["lr"], steps=10 ** 9, num_samples=S, tv_sigma=t["tv_sigma"],
        tv_rgb=t["tv_rgb"], seed=t["seed"],
        nan_check_every=t["nan_check_every"], occ_mask=masked,
        mask_scale=G, mask_refresh=refresh,
        mask_tau=float(tr.get("mask_tau", 0.01)), field_kernel=True)
    clock.mark("target")

    st: dict = {"losses": [], "steps": 0}
    n_traced = int(tr["traced_steps"]) if r.trace else 0
    win = Window() if r.trace else None

    def hook(i, loss):
        if i < 3:
            st["losses"].append(loss)
        if i in (0, 2):
            sync(dev)
            clock.mark(f"step{i}")
        if i == 0:
            f = _trainer_frame()
            tab = f["params"][0]
            m1 = f["opt"].state.get(tab, {}).get("exp_avg")
            st["g0"] = ([0.0, 0.0] if m1 is None else
                        ref.leaf_norms(m1 / (1.0 - ref.BETAS[0])))
        if i == 2:
            tab = _trainer_frame()["params"][0].detach()
            init = torch.empty_like(tab)
            init[world.morton_index(D, dev)] = torch.cat([soft.sigma_raw.reshape(-1, 1),
                                  soft.rgb_raw.reshape(3, -1).t()], dim=1)
            st["change"] = ref.leaf_norms(tab - init)
            del init
        if masked and refresh and i == refresh - 1:
            st["tab_before_refresh"] = _trainer_frame()["params"][0] \
                .detach().to("cpu", copy=True)
        if masked and refresh and i == refresh:
            sync(dev)
            clock.mark(f"step{i}")
            st["loss_refresh"] = loss
            st["mask_refresh"] = _trainer_frame()["mask"].clone()
        if i == open_step:
            sync(dev)
            st["setup_s"] = time.perf_counter() - r.t_start
            clock.mark("warm")
            st["w0"] = time.perf_counter()
            if win is not None:
                if masked:
                    st["bounds_ms"] = _bounds_ms(occmask, _trainer_frame(),
                                                 G, dev)
                win.__enter__()
                st["t_trace"] = time.perf_counter()
            return
        if i > open_step:
            k = i - open_step
            if win is not None and k == n_traced:
                sync(dev)
                st["traced_step_s"] = (time.perf_counter()
                                       - st["t_trace"]) / n_traced
                win.__exit__(None, None, None)
            if time.perf_counter() - st["w0"] >= r.seconds and k >= max(
                    n_traced, 1):
                sync(dev)
                st["w1"] = time.perf_counter()
                st["steps"] = k
                raise WindowClosed

    try:
        with _planted(r.faults, loop):
            loop.fit_soft(soft, cam, target.reshape(h, w, 3),
                          RenderSettings(**cfg["settings"]), tc,
                          step_hook=hook)
        raise RuntimeError("fit_soft returned before the window closed")
    except WindowClosed as exc:
        tb = exc.__traceback__
        while tb.tb_next is not None and tb.tb_frame.f_code.co_name \
                != "_fit_rays":
            tb = tb.tb_next
        state = tb.tb_frame.f_locals
    peak = peak_bytes(dev)
    window_s = st["w1"] - st["w0"]
    steps = st["steps"]
    log(f"steps {steps} in {window_s!r} s"
        + (f"; traced steps {st['traced_step_s'] * 1e3!r} ms each"
           if win is not None else ""))
    from vxbench.harness import rate_per_item
    metrics = {"train_step_ms": rate_per_item(window_s, steps),
               "setup_s": st["setup_s"]}
    ctx = None
    if win is not None:
        ctx = dict(kind="step", window=win, steps=n_traced,
                   step_s=st["traced_step_s"], D=D, rays=o.shape[0])
        if masked:
            # timed before the profiler started: after it, host-bound
            # work runs slower for the rest of the process
            ctx["mask_bounds_ms"] = st["bounds_ms"]
    losses = [float(x) for x in st["losses"]]
    loss_refresh = float(st["loss_refresh"]) if masked else None
    prog_mask = st.get("mask_refresh")
    # the program's state goes before the reference runs
    del state, tb, soft
    st.pop("losses")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    dtype = getattr(torch, cfg["check"]["dtype"])
    tab0 = start_table(tr, dims, r.seed, dev)
    ones = torch.ones((D // G,) * 3, dtype=torch.uint8, device=dev)
    mask_fn = ((lambda p: band_kwargs(ones, G, o, d)) if masked
               else None)
    r_losses, r_g0, r_change = reference_steps(
        tab0, o, d, target, D, S, cfg, 3, dtype, block, mask_fn)
    del tab0
    lim = cfg["limits"]
    checks = {
        "loss_gap": check(max(gap(p, q) for p, q in zip(losses, r_losses)),
                          lim["loss_gap"]),
        "grad_gap": check(leaf_gap(st["g0"], r_g0, r_g0), lim["grad_gap"]),
        "change_gap": check(leaf_gap(st["change"], r_change, r_g0),
                            lim["change_gap"])}
    log(f"losses {losses} reference {r_losses}; gradient norms "
        f"{st['g0']} reference {r_g0}; change norms {st['change']} "
        f"reference {r_change}")
    if masked:
        tab = st.pop("tab_before_refresh").to(dev)
        rm = tab[world.morton_index(D, dev)]
        del tab
        ref_mask = ref.occupancy_mask(rm, D, G, float(tr["mask_tau"]))
        r_loss = ref.loss(rm, o, d, target, D, S, cfg["settings"],
                          (t["tv_sigma"], t["tv_rgb"]), block,
                          **band_kwargs(ref_mask, G, o, d))
        checks["refresh_loss_gap"] = check(gap(loss_refresh, r_loss),
                                           lim["refresh_loss_gap"])
        log(f"refresh step {refresh}: loss {loss_refresh} reference "
            f"{r_loss}; mask cells {int(ref_mask.sum())}, "
            f"{int((prog_mask != ref_mask).sum())} unlike the reference's")
    log(f"reference {time.perf_counter() - t_ref!r} s")
    return Outcome(metrics=metrics, checks=checks, attempted=steps,
                   failed=0, memory_peak_bytes=peak, layer_ctx=ctx,
                   window=win, setup_split=clock.split)


@contextlib.contextmanager
def _planted(faults, loop):
    """Faults planted in the program for the tests that see ``correct``
    come out false: ``state_unchanged`` (Adam's step does nothing),
    ``half_batch`` (the loss is the mean over half of the rays)."""
    saved = (torch.optim.Adam.step, loop.mse)
    if "state_unchanged" in faults:
        torch.optim.Adam.step = lambda self, closure=None: None
    if "half_batch" in faults:
        def half_mse(pred, tgt):
            n = pred.shape[0] // 2
            return torch.mean((pred[:n] - tgt[:n]) ** 2)
        loop.mse = half_mse
    try:
        yield
    finally:
        torch.optim.Adam.step, loop.mse = saved


def _bounds_ms(occmask, state, G, dev, reps: int = 5):
    """ms of one bounds pass on the window's last mask and rays: CUDA
    events around ``reps`` passes after one."""
    mask, df = state["mask"], state["mask_df"]
    o, d = state["o_b"], state["d_b"]
    occmask.mask_segment_bounds(mask, G, o, d, df_flat=df)
    if dev.type != "cuda":
        return None
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        occmask.mask_segment_bounds(mask, G, o, d, df_flat=df)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / reps
    log(f"bounds pass {ms!r} ms (events, mean of {reps})")
    return ms
