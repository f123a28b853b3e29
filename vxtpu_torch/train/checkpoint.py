"""Checkpoints of a fit (counterpart of ``vxtpu/train/checkpoint.py``), in
vxtpu's npz format, so a checkpoint written by either package loads in
the other, optimizer state included.

Keys: ``sigma_raw`` [X,Y,Z], ``rgb_raw`` [3,X,Y,Z], ``cam_pos``,
``cam_yaw``, ``cam_pitch``, ``cam_fov_y``, ``step``, ``x_<name>`` for
extras, and ``o_0000``, ``o_0001``, ... for the optimizer: optax's leaves
of adam's state, per group (``cam`` before ``soft``) the step count
(int32), then the first moments, then the second moments, each in the
group's field order. Moments of Morton tables (the ``field_kernel`` fit)
are stored as vxtpu keeps those tables, [rows, 128] and [3, rows, 128].
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vxtpu_torch.camera.camera import Camera
from vxtpu_torch.device import DEFAULT, resolve
from vxtpu_torch.obs.log import process_rank
from vxtpu_torch.render.soft import SoftGrid
from vxtpu_torch.train.loop import AdamGroupState
from vxtpu_torch.world.packed import LANES


def _optax_shape(shape) -> tuple:
    """The shape vxtpu gives a leaf: flat Morton tables [D^3] and [3, D^3]
    are [rows, 128] and [3, rows, 128]; other leaves (grid [X,Y,Z] /
    [3,X,Y,Z], camera [3] and scalars) keep their shape."""
    shape = tuple(shape)
    if len(shape) == 1 and shape[0] % LANES == 0:
        return (shape[0] // LANES, LANES)
    if len(shape) == 2 and shape[0] == 3 and shape[1] % LANES == 0:
        return (3, shape[1] // LANES, LANES)
    return shape


def _to_optax_layout(x: torch.Tensor) -> np.ndarray:
    a = x.detach().cpu().numpy()
    return a.reshape(_optax_shape(a.shape))


def opt_state_leaves(state: list) -> list:
    """The port's optimizer state -> optax's leaf list (numpy)."""
    leaves = []
    for g in state:
        leaves.append(np.asarray(g.count, np.int32))
        leaves += [_to_optax_layout(m) for m in g.mu]
        leaves += [_to_optax_layout(v) for v in g.nu]
    return leaves


def opt_state_from_leaves(leaves: list, template: list,
                          device=DEFAULT) -> list:
    """optax's leaf list (numpy arrays, as ``opt_state_leaves`` gives or
    ``jax.tree_util.tree_leaves(opt_state)`` of vxtpu's fit) -> the
    port's optimizer state, shaped like ``template`` (a list of
    AdamGroupState, e.g. ``loop.init_opt_state``)."""
    device = resolve(device)
    want = sum(1 + 2 * len(g.mu) for g in template)
    if len(leaves) != want:
        raise ValueError(f"{len(leaves)} optimizer leaves, but the optimizer "
                         f"expects {want}: the config changed between save "
                         f"and resume")
    out, i = [], 0
    for g in template:
        count = int(np.asarray(leaves[i]))
        i += 1
        moments = []
        for t in g.mu + g.nu:
            a = np.asarray(leaves[i], np.float32)
            if a.shape not in (tuple(t.shape), _optax_shape(t.shape)):
                raise ValueError(f"optimizer leaf {i} has shape {a.shape}, "
                                 f"the optimizer expects "
                                 f"{tuple(t.shape)}: model or config "
                                 f"changed between save and resume")
            moments.append(torch.as_tensor(a.reshape(tuple(t.shape)),
                                           device=device))
            i += 1
        k = len(g.mu)
        out.append(AdamGroupState(count, moments[:k], moments[k:]))
    return out


def _migrate_rgb_layout(rgb: np.ndarray) -> np.ndarray:
    """rgb_raw as [3,X,Y,Z]: vxtpu's old [X,Y,Z,3] layout is moved to
    channel-major; a [3,X,Y,3] array, which could be either, raises
    ValueError (as vxtpu's loader does)."""
    if rgb.ndim == 4 and rgb.shape[0] == 3 and rgb.shape[-1] == 3:
        raise ValueError(f"ambiguous rgb_raw checkpoint shape "
                         f"{rgb.shape}: cannot infer layout")
    if rgb.ndim == 4 and rgb.shape[-1] == 3:
        return np.ascontiguousarray(np.transpose(rgb, (3, 0, 1, 2)))
    return rgb


def save_checkpoint(path: str, soft: SoftGrid, cam: Camera, step: int,
                    extra: dict | None = None, opt_state=None,
                    compress: bool = True) -> None:
    """Atomic save (write to a temporary file, then rename) by rank 0 of
    the process group only: every rank holds the same replicated state,
    and every rank loads it on resume. ``opt_state``
    (the fit's optimizer state) is saved leaf by leaf so a resumed run
    continues Adam's trajectory; restore it with load_opt_state().
    compress=False suits big grids (zlib over GBs costs minutes)."""
    if process_rank() != 0:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"

    def host(x):
        return x.detach().cpu().numpy()

    payload = dict(sigma_raw=host(soft.sigma_raw), rgb_raw=host(soft.rgb_raw),
                   cam_pos=host(cam.pos), cam_yaw=host(cam.yaw),
                   cam_pitch=host(cam.pitch), cam_fov_y=host(cam.fov_y),
                   step=np.asarray(step))
    for k, v in (extra or {}).items():
        payload["x_" + k] = host(v) if isinstance(v, torch.Tensor) \
            else np.asarray(v)
    if opt_state is not None:
        for i, leaf in enumerate(opt_state_leaves(opt_state)):
            payload[f"o_{i:04d}"] = leaf
    writer = np.savez_compressed if compress else np.savez
    with open(tmp, "wb") as f:
        writer(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str, device=DEFAULT):
    """Returns (soft, cam, step, extra) on ``device``."""
    device = resolve(device)

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)

    with np.load(path) as z:
        rgb = _migrate_rgb_layout(np.asarray(z["rgb_raw"]))
        soft = SoftGrid(sigma_raw=dev(z["sigma_raw"]), rgb_raw=dev(rgb))
        cam = Camera(pos=dev(z["cam_pos"]), yaw=dev(z["cam_yaw"]),
                     pitch=dev(z["cam_pitch"]), fov_y=dev(z["cam_fov_y"]))
        step = int(z["step"])
        extra = {k[2:]: np.asarray(z[k]) for k in z.files
                 if k.startswith("x_")}
    return soft, cam, step, extra


def load_opt_state(path: str, template: list, device=DEFAULT):
    """The optimizer state saved with the checkpoint, shaped like
    ``template``; None if the checkpoint holds none (the run then starts
    Adam afresh, as vxtpu does)."""
    with np.load(path) as z:
        keys = sorted(k for k in z.files if k.startswith("o_"))
        if not keys:
            return None
        leaves = [np.asarray(z[k]) for k in keys]
    return opt_state_from_leaves(leaves, template, device)
