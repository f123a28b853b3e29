"""The masked fit's bounds pass as one hand-written CUDA kernel.

``mask_bounds(dims, scale, o, d, df_flat)`` is
``render/occmask.py:mask_segment_bounds_batched`` (the plain version, which
defines the function: two ``kernel_xla.march_xla_df`` marches over the
mask's distance field, forward from each ray's origin and backward from
beyond its exit) on CUDA tensors: one launch of ``mask_bounds_kernel``
(``vxtpu_torch/csrc/bounds.cu``), one thread a ray, both marches in
registers. It replaces no Pallas kernel (the JAX package's bounds pass is
plain jnp in a while loop). It gives the batched path's bounds bit for
bit on the card: the kernel makes the same float operations in the same
order, and caps each march at ``ceil((sum(dims) + 2) / STEP_CHUNK) *
STEP_CHUNK`` steps (``occmask.STEP_CHUNK``), as far as the batched path's
chunks let a ray run.

``occmask.mask_segment_bounds`` calls it on CUDA tensors; CPU tensors run
the batched path there and never reach this module. There is no
fallback: the wrapper launches the kernel or raises. It reads no device
value on the host and never synchronises; it allocates only the two
outputs.
"""

from __future__ import annotations

import torch

# Kernel launches since the last reset_launch_counts(), by kernel name.
# The wrapper adds one where it launches the kernel, and nowhere else.
LAUNCHES = {"mask_bounds_kernel": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(dims, o, d, df_flat) -> None:
    """Raises unless o and d are contiguous float32 [N, 3] and df_flat a
    contiguous uint8 field of prod(dims) cells, all on one CUDA device."""
    for name, t, dtype in (("o", o, torch.float32), ("d", d, torch.float32),
                           ("df_flat", df_flat, torch.uint8)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got "
                            f"{type(t).__name__}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.device.type != "cuda" or t.device != o.device:
            raise ValueError(f"{name} on {t.device}: all on one CUDA device "
                             f"(o on {o.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"o, d: expected [N, 3] each, got {tuple(o.shape)} "
                         f"and {tuple(d.shape)}")
    if (len(dims) != 3 or min(dims) < 1
            or df_flat.numel() != dims[0] * dims[1] * dims[2]):
        raise ValueError(f"df_flat: {df_flat.numel()} cells for a mask of "
                         f"{tuple(dims)}")


def mask_bounds(dims, scale: int, o: torch.Tensor, d: torch.Tensor,
                df_flat: torch.Tensor):
    """(t0, t1) [N] float32 of the rays o, d [N, 3] (world units) over the
    mask grid ``dims`` (scale ``scale``) whose flat distance field is
    ``df_flat``: ``mask_bounds_kernel``."""
    from vxtpu_torch import _build
    from vxtpu_torch.render.occmask import STEP_CHUNK

    _check(dims, o, d, df_flat)
    cap = -(-(sum(dims) + 2) // STEP_CHUNK) * STEP_CHUNK
    n = o.shape[0]
    t0 = torch.empty(n, dtype=torch.float32, device=o.device)
    t1 = torch.empty(n, dtype=torch.float32, device=o.device)
    if n == 0:
        return t0, t1
    rc = _build.load().vx_mask_bounds(
        o.data_ptr(), d.data_ptr(), n, df_flat.data_ptr(), *dims,
        float(scale), cap, t0.data_ptr(), t1.data_ptr(),
        torch.cuda.current_stream(o.device).cuda_stream)
    if rc:
        raise RuntimeError(f"mask_bounds_kernel launch failed: "
                           f"{_build.error_string(rc)}")
    LAUNCHES["mask_bounds_kernel"] += 1
    return t0, t1
