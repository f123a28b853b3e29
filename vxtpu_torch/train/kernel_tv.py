"""The Morton TV prior of the field-kernel fit as a hand-written CUDA pair,
and its plain version.

``tv_prior(tab, tv_sigma, tv_rgb)`` is ``train/loss.py:tv_prior_morton``
(the plain version, which defines the function) on the channel-interleaved
Morton table ``tab``, float32 [D^3, 4]: ``tv_sigma`` times the prior of
sigma plus ``tv_rgb`` times the mean of the priors of r, g and b, each
prior the mean squared difference of the even neighbour pairs along each
axis, summed over the axes, times 2/3. In Morton order every such pair
lies inside one aligned group of 8 rows (a 2x2x2 brick), so the value
needs one read of the table and the gradient one read and one write.

On a CUDA tensor it is a ``torch.autograd.Function`` whose forward
launches ``tv_fwd_kernel`` (per-block partial sums) and
``tv_fwd_finish_kernel`` (their fixed-order sum and the weights) and
whose backward launches ``tv_bwd_kernel``, from
``vxtpu_torch/csrc/tv.cu``; they replace no Pallas kernel (the JAX
package's ``tv_loss_morton`` is plain jnp that XLA fuses). There is no
fallback: the wrapper launches the kernels or raises. On a CPU tensor it
runs the plain version through autograd. The value is the same bit for
bit from run to run (no float atomics) and agrees with the plain version
to rounding: the kernels sum in another order.
"""

from __future__ import annotations

import torch

from vxtpu_torch.render.kernel_sample import NCH
from vxtpu_torch.train.loss import tv_prior_morton

# Kernel launches since the last reset_launch_counts(), by kernel name.
# The wrappers add one where they launch a kernel, and nowhere else.
LAUNCHES = {"tv_fwd_kernel": 0, "tv_fwd_finish_kernel": 0,
            "tv_bwd_kernel": 0}

# tv_fwd_kernel's largest grid, and the rows of its [FWD_PARTS, 4] partials
# scratch: the blocks of 256 threads an H100 holds at once (132 SMs x 8;
# the kernel uses 32 registers a thread). Its grid-stride loop takes any
# table on that many blocks.
FWD_PARTS = 132 * 8


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_table(tab: torch.Tensor) -> None:
    """Raises unless ``tab`` is a Morton table [D^3, 4]: float32,
    contiguous, D a power of two and D^3 >= 8, on the CPU or a CUDA device
    (16-byte aligned there, as the kernels read its rows as float4)."""
    if not isinstance(tab, torch.Tensor):
        raise TypeError(f"tab: expected a tensor, got {type(tab).__name__}")
    if tab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tab on {tab.device}: only cpu and cuda are taken")
    if tab.dtype != torch.float32:
        raise TypeError(f"tab: expected torch.float32, got {tab.dtype}")
    n = tab.shape[0] if tab.dim() == 2 else 0
    dim = round(n ** (1.0 / 3.0)) if n > 0 else 0
    if (tab.dim() != 2 or tab.shape[1] != NCH or dim ** 3 != n or dim < 2
            or dim & (dim - 1)):
        raise ValueError(f"tab: expected a [D^3, {NCH}] table with D a power "
                         f"of two >= 2, got {tuple(tab.shape)}")
    if not tab.is_contiguous():
        raise ValueError("tab: must be contiguous")
    if tab.device.type == "cuda" and tab.data_ptr() % 16:
        raise ValueError("tab must be 16-byte aligned (the kernels read its "
                         "rows as float4)")


def tv_fwd(tab: torch.Tensor, tv_sigma: float, tv_rgb: float) -> torch.Tensor:
    """The prior's value, a 0-dim float32 tensor on the table's CUDA
    device: ``tv_fwd_kernel`` and ``tv_fwd_finish_kernel``."""
    from vxtpu_torch import _build

    part = torch.empty((FWD_PARTS, NCH), dtype=torch.float32,
                       device=tab.device)
    out = torch.empty((), dtype=torch.float32, device=tab.device)
    rc = _build.load().vx_tv_fwd(
        tab.data_ptr(), tab.shape[0], tv_sigma, tv_rgb, part.data_ptr(),
        FWD_PARTS, out.data_ptr(),
        torch.cuda.current_stream(tab.device).cuda_stream)
    if rc:
        raise RuntimeError(f"tv_fwd_kernel launch failed: "
                           f"{_build.error_string(rc)}")
    LAUNCHES["tv_fwd_kernel"] += 1
    LAUNCHES["tv_fwd_finish_kernel"] += 1
    return out


def tv_bwd(tab: torch.Tensor, g: torch.Tensor, tv_sigma: float,
           tv_rgb: float) -> torch.Tensor:
    """The prior's gradient [D^3, 4] times the upstream gradient ``g`` (a
    one-element float32 tensor on the table's device, read there):
    ``tv_bwd_kernel``."""
    from vxtpu_torch import _build

    g = g.to(torch.float32).contiguous()
    if g.numel() != 1 or g.device != tab.device:
        raise ValueError(f"g: expected one value on {tab.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    grad = torch.empty_like(tab)
    rc = _build.load().vx_tv_bwd(
        tab.data_ptr(), tab.shape[0], g.data_ptr(), tv_sigma, tv_rgb,
        grad.data_ptr(), torch.cuda.current_stream(tab.device).cuda_stream)
    if rc:
        raise RuntimeError(f"tv_bwd_kernel launch failed: "
                           f"{_build.error_string(rc)}")
    LAUNCHES["tv_bwd_kernel"] += 1
    return grad


class _TVPrior(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tab, tv_sigma, tv_rgb):
        ctx.save_for_backward(tab)
        ctx.weights = (tv_sigma, tv_rgb)
        return tv_fwd(tab, tv_sigma, tv_rgb)

    @staticmethod
    def backward(ctx, g):
        tab, = ctx.saved_tensors
        return tv_bwd(tab, g, *ctx.weights), None, None


def tv_prior(tab: torch.Tensor, tv_sigma: float,
             tv_rgb: float) -> torch.Tensor:
    """``tv_prior_morton(tab, tv_sigma, tv_rgb)``, differentiable in
    ``tab``: CUDA tensors launch the kernel pair, CPU tensors run the
    plain version."""
    _check_table(tab)
    if tab.device.type == "cpu":
        return tv_prior_morton(tab, tv_sigma, tv_rgb)
    return _TVPrior.apply(tab, float(tv_sigma), float(tv_rgb))
