"""Adam's update as one hand-written CUDA kernel, and its plain version.

``adam_step(p, g, m, v, step, lr, betas, eps)`` is one step of
``torch.optim.Adam`` on one parameter ``p`` with gradient ``g`` and moments
``m``, ``v``, in place, ``step`` the count after this step. On CUDA
tensors it launches ``adam_step_kernel`` (``vxtpu_torch/csrc/adam.cu``),
which reads each of p, g, m and v once and writes p, m and v once, in
place of the seven multi-tensor kernels and the parameter-sized
temporary of torch's foreach path; it replaces no Pallas kernel (the JAX
package's ``optax.adam`` is plain jnp that XLA fuses). There is no
fallback: the wrapper launches the kernel or raises. On CPU tensors it
runs the plain version, ``adam_step_reference``: the tensor ops of
torch's single-tensor path, which define the arithmetic. The kernel
rounds where torch's CUDA kernels round, so it gives torch's foreach step
on the card bit for bit, and the same bits from run to run.

``Adam`` is ``torch.optim.Adam`` with that update: the same constructor,
``param_groups`` and ``state`` (``state[p]``: ``"step"``, a CPU float32
tensor counted on the host, and ``"exp_avg"``, ``"exp_avg_sq"``, float32
in p's shape), so ``loop.read_opt_state``/``write_opt_state`` and the
checkpoints take it as they took torch's. Where any parameter lies on a
CUDA device its ``step()`` runs ``adam_step`` once for each parameter
that has a gradient; otherwise it is torch's own step. It refuses what
the kernel does not implement: ``amsgrad``, ``weight_decay``,
``maximize``, ``capturable``, ``differentiable``, ``fused`` and any
dtype but float32.
"""

from __future__ import annotations

import torch

# Kernel launches since the last reset_launch_counts(), by kernel name.
# The wrapper adds one where it launches the kernel, and nowhere else.
LAUNCHES = {"adam_step_kernel": 0}

# the options the kernel does not implement: each refused unless off (0)
_REFUSED = ("amsgrad", "weight_decay", "maximize", "capturable",
            "differentiable", "fused")


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(p, g, m, v) -> None:
    """Raises unless p, g, m and v are dense, contiguous float32 tensors of
    one shape on one CPU or CUDA device."""
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got "
                            f"{type(t).__name__}")
        if t.layout != torch.strided:
            raise ValueError(f"{name}: {t.layout} tensors are not taken")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
        if t.device != p.device or t.shape != p.shape:
            raise ValueError(f"{name}: {tuple(t.shape)} on {t.device}, the "
                             f"parameter {tuple(p.shape)} on {p.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"p on {p.device}: only cpu and cuda are taken")


def adam_step_reference(p, g, m, v, step, lr, betas, eps) -> None:
    """The plain version: torch.optim.Adam's single-tensor step, in place."""
    beta1, beta2 = betas
    m.lerp_(g, 1 - beta1)
    v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
    bc1 = 1 - beta1 ** step
    bc2 = 1 - beta2 ** step
    denom = (v.sqrt() / bc2 ** 0.5).add_(eps)
    p.addcdiv_(m, denom, value=-(lr / bc1))


def adam_step(p, g, m, v, step, lr, betas, eps) -> None:
    """One Adam step of ``p`` in place, and of its moments ``m``, ``v``:
    ``adam_step_kernel`` on CUDA tensors, the plain version on CPU ones.
    ``step`` (>= 1) is the count after this step; the bias corrections are
    worked out from it here, on the host."""
    _check(p, g, m, v)
    if p.device.type == "cpu":
        adam_step_reference(p, g, m, v, step, lr, betas, eps)
        return
    from vxtpu_torch import _build

    beta1, beta2 = betas
    bc1 = 1 - beta1 ** step
    bc2 = 1 - beta2 ** step
    rc = _build.load().vx_adam_step(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
        1 - beta1, beta2, 1 - beta2, bc2 ** 0.5, -(lr / bc1), eps,
        torch.cuda.current_stream(p.device).cuda_stream)
    if rc:
        raise RuntimeError(f"adam_step_kernel launch failed: "
                           f"{_build.error_string(rc)}")
    LAUNCHES["adam_step_kernel"] += 1


class Adam(torch.optim.Adam):
    """torch.optim.Adam whose step on CUDA parameters is ``adam_step``."""

    def add_param_group(self, param_group: dict) -> None:
        super().add_param_group(param_group)
        group = self.param_groups[-1]
        for key in _REFUSED:
            if group.get(key):
                raise ValueError(f"kernel_adam.Adam does not implement "
                                 f"{key}={group[key]!r}")
        for p in group["params"]:
            if p.dtype != torch.float32:
                raise TypeError(f"kernel_adam.Adam takes float32 parameters, "
                                f"got {p.dtype}")

    def step(self, closure=None):
        if not any(p.device.type == "cuda" for group in self.param_groups
                   for p in group["params"]):
            return super().step(closure)
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._step_each()
        return loss

    @torch.no_grad()
    def _step_each(self) -> None:
        """``adam_step`` on each parameter that has a gradient, its state
        kept as torch.optim.Adam keeps it (on CPU tensors the plain
        version runs, as on CUDA ones the kernel)."""
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0, dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                adam_step(p, p.grad, state["exp_avg"], state["exp_avg_sq"],
                          float(state["step"]), group["lr"], group["betas"],
                          group["eps"])
