"""Where an entry point makes its tensors.

Every function of the package that makes tensors from scratch takes
``device`` and defaults to the GPU: the package exists to run there. On a
machine without one such a call raises; it never carries on on the CPU.
The CPU, where every kernel wrapper runs its plain PyTorch version, is
used only when a caller asks for it (``device=torch.device("cpu")`` or
``--device cpu``), as the tests do.
"""

from __future__ import annotations

import functools

import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    """``device`` as a torch.device (None means the GPU); raises if it is
    the GPU and there is none."""
    dev = torch.device(DEFAULT if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vxtpu_torch makes its tensors on the GPU unless asked "
            "otherwise, and torch.cuda.is_available() is false here; pass "
            "device=torch.device('cpu') (or --device cpu) to run the "
            "kernels' plain versions on the CPU")
    return dev


@functools.lru_cache(maxsize=64)
def device_const(values: tuple, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """A small constant tensor on ``device``, made once and shared (never
    write to it): a loop that reads one in every step copies it from the
    host once, and a CUDA graph of that loop, which cannot copy from the
    host, can read it."""
    return torch.tensor(values, dtype=dtype, device=device)
