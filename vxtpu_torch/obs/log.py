"""Levelled logging (counterpart of ``vxtpu/obs/log.py``): rank 0 logs to
the console, every rank to its own file when ``log_dir`` is given. The
rank is ``torch.distributed``'s when a process group is initialised, else
0."""

from __future__ import annotations

import logging
import os
import sys

_FMT = "%(asctime)s %(levelname).1s %(filename)s:%(lineno)d] %(message)s"


def process_rank() -> int:
    """This process's rank in the default process group, or 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def get_logger(name: str = "vxtpu_torch", log_dir: str | None = None,
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    logger.propagate = False
    rank = process_rank()
    if rank == 0:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir,
                                              f"vxtpu_host{rank}.log"))
        fh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(fh)
    if not logger.handlers:  # a non-zero rank without log_dir: swallow
        logger.addHandler(logging.NullHandler())
    return logger
