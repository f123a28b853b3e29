"""Profiler spans of the program's stages, as ``render/pipeline.py``'s
``_span`` opens its own: a ``torch.profiler`` ``record_function`` range,
opened only while a profiler runs, so that an untraced run pays nothing
for it (an idle range still costs two dispatcher calls of host time)."""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function


def span(name: str):
    """The profiler span ``name``, or none when no profiler runs."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()
