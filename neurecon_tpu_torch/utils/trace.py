"""Spans at the port's layer boundaries, for torch.profiler's trace.

`span(name)` is `torch.profiler.record_function("ntt." + name)` while a
torch profiler records (the trainer's `training.profile_steps` window, or any
`torch.profiler.profile` around the port's calls), and one shared null
context otherwise: with no profiler a span costs a flag read, where a bare
`record_function` costs ~14 us on the host. Spans nest as the calls do; the
names are those README's profiler paragraph lists. Only `step` carries an
argument, the step's index.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def profiling() -> bool:
    """Whether a torch profiler records in this process: the flag that
    `torch.profiler.profile` sets on entry and clears on exit."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, it=None):
    """A `record_function` named "ntt." + name while a profiler records
    (with the step index `it` as its args), else the shared null context."""
    if not profiling():
        return _OFF
    return torch.profiler.record_function(
        "ntt." + name, args=None if it is None else str(int(it)))
