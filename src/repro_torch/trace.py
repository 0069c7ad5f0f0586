"""Named host spans on the profiler's timeline.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler is recording, and a shared no-op context otherwise. The test is
a fraction of a microsecond, where a ``record_function`` costs several
even with no profiler recording, so spans may sit on a hot path: they
are recorded exactly when someone profiles, with no knob of their own.
Each span lies on the clock the profiler stamps the device's kernels
with, so a device gap can be put down to the span the host was in.

The spans the port records, each on ``core/fleet.py`` ``read``:
``fleet.read`` (the whole call), ``fleet.resolve`` (the resolver) and
``fleet.gather`` (the rows' gather).
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``record_function(name)`` range if a profiler is recording, else
    a no-op context."""
    if _enabled():
        return torch.profiler.record_function(name)
    return _OFF
