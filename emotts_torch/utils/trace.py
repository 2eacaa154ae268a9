"""Named spans of the program's phases, on the profiler's clock.

``span(name)`` marks a phase.  While a ``torch.profiler`` profile runs it
enters ``torch.profiler.record_function("emotts_torch." + name)``: the
phase shares the clock of the card's kernel records, and its parent is the
span open around it on its thread.  While none runs it returns one shared
no-op, so a phase costs a flag read.  The profiler is the recorder: a trace
exported by ``train.metrics.profile_trace``, or read in memory by whoever
runs the profiler, holds the spans.

The flag read is ``torch.autograd.profiler._is_profiler_enabled``, which a
profile sets for every thread; ``torch._C._autograd._profiler_enabled()``
reads False under ``torch.profiler.profile``.  A profile records the
threads other than its own (the loader's producer, the micro-batcher's
worker) only with :func:`all_threads_config`.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

PREFIX = "emotts_torch."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager around the phase ``name`` (recorded as
    ``emotts_torch.<name>`` while a profile runs, nothing otherwise)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def all_threads_config():
    """The profiler's ``experimental_config`` that records every thread of
    the process, where the installed torch has the setting; None (the
    profile records its own thread only) where it does not."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None
