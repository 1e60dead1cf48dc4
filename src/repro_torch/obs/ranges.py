"""The program's phases as ``torch.profiler`` ranges.

The stage workers, the scatter-reduce, the ``local`` store and the engine
open a range around each phase of a step, named as below, so a device trace
taken with ``torch.profiler`` names the phase the host was in: the ranges
sit on the same clock as the kernels they launch.  A range is entered only
while a profiler runs: ``record_function`` costs ~10 us a call even with no
profiler.  The check reads ``torch.autograd.profiler``'s flag, which a
``torch.profiler`` sets for the process: the C++ check
(``torch._C._autograd._profiler_enabled``) is per thread, false on the
stage workers' threads and under ``profile_all_threads``.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import profiler as _autograd_profiler

FWD = "funcpipe/fwd"                  # StageWorker.forward, one micro-batch
BWD = "funcpipe/bwd"                  # StageWorker.backward
OPTIMIZER = "funcpipe/optimizer"      # StageWorker.apply_update
SYNC = "funcpipe/sync"                # one worker's local_scatter_reduce
BARRIER = "funcpipe/barrier"          # a scatter-reduce barrier's wait
STORE_WAIT = "funcpipe/store_wait"    # a LocalStore get or take that blocks
STEP = "funcpipe/step"                # the engine's thread: one step's own work
NAMES = (FWD, BWD, OPTIMIZER, SYNC, BARRIER, STORE_WAIT, STEP)

_NONE = contextlib.nullcontext()


def phase_range(name: str):
    """A profiler range named ``name`` while a profiler runs, else a no-op
    context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NONE


def ranged(name: str):
    """Decorate a function to run inside :func:`phase_range` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with phase_range(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
