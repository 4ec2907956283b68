"""Profiling and tracing (port of ``cilantro_tpu/utils/profiling.py``) on
``torch.profiler``:

* :func:`trace` — context manager that records CPU and CUDA activity and
  writes a Chrome trace (``chrome://tracing``, Perfetto) into a directory;
* :func:`annotate` — named host-side region that shows up in the trace
  (``torch.profiler.record_function``);
* :func:`annotate_function` — decorator form for per-phase attribution
  (localize / integrate / NN / solve);
* :func:`device_memory_profile` — a snapshot of the CUDA caching
  allocator.

Usage::

    from cilantro_tpu_torch.utils.profiling import trace, annotate
    with trace("traces/run"):
        with annotate("localize"):
            pose, res = localize(...)
"""

from __future__ import annotations

import contextlib
import functools
import os
import pickle

import torch


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Record everything executed in the block (CPU ops, and CUDA kernels
    when a card is present) and write it as ``log_dir/trace.json``.
    ``create_perfetto_link`` is accepted for the reference's signature and
    unused: open the file in Perfetto or ``chrome://tracing``."""
    del create_perfetto_link
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region visible in profiler traces."""
    return torch.profiler.record_function(name)


def annotate_function(name=None):
    """Decorator: wrap a function in a named trace annotation."""

    def deco(fn):
        label = name or fn.__name__

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def device_memory_profile(path: str) -> None:
    """Write the CUDA caching allocator's snapshot
    (``torch.cuda.memory._snapshot()``, pickled) to ``path``. The format is
    PyTorch's snapshot, which ``torch.cuda._memory_viz`` reads, not pprof.
    Raises, and writes nothing, when there is no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_profile needs a CUDA device; none is available")
    snapshot = torch.cuda.memory._snapshot()
    with open(path, "wb") as f:
        pickle.dump(snapshot, f)
