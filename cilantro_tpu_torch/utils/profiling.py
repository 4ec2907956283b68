"""Profiling and tracing (port of ``cilantro_tpu/utils/profiling.py``) on
``torch.profiler``:

* :func:`trace` — context manager that records CPU and CUDA activity and
  writes a Chrome trace (``chrome://tracing``, Perfetto) into a directory;
* :func:`span` — named host-side region that shows up in any running
  profiler window;
* :func:`count` — a counter, a zero-length host event that carries its
  value in its name;
* :func:`annotate` — :func:`span` under the reference's name;
* :func:`annotate_function` — decorator form for per-phase attribution
  (localize / integrate / NN / solve);
* :func:`device_memory_profile` — a snapshot of the CUDA caching
  allocator.

A span is a host event of the profiler's function scope
(``torch._C._profiler._RecordFunctionFast``), not a user annotation
(``torch.profiler.record_function``): with the CUDA activity on, a user
annotation also leaves a ``gpu_user_annotation`` event on the device's
side as long as the kernels it encloses, which a reader of device time
would take for busy time. A span leaves nothing on the device, and with
no profiler running costs one native enter and exit, under a
microsecond.

The program's names: every one starts with ``cilantro.``; then
``entry.<name>`` for an entry call and its phases (``entry.prepare``,
``entry.finish``), ``scan.<phase>`` for :func:`..slam.scan.scan`'s
(``warmup``, ``capture``, ``pass.untimed``, ``pass.timed``, ``step``,
``readback``), and ``count.<name>=<int>`` for a counter. A span's parent
is the span that contains it on the calling thread; a call's spans and
counters are those inside its ``cilantro.entry.*`` span.

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
from torch._C._profiler import _RecordFunctionFast


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


def span(name: str):
    """A context manager: a host event named ``name`` in any running
    ``torch.profiler`` window, from entering to leaving it."""
    return _RecordFunctionFast(name)


def count(name: str, value) -> None:
    """A counter: a zero-length host event named
    ``cilantro.count.<name>=<int(value)>``. Formats nothing, and reads
    nothing of ``value``, when no profiler runs."""
    if torch.autograd._profiler_enabled():
        with _RecordFunctionFast(f"cilantro.count.{name}={int(value)}"):
            pass


def annotate(name: str):
    """Named region visible in profiler traces (:func:`span`)."""
    return span(name)


def annotate_function(name=None):
    """Decorator: wrap a function in a named trace annotation
    (:func:`span`)."""

    def deco(fn):
        label = name or fn.__name__

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(label):
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
