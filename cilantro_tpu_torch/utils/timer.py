"""Stopwatch (port of ``cilantro_tpu/utils/timer.py``; reference
``utilities/timer.hpp:7-43``) plus a variant that waits for the card before
reading the clock: CUDA launches return before the work ends, so a host
clock read without a wait times the enqueue."""

from __future__ import annotations

import dataclasses
import time

import torch

_clock = time.perf_counter  # the host clock every timer here reads


class Timer:
    def __init__(self):
        self._start = _clock()

    def start(self) -> "Timer":
        self._start = _clock()
        return self

    def elapsed_seconds(self) -> float:
        return _clock() - self._start

    def elapsed_milliseconds(self) -> float:
        return self.elapsed_seconds() * 1e3


def _first_tensor(x):
    """The first tensor leaf of ``x``, walking tuples, lists, dicts and
    dataclasses in order; None if it holds none."""
    if isinstance(x, torch.Tensor):
        return x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        for item in x:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


def _wait(result) -> None:
    """Wait for the device of ``result``'s first tensor leaf; a CPU result
    is ready when it is returned."""
    t = _first_tensor(result)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def time_blocked(fn, *args, repeats: int = 1, **kwargs):
    """Run ``fn`` once to warm up, then ``repeats`` times, waiting for the
    device of the result's first tensor leaf after each run. Returns
    ``(last_result, seconds_per_run)``."""
    result = fn(*args, **kwargs)
    _wait(result)
    t = Timer()
    for _ in range(repeats):
        result = fn(*args, **kwargs)
        _wait(result)
    return result, t.elapsed_seconds() / max(repeats, 1)
