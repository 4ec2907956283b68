"""Two-count op timing (port of ``cilantro_tpu/utils/honest_timing.py``).

The per-call time of ``fn`` comes from TWO loop lengths,
``(t_hi - t_lo) / (hi - lo)``: whatever each measurement pays once (the
launch and synchronise floor: the first launch's latency, the wait for
the last, the events' own cost) cancels exactly, so a call far shorter
than that floor is still measured. ``linearity = t_hi / t_lo`` is about
``hi / lo`` when the loop's time grows with its length; near 1 it flags a
measurement that the floor swamped.

Eager PyTorch runs every call it is given (there is no compiler to hoist
a loop-invariant body out of the loop, as XLA may hoist a scan's), so the
loops here are plain repetitions. On the card each loop is bracketed by
CUDA events (best of ``reps`` after one warm-up); on the CPU by the host
clock. A loop of eager launches measures the host's enqueue rate where
that is slower than the device; pass ``precompiled`` (for example
CUDA-graph replays of the two loops) to take the host out.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from .timer import _first_tensor

_clock = time.perf_counter  # the host clock of CPU measurements


def _looped(fn, iters):
    """A callable that runs ``fn(*args)`` ``iters`` times back to back and
    returns the last result."""

    def run(*args):
        out = None
        for _ in range(iters):
            out = fn(*args)
        return out

    return run


@dataclasses.dataclass
class OpTime:
    per_iter_ms: float
    linearity: float  # t_hi / t_lo; ~hi/lo when honest, ~1 when swamped
    floor_ms: float  # extrapolated zero-iteration cost (launch + sync)
    t_lo_ms: float
    t_hi_ms: float

    def __str__(self):
        flag = "" if self.linearity > 1.3 else "  [SUSPECT: body hoisted?]"
        return (
            f"{self.per_iter_ms:8.2f} ms/iter  "
            f"(floor {self.floor_ms:.1f} ms, lin x{self.linearity:.2f}){flag}"
        )


def _best(f, args, reps, device) -> float:
    """Best ms of ``reps`` runs of ``f(*args)`` after one warm-up: CUDA
    events on a CUDA device, the host clock on the CPU."""
    f(*args)
    best = float("inf")
    for _ in range(reps):
        if device is not None:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f(*args)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = _clock()
            f(*args)
            ms = (_clock() - t0) * 1e3
        best = min(best, ms)
    return best


def op_time(fn, args, lo=2, hi=8, reps=3, precompiled=None) -> OpTime:
    """Per-call time of ``fn(*args)`` on the device of ``args``' first
    tensor leaf (the CPU when there is none).

    ``precompiled``: optional ``(run_lo, run_hi)`` callables, each taking
    ``*args`` and doing the work of ``lo`` and ``hi`` calls (for example
    replays of two captured CUDA graphs); ``fn`` is then unused.
    """
    t = _first_tensor(args)
    device = t.device if t is not None and t.device.type == "cuda" else None
    if precompiled is not None:
        f_lo, f_hi = precompiled
    else:
        f_lo, f_hi = _looped(fn, lo), _looped(fn, hi)
    t_lo = _best(f_lo, args, reps, device)
    t_hi = _best(f_hi, args, reps, device)
    per = (t_hi - t_lo) / (hi - lo)
    return OpTime(
        per_iter_ms=per,
        linearity=t_hi / max(t_lo, 1e-9),
        floor_ms=t_lo - lo * per,
        t_lo_ms=t_lo,
        t_hi_ms=t_hi,
    )
