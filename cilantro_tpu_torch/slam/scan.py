"""Whole-sequence drivers as CUDA-graph replays: the counterpart of the JAX
package's ``lax.scan`` drivers (``run_splat_sequence_scanned``,
``run_fusion_sequence_scanned``), which run a sequence as one compiled
program.

:func:`scan` runs ``step(carry, x) -> (carry, ys)`` over the leading axis
of ``xs``. On the card it warms one step up on a side stream, captures one
step in a ``torch.cuda.CUDAGraph`` on static buffers (carry in, ``x`` in,
``ys`` out, the new carry copied back onto the carry in inside the graph)
and replays it once a step, after copying the step's ``x`` into its static
buffer from ``xs``, which lie on the card already. Between the first
replay and the read-back of ``ys`` at the end of a run the host never waits
on the device; a capture that fails raises, and nothing falls back to
eager steps. On the CPU the same step runs eagerly.

A kernel wrapper counts its launches in Python, which runs once, at
capture: a replay launches what the capture recorded, so the launches of a
run are ``steps × launches_per_step``.

Each phase is a ``cilantro.scan.*`` span (:mod:`..utils.profiling`): the
warm-up step and the capture, each pass over the sequence
(``pass.untimed``, ``pass.timed``), each step in it (the ``x`` copy, the
replay or the eager step, the ``ys`` copies) and the read-back of ``ys``
that ends a timed pass. No span lies inside the step, which runs only at
warm-up and capture.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import span

RUNS = 3
Tensors = Tuple[torch.Tensor, ...]
Step = Callable[[Tensors, torch.Tensor], Tuple[Tensors, Tensors]]


@dataclasses.dataclass
class Scanned:
    """The result of :func:`scan`: the last run's final carry (on the
    device) and stacked ``ys`` (numpy, one row a step); host-clock and
    device seconds a step of the fastest timed run (``device_seconds`` from
    CUDA events, ``None`` on the CPU); and the kernel launches one step
    makes, by counter name."""

    carry: Tensors
    ys: Tuple[np.ndarray, ...]
    seconds_per_step: float
    device_seconds_per_step: float | None
    launches_per_step: Dict[str, int]


def _counts(counters: Sequence[Dict[str, int]]) -> Dict[str, int]:
    return {k: v for c in counters for k, v in c.items()}


def _delta(before: Dict[str, int], counters) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _counts(counters).items()}


class _GraphStep:
    """One step captured on static buffers; :meth:`run` replays it over a
    sequence."""

    def __init__(self, step: Step, carry0: Tensors, x0: torch.Tensor, counters):
        with span("cilantro.scan.warmup"):
            self.carry = tuple(c.clone() for c in carry0)
            self.x = x0.clone()
            self.graph = torch.cuda.CUDAGraph()
            stream = torch.cuda.Stream(device=x0.device)
            stream.wait_stream(torch.cuda.current_stream())
            # Warm-up on the capture's stream: libraries load, cuBLAS and
            # cuSOLVER set up their handles and workspaces, kernels set their
            # attributes. Its output is dropped; the carry is left as it was.
            with torch.cuda.stream(stream):
                step(self.carry, self.x)
            torch.cuda.current_stream().wait_stream(stream)
        before = _counts(counters)
        with span("cilantro.scan.capture"), torch.cuda.graph(self.graph, stream=stream):
            new_carry, self.ys = step(self.carry, self.x)
            for dst, src in zip(self.carry, new_carry):
                dst.copy_(src)
        self.launches = _delta(before, counters)

    def run(self, carry0: Tensors, xs: torch.Tensor) -> Tensors:
        for dst, src in zip(self.carry, carry0):
            dst.copy_(src)
        out = tuple(torch.empty((xs.shape[0],) + y.shape, dtype=y.dtype, device=y.device)
                    for y in self.ys)
        for i in range(xs.shape[0]):
            with span("cilantro.scan.step"):
                self.x.copy_(xs[i])
                self.graph.replay()
                for o, y in zip(out, self.ys):
                    o[i].copy_(y)
        return out


def scan(
    step: Step,
    carry0: Tensors,
    xs: torch.Tensor,
    *,
    counters: Sequence[Dict[str, int]] = (),
    runs: int = RUNS,
) -> Scanned:
    """Run ``step`` over ``xs`` (at least one step) from ``carry0``
    ``runs`` times and keep the fastest by the host clock, as the JAX
    drivers do, each run ended by the read-back of its stacked ``ys``. On
    the card the capture comes first and, when ``runs > 1``, one untimed
    run of the sequence (the JAX driver's compile and first run);
    ``runs=1`` is one pass of the sequence after the capture. ``counters`` are the
    launch-count dicts of the kernels the step may launch. The step
    returns new tensors: none of its outputs may be a view of another
    position's carry buffer, which the copy-back would overwrite."""
    dev = xs.device
    if dev.type == "cuda":
        graph = _GraphStep(step, carry0, xs[0], counters)
        launches = graph.launches
        if runs > 1:
            with span("cilantro.scan.pass.untimed"):
                graph.run(carry0, xs)

        def one_run():
            return graph.carry, graph.run(carry0, xs)

    else:
        launches = None  # counted over the first run

        def one_run():
            carry, ys = carry0, []
            for i in range(xs.shape[0]):
                with span("cilantro.scan.step"):
                    carry, y = step(carry, xs[i])
                ys.append(y)
            return carry, tuple(torch.stack(col) for col in zip(*ys))

    best = best_dev = float("inf")
    for _ in range(runs):
        with span("cilantro.scan.pass.timed"):
            before = _counts(counters)
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            carry, ys = one_run()
            if dev.type == "cuda":
                end.record()
            with span("cilantro.scan.readback"):
                ys_host = tuple(y.cpu().numpy() for y in ys)
            if launches is None:
                launches = {k: v // xs.shape[0] for k, v in _delta(before, counters).items()}
            best = min(best, time.perf_counter() - t0)
            if dev.type == "cuda":
                best_dev = min(best_dev, start.elapsed_time(end) * 1e-3)
    n = xs.shape[0]
    return Scanned(
        carry=tuple(c.clone() for c in carry),
        ys=ys_host,
        seconds_per_step=best / n,
        device_seconds_per_step=best_dev / n if dev.type == "cuda" else None,
        launches_per_step=launches,
    )
