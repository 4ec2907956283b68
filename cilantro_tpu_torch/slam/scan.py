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

A call with a ``key`` keeps its captured step for the next call of its
call site: one slot a site (the key's first item), which holds one graph,
its private memory pool and its static buffers (the carry, one ``x``, one
step's ``ys``). A later call whose key, carry shapes and dtypes, ``x``
shape and dtype and device are all equal replays the kept graph with no
warm-up and no capture; any other call of the site drops the kept graph
first, so that its pool can go, and captures anew. :func:`clear` drops
every slot. A keyless call, and every call on the CPU, keeps nothing. The
key must name every value the step reads that is neither in the carry nor
in ``x``: a captured graph holds the addresses of the tensors it read and
the Python values the step branched on at capture.

A kernel wrapper counts its launches in Python (``native.launch_counts``),
which runs once, at capture: a replay launches what the capture recorded,
so the launches of a run are ``steps × launches_per_step``. A kept graph's
replays add nothing to the counts; its ``launches_per_step`` is its
capture's.

Each phase is a ``cilantro.scan.*`` span (:mod:`..utils.profiling`): the
warm-up step and the capture, each pass over the sequence
(``pass.untimed``, ``pass.timed``), each step in it (the ``x`` copy, the
replay or the eager step, the ``ys`` copies) and the read-back of ``ys``
that ends a timed pass. No span lies inside the step, which runs only at
warm-up and capture. A keyed call on the card counts ``scan_graph_reused``
or ``scan_graph_captured``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..utils.profiling import count, span

RUNS = 3
Tensors = Tuple[torch.Tensor, ...]
Step = Callable[[Tensors, torch.Tensor], Tuple[Tensors, Tensors]]


@dataclasses.dataclass
class Scanned:
    """The result of :func:`scan`: the last run's final carry (on the
    device) and stacked ``ys`` (numpy, one row a step); host-clock and
    device seconds a step of the fastest timed run (``device_seconds`` from
    CUDA events, ``None`` on the CPU); and the kernel launches one step
    makes, by kernel (every kernel of ``native.launch_counts``, 0 where the
    step launches none)."""

    carry: Tensors
    ys: Tuple[np.ndarray, ...]
    seconds_per_step: float
    device_seconds_per_step: float | None
    launches_per_step: Dict[str, int]


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in native.launch_counts.items()}


class _GraphStep:
    """One step captured on static buffers; :meth:`run` replays it over a
    sequence."""

    def __init__(self, step: Step, carry0: Tensors, x0: torch.Tensor):
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
        before = dict(native.launch_counts)
        with span("cilantro.scan.capture"), torch.cuda.graph(self.graph, stream=stream):
            new_carry, self.ys = step(self.carry, self.x)
            for dst, src in zip(self.carry, new_carry):
                dst.copy_(src)
        self.launches = _delta(before)

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


# Call site -> (full key, kept step); see the module docstring.
_kept: Dict[str, Tuple[tuple, _GraphStep]] = {}


def clear() -> None:
    """Drop every kept graph (:func:`scan`'s ``key``), and with it its pool
    and static buffers once nothing else holds them."""
    _kept.clear()


def _graph_step(step: Step, carry0: Tensors, x0: torch.Tensor,
                key: Optional[Tuple[Hashable, ...]]) -> _GraphStep:
    """The captured step for this call: a new one without ``key``, else
    the site's kept one where the full key matches, else a new one that
    takes the site's slot."""
    if key is None:
        return _GraphStep(step, carry0, x0)
    site = key[0]
    full = (key, tuple((c.shape, c.dtype) for c in carry0), x0.shape, x0.dtype, x0.device)
    kept = _kept.pop(site, None)
    if kept is not None and kept[0] == full:
        graph = kept[1]
        count("scan_graph_reused", 1)
    else:
        del kept  # the old graph's pool is free before the new capture
        graph = _GraphStep(step, carry0, x0)
        count("scan_graph_captured", 1)
    _kept[site] = (full, graph)
    return graph


def scan(
    step: Step,
    carry0: Tensors,
    xs: torch.Tensor,
    *,
    runs: int = RUNS,
    key: Optional[Tuple[Hashable, ...]] = None,
) -> Scanned:
    """Run ``step`` over ``xs`` (at least one step) from ``carry0``
    ``runs`` times and keep the fastest by the host clock, as the JAX
    drivers do, each run ended by the read-back of its stacked ``ys``. On
    the card the capture (unless kept) comes first and, when ``runs > 1``,
    one untimed run of the sequence (the JAX driver's compile and first
    run); ``runs=1`` is one pass of the sequence. The step returns new
    tensors: none of its outputs may be a view of another position's carry
    buffer, which the copy-back would overwrite.

    ``key``: ``(site, *values)``, where ``site`` names the caller's slot
    and ``values`` are every value the step reads besides the carry and
    ``x`` (the module docstring). With a key, a later call on the card
    with equal key, shapes, dtypes and device replays the step this call
    captured; the seconds never include the capture either way. The
    returned carry is a copy: the next call overwrites the static
    buffers, so calls of one site may not overlap (two threads).

    The keyed callers' steps (``splat_scanned``, ``fusion_scanned``,
    ``batched_fusion``) read no tensor from outside the carry, ``x`` and
    what they allocate inside the capture, which the graph's pool keeps:
    no module of the port caches a grid or constant tensor between calls.
    Their closures hold Python values alone (the configuration, the
    intrinsics, the frame's height and width), and their keys name all of
    them. cuBLAS's workspace for the capture's stream stays in PyTorch's
    per-stream map for the life of the process."""
    dev = xs.device
    if dev.type == "cuda":
        graph = _graph_step(step, carry0, xs[0], key)
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
            before = dict(native.launch_counts)
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
                launches = {k: v // xs.shape[0] for k, v in _delta(before).items()}
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
