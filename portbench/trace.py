"""The traced window: ``torch.profiler`` over whole entry calls, reduced
to the intervals the per-layer readers and the breakdown read.

Device operations are the profiler's CUDA-side events (kernels, copies,
fills), graph replays' kernels included; host operations are the
CPU-side events (PyTorch ops and CUDA runtime calls such as
``cudaGraphLaunch``). Times are seconds on the profiler's clock.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

Span = Tuple[str, float, float]


@dataclasses.dataclass
class Trace:
    device_ops: List[Span]  # every device-side event
    host_ops: List[Span]  # every host-side event
    window_s: float  # host seconds of the traced calls
    frames: int  # frames the traced calls delivered
    calls: int
    steps_per_call: int  # tracked steps of one call (frames a clip - 1)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device events, merged, in time order."""
        spans = sorted((s, e) for _, s, e in self.device_ops if e > s)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e in self.device_ops if match(n))


def _spans(prof) -> Tuple[List[Span], List[Span]]:
    """(device, host) spans of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    dev: List[Span] = []
    host: List[Span] = []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() * 1e-9
        span = (ev.name(), start, start + ev.duration_ns() * 1e-9)
        (dev if ev.device_type() == DeviceType.CUDA else host).append(span)
    return dev, host


def traced(calls: Callable[[], Tuple[int, int]], cuda: bool, steps_per_call: int,
           clock: Callable[[], float]) -> Trace:
    """Run ``calls()`` (which makes the traced entry calls and returns
    ``(calls made, frames delivered)``) under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = clock()
        n_calls, frames = calls()
        if cuda:
            torch.cuda.synchronize()
        window = clock() - t0
    dev, host = _spans(prof)
    return Trace(device_ops=dev, host_ops=host, window_s=window, frames=frames, calls=n_calls,
                 steps_per_call=steps_per_call)


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def breakdown(t: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, summed by name, and the
    longest idle gaps of the device, each named by the innermost host
    operation running at its middle."""
    by_name: Dict[str, float] = {}
    for n, s, e in t.device_ops:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = t.busy_intervals()
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = sorted(t.host_ops, key=lambda sp: sp[1])
    out = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        inner: Optional[Span] = None
        for sp in host:
            if sp[1] > mid:
                break
            if sp[2] >= mid and (inner is None or sp[1] >= inner[1]):
                inner = sp
        out.append([_short(inner[0]) if inner else "(no host op)", e - s])
    return {"device_ops": [[_short(n), v] for n, v in ops], "idle_gaps": out}
