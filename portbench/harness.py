"""One run of one cell: set-up, the measured window, the traced window,
and the comparison with the plain reference that decides ``correct``.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration's file, ``traffic/<traffic>.json``,
``limits/<cell>.json``, ``pipelines/<pipeline>.py`` and
``metrics/<metric>.py``. Adding a cell or a metric adds files and entries.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from . import clips as clip_gen
from . import compare
from . import trace as tracing
from .reference import geometry

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def process_start(clock: Callable[[], float] = time.perf_counter) -> float:
    """The process's start on ``clock``: from ``/proc/self/stat``'s start
    time (clock ticks since boot) against the boot clock, or the first
    import of this module where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return clock() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # the configuration file's contents
    traffic: dict
    limits: Dict[str, float]
    readers: Dict[str, object]  # per-layer metric name -> reader module
    units: Dict[str, str]  # metric name -> unit
    over_streams: str = "largest"  # how a number is taken over the streams compared


def _load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics._{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, spec: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with every file it names."""
    if spec is None:
        spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limit_file = json.loads((HERE / "limits" / f"{name}.json").read_text())
    limits = limit_file["limits"]
    readers = {m["name"]: _load_reader(m["name"]) for m in spec["per_layer"]
               if name in m.get("workloads", [name])}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    return Cell(name, config, traffic, {k: float(v) for k, v in limits.items()}, readers, units,
                limit_file.get("over_streams", "largest"))


def make_pipeline(cell: Cell, device):
    mod = importlib.import_module(f"portbench.pipelines.{cell.config['pipeline']}")
    return mod.Pipeline(cell.config, cell.traffic, device)


def make_inputs(cell: Cell, pipe, seed: int, device):
    t = cell.traffic
    depths, truth = clip_gen.make_clips(seed, t["distinct_clips"], t["frames"],
                                        cell.config["sensor"], t["motion_scale"], device)
    return pipe.inputs(depths), pipe.inputs(truth)


@dataclasses.dataclass
class Record:
    """What the window kept of its calls for the comparison."""

    poses: Dict[int, List[np.ndarray]]  # input index -> each call's poses
    maps: Dict[int, list]  # input index -> its last call's maps


# A stream whose float64 reference lies this far (m, rad) from the float32
# one at some frame has poses that rounding alone decides: not compared.
ROUNDING_DECIDED = 1e-4


OVER_STREAMS = {"largest": np.max, "median": np.median}  # NaN reads as NaN in both


def compare_outputs(pipe, inputs, truth, rec: Record, device, sensor: dict,
                    over: str = "largest") -> Dict[str, float]:
    """The compared numbers over every call kept in ``rec``: each stream's
    numbers (its pose gaps the largest over its calls), taken over the
    streams that the float64 probe finds not decided by rounding by
    ``over`` (``OVER_STREAMS``). For the record also the largest of each,
    the stream-calls compared, the streams left out, the ATE and every
    compared stream's numbers (``per_stream``)."""
    names = ("pose_gap_m", "pose_gap_rad") + compare.MAP_NUMBERS
    per_stream = []
    ate = 0.0
    compared = left_out = maps = 0
    for idx in sorted(rec.poses):
        ref = pipe.reference(inputs[idx], device)
        with geometry.float64():
            probe = pipe.reference(inputs[idx], device).poses
        poses, outs = rec.poses[idx], rec.maps.get(idx)
        for s in range(ref.poses.shape[0]):
            if max(compare.pose_gaps(probe[s], ref.poses[s])) >= ROUNDING_DECIDED:
                left_out += 1
                continue
            compared += len(poses)
            gaps = np.array([compare.pose_gaps(p[s], ref.poses[s]) for p in poses])
            row = dict(input=idx, stream=s, pose_gap_m=float(np.max(gaps[:, 0])),
                       pose_gap_rad=float(np.max(gaps[:, 1])))
            ate = max(ate, compare.ate(poses[-1][s], truth[idx][s]))
            if outs:
                row.update(compare.map_gaps(pipe.cloud(outs[s].to(device)),
                                            pipe.cloud(ref.maps[s]),
                                            ref.poses[s, -1], sensor))
                maps += 1
            per_stream.append(row)
        del ref, outs

    def over_streams(stat, k):
        vals = [r[k] for r in per_stream if k in r]
        return float(OVER_STREAMS[stat](vals)) if vals else 0.0

    numbers = {k: over_streams(over, k) for k in names}
    return dict(numbers, largest={k: over_streams("largest", k) for k in names}, ate_m=ate,
                stream_calls_compared=compared, maps_compared=maps,
                streams_rounding_decided=left_out, per_stream=per_stream)


def control_call(pipe, inp, device):
    """The control: the plain reference with TF32 matrix products, put in
    the program's place."""
    with geometry.tf32():
        return pipe.reference(inp, device)


def readings(cell: Cell, pipe, seed: int, device, control: bool = False) -> Dict[str, float]:
    """The compared numbers of one call on each distinct input of the
    cell's traffic from ``seed``: the measured entry's, or with
    ``control`` the control's in its place."""
    inputs, truth = make_inputs(cell, pipe, seed, device)
    rec = Record(poses={}, maps={})
    for i, x in enumerate(inputs):
        out = control_call(pipe, x, device) if control else pipe.call(x)
        rec.poses[i], rec.maps[i] = [out.poses], out.maps
    return compare_outputs(pipe, inputs, truth, rec, device, cell.config["sensor"],
                           cell.over_streams)


def _window(pipe, inputs, seconds: float, max_calls: Optional[int], clock, sync, cuda: bool):
    """Closed loop of whole calls, cycling through ``inputs``, until
    ``seconds`` have passed (or ``max_calls`` calls are made). The maps of
    each input's last call are kept for the comparison; the peak leaves
    them out: it is what the process held at the window's start plus the
    most any call added to what was held when it began, the peak of a
    process that keeps nothing of its calls."""
    import torch

    rec = Record(poses={}, maps={})
    calls = frames = failed = 0
    base = torch.cuda.memory_allocated() if cuda else 0
    added = 0
    t0 = clock()
    while True:
        idx = calls % len(inputs)
        calls += 1
        if cuda:
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        try:
            out = pipe.call(inputs[idx])
            sync()
        except Exception as e:  # a call that raises is a failed answer
            print(f"call {calls} on input {idx} raised {type(e).__name__}: {e}", file=sys.stderr)
            failed += 1
            break
        if cuda:
            added = max(added, torch.cuda.max_memory_allocated() - held)
        frames += out.frames
        rec.poses.setdefault(idx, []).append(out.poses)
        rec.maps[idx] = out.maps
        del out
        if (max_calls is not None and calls >= max_calls) or (
                max_calls is None and clock() - t0 >= seconds):
            break
    return rec, calls, frames, failed, clock() - t0, base + added


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, pipeline=None, clock=time.perf_counter) -> dict:
    """One run: the result line's object, its compared numbers last under
    ``checks``."""
    import torch

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if t_start is None:
        t_start = process_start(clock)
    pipe = pipeline or make_pipeline(cell, device)
    inputs, truth = make_inputs(cell, pipe, seed, device)
    warm = pipe.call(inputs[0])  # every call has the same shapes
    sync()
    del warm
    gc.collect()
    setup_s = clock() - t_start
    steps = cell.traffic["frames"] - 1
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": 1}
    metrics = {}
    breakdown = None
    if trace:
        # One untraced cycle first, so the trace sees the steady state the
        # measured window spends most of its time in (every held map
        # allocated). Its answers are compared too, so that every input is
        # (the traced calls reach a few); its maps wait on the host, out of
        # the traced window's peak.
        pre, _, _, pre_failed, _, _ = _window(pipe, inputs, 0.0, len(inputs), clock, sync, cuda)
        pre.maps = {i: [m.cpu() for m in ms] for i, ms in pre.maps.items()}
        gc.collect()
        box = {}

        def traced_calls():
            box["w"] = _window(pipe, inputs, 0.0, cell.traffic["trace_calls"], clock, sync, cuda)
            return box["w"][1], box["w"][2]

        tr = tracing.traced(traced_calls, cuda, steps, clock)
        rec, calls, frames, failed, _, peak = box["w"]
        failed += pre_failed
        for i, poses in pre.poses.items():
            rec.poses[i] = poses + rec.poses.get(i, [])
            rec.maps.setdefault(i, pre.maps[i])  # the traced call's map is the later
        for name, reader in cell.readers.items():
            value = reader.read(tr) if frames else None
            if value is not None:
                metrics[name] = {"value": value, "unit": cell.units[name]}
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        breakdown = tracing.breakdown(tr)
        del tr
    else:
        rec, calls, frames, failed, elapsed, peak = _window(pipe, inputs, seconds, None, clock,
                                                            sync, cuda)
        if frames:
            metrics["frames_per_s"] = {"value": frames / elapsed, "unit": "frames/s"}
        metrics["peak_device_mib"] = {"value": peak / 2**20, "unit": "MiB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    device_info["memory_peak_bytes"] = int(peak)

    # The comparison: after the window, with the peak read.
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = compare_outputs(pipe, inputs, truth, rec, device, cell.config["sensor"],
                              cell.over_streams)
    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in cell.limits.items()}
    correct = (failed == 0 and numbers["stream_calls_compared"] > 0
               and compare.within(numbers, cell.limits))
    out = {"correct": bool(correct), "attempted": calls, "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["info"] = {k: numbers[k] for k in ("stream_calls_compared", "streams_rounding_decided",
                                           "maps_compared", "ate_m", "largest")}
    out["info"]["over_streams"] = cell.over_streams
    out["checks"] = checks
    return out


def check_lines(result: dict) -> List[str]:
    """Each compared number beside its limit, one a line."""
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r}) "
            f"{'ok' if v['value'] <= v['limit'] else 'FAIL'}"
            for k, v in result["checks"].items()] + [f"correct: {result['correct']}"]
