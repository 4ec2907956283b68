"""Where the whole-clip entries' host time goes, call by call, on one CUDA
card:

    python3 cilantro_tpu_torch/tools/entry_phases.py [--calls N] [--seed S] ROOT [ROOT ...]

(``--device cpu`` runs the same on the CPU, to rehearse at a small size.)

Each ``ROOT`` is the root of a checkout that holds ``cilantro_tpu_torch``
and ``portbench/`` (say a parent unpacked with ``git archive`` and the
working tree). For each root and each cell of the root's
``BENCHMARK.json``, a fresh process in that root builds the cell's
pipeline and clips from ``S`` as ``portbench.run`` does, warms one call
up, times ``N`` calls by the host clock (each ended by a synchronise),
then ``N`` calls more, each alone in a ``torch.profiler`` window with the
CUDA activity on (``portbench.trace.traced``). Of each traced call it
keeps the host milliseconds of every ``cilantro.`` span, summed by name
(``other``: the entry span less its ``entry.*`` and ``scan.*`` children,
and the device's busy milliseconds inside each), the GN counters and the
kept-graph counters (``scan_graph_reused`` / ``scan_graph_captured``). It
also times 200,000 enters and exits of ``utils.profiling.span`` with no
profiler running. A checkout without the spans reports call times only.

One JSON line a root and cell (the per-call lists), then one summary line
a root and cell: the median call, untraced and traced, each span's median
and its median in the slow calls (1.2× the traced median or more), with
the span that grew most there, and the share of traced calls that
replayed a kept graph (``None`` for a checkout that keeps none). Lines go to standard output and, with
``--out FILE``, to ``FILE``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

RUN = r"""
import gc, json, sys, time
sys.path.insert(0, ".")
import torch
from portbench import harness, run, trace

run._cache_dirs()
cell = harness.load_cell(sys.argv[1])
calls, seed, device = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
cuda = device == "cuda"
sync = torch.cuda.synchronize if cuda else (lambda: None)
pipe = harness.make_pipeline(cell, device)
inputs, _ = harness.make_inputs(cell, pipe, seed, device)
pipe.call(inputs[0])
sync()

try:
    from cilantro_tpu_torch.utils.profiling import span
except ImportError:
    span = None
span_ns = None
if span is not None:
    t0 = time.perf_counter()
    for _ in range(200_000):
        with span("cilantro.probe"):
            pass
    span_ns = (time.perf_counter() - t0) * 1e9 / 200_000

def one(i):
    t0 = time.perf_counter()
    out = pipe.call(inputs[i % len(inputs)])
    sync()
    return (time.perf_counter() - t0) * 1e3, out.frames

untraced = [one(i)[0] for i in range(calls)]
gc.collect()
CHILDREN = ("cilantro.entry.prepare", "cilantro.scan.warmup", "cilantro.scan.capture",
            "cilantro.scan.pass.untimed", "cilantro.scan.pass.timed", "cilantro.entry.finish")
rows = []
for i in range(calls):
    box = {}

    def call():
        box["ms"], frames = one(i)
        return 1, frames

    t = trace.traced(call, cuda, cell.traffic["frames"] - 1, time.perf_counter)
    busy = t.busy_intervals()

    def busy_ms(s, e):
        return 1e3 * sum(max(0.0, min(e, b) - max(s, a)) for a, b in busy if a < e and b > s)

    host, dev, counts = {}, {}, {}
    for n, s, e in t.host_ops:
        if n.startswith("cilantro.count."):
            k, v = n[len("cilantro.count."):].split("=")
            counts[k] = counts.get(k, 0) + int(v)
        elif n.startswith("cilantro."):
            key = "entry" if n in ("cilantro.entry.splat_scanned", "cilantro.entry.fusion_scanned",
                                   "cilantro.entry.batched_fusion") else n[len("cilantro."):]
            host[key] = host.get(key, 0.0) + (e - s) * 1e3
            dev[key] = dev.get(key, 0.0) + busy_ms(s, e)
    if "entry" in host:
        kids = [k[len("cilantro."):] for k in CHILDREN]
        host["other"] = host["entry"] - sum(host.get(k, 0.0) for k in kids)
        dev["other"] = dev["entry"] - sum(dev.get(k, 0.0) for k in kids)
    rows.append(dict(ms=box["ms"], window_ms=t.window_s * 1e3, busy_ms=t.busy_s() * 1e3,
                     host=host, dev=dev, counts=counts))
    del t
print(json.dumps(dict(cell=cell.name, calls=calls, seed=seed, span_ns=span_ns,
                      device=torch.cuda.get_device_name() if cuda else "cpu",
                      untraced_ms=untraced, traced=rows)))
"""


def cells(root: str):
    with open(f"{root}/BENCHMARK.json") as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def measure(root: str, cell: str, calls: int, seed: int, device: str) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN, cell, str(calls), str(seed), device],
                         cwd=root, capture_output=True, text=True, timeout=1800)
    if out.returncode:
        raise RuntimeError(f"{root} {cell}: exit {out.returncode}\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def summary(root: str, r: dict) -> dict:
    traced = [row["ms"] for row in r["traced"]]
    med = statistics.median(traced)
    slow = [row for row in r["traced"] if row["ms"] >= 1.2 * med]
    names = sorted({k for row in r["traced"] for k in row["host"]})

    def median_of(rows, key, part="host"):
        vals = [row[part].get(key, 0.0) for row in rows]
        return statistics.median(vals) if vals else None

    phases = {k: dict(host_ms=median_of(r["traced"], k),
                      device_busy_ms=median_of(r["traced"], k, "dev"),
                      slow_host_ms=median_of(slow, k)) for k in names}
    grew = max((k for k in names if k != "entry" and slow),
               key=lambda k: phases[k]["slow_host_ms"] - phases[k]["host_ms"], default=None)
    def total(counter):
        return sum(row["counts"].get(counter, 0) for row in r["traced"])

    kept, ran = total("gn_iterations_kept"), total("gn_iterations_run")
    reused, captured = total("scan_graph_reused"), total("scan_graph_captured")
    return dict(root=root, cell=r["cell"], device=r["device"], span_ns=r["span_ns"],
                untraced_ms_median=statistics.median(r["untraced_ms"]),
                untraced_ms_max=max(r["untraced_ms"]), traced_ms_median=med,
                traced_ms_max=max(traced), slow_calls=len(slow), phases=phases, grew_most=grew,
                gn_useful_share=100.0 * kept / ran if ran else None,
                graph_reused_share=(100.0 * reused / (reused + captured)
                                    if reused + captured else None))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("roots", nargs="+")
    p.add_argument("--calls", type=int, default=30)
    p.add_argument("--seed", type=int, default=2**31 + 2101)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    lines = []
    for cell in cells(args.roots[0]):
        for root in args.roots:
            r = measure(root, cell, args.calls, args.seed, args.device)
            lines += [json.dumps(dict(root=root, **r)), json.dumps(summary(root, r))]
            print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
