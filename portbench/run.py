"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``cilantro_tpu_torch``. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; the compared numbers beside their limits last, under
``checks``); the last lines of standard error repeat the compared numbers.
With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiler window.

Exits with another code than 0, and prints no result, without a CUDA
device, without the measured package, or when the process holds ``jax``,
``jaxlib``, ``flax`` or ``cilantro_tpu`` after the run.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cilantro_tpu")


def _cache_dirs() -> None:
    """The CUDA driver's kernel cache inside the checkout, at a fixed path
    (the measured package builds its kernels into its own ``_build/``)."""
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / ".portbench_cache" / "cuda")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``cilantro_tpu_torch`` is not ``cilantro_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def _clean(x):
    """JSON-safe: non-finite floats become null."""
    if isinstance(x, dict):
        return {k: _clean(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_clean(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    t_start = harness.process_start()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell_entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell_entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell_entry["chips"]:
        print(f"needs {cell_entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    try:
        import cilantro_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the measured package is not in this checkout: {e}", file=sys.stderr)
        return 4
    cell = harness.load_cell(args.workload, spec)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 5
    info = result.pop("info")
    print(f"info: {json.dumps(_clean(info))}", file=sys.stderr)
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_clean(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
