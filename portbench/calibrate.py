"""Readings that set a cell's limits, on the card at the cell's own size.

    python3 -m portbench.calibrate --workload <cell> --seeds 11 12 ... \\
        [--control-seeds 11 12 13] [--out FILE]

For each seed, ``harness.readings``: the cell's clips, one entry call on
each distinct input, and the compared numbers against the plain
reference (the program's readings, of which the lower end of a limit is
the largest). For each control seed, the same with the control, the
reference computed with TF32 matrix products, in the program's place
(the upper end is the smallest such reading). One process, so the set-up
is paid once.
Prints one JSON line a reading; ``--out`` writes them all.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    cell = harness.load_cell(args.workload)
    pipe = harness.make_pipeline(cell, "cuda")
    rows = []
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        for side, control in (("program", False), ("control_tf32", True)):
            if seed not in (args.control_seeds if control else args.seeds):
                continue
            t0 = time.perf_counter()
            got = harness.readings(cell, pipe, seed, "cuda", control=control)
            rows.append(dict(workload=args.workload, seed=seed, side=side, **got,
                             seconds=time.perf_counter() - t0))
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
