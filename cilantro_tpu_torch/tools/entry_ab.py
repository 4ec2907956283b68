"""Time ``entry()``'s forward on two checkouts, in alternating processes, on
one CUDA card:

    python3 cilantro_tpu_torch/tools/entry_ab.py PARENT CHANGE [PAIRS]

``PARENT`` and ``CHANGE`` are roots of checkouts (say a parent unpacked
with ``git archive`` and the working tree). Each run is a fresh process in
one root that imports that root's ``cilantro_tpu_torch``, warms
``entry()``'s forward up three times and times ten more by the host clock,
each ended by a synchronise, then the host time of enqueueing one
``nn1_fused`` call on the forward's clouds (the mean of 50, no
synchronise between them). ``PAIRS`` (default 5) pairs run, the parent
first in the even pairs and the change first in the odd ones. One JSON
line a run (its ten times, their median and the enqueue time), then one
summary line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

RUN = """
import json, sys, time
sys.path.insert(0, ".")
import torch
from cilantro_tpu_torch import native
native.build(("nn1_kernels",))
from cilantro_tpu_torch.entry import entry
fwd, args = entry()
for _ in range(3):
    fwd(*args)
torch.cuda.synchronize()
times = []
for _ in range(10):
    t0 = time.perf_counter()
    fwd(*args)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
from cilantro_tpu_torch.neighbors.fused_nn import nn1_fused
nn1_fused(args[0], args[1])
torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(50):
    nn1_fused(args[0], args[1])
enqueue_ms = (time.perf_counter() - t0) * 1e3 / 50
torch.cuda.synchronize()
print(json.dumps(dict(ms=times, nn1_fused_enqueue_ms=enqueue_ms)))
"""


def run(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN], cwd=root, capture_output=True, text=True,
                         check=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(parent: str, change: str, pairs: int) -> int:
    medians = {"parent": [], "change": []}
    enqueue = {"parent": [], "change": []}
    for i in range(pairs):
        order = (("parent", parent), ("change", change))
        for side, root in order if i % 2 == 0 else order[::-1]:
            rec = run(root)
            medians[side].append(statistics.median(rec["ms"]))
            enqueue[side].append(rec["nn1_fused_enqueue_ms"])
            print(json.dumps(dict(pair=i, side=side, root=root, median_ms=medians[side][-1], **rec)),
                  flush=True)
    wins = sum(c < p for p, c in zip(medians["parent"], medians["change"]))
    print(json.dumps(dict(summary="entry() forward, host ms", parent_medians=medians["parent"],
                          change_medians=medians["change"], change_faster_in_pairs=wins,
                          nn1_fused_enqueue_ms=enqueue, pairs=pairs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 5))
