"""Launch the ranks of a gloo group as subprocesses for the port's
multi-rank tests (imports no JAX).

Each rank runs ``tests/torch_parallel_worker.py SUITE RANK WORLD STORE OUT
TIMEOUT``: the group meets through a ``FileStore`` under the test's
``tmp_path`` (no fixed port, so files run side by side), the suite's
inputs come from ``inputs.npz`` there and each rank pickles its results
there. Every process is waited on with a timeout and killed on expiry."""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

WORKER = Path(__file__).with_name("torch_parallel_worker.py")
REPO = WORKER.parents[1]


class Ranks:
    """The processes of one launch; :meth:`results` waits for them."""

    def __init__(self, suite: str, world: int, tmp: Path, inputs: dict, group_timeout: float = 60.0,
                 wait_timeout: float = 240.0, device: str = "cpu"):
        self.suite, self.world, self.tmp = suite, world, Path(tmp)
        self.tmp.mkdir(parents=True, exist_ok=True)
        np.savez(self.tmp / "inputs.npz", **inputs)
        env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
        env["PYTHONPATH"] = str(REPO)
        env["OMP_NUM_THREADS"] = "1"
        self.wait_timeout = wait_timeout
        self.started = time.perf_counter()
        self.started_at = time.time()
        store = self.tmp / "store"
        self.procs = [
            subprocess.Popen(
                [sys.executable, str(WORKER), suite, str(r), str(world), str(store), str(self.tmp),
                 str(group_timeout), device],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
            )
            for r in range(world)
        ]
        self._results = None

    def results(self):
        """Each rank's result dict, in rank order; raises with the rank's
        output when a rank failed or overran its time."""
        if self._results is not None:
            return self._results
        outs = []
        try:
            for p in self.procs:
                left = max(1.0, self.wait_timeout - (time.perf_counter() - self.started))
                outs.append(p.communicate(timeout=left)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, out) in enumerate(zip(self.procs, outs)):
            assert p.returncode == 0, f"{self.suite} rank {r} failed:\n{out[-4000:]}"
        self._results = []
        for r in range(self.world):
            with open(self.tmp / f"{self.suite}_{r}.pkl", "rb") as f:
                self._results.append(pickle.load(f))
        return self._results
