"""Whether two checkouts' scanned drivers give the same bits on one CUDA
card:

    python3 cilantro_tpu_torch/tools/scanned_ab.py PARENT CHANGE

``PARENT`` and ``CHANGE`` are roots of checkouts (say a parent unpacked
with ``git archive`` and the working tree). Each root runs in a process of
its own that imports its ``cilantro_tpu_torch``, builds its kernels and
runs ``run_fusion_sequence_scanned`` and ``run_splat_sequence_scanned`` at
``chip_smoke.py`` phases 21-22's settings (16 synthetic 640×480 frames; a
pool of 430,080 rows with stride-2 localize; radius 4, margin 16), each
twice in a row: on the clip of seed 0, then on that of seed 1, whose call
replays the first call's graph where the checkout keeps it. One JSON line
a root (for each call, suffix ``_0`` and ``_1``: SHA-256 digests of the
pool driver's poses and pool and of the splat driver's poses and map, the
ICP and GN iterations, and the host ms a frame of each), then one line
that says which agree.
"""

from __future__ import annotations

import json
import subprocess
import sys

RUN = """
import hashlib, json, sys
sys.path.insert(0, ".")
import numpy as np
from cilantro_tpu_torch import native
native.build()
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
from cilantro_tpu_torch.slam import splat_fusion as sf
from cilantro_tpu_torch.slam.driver import run_fusion_sequence_scanned, synthetic_sequence
from cilantro_tpu_torch.slam.fusion import FusionConfig

def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

k = CameraIntrinsics.kinect_640()
clips = [synthetic_sequence(16, 480, 640, k, seed=s)[0] for s in (0, 1)]
out = {}
for i, depths in enumerate(clips):
    fmap, met = run_fusion_sequence_scanned(depths, k, map_capacity=430_080,
                                            cfg=FusionConfig(localize_stride=2))
    out.update({f"pool_poses_{i}": digest(np.stack(met.poses)), f"pool_{i}": digest(fmap.data.cpu().numpy()),
                f"icp_iterations_{i}": met.icp_iterations, f"pool_ms_per_frame_{i}": met.seconds_per_frame * 1e3})
for i, depths in enumerate(clips):
    stats = {}
    smap, poses, spf, _ = sf.run_splat_sequence_scanned(depths, k, cfg=sf.SplatConfig(radius=4, margin=16),
                                                        stats=stats)
    out.update({f"splat_poses_{i}": digest(np.stack(poses)), f"splat_{i}": digest(smap.rows.cpu().numpy()),
                f"gn_iterations_{i}": stats["iterations"], f"splat_ms_per_frame_{i}": spf * 1e3})
print(json.dumps(out))
"""

KEYS = tuple(f"{k}_{i}" for i in (0, 1)
             for k in ("pool_poses", "pool", "icp_iterations", "splat_poses", "splat", "gn_iterations"))


def run(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", RUN], cwd=root, capture_output=True, text=True,
                         timeout=900, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    results = {}
    for label, root in (("parent", sys.argv[1]), ("change", sys.argv[2])):
        results[label] = run(root)
        print(json.dumps({"root": label, **results[label]}), flush=True)
    print(json.dumps({"same": {k: results["parent"][k] == results["change"][k] for k in KEYS}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
