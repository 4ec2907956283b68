"""Whether two checkouts' scanned drivers give the same bits on one CUDA
card:

    python3 cilantro_tpu_torch/tools/scanned_ab.py PARENT CHANGE

``PARENT`` and ``CHANGE`` are roots of checkouts (say a parent unpacked
with ``git archive`` and the working tree). Each root runs in a process of
its own that imports its ``cilantro_tpu_torch``, builds its kernels and
runs ``run_fusion_sequence_scanned`` and ``run_splat_sequence_scanned`` at
``chip_smoke.py`` phases 21-22's settings (16 synthetic 640×480 frames,
seed 0; a pool of 430,080 rows with stride-2 localize; radius 4, margin
16). One JSON line a root (SHA-256 digests of the pool driver's poses and
pool and of the splat driver's poses, the ICP iterations and the host ms a
frame of each), then one line that says which agree.
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
depths, _ = synthetic_sequence(16, 480, 640, k, seed=0)
fmap, met = run_fusion_sequence_scanned(depths, k, map_capacity=430_080, cfg=FusionConfig(localize_stride=2))
_, poses, spf, _ = sf.run_splat_sequence_scanned(depths, k, cfg=sf.SplatConfig(radius=4, margin=16))
print(json.dumps({"pool_poses": digest(np.stack(met.poses)), "pool": digest(fmap.data.cpu().numpy()),
                  "splat_poses": digest(np.stack(poses)), "icp_iterations": met.icp_iterations,
                  "pool_ms_per_frame": met.seconds_per_frame * 1e3, "splat_ms_per_frame": spf * 1e3}))
"""

KEYS = ("pool_poses", "pool", "splat_poses", "icp_iterations")


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
