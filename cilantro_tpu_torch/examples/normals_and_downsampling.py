"""Normal estimation + grid downsampling demo (port of
``examples/normals_and_downsampling.py``) — the reference's
``normal_estimation.cpp`` / ``downsampling.cpp`` examples.

Usage: python -m cilantro_tpu_torch.examples.normals_and_downsampling [cloud.ply] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..core.containers import PointCloud
from ._common import load_cloud, parser


def main(argv=None) -> int:
    args = parser(__doc__, cloud=True).parse_args(argv)
    dev = resolve_device(args.device)
    (pts, stored_normals, _), _ = load_cloud(args.cloud, args.points)
    cloud = PointCloud(points=torch.as_tensor(pts, device=dev))
    print(f"{len(pts)} points")

    t0 = time.time()
    down = cloud.grid_downsampled(0.01)
    print(f"downsample @1cm: {int(down.num_valid())} bins ({time.time()-t0:.2f}s)")

    # kNN normals on a subsample of about 20,000 points, as the JAX demo.
    step = max(len(pts) // 20000, 1)
    sub = pts[::step]
    sub_n = stored_normals[::step] if stored_normals is not None else None
    t0 = time.time()
    with_n = PointCloud(points=torch.as_tensor(sub, device=dev)).with_normals_knn(k=12)
    est = with_n.normals.cpu().numpy()
    print(f"kNN normals on {len(sub)} points: {time.time()-t0:.2f}s")

    if sub_n is not None:
        agree = np.abs(np.einsum("nd,nd->n", est, sub_n))
        print(f"|dot| vs the input's stored normals: median {np.median(agree):.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
