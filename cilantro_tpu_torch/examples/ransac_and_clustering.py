"""RANSAC + clustering demo (port of ``examples/ransac_and_clustering.py``)
— the reference's ``ransac_plane_estimator.cpp``,
``ransac_transform_estimator.cpp`` and clustering examples in one script.

The JAX script draws hypotheses and seeds from ``jax.random.PRNGKey(s)``;
here they come from a ``torch.Generator`` seeded with ``s``: other draws,
the same planted truth.

Usage: python -m cilantro_tpu_torch.examples.ransac_and_clustering [cloud.ply] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..clustering import connected_components, edge_mask_from_evaluator, kmeans
from ..model_estimation import ransac_plane, ransac_transform
from ..neighbors import knn_search
from ._common import generator, load_cloud, parser


def main(argv=None) -> int:
    args = parser(__doc__, cloud=True).parse_args(argv)
    dev = resolve_device(args.device)
    (pts, _, _), _ = load_cloud(args.cloud, args.points)
    pts_t = torch.as_tensor(pts[:: max(len(pts) // 15000, 1)], device=dev)  # subsample for demo
    print(f"{pts_t.shape[0]} points")

    # --- dominant plane -----------------------------------------------------
    plane, res = ransac_plane(generator(0, dev), pts_t, 0.01, num_hypotheses=200)
    print(
        f"RANSAC plane: n={plane.normal.cpu().numpy().round(3)}, "
        f"d={float(plane.offset):.3f}, inliers={int(res.num_inliers)}"
    )

    # --- robust transform from corrupted correspondences --------------------
    rng = np.random.default_rng(0)
    sub = pts_t[:2000].cpu().numpy()
    ang = 0.3
    r = np.array(
        [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
        np.float32,
    )
    t = np.float32([0.1, -0.2, 0.3])
    dst = sub @ r.T + t
    dst[:500] = rng.uniform(-2, 2, (500, 3))  # 25% junk correspondences
    tf, tres = ransac_transform(
        generator(1, dev), torch.as_tensor(sub, device=dev), torch.as_tensor(dst, device=dev), 0.02,
        num_hypotheses=200,
    )
    print(
        f"RANSAC transform: rot err {np.linalg.norm(tf.linear.cpu().numpy()-r):.2e}, "
        f"t err {np.linalg.norm(tf.translation.cpu().numpy()-t):.2e}, "
        f"inliers {int(tres.num_inliers)}/{len(sub)}"
    )

    # --- k-means ------------------------------------------------------------
    km = kmeans(generator(2, dev), pts_t, 8)
    print(f"k-means: {int(km.iterations)} iterations, 8 clusters")

    # --- connected components (euclidean) -----------------------------------
    nb = knn_search(pts_t, pts_t, 8, exclude_self=True)
    em = edge_mask_from_evaluator(nb, pts_t, max_distance=0.02)
    cc = connected_components(nb, edge_mask=em, min_size=100)
    print(
        f"connected components: {int(cc.num_components)} segments ≥100 pts, "
        f"largest {int(cc.sizes[0])}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
