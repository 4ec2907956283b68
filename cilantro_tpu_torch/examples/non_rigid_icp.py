"""Non-rigid (embedded-deformation-graph) ICP demo (port of
``examples/non_rigid_icp.py``) — the reference's
``examples/non_rigid_icp.cpp`` recipe: bend a cloud smoothly, recover the
warp field with 2.5 cm control nodes.

Usage: python -m cilantro_tpu_torch.examples.non_rigid_icp [cloud.ply] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..core.containers import PointCloud
from ..core.grid import grid_downsample
from ..registration import build_deformation_graph, icp_warp_field, warp_points
from ._common import load_cloud, parser


def main(argv=None) -> int:
    args = parser(__doc__, cloud=True).parse_args(argv)
    dev = resolve_device(args.device)
    (src, _, _), _ = load_cloud(args.cloud, args.points)
    print(f"{len(src)} points")

    dst = src.copy()
    dst[:, 2] += 0.02 * np.sin(8.0 * src[:, 0])
    dst[:, 1] += 0.01 * np.cos(6.0 * src[:, 0])

    src_t = torch.as_tensor(src, device=dev)
    ctrl = grid_downsample(PointCloud(points=src_t), 0.025, capacity=16384)
    graph = build_deformation_graph(
        src_t, ctrl.points, node_valid=ctrl.valid,
        k_anchors=4, k_arcs=8, device=dev,
    )
    print(f"{int(ctrl.valid.sum())} control nodes")

    t0 = time.time()
    node_tf, iters, converged = icp_warp_field(
        graph,
        src_t,
        torch.as_tensor(dst, device=dev),
        max_corr_dist_sq=0.0025,
        point_weight=1.0,
        plane_weight=0.0,
        stiffness=50.0,
        max_iterations=10,
        max_cg_iterations=200,
        device=dev,
    )
    warped = warp_points(graph, node_tf, src_t, device=dev).cpu().numpy()
    err = np.linalg.norm(warped - dst, axis=1)
    print(f"done in {time.time()-t0:.1f}s ({int(iters)} outer iterations)")
    print(f"median error {np.median(err)*1e3:.2f} mm vs ~20 mm deformation")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
