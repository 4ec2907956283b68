"""Rigid ICP demo (port of ``examples/rigid_icp.py``) — the reference's
``examples/rigid_icp.cpp`` recipe: apply a known transform to a cloud,
recover it, print TRUE vs ESTIMATED.

Usage: python -m cilantro_tpu_torch.examples.rigid_icp [cloud.ply] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..registration.icp import icp_multires
from ._common import load_cloud, parser


def main(argv=None) -> int:
    args = parser(__doc__, cloud=True).parse_args(argv)
    dev = resolve_device(args.device)
    (pts, normals, _), source = load_cloud(args.cloud, args.points)
    print(f"{len(pts)} points from {source}")

    # Distort: a known rigid transform about the centroid.
    ang = 0.05
    r_true = np.array(
        [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
        np.float32,
    )
    t_true = np.array([0.02, -0.015, 0.01], np.float32)
    c = pts.mean(0)
    src = (pts - c) @ r_true.T + t_true + c

    t0 = time.time()
    res = icp_multires(
        torch.as_tensor(src, device=dev),
        torch.as_tensor(pts, device=dev),
        dst_normals=torch.as_tensor(normals, device=dev) if normals is not None else None,
        metric="combined",
        convergence_tol=1e-6,
    )
    est = res.transform.matrix().cpu().numpy()
    print(f"registered in {time.time()-t0:.2f}s (includes first-use setup)")

    true = np.eye(4, dtype=np.float32)
    true[:3, :3] = r_true.T
    true[:3, 3] = c - r_true.T @ (t_true + c)
    print("TRUE transform (inverse of distortion):\n", true)
    print("ESTIMATED transform:\n", est)
    print("max abs error:", np.abs(est - true).max())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
