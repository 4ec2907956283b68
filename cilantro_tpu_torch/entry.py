"""The forward step on the toy pair (port of ``entry()`` of the JAX
package's ``__graft_entry__.py``): one rigid combined-metric ICP
registration of a 4096-point wavy sheet onto a rotated and shifted copy.
At 4096 × 4096 pairs (below the 2²⁶ prune threshold) each correspondence
pass runs the fused nn1 kernel on CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .registration.icp import icp


def _toy_pair(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    z = (0.3 * np.sin(2 * xy[:, 0]) * np.cos(2 * xy[:, 1])).astype(np.float32)
    pts = np.column_stack([xy, z])
    ang = 0.05
    r = np.array(
        [
            [np.cos(ang), -np.sin(ang), 0],
            [np.sin(ang), np.cos(ang), 0],
            [0, 0, 1],
        ],
        np.float32,
    )
    t = np.array([0.02, -0.01, 0.015], np.float32)
    dst = pts @ r.T + t
    nrm = np.zeros_like(dst)
    nrm[:, 2] = 1.0
    return pts, dst, nrm


def entry(device="cuda"):
    """``(forward, (src, dst, dst_normals))``: ``forward`` runs one full
    rigid combined-metric ICP registration and returns the transform's
    ``(linear, translation)``; the inputs lie on ``device``."""
    dev = resolve_device(device)
    pts, dst, nrm = _toy_pair()

    def forward(src_points, dst_points, dst_normals):
        res = icp(
            src_points,
            dst_points,
            dst_normals=dst_normals,
            metric="combined",
            point_weight=0.3,
            max_corr_dist_sq=0.25,
            max_iterations=10,
        )
        return res.transform.linear, res.transform.translation

    inputs = tuple(torch.as_tensor(a, device=dev) for a in (pts, dst, nrm))
    return forward, inputs
