"""Depth image → point cloud (port of ``cilantro_tpu/core/rgbd.py``, the
part splat fusion runs).

Images are row-major ``(H, W)``; pixel (u, v) = (column, row); points are in
the camera frame (+z forward) unless a pose is given. The float32
expressions keep the JAX module's order (``(u − cx)·z/fx``) so that both
packages round alike.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .transforms import Transform, transform_normals, transform_points


def scalar_like(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d float32 tensor on ``like``'s device. Dividing by
    it is a true division on every device (PyTorch turns division by a
    Python number on CUDA into a product with its reciprocal, which rounds
    differently)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics, held as float32-rounded Python floats. The
    reference fusion example uses fx=fy=525, cx=319.5, cy=239.5 @ 640×480."""

    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def make(fx, fy, cx, cy) -> "CameraIntrinsics":
        return CameraIntrinsics(
            *(float(np.float32(v)) for v in (fx, fy, cx, cy))
        )

    @staticmethod
    def kinect_640() -> "CameraIntrinsics":
        return CameraIntrinsics.make(525.0, 525.0, 319.5, 239.5)


def depth_to_points(
    depth: torch.Tensor,
    intrinsics: CameraIntrinsics,
    pose: Optional[Transform] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Back-project a metric depth image: ``(points (H·W, 3), valid
    (H·W,))`` in row-major pixel order; invalid points are 1e30."""
    h, w = depth.shape
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    z = depth
    x = (u - intrinsics.cx) * z / scalar_like(intrinsics.fx, z)
    y = (v - intrinsics.cy) * z / scalar_like(intrinsics.fy, z)
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    valid = (z > 0).reshape(-1)
    if pose is not None:
        pts = transform_points(pose, pts)
    pts = torch.where(valid[:, None], pts, 1e30)
    return pts, valid


def depth_to_points_normals(
    depth: torch.Tensor,
    intrinsics: CameraIntrinsics,
    pose: Optional[Transform] = None,
    max_depth_jump: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Back-project + per-pixel normals from neighbouring-pixel cross
    products. Normals flip toward the camera; pixels next to a depth jump
    above ``max_depth_jump`` and the (wrapped) image border are invalid."""
    h, w = depth.shape
    pts_flat, valid_flat = depth_to_points(depth, intrinsics)
    pts = pts_flat.reshape(h, w, 3)
    valid = valid_flat.reshape(h, w)

    du = torch.roll(pts, -1, dims=1) - torch.roll(pts, 1, dims=1)
    dv = torch.roll(pts, -1, dims=0) - torch.roll(pts, 1, dims=0)
    nrm = torch.linalg.cross(dv, du, dim=-1)
    norm = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    nrm = nrm / torch.clamp(norm, min=1e-30)
    # Flip toward the camera (view point at origin): normal·p < 0.
    flip = torch.sum(nrm * pts, dim=-1, keepdim=True) > 0
    nrm = torch.where(flip, -nrm, nrm)

    z = depth
    nvalid = valid.clone()
    for shift, dim in ((-1, 1), (1, 1), (-1, 0), (1, 0)):
        nvalid &= torch.roll(valid, shift, dims=dim)
        nvalid &= ~(torch.abs(torch.roll(z, shift, dims=dim) - z) > max_depth_jump)
    # Border pixels wrap under roll: invalidate them.
    nvalid[0, :] = False
    nvalid[-1, :] = False
    nvalid[:, 0] = False
    nvalid[:, -1] = False

    pts_o = pts.reshape(-1, 3)
    nrm_o = torch.where(nvalid[..., None], nrm, 0.0).reshape(-1, 3)
    if pose is not None:
        pts_o = transform_points(pose, pts_o)
        nrm_o = transform_normals(pose, nrm_o)
    pts_o = torch.where(valid.reshape(-1)[:, None], pts_o, 1e30)
    return pts_o, nrm_o, (valid & nvalid).reshape(-1)
