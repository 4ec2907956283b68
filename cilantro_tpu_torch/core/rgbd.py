"""Depth image ↔ point cloud (port of ``cilantro_tpu/core/rgbd.py``).

Images are row-major ``(H, W)``; pixel (u, v) = (column, row); points are in
the camera frame (+z forward) unless a pose is given. The float32
expressions keep the JAX module's order (``(u − cx)·z/fx``) so that both
packages round alike.

The z-buffer (:func:`_zbuffer_winner`) keeps the JAX module's winner rule
exactly: a scatter-min of a packed int32 key (quantized z above the point
index). Exact keys would pick other winners among ties in one z bucket.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from .containers import PointCloud
from .grid import floor_int32
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

    def matrix(self, device="cuda") -> torch.Tensor:
        """The 3×3 pinhole matrix ``K``, float32 on ``device``."""
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=resolve_device(device),
        )


def depth_to_metric(
    raw: torch.Tensor, scale: float = 0.001, max_depth: Optional[float] = None
) -> torch.Tensor:
    """Raw sensor depth → metric float32, 0 = invalid (beyond ``max_depth``
    too)."""
    z = raw.to(torch.float32) * scale
    if max_depth is not None:
        z = torch.where(z > max_depth, 0.0, z)
    return z


def depth_to_points(
    depth: torch.Tensor,
    intrinsics: CameraIntrinsics,
    pose: Optional[Transform] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Back-project a metric depth image: ``(points (H·W, 3), valid
    (H·W,))`` in row-major pixel order; invalid points are 1e30. Leading
    dimensions of ``depth (..., H, W)`` are a batch of images."""
    h, w = depth.shape[-2:]
    batch = depth.shape[:-2]
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    z = depth
    x = (u - intrinsics.cx) * z / scalar_like(intrinsics.fx, z)
    y = (v - intrinsics.cy) * z / scalar_like(intrinsics.fy, z)
    pts = torch.stack([x, y, z], dim=-1).reshape(batch + (-1, 3))
    valid = (z > 0).reshape(batch + (-1,))
    if pose is not None:
        pts = transform_points(pose, pts)
    pts = torch.where(valid[..., None], pts, 1e30)
    return pts, valid


def depth_to_points_normals(
    depth: torch.Tensor,
    intrinsics: CameraIntrinsics,
    pose: Optional[Transform] = None,
    max_depth_jump: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Back-project + per-pixel normals from neighbouring-pixel cross
    products. Normals flip toward the camera; pixels next to a depth jump
    above ``max_depth_jump`` and the (wrapped) image border are invalid.
    Leading dimensions of ``depth (..., H, W)`` are a batch of images."""
    batch = depth.shape[:-2]
    pts_flat, valid_flat = depth_to_points(depth, intrinsics)
    pts = pts_flat.reshape(depth.shape + (3,))
    valid = valid_flat.reshape(depth.shape)

    # Image rows are dimension -3 of pts and -2 of valid, columns the next.
    du = torch.roll(pts, -1, dims=-2) - torch.roll(pts, 1, dims=-2)
    dv = torch.roll(pts, -1, dims=-3) - torch.roll(pts, 1, dims=-3)
    nrm = torch.linalg.cross(dv, du, dim=-1)
    norm = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    nrm = nrm / torch.clamp(norm, min=1e-30)
    # Flip toward the camera (view point at origin): normal·p < 0.
    flip = torch.sum(nrm * pts, dim=-1, keepdim=True) > 0
    nrm = torch.where(flip, -nrm, nrm)

    z = depth
    nvalid = valid.clone()
    for shift, dim in ((-1, -1), (1, -1), (-1, -2), (1, -2)):
        nvalid &= torch.roll(valid, shift, dims=dim)
        nvalid &= ~(torch.abs(torch.roll(z, shift, dims=dim) - z) > max_depth_jump)
    # Border pixels wrap under roll: invalidate them.
    nvalid[..., 0, :] = False
    nvalid[..., -1, :] = False
    nvalid[..., :, 0] = False
    nvalid[..., :, -1] = False

    pts_o = pts.reshape(batch + (-1, 3))
    nrm_o = torch.where(nvalid[..., None], nrm, 0.0).reshape(batch + (-1, 3))
    if pose is not None:
        pts_o = transform_points(pose, pts_o)
        nrm_o = transform_normals(pose, nrm_o)
    pts_o = torch.where(valid.reshape(batch + (-1,))[..., None], pts_o, 1e30)
    return pts_o, nrm_o, (valid & nvalid).reshape(batch + (-1,))


def rgbd_to_cloud(
    depth: torch.Tensor,
    colors: Optional[torch.Tensor],
    intrinsics: CameraIntrinsics,
    pose: Optional[Transform] = None,
    compute_normals: bool = False,
) -> PointCloud:
    """RGBD → ``PointCloud``; ``colors`` is ``(H, W, 3)`` in [0, 1] or
    None."""
    if compute_normals:
        pts, nrm, valid = depth_to_points_normals(depth, intrinsics, pose)
    else:
        pts, valid = depth_to_points(depth, intrinsics, pose)
        nrm = None
    cols = colors.reshape(-1, 3) if colors is not None else None
    return PointCloud(points=pts, normals=nrm, colors=cols, valid=valid)


def project_points(
    points: torch.Tensor, intrinsics: CameraIntrinsics
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Camera-frame points ``(..., 3)`` → ``(u, v)`` pixel coordinates
    (int32, rounded half to even) and depth. Out-of-range coordinates
    saturate to the int32 limits, as XLA converts."""
    z = points[..., 2]
    safe_z = torch.where(z > 0, z, 1.0)
    u = torch.round(points[..., 0] * intrinsics.fx / safe_z + intrinsics.cx)
    v = torch.round(points[..., 1] * intrinsics.fy / safe_z + intrinsics.cy)
    return floor_int32(u), floor_int32(v), z


_INVALID_KEY = 2**31 - 1


def _zbuffer_winner(
    points: torch.Tensor,
    valid: torch.Tensor,
    intrinsics: CameraIntrinsics,
    h: int,
    w: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel winning point index and its depth: ``(index (H, W) int32,
    depth (H, W))``; empty pixels hold -1 and depth 0.

    The winner is the smallest packed key ``(zq << idx_bits) | local_idx``
    with ``idx_bits = min(bit_length(n-1), 20)`` and ``zq`` the depth
    quantized to ``2^(31-idx_bits)`` levels of ``[0, z_max]`` (clipped to
    ``levels - 2``, so that no key equals the empty sentinel): the nearest
    z bucket, and the smallest index inside it. Points beyond 2^20 form
    groups of 2^20 whose images combine by an elementwise key min (ties go
    to the earlier group). The scatter-min writes an ``(H·W + 1,)`` image
    whose last slot takes the dropped points; a min is order-free, so the
    result is the same on every device."""
    n = points.shape[0]
    dev = points.device
    u, v, z = project_points(points, intrinsics)
    ok = valid & (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    group = 1 << 20
    n_groups = (n + group - 1) // group
    idx_bits = min(max(n - 1, 1).bit_length(), 20)
    levels = float(1 << (31 - idx_bits))
    pix = torch.where(ok, v * w + u, 0)
    z_max = torch.max(torch.where(ok, z, 0.0)) + 1e-6
    scale = scalar_like(levels, z) / z_max
    zq = torch.clamp(z * scale, 0, levels - 2).to(torch.int32)
    tgt_all = torch.where(ok, pix, h * w).long()

    best_key = best_group = None
    for g in range(n_groups):
        lo, hi = g * group, min((g + 1) * group, n)
        local_idx = torch.arange(hi - lo, dtype=torch.int32, device=dev)
        key = torch.where(ok[lo:hi], (zq[lo:hi] << idx_bits) | local_idx, _INVALID_KEY)
        img = torch.full((h * w + 1,), _INVALID_KEY, dtype=torch.int32, device=dev)
        img = img.scatter_reduce_(0, tgt_all[lo:hi], key, "amin")[: h * w]
        if best_key is None:
            best_key, best_group = img, torch.zeros_like(img)
        else:
            better = img < best_key
            best_key = torch.where(better, img, best_key)
            best_group = torch.where(better, g, best_group)

    has = best_key != _INVALID_KEY
    widx = torch.where(has, (best_key & ((1 << idx_bits) - 1)) + best_group * group, -1)
    depth = torch.where(has, z[torch.where(has, widx, 0).long()], 0.0)
    return widx.reshape(h, w), depth.reshape(h, w)


def _zbuffer_winner_batched(
    points: torch.Tensor,
    valid: torch.Tensor,
    intrinsics: CameraIntrinsics,
    h: int,
    w: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_zbuffer_winner` for B streams in one scatter-min: ``points
    (B, N, 3)`` camera-frame, ``valid (B, N)`` → ``(index (B, H, W) int32,
    local to each stream's N rows, depth (B, H, W))``.

    The B images are one ``(B·H·W,)`` pixel space and the rows one
    ``(B·N,)`` stream, so everything of the key is taken over all streams
    at once: ``idx_bits`` from ``B·N``, one ``z_max`` over every stream,
    and groups of 2^20 global rows that may cross a stream boundary. A
    winner's global row goes back to its stream's local index through the
    stream its pixel belongs to."""
    bsz, n, _ = points.shape
    dev = points.device
    u, v, z = project_points(points.reshape(bsz * n, 3), intrinsics)
    ok = valid.reshape(-1) & (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    total = bsz * n
    npix = bsz * h * w
    group = 1 << 20
    n_groups = (total + group - 1) // group
    idx_bits = min(max(total - 1, 1).bit_length(), 20)
    levels = float(1 << (31 - idx_bits))
    stream = torch.arange(total, dtype=torch.int32, device=dev) // n
    tgt_all = torch.where(ok, stream * (h * w) + (v * w + u), npix).long()
    z_max = torch.max(torch.where(ok, z, 0.0)) + 1e-6
    scale = scalar_like(levels, z) / z_max
    zq = torch.clamp(z * scale, 0, levels - 2).to(torch.int32)

    best_key = best_group = None
    for g in range(n_groups):
        lo, hi = g * group, min((g + 1) * group, total)
        local_idx = torch.arange(hi - lo, dtype=torch.int32, device=dev)
        key = torch.where(ok[lo:hi], (zq[lo:hi] << idx_bits) | local_idx, _INVALID_KEY)
        img = torch.full((npix + 1,), _INVALID_KEY, dtype=torch.int32, device=dev)
        img = img.scatter_reduce_(0, tgt_all[lo:hi], key, "amin")[:npix]
        if best_key is None:
            best_key, best_group = img, torch.zeros_like(img)
        else:
            better = img < best_key
            best_key = torch.where(better, img, best_key)
            best_group = torch.where(better, g, best_group)

    has = best_key != _INVALID_KEY
    widx_g = torch.where(has, (best_key & ((1 << idx_bits) - 1)) + best_group * group, 0)
    pix_stream = torch.arange(npix, dtype=torch.int32, device=dev) // (h * w)
    widx = torch.where(has, widx_g - pix_stream * n, -1)
    depth = torch.where(has, z[widx_g.long()], 0.0)
    return widx.reshape(bsz, h, w), depth.reshape(bsz, h, w)


def points_to_index_map(
    points: torch.Tensor,
    intrinsics: CameraIntrinsics,
    h: int,
    w: int,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Z-buffered point-index image; -1 = empty pixel."""
    if valid is None:
        valid = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    return _zbuffer_winner(points, valid, intrinsics, h, w)[0]


def points_to_depth_image(
    points: torch.Tensor,
    intrinsics: CameraIntrinsics,
    h: int,
    w: int,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Render points to a z-buffered depth image (0 = empty)."""
    if valid is None:
        valid = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    return _zbuffer_winner(points, valid, intrinsics, h, w)[1]


def cloud_to_rgbd(
    cloud: PointCloud, intrinsics: CameraIntrinsics, h: int, w: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points (+colors) → ``(depth (H, W), rgb (H, W, 3))`` through the
    z-buffer winner; rgb is 0 at empty pixels and without colors."""
    index_map, depth_map = _zbuffer_winner(
        cloud.points, cloud.valid_mask(), intrinsics, h, w
    )
    if cloud.colors is None:
        return depth_map, torch.zeros((h, w, 3), dtype=torch.float32, device=depth_map.device)
    rgb = cloud.colors[index_map.clamp(min=0).long()]
    return depth_map, torch.where((index_map >= 0)[..., None], rgb, 0.0)
