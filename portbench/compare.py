"""The numbers that decide ``correct``: how far the measured program's
poses and maps lie from the reference's on the same clip.

Each number is a stream's; the harness takes it over the streams compared
as the cell's limits file says (``over_streams``: the largest, or the
median).

* ``pose_gap_m`` / ``pose_gap_rad``: the largest distance between the two
  camera positions, and the largest angle of ``R_prog R_refᵀ``, over every
  frame of the stream in every call compared.
* The stream's map (valid points) is rendered into one camera (the
  reference's last pose of that stream) as nearest-point images: the
  depth, and the row that wins each pixel. Rendering makes the numbers
  blind to where in the pool a row sits, so a different but equal layout
  reads 0. Then
  * ``map_gap_m``: the mean absolute depth difference over the pixels
    both images cover;
  * ``map_one_side_share``: the share of the covered pixels that one image
    covers and the other does not (rows lost, added or made invalid);
  * ``map_normal_gap``: the mean ``|n_prog − n_ref|`` of the winning rows'
    normals over the pixels both cover;
  * ``map_conf_gap``: the mean absolute difference of the winning rows'
    confidences over the pixels both cover.

Also the trajectory error against the generator's ground truth (ATE,
after a rigid alignment), which is printed and not compared.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


def pose_gaps(prog: np.ndarray, ref: np.ndarray) -> Tuple[float, float]:
    """``(largest position gap (m), largest rotation gap (rad))`` between
    pose stacks ``(..., 4, 4)``. A non-finite pose reads as infinite."""
    p = np.asarray(prog, np.float64)
    r = np.asarray(ref, np.float64)
    if p.shape != r.shape or not np.all(np.isfinite(p)):
        return math.inf, math.inf
    dt = np.linalg.norm(p[..., :3, 3] - r[..., :3, 3], axis=-1)
    rel = p[..., :3, :3] @ np.swapaxes(r[..., :3, :3], -1, -2)
    cos = np.clip((np.trace(rel, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    # arccos loses its digits near 0: take the angle from the skew part.
    skew = np.stack([rel[..., 2, 1] - rel[..., 1, 2], rel[..., 0, 2] - rel[..., 2, 0],
                     rel[..., 1, 0] - rel[..., 0, 1]], -1)
    ang = np.arctan2(np.linalg.norm(skew, axis=-1) / 2.0, cos)
    return float(dt.max()), float(ang.max())


def render(points: torch.Tensor, valid: torch.Tensor, pose: np.ndarray, sensor: dict
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-point image of world ``points (N, 3)`` seen from
    camera-to-world ``pose``: ``(depth (H·W,) float64, 0 where empty;
    the winning row a pixel (H·W,), -1 where empty)``."""
    h, w = sensor["height"], sensor["width"]
    dev = points.device
    pose = torch.as_tensor(np.asarray(pose, np.float64), device=dev)
    p = points.to(torch.float64)
    cam = (p - pose[:3, 3]) @ pose[:3, :3]
    z = cam[:, 2]
    ok = valid & torch.isfinite(z) & (z > 1e-6) & (points.abs().amax(-1) < 1e20)
    zs = torch.where(ok, z, 1.0)
    u = torch.round(cam[:, 0] * sensor["fx"] / zs + sensor["cx"])
    v = torch.round(cam[:, 1] * sensor["fy"] / zs + sensor["cy"])
    ok &= (u >= 0) & (u < w) & (v >= 0) & (v < h)
    pix = torch.where(ok, v * w + u, float(h * w)).to(torch.int64)
    zk = torch.where(ok, z, math.inf)
    img = torch.full((h * w + 1,), math.inf, dtype=torch.float64, device=dev)
    img.scatter_reduce_(0, pix, zk, "amin")
    won = ok & (zk == img[pix])
    row = torch.full((h * w + 1,), -1, dtype=torch.int64, device=dev)
    row.scatter_reduce_(0, torch.where(won, pix, h * w),
                        torch.arange(len(z), device=dev), "amax")
    img, row = img[:-1], row[:-1]
    return torch.where(torch.isinf(img), 0.0, img), row


MAP_NUMBERS = ("map_gap_m", "map_one_side_share", "map_normal_gap", "map_conf_gap")


def map_gaps(prog_cloud, ref_cloud, pose: np.ndarray, sensor: dict) -> Dict[str, float]:
    """The ``MAP_NUMBERS`` of two clouds ``(points, valid, normals,
    confidence)``. A map whose render covers nothing the other covers
    reads as infinite."""
    a, ra = render(*prog_cloud[:2], pose, sensor)
    b, rb = render(*ref_cloud[:2], pose, sensor)
    both = (a > 0) & (b > 0)
    either = (a > 0) | (b > 0)
    n = int(both.sum())
    if n == 0:
        return dict(zip(MAP_NUMBERS, (math.inf, 1.0, math.inf, math.inf)))
    wa, wb = ra[both], rb[both]
    na = prog_cloud[2][wa].to(torch.float64)
    nb = ref_cloud[2][wb].to(torch.float64)
    ca = prog_cloud[3][wa].to(torch.float64)
    cb = ref_cloud[3][wb].to(torch.float64)
    return {
        "map_gap_m": float(torch.abs(a - b)[both].mean()),
        "map_one_side_share": float((either & ~both).sum()) / max(int(either.sum()), 1),
        "map_normal_gap": float(torch.linalg.vector_norm(na - nb, dim=-1).mean()),
        "map_conf_gap": float(torch.abs(ca - cb).mean()),
    }


def ate(est: np.ndarray, truth: np.ndarray) -> float:
    """RMS position error (m) of ``est (F, 4, 4)`` after the rigid
    alignment onto ``truth`` (Umeyama, no scale), float64."""
    a = np.asarray(est, np.float64)[:, :3, 3]
    b = np.asarray(truth, np.float64)[:, :3, 3]
    if not np.all(np.isfinite(a)):
        return math.inf
    ma, mb = a.mean(0), b.mean(0)
    u, _, vt = np.linalg.svd((a - ma).T @ (b - mb))
    d = 1.0 if np.linalg.det(vt.T @ u.T) >= 0 else -1.0
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    res = (a - ma) @ r.T + mb - b
    return float(np.sqrt(np.mean(np.sum(res * res, axis=1))))


def within(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number at or under its limit (NaN fails)."""
    return all(numbers.get(k, math.inf) <= lim for k, lim in limits.items())
