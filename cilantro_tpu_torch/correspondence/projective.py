"""Projective (one lookup per point) correspondence search for organized
clouds (port of ``cilantro_tpu/correspondence/projective.py``).

The destination is rendered once into a z-buffered index map; each ICP
iteration projects the transformed source points through the intrinsics
and reads the target at the hit pixel. :func:`pack_projective_target`
resolves the index map once into a packed ``(H·W, 8)`` target so that an
iteration does one row gather, through
:func:`..core.coalesced.coalesced_gather` (out-of-image queries pass -1
and read row 0, as the JAX package's plain gather does; the mask drops
them).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.coalesced import coalesced_gather
from ..core.rgbd import CameraIntrinsics, points_to_index_map, project_points
from ..core.transforms import Transform, per_stream
from ..neighbors.bruteforce import INVALID_DIST
from .search import Correspondences


def build_projective_target(
    dst_points: torch.Tensor,
    intrinsics: CameraIntrinsics,
    h: int,
    w: int,
    dst_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The dst index map, to be cached across ICP iterations."""
    return points_to_index_map(dst_points, intrinsics, h, w, valid=dst_valid)


def pack_projective_target(
    dst_points: torch.Tensor,
    dst_normals: Optional[torch.Tensor],
    index_map: torch.Tensor,
    dst_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The index map resolved into ``(H·W, 8)`` rows ``[point | normal |
    hit flag | 0]``, zero where there is no hit."""
    hit = index_map.reshape(-1)
    ok = hit >= 0
    safe = torch.where(ok, hit, 0).long()
    if dst_valid is not None:
        ok = ok & dst_valid[safe]
    pts = dst_points[safe]
    nrm = dst_normals[safe] if dst_normals is not None else torch.zeros_like(pts)
    flag = ok.to(dst_points.dtype)[:, None]
    return torch.where(
        ok[:, None], torch.cat([pts, nrm, flag, torch.zeros_like(flag)], dim=1), 0.0
    )


def _in_image(u, v, z, h, w):
    return (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)


def find_projective_correspondences_packed(
    src_points: torch.Tensor,
    packed_target: torch.Tensor,
    intrinsics: CameraIntrinsics,
    h: int,
    w: int,
    *,
    tf: Optional[Transform] = None,
    src_valid: Optional[torch.Tensor] = None,
    max_distance: Optional[float] = None,
):
    """One-gather projective matching against a packed target. Returns
    ``(s, dst_pts, dst_nrm, weights)``: the transformed source, the matched
    target points and normals, and 0/1 weights.

    A batch of B streams (``src_points (B, N, 3)``, ``packed_target (B,
    H·W, 8)``, ``tf`` a batch ``(B,)``) matches each stream against its own
    target in one gather over the ``(B·H·W, 8)`` flat target: stream ``b``
    reads row ``b·H·W + pixel``, and an out-of-image query reads its own
    stream's row 0, as the JAX package's ``vmap`` of the plain gather
    does."""
    batched = src_points.dim() == 3
    if tf is not None:
        s = (per_stream(tf) if batched else tf).apply(src_points)
    else:
        s = src_points
    u, v, z = project_points(s, intrinsics)
    in_img = _in_image(u, v, z, h, w)
    if batched:
        bsz, hw, width = packed_target.shape
        offs = torch.arange(bsz, dtype=torch.int32, device=s.device)[:, None] * hw
        idx = (torch.where(in_img, v * w + u, 0) + offs).reshape(-1)
        row = coalesced_gather(packed_target.reshape(bsz * hw, width), idx).reshape(bsz, -1, width)
    else:
        row = coalesced_gather(packed_target, torch.where(in_img, v * w + u, -1))
    dst_pts, dst_nrm = row[..., 0:3], row[..., 3:6]
    mask = in_img & (row[..., 6] > 0.5)
    if src_valid is not None:
        mask = mask & src_valid
    diff = dst_pts - s
    dist = torch.sum(diff * diff, dim=-1)
    if max_distance is not None:
        mask = mask & (dist <= max_distance)
    return s, dst_pts, dst_nrm, mask.to(src_points.dtype)


def find_projective_correspondences(
    src_points: torch.Tensor,
    dst_points: torch.Tensor,
    index_map: torch.Tensor,
    intrinsics: CameraIntrinsics,
    *,
    tf: Optional[Transform] = None,
    src_valid: Optional[torch.Tensor] = None,
    dst_valid: Optional[torch.Tensor] = None,
    max_distance: Optional[float] = None,
) -> Correspondences:
    """Project the (transformed) source; its correspondence is the dst
    point rendered at the hit pixel. ``max_distance`` gates the squared
    distance; ``dst_valid`` re-gates hits invalidated after the render."""
    h, w = index_map.shape
    s = src_points if tf is None else tf.apply(src_points)
    u, v, z = project_points(s, intrinsics)
    in_img = _in_image(u, v, z, h, w)
    hit = index_map.reshape(-1)[torch.where(in_img, v * w + u, 0).long()]
    mask = in_img & (hit >= 0)
    if src_valid is not None:
        mask = mask & src_valid
    if dst_valid is not None:
        mask = mask & dst_valid[torch.where(mask, hit, 0).long()]
    safe_hit = torch.where(mask, hit, 0)
    diff = dst_points[safe_hit.long()] - s
    dist = torch.sum(diff * diff, dim=-1)
    if max_distance is not None:
        mask = mask & (dist <= max_distance)
    return Correspondences(
        dst_idx=torch.where(mask, safe_hit, 0),
        distances=torch.where(mask, dist, INVALID_DIST),
        weights=mask.to(src_points.dtype),
        mask=mask,
    )
