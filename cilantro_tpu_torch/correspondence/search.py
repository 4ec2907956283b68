"""Nearest-neighbour correspondence search (port of
``cilantro_tpu/correspondence/search.py``).

A :class:`Correspondences` is sized by the query cloud: partner index,
squared feature distance, weight and mask per query; filtering clears mask
bits and shapes never change. Besides one-way matching: both ways (the
intersection or the union on fixed shapes), fixed user correspondences
re-scored under a transform, and the combiner that stacks a point-metric
and a plane-metric set for the GN estimators.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.transforms import Transform
from ..neighbors import fused_nn
from ..neighbors.bruteforce import INVALID_DIST, nn1


@dataclasses.dataclass(frozen=True)
class Correspondences:
    """Fixed-shape correspondence set (query i ↔ ``dst_idx[i]``)."""

    dst_idx: torch.Tensor  # (Q,) int32, 0 where masked (safe to gather)
    distances: torch.Tensor  # (Q,) squared feature distance, INVALID_DIST if masked
    weights: torch.Tensor  # (Q,) 1 where kept, 0 where masked
    mask: torch.Tensor  # (Q,) bool

    def count(self) -> torch.Tensor:
        return torch.sum(self.mask)


def point_features(points: torch.Tensor, tf: Optional[Transform] = None) -> torch.Tensor:
    return points if tf is None else tf.apply(points)


def point_normal_features(
    points: torch.Tensor,
    normals: torch.Tensor,
    normal_weight: float,
    tf: Optional[Transform] = None,
    rigid: bool = True,
) -> torch.Tensor:
    """Point‖weighted-normal 2·D features."""
    if tf is not None:
        points = tf.apply(points)
        normals = tf.apply_normals(normals, rigid=rigid)
    return torch.cat([points, normal_weight * normals], dim=-1)


def _fraction_threshold(distances, mask, fraction):
    """Distance at the ``fraction`` quantile of the valid correspondences."""
    q = distances.shape[0]
    d_sorted = torch.sort(torch.where(mask, distances, INVALID_DIST)).values
    count = torch.sum(mask)
    kth = torch.clamp((fraction * count.float()).to(torch.int32), 1, q) - 1
    return d_sorted[kth.long()]


def _one_to_one_mask(dst_idx, distances, mask, num_dst):
    """Keep only the closest query per destination; ties go to the smallest
    query index (two deterministic scatter-mins)."""
    q = dst_idx.shape[0]
    dev = distances.device
    d = torch.where(mask, distances, INVALID_DIST)
    idx = dst_idx.long()
    best_d = torch.full((num_dst,), INVALID_DIST, dtype=d.dtype, device=dev)
    best_d = best_d.scatter_reduce(0, idx, d, "amin")
    is_best = mask & (d <= best_d[idx])
    qidx = torch.arange(q, dtype=torch.int32, device=dev)
    best_q = torch.full((num_dst,), q, dtype=torch.int32, device=dev)
    best_q = best_q.scatter_reduce(0, idx, torch.where(is_best, qidx, q), "amin")
    return is_best & (best_q[idx] == qidx)


def find_nn_correspondences(
    query_features: torch.Tensor,
    dst_features: torch.Tensor,
    *,
    query_valid: Optional[torch.Tensor] = None,
    dst_valid: Optional[torch.Tensor] = None,
    max_distance: Optional[float] = None,
    inlier_fraction: float = 1.0,
    one_to_one: bool = False,
    metric: str = "l2",
    prune_plan: Optional[fused_nn.NN1PrunePlan] = None,
) -> Correspondences:
    """Unidirectional NN matching with the gate, trimming and one-to-one
    filters. ``max_distance`` is compared with the *squared* distance.

    With a gate on a large 3-D L2 problem on CUDA the search runs the
    Morton-tile pruned kernels; callers that search repeatedly against a
    fixed ``dst`` pass ``prune_plan`` (built from ``dst_features``, both
    masks and the gate) to reuse its sorts."""
    if prune_plan is not None:
        if prune_plan.kperm.shape[0] != dst_features.shape[0]:
            raise ValueError(
                f"prune_plan was built for {prune_plan.kperm.shape[0]} keys "
                f"but dst_features has {dst_features.shape[0]} rows"
            )
        if prune_plan.qperm.shape[0] != query_features.shape[0]:
            raise ValueError(
                f"prune_plan was built for {prune_plan.qperm.shape[0]} "
                f"queries but query_features has {query_features.shape[0]} rows"
            )
        dist, idx = fused_nn.nn1_pruned_planned(query_features, prune_plan)
    elif fused_nn.prune_eligible(
        query_features.shape, dst_features.shape, max_distance, metric,
        device=query_features.device,
    ):
        dist, idx = fused_nn.nn1_pruned(
            query_features,
            dst_features,
            torch.sqrt(torch.as_tensor(max_distance, dtype=torch.float32)),
            query_valid=query_valid,
            key_valid=dst_valid,
        )
    else:
        dist, idx = nn1(
            query_features, dst_features, query_valid=query_valid,
            key_valid=dst_valid, metric=metric,
        )
    mask = dist < INVALID_DIST
    if max_distance is not None:
        mask &= dist <= max_distance
    if inlier_fraction < 1.0:
        mask &= dist <= _fraction_threshold(dist, mask, inlier_fraction)
    if one_to_one:
        mask &= _one_to_one_mask(idx, dist, mask, dst_features.shape[0])
    return Correspondences(
        dst_idx=torch.where(mask, idx, 0),
        distances=torch.where(mask, dist, INVALID_DIST),
        weights=mask.to(query_features.dtype),
        mask=mask,
    )


def find_nn_correspondences_bidirectional(
    src_features: torch.Tensor,
    dst_features: torch.Tensor,
    *,
    src_valid: Optional[torch.Tensor] = None,
    dst_valid: Optional[torch.Tensor] = None,
    max_distance: Optional[float] = None,
    inlier_fraction: float = 1.0,
    require_reciprocal: bool = False,
    metric: str = "l2",
) -> Correspondences:
    """Matching both ways, sized by the src cloud. ``require_reciprocal``
    keeps src i only if its partner j maps back to i; otherwise the union:
    the src→dst matches, with a dst→src match folded into its src slot
    where it is closer (scatter-mins, exact on every device)."""
    fwd = find_nn_correspondences(
        src_features, dst_features, query_valid=src_valid, dst_valid=dst_valid,
        max_distance=max_distance, metric=metric,
    )
    bwd = find_nn_correspondences(
        dst_features, src_features, query_valid=dst_valid, dst_valid=src_valid,
        max_distance=max_distance, metric=metric,
    )
    fwd_idx, bwd_idx = fwd.dst_idx.long(), bwd.dst_idx.long()
    src_n = src_features.shape[0]
    dev = src_features.device
    qidx = torch.arange(src_n, dtype=torch.int32, device=dev)
    if require_reciprocal:
        mask = fwd.mask & bwd.mask[fwd_idx] & (bwd.dst_idx[fwd_idx] == qidx)
        dist = fwd.distances
        idx = fwd.dst_idx
    else:
        # Union: scatter dst→src matches into src slots, prefer the closer.
        rev = torch.where(bwd.mask, bwd.distances, INVALID_DIST)
        rev_d = torch.full((src_n,), INVALID_DIST, dtype=rev.dtype, device=dev)
        rev_d = rev_d.scatter_reduce(0, bwd_idx, rev, "amin")
        rows = torch.arange(bwd_idx.shape[0], dtype=torch.int32, device=dev)
        won = bwd.mask & (bwd.distances <= rev_d[bwd_idx])
        rev_j = torch.zeros(src_n, dtype=torch.int32, device=dev)
        rev_j = rev_j.scatter_reduce(0, bwd_idx, torch.where(won, rows, 0), "amax")
        use_rev = rev_d < fwd.distances
        dist = torch.where(use_rev, rev_d, fwd.distances)
        idx = torch.where(use_rev, rev_j, fwd.dst_idx)
        mask = dist < INVALID_DIST
    if inlier_fraction < 1.0:
        mask &= dist <= _fraction_threshold(dist, mask, inlier_fraction)
    return Correspondences(
        dst_idx=torch.where(mask, idx, 0),
        distances=torch.where(mask, dist, INVALID_DIST),
        weights=mask.to(src_features.dtype),
        mask=mask,
    )


def oracle_correspondences(
    src_points: torch.Tensor,
    dst_points: torch.Tensor,
    dst_idx: torch.Tensor,
    mask: torch.Tensor,
    tf: Optional[Transform] = None,
    max_distance: Optional[float] = None,
) -> Correspondences:
    """Fixed user-provided correspondences, re-scored under the current
    transform with a squared-distance gate."""
    s = src_points if tf is None else tf.apply(src_points)
    diff = dst_points[dst_idx.long()] - s
    dist = torch.sum(diff * diff, dim=-1)
    m = mask
    if max_distance is not None:
        m = m & (dist <= max_distance)
    return Correspondences(
        dst_idx=torch.where(m, dst_idx, 0).to(torch.int32),
        distances=torch.where(m, dist, INVALID_DIST),
        weights=m.to(src_points.dtype),
        mask=m,
    )


def combine_metric_correspondences(
    corr_point: Correspondences,
    corr_plane: Correspondences,
    dst_points: torch.Tensor,
    dst_normals: torch.Tensor,
    *,
    point_weight: float = 1.0,
    plane_weight: float = 1.0,
):
    """Merge a point-metric and a plane-metric correspondence set (from two
    search engines) into the arrays the GN estimators take: ``(dst (2Q, D),
    nrm (2Q, D), w_point (2Q,), w_plane (2Q,))``, rows ``[0, Q)`` the point
    metric (plane weight 0), rows ``[Q, 2Q)`` the plane metric (point
    weight 0). Pass the source twice: ``torch.cat([s, s])``."""
    q = corr_point.dst_idx.shape[0]
    zeros = dst_points.new_zeros(q)
    pi, li = corr_point.dst_idx.long(), corr_plane.dst_idx.long()
    dst = torch.cat([dst_points[pi], dst_points[li]])
    nrm = torch.cat([dst_points.new_zeros((q, dst_points.shape[1])), dst_normals[li]])
    w_point = torch.cat([corr_point.weights * point_weight, zeros])
    w_plane = torch.cat([zeros, corr_plane.weights * plane_weight])
    return dst, nrm, w_point, w_plane
