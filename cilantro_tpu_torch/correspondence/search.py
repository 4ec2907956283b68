"""Nearest-neighbour correspondence search (port of the unidirectional part
of ``cilantro_tpu/correspondence/search.py``).

A :class:`Correspondences` is sized by the query cloud: partner index,
squared feature distance, weight and mask per query; filtering clears mask
bits and shapes never change. The bidirectional, oracle and
combined-metric combiner functions wait for a later slice.
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
