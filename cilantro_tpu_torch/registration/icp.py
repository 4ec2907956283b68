"""Rigid and affine single-transform ICP (port of the non-projective half of
``cilantro_tpu/registration/icp.py``; projective ICP waits for the pool
pipeline's slice).

Each iteration updates the correspondences (one nn1 pass) and the estimate,
until the update norm ``‖ΔR − I‖ + ‖Δt‖`` falls below the tolerance or the
iteration budget runs out. The JAX package's ``lax.while_loop`` is a Python
loop here with one host read of the update norm per iteration.

On CUDA, a gated 3-D problem of Q·M ≥ 2²⁶ pairs builds a Morton-tile prune
plan once (the dst cloud never moves) and each pass runs the compact nn1
kernel, or the masked one when more tile pairs survive than the budget
allows; smaller problems run the fused nn1 kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core.transforms import Transform, compose, identity, reproject_rigid
from ..correspondence.search import (
    Correspondences,
    find_nn_correspondences,
    point_features,
    point_normal_features,
)
from ..neighbors import fused_nn
from ..neighbors.bruteforce import nn1
from .transform_estimation import (
    estimate_affine_combined_metric,
    estimate_affine_point_to_point,
    estimate_rigid_combined_metric,
    estimate_rigid_point_to_point,
    estimate_rigid_symmetric_metric,
    residuals_combined_metric,
)


@dataclasses.dataclass(frozen=True)
class ICPResult:
    transform: Transform
    iterations: torch.Tensor  # int32
    delta_norm: torch.Tensor  # last update norm
    converged: torch.Tensor  # bool
    num_correspondences: torch.Tensor  # int32, last iteration


def _delta_norm(delta: Transform) -> torch.Tensor:
    eye = torch.eye(delta.dim, dtype=delta.linear.dtype, device=delta.linear.device)
    return torch.linalg.norm(delta.linear - eye) + torch.linalg.norm(delta.translation)


def icp(
    src_points: torch.Tensor,
    dst_points: torch.Tensor,
    *,
    src_normals: Optional[torch.Tensor] = None,
    dst_normals: Optional[torch.Tensor] = None,
    src_valid: Optional[torch.Tensor] = None,
    dst_valid: Optional[torch.Tensor] = None,
    init: Optional[Transform] = None,
    metric: str = "combined",  # point_to_point | combined | symmetric | affine
    point_weight: float = 0.0,
    plane_weight: float = 1.0,
    max_iterations: int = 15,
    convergence_tol: float = 1e-5,
    max_gn_iterations: int = 1,
    max_corr_dist_sq: Optional[float] = 0.0001,
    inlier_fraction: float = 1.0,
    one_to_one: bool = False,
    weight_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    feature_normal_weight: float = 0.0,
) -> ICPResult:
    """Register ``src`` onto ``dst``: returns ``T`` with ``T(src) ≈ dst``.

    ``metric='combined'`` with ``src_normals`` upgrades to the symmetric
    metric; ``feature_normal_weight > 0`` matches in point‖normal feature
    space; ``weight_fn`` maps squared correspondence distances to weights.
    The tensors' device is where it runs."""
    if metric not in ("point_to_point", "combined", "symmetric", "affine"):
        raise ValueError(f"unknown metric {metric!r}")
    d = src_points.shape[1]
    if init is None:
        init = identity(d, dtype=src_points.dtype, device=src_points.device)
    use_plane = metric in ("combined", "symmetric", "affine") and dst_normals is not None
    use_symmetric = metric == "symmetric" or (
        metric == "combined" and src_normals is not None and use_plane
    )
    use_features_normals = (
        feature_normal_weight > 0.0 and src_normals is not None and dst_normals is not None
    )

    if use_features_normals:
        dst_feat = point_normal_features(dst_points, dst_normals, feature_normal_weight)
    else:
        dst_feat = point_features(dst_points)

    # The dst cloud never moves and src moves little per iteration: the
    # Morton sorts behind the pruned kernel are built once, here.
    prune_plan = None
    if not use_features_normals:
        prune_plan = fused_nn.maybe_make_nn1_prune_plan(
            dst_feat,
            max_corr_dist_sq,
            point_features(src_points, init),
            key_valid=dst_valid,
            query_valid=src_valid,
        )

    def update_correspondences(tf: Transform) -> Correspondences:
        if use_features_normals:
            qf = point_normal_features(src_points, src_normals, feature_normal_weight, tf)
        else:
            qf = point_features(src_points, tf)
        return find_nn_correspondences(
            qf,
            dst_feat,
            query_valid=src_valid,
            dst_valid=dst_valid,
            max_distance=max_corr_dist_sq,
            inlier_fraction=inlier_fraction,
            one_to_one=one_to_one,
            prune_plan=prune_plan,
        )

    def update_estimate(tf: Transform, corr: Correspondences) -> Transform:
        s = tf.apply(src_points)
        idx = corr.dst_idx.long()
        dgt = dst_points[idx]
        w = corr.weights
        if weight_fn is not None:
            w = w * weight_fn(corr.distances)
        if use_symmetric:
            delta, _ = estimate_rigid_symmetric_metric(
                s, dgt, tf.apply_normals(src_normals), dst_normals[idx],
                point_weights=w * point_weight, plane_weights=w * plane_weight,
                max_iterations=max_gn_iterations,
            )
        elif metric == "combined" and use_plane:
            delta, _ = estimate_rigid_combined_metric(
                s, dgt, dst_normals[idx],
                point_weights=w * point_weight, plane_weights=w * plane_weight,
                max_iterations=max_gn_iterations,
            )
        elif metric == "affine":
            if use_plane:
                delta, _ = estimate_affine_combined_metric(
                    s, dgt, dst_normals[idx],
                    point_weights=w * point_weight, plane_weights=w * plane_weight,
                )
            else:
                delta, _ = estimate_affine_point_to_point(s, dgt, w)
        else:  # point_to_point
            delta, _ = estimate_rigid_point_to_point(s, dgt, w)
        return delta

    rigid = metric != "affine"
    tf = init
    dn = torch.tensor(float("inf"), dtype=src_points.dtype, device=src_points.device)
    it = 0
    ncorr = torch.zeros((), dtype=torch.int32, device=src_points.device)
    while it < max_iterations and dn.item() >= convergence_tol:
        corr = update_correspondences(tf)
        delta = update_estimate(tf, corr)
        tf = compose(delta, tf)
        if rigid:
            tf = reproject_rigid(tf)
        dn = _delta_norm(delta)
        it += 1
        ncorr = corr.count().to(torch.int32)
    return ICPResult(
        transform=tf,
        iterations=torch.tensor(it, dtype=torch.int32),
        delta_norm=dn,
        converged=dn < convergence_tol,
        num_correspondences=ncorr,
    )


def icp_residuals(
    result_tf: Transform,
    src_points: torch.Tensor,
    dst_points: torch.Tensor,
    dst_normals: Optional[torch.Tensor] = None,
    *,
    dst_valid: Optional[torch.Tensor] = None,
    point_weight: float = 0.0,
    plane_weight: float = 1.0,
) -> torch.Tensor:
    """Per-src-point residuals under the final transform (nearest dst point
    by the fused nn1 kernel on CUDA)."""
    s = result_tf.apply(src_points)
    _, idx = nn1(s, dst_points, key_valid=dst_valid)
    idx = idx.long()
    if dst_normals is None:
        diff = dst_points[idx] - s
        return torch.sum(diff * diff, dim=-1)
    return residuals_combined_metric(
        identity(s.shape[1], dtype=s.dtype, device=s.device),
        s, dst_points[idx], dst_normals[idx], point_weight, plane_weight,
    )


def simple_point_to_point_icp(src_points, dst_points, **kwargs):
    kwargs.setdefault("metric", "point_to_point")
    return icp(src_points, dst_points, **kwargs)


def simple_combined_metric_icp(src_points, dst_points, dst_normals, **kwargs):
    kwargs.setdefault("metric", "combined")
    return icp(src_points, dst_points, dst_normals=dst_normals, **kwargs)


def icp_multires(
    src_points,
    dst_points,
    *,
    src_normals=None,
    dst_normals=None,
    src_valid=None,
    dst_valid=None,
    init: Optional[Transform] = None,
    levels=((0.02, 10, 16384, 0.0064), (None, 3, None, 0.0004)),
    metric: str = "combined",
    point_weight: float = 0.0,
    plane_weight: float = 1.0,
    convergence_tol: float = 1e-5,
    max_gn_iterations: int = 1,
) -> ICPResult:
    """Coarse-to-fine ICP: each level is ``(bin_size, max_iterations,
    capacity, max_corr_dist_sq)``; ``bin_size=None`` runs at full
    resolution, the others on voxel-downsampled clouds."""
    from ..core.containers import PointCloud
    from ..core.grid import grid_downsample

    tf = init
    result = None
    icp_kwargs = dict(
        metric=metric,
        point_weight=point_weight,
        plane_weight=plane_weight,
        convergence_tol=convergence_tol,
        max_gn_iterations=max_gn_iterations,
    )
    for bin_size, iters, capacity, mcd in levels:
        if bin_size is None:
            sp, sn, sv = src_points, src_normals, src_valid
            dp, dn, dv = dst_points, dst_normals, dst_valid
        else:
            sc = grid_downsample(
                PointCloud(points=src_points, normals=src_normals, valid=src_valid),
                bin_size, capacity=capacity,
            )
            dc = grid_downsample(
                PointCloud(points=dst_points, normals=dst_normals, valid=dst_valid),
                bin_size, capacity=capacity,
            )
            sp, sn, sv = sc.points, sc.normals, sc.valid
            dp, dn, dv = dc.points, dc.normals, dc.valid
        result = icp(
            sp, dp, src_normals=sn, dst_normals=dn, src_valid=sv, dst_valid=dv,
            init=tf, max_iterations=iters, max_corr_dist_sq=mcd, **icp_kwargs,
        )
        tf = result.transform
    return result
