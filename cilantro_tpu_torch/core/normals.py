"""Surface normals and curvature (port of ``cilantro_tpu/core/normals.py``).

One batched program per cloud: a neighbourhood search (:mod:`..neighbors.api`),
a ``(Q, k, 3)`` gather, the covariance einsums and a batched symmetric
eigendecomposition (:func:`.covariance.eigh_sym`, Jacobi rotations); the
normal is the eigenvector of the smallest eigenvalue, curvature ``λ₀ /
(λ₀ + λ₁ + λ₂)``. Normals flip toward a view point or toward reference
normals; without either their sign is whatever the eigensolver gives
(Jacobi's need not be LAPACK's, which the JAX package gets on the CPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..neighbors.api import Neighborhoods, knn_search, radius_search
from .covariance import _mcd_from_scores, eigh_sym, neighborhood_mean_cov


def _normal_and_curvature(cov: torch.Tensor):
    w, v = eigh_sym(cov)  # ascending eigenvalues
    lam0 = torch.clamp(w[..., 0], min=0.0)
    trace = torch.clamp(torch.sum(torch.clamp(w, min=0.0), dim=-1), min=1e-30)
    return v[..., :, 0], lam0 / trace


def _orient(normal: torch.Tensor, toward: torch.Tensor) -> torch.Tensor:
    """``normal`` times the sign of its dot with ``toward`` (1 where 0)."""
    sign = torch.sign(torch.sum(normal * toward, dim=-1, keepdim=True))
    return normal * torch.where(sign == 0, 1.0, sign)


def normals_from_neighborhoods(
    points: torch.Tensor,
    nb: Neighborhoods,
    view_point: Optional[torch.Tensor] = None,
    reference_normals: Optional[torch.Tensor] = None,
    min_neighbors: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normals and curvature of each query from given neighbourhoods:
    ``(normals (Q, D), curvature (Q,), valid (Q,))``; queries with fewer
    than ``min_neighbors`` neighbours get a zero normal and curvature."""
    _, cov, valid = neighborhood_mean_cov(points, nb.indices, nb.mask, min_sample_size=min_neighbors)
    normal, curvature = _normal_and_curvature(cov)
    query_points = points[: nb.indices.shape[0]]
    if reference_normals is not None:
        normal = _orient(normal, reference_normals)
    elif view_point is not None:
        normal = _orient(normal, view_point - query_points)
    normal = torch.where(valid[..., None], normal, 0.0)
    curvature = torch.where(valid, curvature, 0.0)
    return normal, curvature, valid


def estimate_normals_knn(
    points: torch.Tensor,
    k: int = 12,
    *,
    valid: Optional[torch.Tensor] = None,
    view_point: Optional[torch.Tensor] = None,
    reference_normals: Optional[torch.Tensor] = None,
):
    """Normals from k-nearest-neighbour neighbourhoods of the cloud itself
    (the query point takes part, as in the reference)."""
    nb = knn_search(points, points, k, query_valid=valid, key_valid=valid)
    return normals_from_neighborhoods(
        points, nb, view_point=view_point, reference_normals=reference_normals
    )


def estimate_normals_radius(
    points: torch.Tensor,
    radius: float,
    max_neighbors: int = 32,
    *,
    valid: Optional[torch.Tensor] = None,
    view_point: Optional[torch.Tensor] = None,
    reference_normals: Optional[torch.Tensor] = None,
):
    """Normals from the at most ``max_neighbors`` closest points within
    ``radius``."""
    nb = radius_search(points, points, radius, max_neighbors, query_valid=valid, key_valid=valid)
    return normals_from_neighborhoods(
        points, nb, view_point=view_point, reference_normals=reference_normals
    )


def estimate_normals_knn_in_radius(points: torch.Tensor, k: int, radius: float, **kwargs):
    return estimate_normals_radius(points, radius, max_neighbors=k, **kwargs)


def _normals_robust_from_scores(
    scores: torch.Tensor,
    points: torch.Tensor,
    nb: Neighborhoods,
    *,
    view_point: Optional[torch.Tensor] = None,
    num_refinements: int = 3,
    keep_fraction: float = 0.75,
):
    """:func:`estimate_normals_robust` from the neighbourhoods ``nb`` (the
    cloud's own, one per point) and each point's trial scores ``(N, T,
    nb.k)`` in [0, 1)."""
    gathered = points[nb.indices.long()]  # (N, k, D)
    _, cov, ok = _mcd_from_scores(
        scores, gathered, nb.mask, num_refinements=num_refinements, keep_fraction=keep_fraction
    )
    normal, curvature = _normal_and_curvature(cov)
    if view_point is not None:
        normal = _orient(normal, view_point - points)
    ok = ok & (nb.counts() >= 3)
    return torch.where(ok[..., None], normal, 0.0), torch.where(ok, curvature, 0.0), ok


def estimate_normals_robust(
    generator: Optional[torch.Generator],
    points: torch.Tensor,
    k: int = 16,
    *,
    valid: Optional[torch.Tensor] = None,
    view_point: Optional[torch.Tensor] = None,
    num_trials: int = 6,
    num_refinements: int = 3,
    keep_fraction: float = 0.75,
):
    """Normals from Minimum-Covariance-Determinant fits of each point's k
    nearest neighbours (:func:`.covariance.mcd_mean_cov`), resistant to
    outliers and mixed surfaces inside a neighbourhood. ``generator`` draws
    every point's trial subsets (the default generator of the points'
    device if None)."""
    nb = knn_search(points, points, k, query_valid=valid, key_valid=valid)
    scores = torch.rand(
        (points.shape[0], num_trials, nb.k), generator=generator, device=points.device
    )
    return _normals_robust_from_scores(
        scores, points, nb, view_point=view_point,
        num_refinements=num_refinements, keep_fraction=keep_fraction,
    )
