"""Batched RANSAC estimators (port of
``cilantro_tpu/model_estimation/ransac.py``).

All ``num_hypotheses`` minimal fits run as one batch, all residuals come
from one ``(H, N)`` block and the winner is an ``argmax`` (the first of
equal counts). Planes are fitted by the smallest eigenvector of each
minimal set's covariance (:func:`.covariance.eigh_sym`, batched over the
hypotheses); rigid fits project each hypothesis's cross-covariance onto
a rotation (the ``csrc/rotation_kernels.cu`` kernel for 3×3 float32 on
the card, the SVD in 2-D); affine fits solve the normal equations. The
winner is optionally re-estimated on all its inliers.

JAX's PRNG key is a ``torch.Generator``: the public functions draw the
``(H, N)`` uniform scores (on the points' device) and pass them to
:func:`_ransac_plane_from_scores` / :func:`_ransac_transform_from_scores`,
so that a test can hand in JAX's own draws. A plane's normal is defined
up to its sign (with its offset).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import on_device
from ..core.covariance import eigh_sym, mean_and_covariance
from ..core.transforms import Transform
from ..registration.transform_estimation import (
    estimate_affine_point_to_point,
    estimate_rigid_point_to_point,
)


@dataclasses.dataclass(frozen=True)
class Hyperplane:
    """``n·x + d = 0`` with unit normal."""

    normal: torch.Tensor  # (D,)
    offset: torch.Tensor  # ()

    def signed_distance(self, points: torch.Tensor) -> torch.Tensor:
        return points @ self.normal + self.offset


@dataclasses.dataclass(frozen=True)
class RANSACResult:
    inlier_mask: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # int32
    hypothesis_inliers: torch.Tensor  # (H,) int32, per-hypothesis counts


def _minimal_sets_from_scores(scores, valid, sample_size) -> torch.Tensor:
    """``(H, sample_size)`` distinct indices among the valid points: the
    valid points of smallest score, smallest first (``lax.top_k`` of the
    negated scores)."""
    scores = scores + torch.where(valid, 0.0, 2.0)[None, :]
    return torch.topk(-scores, sample_size, dim=-1, sorted=True).indices


def _fit_plane(points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planes through point sets ``(..., S, D)``: smallest-eigenvector
    normals and their offsets."""
    mean, cov, _ = mean_and_covariance(points)
    _, v = eigh_sym(cov)
    normal = v[..., :, 0]
    return normal, -torch.sum(normal * mean, dim=-1)


def _result(best_mask, counts) -> RANSACResult:
    return RANSACResult(inlier_mask=best_mask, num_inliers=torch.sum(best_mask).to(torch.int32),
                        hypothesis_inliers=counts)


def _ransac_plane_from_scores(
    scores: torch.Tensor,
    points: torch.Tensor,
    inlier_threshold: float,
    *,
    valid: Optional[torch.Tensor] = None,
    sample_size: Optional[int] = None,
    re_estimate: bool = True,
) -> Tuple[Hyperplane, RANSACResult]:
    """:func:`ransac_plane` with the ``(H, N)`` uniform scores given."""
    n, d = points.shape
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    if sample_size is None:
        sample_size = d
    idx = _minimal_sets_from_scores(scores, valid, sample_size)
    normals, offsets = _fit_plane(points[idx])  # (H, D), (H,)

    # (H, N) absolute distances: one product.
    dist = torch.abs(normals @ points.T + offsets[:, None])
    inl = (dist <= inlier_threshold) & valid[None, :]
    counts = torch.sum(inl, dim=1, dtype=torch.int32)
    best = torch.argmax(counts)
    best_mask = inl[best]

    normal, offset = normals[best], offsets[best]
    if re_estimate:
        mean, cov, ok = mean_and_covariance(points, best_mask)
        _, v = eigh_sym(cov)
        n_re = v[:, 0]
        normal = torch.where(ok, n_re, normal)
        offset = torch.where(ok, -torch.dot(n_re, mean), offset)
        best_mask = (torch.abs(points @ normal + offset) <= inlier_threshold) & valid
    return Hyperplane(normal=normal, offset=offset), _result(best_mask, counts)


def ransac_plane(
    generator: Optional[torch.Generator],
    points,
    inlier_threshold: float,
    *,
    valid=None,
    num_hypotheses: int = 100,
    sample_size: Optional[int] = None,
    re_estimate: bool = True,
    device=None,
) -> Tuple[Hyperplane, RANSACResult]:
    """Robust hyperplane fit. ``inlier_threshold`` is an absolute
    point-plane distance. Runs on the points' device (numpy: ``device``,
    the card by default); ``generator`` draws the minimal sets (the
    device's default generator if None)."""
    points = on_device(points, device, torch.float32)
    valid = on_device(valid, points.device, torch.bool)
    scores = torch.rand((num_hypotheses, points.shape[0]), generator=generator, device=points.device)
    return _ransac_plane_from_scores(scores, points, inlier_threshold, valid=valid,
                                     sample_size=sample_size, re_estimate=re_estimate)


def _ransac_transform_from_scores(
    scores: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    inlier_threshold: float,
    *,
    valid: Optional[torch.Tensor] = None,
    sample_size: Optional[int] = None,
    rigid: bool = True,
    re_estimate: bool = True,
) -> Tuple[Transform, RANSACResult]:
    """:func:`ransac_transform` with the ``(H, N)`` uniform scores given."""
    n, d = src.shape
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=src.device)
    if sample_size is None:
        sample_size = d if rigid else d + 1
    estimator = estimate_rigid_point_to_point if rigid else estimate_affine_point_to_point
    idx = _minimal_sets_from_scores(scores, valid, sample_size)
    fits, oks = estimator(src[idx], dst[idx])  # a batch of H minimal fits
    lins, trans = fits.linear, fits.translation

    # (H, N) Euclidean errors.
    mapped = torch.einsum("hij,nj->hni", lins, src) + trans[:, None, :]
    err = torch.linalg.vector_norm(mapped - dst[None, :, :], dim=-1)
    inl = (err <= inlier_threshold) & valid[None, :] & oks[:, None]
    counts = torch.sum(inl, dim=1, dtype=torch.int32)
    best = torch.argmax(counts)
    best_mask = inl[best]
    tf = Transform(lins[best], trans[best])

    if re_estimate:
        tf_re, ok = estimator(src, dst, best_mask.to(src.dtype))
        tf = Transform(torch.where(ok, tf_re.linear, tf.linear),
                       torch.where(ok, tf_re.translation, tf.translation))
        err_b = torch.linalg.vector_norm(tf.apply(src) - dst, dim=-1)
        best_mask = (err_b <= inlier_threshold) & valid
    return tf, _result(best_mask, counts)


def ransac_transform(
    generator: Optional[torch.Generator],
    src,
    dst,
    inlier_threshold: float,
    *,
    valid=None,
    num_hypotheses: int = 100,
    sample_size: Optional[int] = None,
    rigid: bool = True,
    re_estimate: bool = True,
    device=None,
) -> Tuple[Transform, RANSACResult]:
    """Robust rigid / affine alignment of ``src[i] ↔ dst[i]``;
    ``inlier_threshold`` gates the Euclidean error ‖T(s) − d‖. Runs on
    ``src``'s device (numpy: ``device``, the card by default)."""
    src = on_device(src, device, torch.float32)
    dst = on_device(dst, src.device, torch.float32)
    valid = on_device(valid, src.device, torch.bool)
    scores = torch.rand((num_hypotheses, src.shape[0]), generator=generator, device=src.device)
    return _ransac_transform_from_scores(scores, src, dst, inlier_threshold, valid=valid,
                                         sample_size=sample_size, rigid=rigid, re_estimate=re_estimate)
