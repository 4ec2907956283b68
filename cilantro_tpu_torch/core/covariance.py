"""Mean and covariance, plain and robust (port of
``cilantro_tpu/core/covariance.py``).

Masked batched means and outer products over the leading sample axis, the
per-neighbourhood variant over one ``(Q, k, D)`` gather, and the Minimum
Covariance Determinant fit batched over trials (and over neighbourhoods).
JAX's ``jax.random`` keys become a ``torch.Generator``: the public
:func:`mcd_mean_cov` draws the trials' uniform scores and hands them to
:func:`_mcd_from_scores`, so that a test can hand in JAX's own uniforms.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def mean_and_covariance(
    points: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    min_sample_size: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked mean and unbiased (``1/(n-1)``) covariance over the leading
    axis of ``points (..., N, D)``: ``(mean (..., D), cov (..., D, D),
    valid (...,))``, ``valid`` where at least ``min_sample_size`` (default
    D + 1) samples contribute."""
    d = points.shape[-1]
    if min_sample_size is None:
        min_sample_size = d + 1
    if mask is None:
        n = float(points.shape[-2])
        mean = torch.mean(points, dim=-2)
        centered = points - mean[..., None, :]
        cov = torch.einsum("...ni,...nj->...ij", centered, centered) / max(n - 1.0, 1.0)
        valid = torch.full(
            points.shape[:-2], points.shape[-2] >= min_sample_size, device=points.device
        )
        return mean, cov, valid
    m = mask.to(points.dtype)
    n = torch.sum(m, dim=-1)
    mean = torch.einsum("...n,...ni->...i", m, points) / torch.clamp(n, min=1.0)[..., None]
    centered = (points - mean[..., None, :]) * m[..., None]
    cov = torch.einsum("...ni,...nj->...ij", centered, centered) / torch.clamp(
        n - 1.0, min=1.0
    )[..., None, None]
    return mean, cov, n >= min_sample_size


def neighborhood_mean_cov(
    points: torch.Tensor,
    indices: torch.Tensor,
    mask: torch.Tensor,
    min_sample_size: Optional[int] = None,
):
    """Per-query mean and covariance over gathered neighbourhoods:
    ``points (N, D)``, ``indices (Q, k)``, ``mask (Q, k)`` → ``(mean (Q,
    D), cov (Q, D, D), valid (Q,))``."""
    return mean_and_covariance(points[indices.long()], mask, min_sample_size)


_JACOBI_SWEEPS = 4


def eigh_sym(mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues (ascending) and eigenvectors (columns) of a batch of
    small symmetric matrices ``(..., D, D)``, by cyclic Jacobi rotations
    written as elementwise tensor ops over the batch (XLA's TPU ``eigh`` is
    a Jacobi method too). ``torch.linalg.eigh`` is no option on the card:
    cuSOLVER's batched solver refuses batches of 32,768 matrices or more,
    and a cloud's neighbourhoods are hundreds of thousands (``chip_smoke.py``
    phase 14 shows both). A 3×3 batch in float32 converges within three
    sweeps to the rounding of its largest eigenvalue; the fourth is margin.
    Equal eigenvalues keep their input order (a stable sort)."""
    d = mat.shape[-1]
    a = [[mat[..., i, j] for j in range(d)] for i in range(d)]
    one, zero = torch.ones_like(a[0][0]), torch.zeros_like(a[0][0])
    v = [[one if i == j else zero for j in range(d)] for i in range(d)]
    for _ in range(_JACOBI_SWEEPS):
        for p in range(d):
            for q in range(p + 1, d):
                # The rotation that zeroes a[p][q] (the smaller angle).
                apq = a[p][q]
                theta = (a[q][q] - a[p][p]) / (2.0 * apq)
                t = torch.where(theta >= 0, 1.0, -1.0) / (
                    torch.abs(theta) + torch.sqrt(theta * theta + 1.0)
                )
                t = torch.where(apq == 0, 0.0, t)
                c = torch.rsqrt(t * t + 1.0)
                s = t * c
                a[p][p] = a[p][p] - t * apq
                a[q][q] = a[q][q] + t * apq
                a[p][q] = a[q][p] = zero
                for r in range(d):
                    if r not in (p, q):
                        arp, arq = a[r][p], a[r][q]
                        a[r][p] = a[p][r] = c * arp - s * arq
                        a[r][q] = a[q][r] = s * arp + c * arq
                for k in range(d):
                    vkp, vkq = v[k][p], v[k][q]
                    v[k][p] = c * vkp - s * vkq
                    v[k][q] = s * vkp + c * vkq
    w = torch.stack([a[i][i] for i in range(d)], dim=-1)
    vec = torch.stack([torch.stack(row, dim=-1) for row in v], dim=-2)
    w, order = torch.sort(w, dim=-1, stable=True)
    return w, torch.take_along_dim(vec, order[..., None, :], dim=-1)


def _logdet_psd(cov: torch.Tensor) -> torch.Tensor:
    """log|Σ| from the eigenvalues, safe for near-singular matrices."""
    w, _ = eigh_sym(cov)
    return torch.sum(torch.log(torch.clamp(w, min=1e-30)), dim=-1)


def mahalanobis2(points, mean, cov) -> torch.Tensor:
    """Squared Mahalanobis distances of ``points (..., N, D)``."""
    d = points.shape[-1]
    prec = torch.linalg.inv(cov + 1e-12 * torch.eye(d, dtype=cov.dtype, device=cov.device))
    diff = points - mean[..., None, :]
    return torch.einsum("...ni,...ij,...nj->...n", diff, prec, diff)


def _smallest(values: torch.Tensor, count: int) -> torch.Tensor:
    """Positions of the ``count`` smallest entries of the last axis, the
    earlier one first among equals (a stable sort, as ``lax.top_k`` of the
    negated values)."""
    return torch.sort(values, dim=-1, stable=True).indices[..., :count]


def _select_mask(positions: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(positions.shape[:-1] + (n,), dtype=torch.bool, device=positions.device)
    return out.scatter(-1, positions, True)


def _mcd_from_scores(
    scores: torch.Tensor,
    points: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    num_refinements: int = 3,
    keep_fraction: float = 0.75,
    min_sample_size: Optional[int] = None,
    chi_square_threshold: float = -1.0,
):
    """:func:`mcd_mean_cov` with the trials' uniform scores given:
    ``scores (..., T, N)`` in [0, 1), ``points (..., N, D)``, ``mask (...,
    N)``. Trial t starts from the D + 1 valid points of smallest score."""
    n, d = points.shape[-2:]
    if mask is None:
        mask = torch.ones(points.shape[:-1], dtype=torch.bool, device=points.device)
    if min_sample_size is None:
        min_sample_size = d + 1
    h = max(int(keep_fraction * n), d + 1)
    pts = points[..., None, :, :]  # (..., 1, N, D): one copy for every trial
    tmask = mask[..., None, :]
    s = scores + torch.where(tmask, 0.0, 2.0)
    sub = _select_mask(_smallest(s, d + 1), n) & tmask
    mean, cov, _ = mean_and_covariance(pts, sub, d + 1)
    for _ in range(num_refinements):
        m2 = torch.where(tmask, mahalanobis2(pts, mean, cov), 1e30)
        keep = _select_mask(_smallest(m2, h), n) & tmask
        mean, cov, _ = mean_and_covariance(pts, keep, d + 1)
    best = torch.argmin(_logdet_psd(cov), dim=-1)  # the first of equals
    mean = torch.take_along_dim(mean, best[..., None, None], dim=-2)[..., 0, :]
    cov = torch.take_along_dim(cov, best[..., None, None, None], dim=-3)[..., 0, :, :]
    valid = torch.sum(mask, dim=-1) >= min_sample_size
    if chi_square_threshold > 0.0:
        m2_query = mahalanobis2(points[..., :1, :], mean, cov)[..., 0]
        valid = valid & (m2_query <= chi_square_threshold)
    return mean, cov, valid


def mcd_mean_cov(
    generator: Optional[torch.Generator],
    points: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    num_trials: int = 6,
    num_refinements: int = 3,
    keep_fraction: float = 0.75,
    min_sample_size: Optional[int] = None,
    chi_square_threshold: float = -1.0,
):
    """Minimum Covariance Determinant over one point set ``(N, D)``:
    ``num_trials`` random (D+1)-subsets, each refined ``num_refinements``
    times on the ``h = keep_fraction·N`` points of smallest Mahalanobis
    distance, the fit of smallest covariance determinant kept. With
    ``chi_square_threshold > 0`` the first point (the query, which leads its
    neighbourhood) must also lie inside the robust ellipse for ``valid``.
    Returns ``(mean, cov, valid)``. ``generator`` draws the subsets (the
    default generator of the points' device if None)."""
    scores = torch.rand(
        (num_trials, points.shape[0]), generator=generator, device=points.device
    )
    return _mcd_from_scores(
        scores, points, mask, num_refinements=num_refinements, keep_fraction=keep_fraction,
        min_sample_size=min_sample_size, chi_square_threshold=chi_square_threshold,
    )
