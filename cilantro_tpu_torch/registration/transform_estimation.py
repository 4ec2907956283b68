"""Closed-form rigid fit (port of ``estimate_rigid_point_to_point`` of
``cilantro_tpu/registration/transform_estimation.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.transforms import Transform

_EPS = 1e-12


def estimate_rigid_point_to_point(
    src: torch.Tensor,
    dst: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[Transform, torch.Tensor]:
    """Closed-form weighted Kabsch/Umeyama rigid fit ``R src + t ≈ dst``
    for ``(N, D)`` correspondences. Returns the transform and whether at
    least D correspondences carry weight."""
    n, d = src.shape
    w = torch.ones(n, dtype=src.dtype, device=src.device) if weights is None else weights
    wsum = torch.clamp(torch.sum(w), min=_EPS)
    mu_s = torch.einsum("n,ni->i", w, src) / wsum
    mu_d = torch.einsum("n,ni->i", w, dst) / wsum
    cs = src - mu_s
    cd = dst - mu_d
    # Cross-covariance C = Σ w d̃ s̃ᵀ  → R = U diag(1..det) Vᵀ.
    c = torch.einsum("n,ni,nj->ij", w, cd, cs)
    u, _, vt = torch.linalg.svd(c)
    det = torch.linalg.det(u @ vt)
    sign = torch.where(det < 0, -1.0, 1.0).to(u.dtype)
    u_fix = torch.cat([u[:, :-1], u[:, -1:] * sign], dim=1)
    r = u_fix @ vt
    t = mu_d - r @ mu_s
    valid = torch.sum(w > 0) >= d
    return Transform(r, t), valid
