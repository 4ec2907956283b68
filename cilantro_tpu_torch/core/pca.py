"""Principal component analysis (port of ``cilantro_tpu/core/pca.py``).

Mean and covariance, the symmetric eigenproblem by :func:`.covariance.eigh_sym`
(cyclic Jacobi, as every small eigenproblem in the port: cuSOLVER's
batched ``eigh`` refuses batches of 32,768 matrices or more), eigenvectors
sorted descending with the determinant-sign fix, and ``project`` /
``reconstruct`` to and from the leading subspace. Only the basis as a
whole is defined: a column's sign may differ from JAX's ``eigh``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .covariance import eigh_sym, mean_and_covariance


@dataclasses.dataclass(frozen=True)
class PCA:
    mean: torch.Tensor  # (..., D)
    eigenvalues: torch.Tensor  # (..., D) descending
    eigenvectors: torch.Tensor  # (..., D, D) columns, descending, det = +1

    def project(self, points: torch.Tensor, num_components: int) -> torch.Tensor:
        basis = self.eigenvectors[..., :, :num_components]
        return (points - self.mean) @ basis

    def reconstruct(self, projected: torch.Tensor) -> torch.Tensor:
        k = projected.shape[-1]
        basis = self.eigenvectors[..., :, :k]
        return projected @ basis.transpose(-1, -2) + self.mean


def fit_pca(points: torch.Tensor, mask: Optional[torch.Tensor] = None) -> PCA:
    """PCA of ``points (..., N, D)`` (``mask (..., N)`` selects samples),
    on the points' device."""
    mean, cov, _ = mean_and_covariance(points, mask)
    w, v = eigh_sym(cov)
    w = torch.flip(w, (-1,))
    v = torch.flip(v, (-1,))
    # Determinant-sign fix: make the basis a proper rotation.
    sign = torch.where(torch.linalg.det(v) < 0, -1.0, 1.0).to(v.dtype)
    v = torch.cat([v[..., :, :-1], v[..., :, -1:] * sign[..., None, None]], -1)
    return PCA(mean=mean, eigenvalues=w, eigenvectors=v)
