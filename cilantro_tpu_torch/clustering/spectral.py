"""Spectral clustering (port of ``cilantro_tpu/clustering/spectral.py``).

The graph Laplacian in three flavours (unnormalized, normalized-symmetric,
random-walk through the symmetric problem rescaled), its smallest
eigenvectors, the eigengap estimate of the cluster count and k-means on
the row-normalized embedding. Dense affinities use ``torch.linalg.eigh``.
For large N, :func:`spectral_embedding_knn` works on the masked kNN graph
itself: LOBPCG (:func:`_lobpcg_standard`, the port's copy of the JAX
package's ``lobpcg_standard``, which ``torch.lobpcg`` is not) on the
polynomially filtered operator ``((σI − L)/σ)^q``, one gather and one
sorted segment sum an application, so that two card runs give the same
bits. JAX's PRNG keys are a ``torch.Generator``: the public functions draw
LOBPCG's start block and k-means's noise and pass them to the
``_..._from_draws`` stages, so that a test can hand in JAX's own draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import on_device
from ..core.segment import sorted_scatter_plan, sorted_scatter_sum
from .kmeans import _gumbel_from_uniform, _kmeans_from_draws


@dataclasses.dataclass(frozen=True)
class SpectralResult:
    labels: torch.Tensor  # (N,) int32
    embedding: torch.Tensor  # (N, k)
    eigenvalues: torch.Tensor  # (k,) ascending
    num_clusters: torch.Tensor  # int32


def laplacian(affinity: torch.Tensor, kind: str = "normalized") -> torch.Tensor:
    """L from a symmetric affinity W: ``unnormalized`` D − W, otherwise
    ``I − D^{-1/2} W D^{-1/2}`` (the random-walk variant rescales the
    eigenvectors in :func:`spectral_embedding`)."""
    d = torch.sum(affinity, dim=1)
    if kind == "unnormalized":
        return torch.diag(d) - affinity
    dm = 1.0 / torch.sqrt(torch.clamp(d, min=1e-30))
    n = affinity.shape[0]
    eye = torch.eye(n, dtype=affinity.dtype, device=affinity.device)
    return eye - (dm[:, None] * affinity) * dm[None, :]


def spectral_embedding(
    affinity: torch.Tensor,
    num_components: int,
    kind: str = "normalized",
):
    """Smallest-eigenvector embedding of the Laplacian: ``(embedding (N,
    k), eigenvalues (k,) ascending)``."""
    lap = laplacian(affinity, kind)
    w, v = torch.linalg.eigh(lap)
    emb = v[:, :num_components]
    vals = w[:num_components]
    if kind == "random_walk":
        d = torch.sum(affinity, dim=1)
        emb = emb / torch.sqrt(torch.clamp(d, min=1e-30))[:, None]
    return emb, vals


def estimate_num_clusters_eigengap(eigenvalues: torch.Tensor) -> torch.Tensor:
    """Largest-gap heuristic over ascending Laplacian eigenvalues; at
    least 2."""
    gaps = eigenvalues[1:] - eigenvalues[:-1]
    return torch.clamp(torch.argmax(gaps).to(torch.int32) + 1, min=2)


def _kmeans_draws(generator, k, n, device):
    """k-means++'s ``(k, N)`` Gumbel noise."""
    return _gumbel_from_uniform(torch.rand((k, n), generator=generator, device=device))


def _cluster_embedding(draws, emb, vals, num_clusters, k_emb, row_normalize):
    """The dense and kNN paths' shared tail: eigengap count, unused columns
    zeroed, optional row normalization, then k-means with ``draws``."""
    if num_clusters is None:
        n_est = estimate_num_clusters_eigengap(vals)
        col_ok = torch.arange(k_emb, device=emb.device)[None, :] < n_est
        emb = torch.where(col_ok, emb, 0.0)
        k_fit = k_emb  # capacity; extra clusters starve
        num = n_est
    else:
        k_fit = num_clusters
        num = torch.tensor(num_clusters, dtype=torch.int32, device=emb.device)
    if row_normalize:
        emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-30)
    km = _kmeans_from_draws(draws[:k_fit], emb, k_fit)
    return SpectralResult(labels=km.labels, embedding=emb, eigenvalues=vals, num_clusters=num)


def _spectral_clustering_from_draws(draws, affinity, num_clusters=None, *, kind="normalized",
                                    max_embedding_dim=8, row_normalize=True) -> SpectralResult:
    """:func:`spectral_clustering` with k-means's ``(k, N)`` Gumbel noise
    given."""
    k_emb = max_embedding_dim if num_clusters is None else num_clusters
    emb, vals = spectral_embedding(affinity, k_emb, kind)
    return _cluster_embedding(draws, emb, vals, num_clusters, k_emb, row_normalize)


def spectral_clustering(
    generator: Optional[torch.Generator],
    affinity,
    num_clusters: Optional[int] = None,
    *,
    kind: str = "normalized",
    max_embedding_dim: int = 8,
    row_normalize: bool = True,
    device=None,
) -> SpectralResult:
    """Cluster from a dense symmetric affinity matrix. ``num_clusters=None``
    estimates the count by the eigengap; the embedding then keeps
    ``max_embedding_dim`` columns with the unused ones zeroed. Runs on the
    affinity's device (numpy: ``device``, the card by default)."""
    affinity = on_device(affinity, device, torch.float32)
    k_emb = max_embedding_dim if num_clusters is None else num_clusters
    draws = _kmeans_draws(generator, k_emb, affinity.shape[0], affinity.device)
    return _spectral_clustering_from_draws(draws, affinity, num_clusters, kind=kind,
                                           max_embedding_dim=max_embedding_dim,
                                           row_normalize=row_normalize)


# ---------------------------------------------------------------------------
# Large N: the masked kNN graph and block LOBPCG.
# ---------------------------------------------------------------------------


def _knn_laplacian_matvec(indices, weights, mask, kind):
    """``(matvec, sigma, dm)`` for the symmetrized kNN affinity
    ``W = (A + Aᵀ)/2``: ``matvec(X) (N, B) → L X``, a Gershgorin bound
    ``sigma ≥ λ_max(L)`` and ``D^{-1/2}`` (None when unnormalized). ``A X``
    is a gather, ``Aᵀ X`` a sorted segment sum over the edge list (its
    plan built once, from one copy of the indices to the host)."""
    n, k = indices.shape
    wm = torch.where(mask, weights, 0.0)
    idx = indices.long()
    flat_idx = indices.reshape(-1)
    plan = sorted_scatter_plan(flat_idx.cpu().numpy(), n, indices.device)

    def w_apply(x):  # (N, B) → W x
        # A broadcast product summed over the k slots: as an einsum this is
        # a batched GEMV of N tiny products (0.041 ms a call at N = 30,000
        # on an H100, chip_smoke.py phase 31).
        ax = torch.sum(wm[..., None] * x[idx], dim=1)
        atx = sorted_scatter_sum((wm[..., None] * x[:, None, :]).reshape(n * k, -1), plan, n)
        return 0.5 * (ax + atx)

    d = w_apply(torch.ones((n, 1), dtype=wm.dtype, device=wm.device))[:, 0]
    if kind == "unnormalized":
        sigma = 2.0 * torch.max(d)

        def matvec(x):
            return d[:, None] * x - w_apply(x)

        return matvec, sigma, None

    dm = 1.0 / torch.sqrt(torch.clamp(d, min=1e-30))

    def matvec(x):  # L_sym x = x − D^{-1/2} W D^{-1/2} x
        return x - dm[:, None] * w_apply(dm[:, None] * x)

    return matvec, torch.tensor(2.0, dtype=wm.dtype, device=wm.device), dm


def _col_norms(x):
    return torch.linalg.vector_norm(x, dim=0, keepdim=True)


def _eigh_descending(a):
    w, v = torch.linalg.eigh(a)
    return torch.flip(w, (0,)), torch.flip(v, (1,))


def _svqb(x):
    """A truncated orthonormal basis of ``x``'s columns (SVQB): columns of
    a rank-deficient ``x`` come out zero."""
    norms = _col_norms(x)
    x = x / torch.where(norms == 0, 1.0, norms)
    inner = x.T @ x
    w, v = _eigh_descending(inner)
    tau = torch.finfo(x.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, 1.0) ** (-0.5)
    ortho = x @ (v * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep.to(ortho.dtype)
    norms = _col_norms(ortho)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, 1.0)


def _orthonormalize(basis):
    for _ in range(2):  # twice is enough
        basis = _svqb(basis)
    return basis


def _project_out(basis, u):
    """``u``'s component orthogonal to the orthonormal ``basis`` (zero
    columns allowed), its nonzero columns orthonormal; suspicious columns
    are zeroed."""
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
        u = _orthonormalize(u)
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
    return u * (_col_norms(u) >= 0.99).to(u.dtype)


def _extend_basis(x, m):
    """``m`` more orthonormal columns for the orthonormal ``x (n, k)``, by
    a block Householder reflector."""
    n, k = x.shape
    upper, lower = x[:k], x[k:]
    u, s, vt = torch.linalg.svd(upper)
    y = torch.cat([upper + u @ vt, lower], dim=0)
    other = torch.cat([torch.eye(m, dtype=x.dtype, device=x.device),
                       torch.zeros((n - k - m, m), dtype=x.dtype, device=x.device)], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** (-0.5))[None, :])
    h = -2 * torch.linalg.multi_dot([w, w[k:, :].T, other])
    return torch.cat([h[:k], h[k:] + other], dim=0)


def _lobpcg_standard(a, x, m: int = 100, tol: Optional[float] = None):
    """The top-k eigenpairs of the symmetric operator ``a`` by LOBPCG, the
    algorithm of ``jax.experimental.sparse.linalg.lobpcg_standard``: an
    orthonormal ``[X, P, R]`` basis kept by SVQB, Rayleigh-Ritz on it, no
    locking. ``tol=0`` runs all ``m`` iterations (no host read); a positive
    ``tol`` stops once every residual passes JAX's test (a read an
    iteration). Returns ``(theta (k,), X (n, k), iterations)``."""
    n, k = x.shape
    if k == 0 or k * 5 >= n:
        raise ValueError(f"LOBPCG needs 0 < 5·k < n, got k={k}, n={n}")
    if tol is None:
        tol = float(torch.finfo(x.dtype).eps)
    x = _orthonormalize(x)
    p = _extend_basis(x, k)
    ax = a(x)
    theta = torch.sum(x * ax, dim=0, keepdim=True)
    r = ax - theta * x
    i = 0
    while i < m:
        r = _project_out(torch.cat([x, p], dim=1), r)
        xpr = torch.cat([x, p, r], dim=1)
        theta, q = _eigh_descending(xpr.T @ a(xpr))  # Rayleigh-Ritz
        b = q[:, :k]
        b = b / _col_norms(b)
        x = xpr @ b
        x = x / _col_norms(x)
        qq, _ = torch.linalg.qr(q[:k, k:].T)
        p = xpr @ (q[:, k:] @ qq)
        norm_p = _col_norms(p)
        p = p / torch.where(norm_p == 0, 1.0, norm_p)
        ax = a(x)
        r = ax - theta[None, :k] * x
        i += 1
        if tol > 0.0:
            reltol = (torch.linalg.vector_norm(ax, dim=0) + theta[:k]) * n * 10
            if int(torch.sum(torch.linalg.vector_norm(r, dim=0) < tol * reltol)) >= k:
                break
        theta = theta[None, :k]
    return theta.reshape(-1)[:k], x, i


def _spectral_embedding_knn_from_x0(
    x0: torch.Tensor,
    indices: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    *,
    kind: str = "normalized",
    max_iterations: int = 100,
    filter_degree: int = 8,
    tol: float = 0.0,
):
    """:func:`spectral_embedding_knn` with LOBPCG's ``(N, k)`` start block
    given."""
    matvec, sigma, dm = _knn_laplacian_matvec(indices, weights, mask, kind)

    def filtered(x):
        for _ in range(max(1, filter_degree)):
            x = x - matvec(x) / sigma
        return x

    _, v, _ = _lobpcg_standard(filtered, x0, m=max_iterations, tol=tol)
    lam = torch.einsum("nk,nk->k", v, matvec(v))  # Rayleigh (v orthonormal)
    order = torch.argsort(lam, stable=True)
    lam = lam[order]
    emb = v[:, order]
    if kind == "random_walk":
        emb = emb * dm[:, None]
    return emb, lam


def spectral_embedding_knn(
    generator: Optional[torch.Generator],
    indices: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    num_components: int,
    *,
    kind: str = "normalized",
    max_iterations: int = 100,
    filter_degree: int = 8,
    tol: float = 0.0,
):
    """Smallest-eigenvector Laplacian embedding of a masked kNN affinity
    graph (``indices / weights / mask (N, k)``): LOBPCG on
    ``((σI − L)/σ)^q``, whose top k are L's smallest k, the eigenvalues from
    Rayleigh quotients against L. ``tol=0`` (default) runs all
    ``max_iterations``: the filtered spectrum packs the sought eigenvalues
    near 1, where a float32 stopping rule fires far too early. Runs on the
    graph's device; ``generator`` draws the normal start block. Returns
    ``(embedding (N, num_components), eigenvalues ascending)``."""
    x0 = torch.randn((indices.shape[0], num_components), generator=generator,
                     dtype=weights.dtype, device=weights.device)
    return _spectral_embedding_knn_from_x0(x0, indices, weights, mask, kind=kind,
                                           max_iterations=max_iterations,
                                           filter_degree=filter_degree, tol=tol)


def _spectral_clustering_knn_from_draws(
    x0, draws, indices, weights, mask, num_clusters=None, *, kind="normalized",
    max_embedding_dim=8, row_normalize=True, max_iterations=100, filter_degree=8,
) -> SpectralResult:
    """:func:`spectral_clustering_knn` with LOBPCG's start block ``x0`` and
    k-means's Gumbel noise ``draws`` given."""
    k_emb = max_embedding_dim if num_clusters is None else num_clusters
    emb, vals = _spectral_embedding_knn_from_x0(
        x0, indices, weights, mask, kind=kind, max_iterations=max_iterations,
        filter_degree=filter_degree,
    )
    return _cluster_embedding(draws, emb, vals, num_clusters, k_emb, row_normalize)


def spectral_clustering_knn(
    generator: Optional[torch.Generator],
    indices: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    num_clusters: Optional[int] = None,
    *,
    kind: str = "normalized",
    max_embedding_dim: int = 8,
    row_normalize: bool = True,
    max_iterations: int = 100,
    filter_degree: int = 8,
) -> SpectralResult:
    """Spectral clustering on a masked kNN affinity graph, the large-N twin
    of :func:`spectral_clustering`, on the graph's device."""
    k_emb = max_embedding_dim if num_clusters is None else num_clusters
    n, dev = indices.shape[0], weights.device
    x0 = torch.randn((n, k_emb), generator=generator, dtype=weights.dtype, device=dev)
    draws = _kmeans_draws(generator, k_emb, n, dev)
    return _spectral_clustering_knn_from_draws(
        x0, draws, indices, weights, mask, num_clusters, kind=kind,
        max_embedding_dim=max_embedding_dim, row_normalize=row_normalize,
        max_iterations=max_iterations, filter_degree=filter_degree,
    )
