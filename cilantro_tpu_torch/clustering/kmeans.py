"""k-means clustering, Lloyd iterations (port of
``cilantro_tpu/clustering/kmeans.py``).

Assignment is one ``(N, K)`` distance block and an argmin (the first of
equal distances); the centroid update is one ``(N, K)ᵀ(N, D)`` one-hot
product (exact 0/1 weights). On an H100 that GEMM took 0.039 ms at N =
120,000, K = 16, D = 3, against 0.043 ms for a broadcast product summed
over the points (``chip_smoke.py`` phase 30). An empty cluster takes a far point: the e-th empty cluster
the e-th farthest from its centroid. The JAX package's ``while_loop`` is
a host loop with one read an iteration (the shift, and whether a cluster
emptied).

Init: k-means++ by default, each next centroid drawn with probability ∝
the squared distance to the nearest chosen one, or ``"random"``: distinct
random valid points. JAX's PRNG key is a ``torch.Generator``: :func:`kmeans`
draws the noise up front, ``(K, N)`` Gumbel noise for k-means++ (JAX's
``categorical`` is ``argmax(logits + gumbel)``, one row a centroid) or
``(N,)`` uniforms for ``"random"``, and passes it to
:func:`_kmeans_from_draws`, so that a test can hand in JAX's own draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import on_device
from ..neighbors.bruteforce import _TILE_DISTS


@dataclasses.dataclass(frozen=True)
class KMeansResult:
    centroids: torch.Tensor  # (K, D)
    labels: torch.Tensor  # (N,) int32
    iterations: torch.Tensor  # int32
    converged: torch.Tensor  # bool


def _assign(points, centroids, valid, metric="l2"):
    """``(N,)`` nearest centroid per point and its distance (``-inf`` for
    invalid points), from one distance block in the metric's family."""
    dist = _TILE_DISTS[metric](points, centroids)  # (N, K)
    d_min, lab = torch.min(dist, dim=1)
    return lab.to(torch.int32), torch.where(valid, d_min, -torch.inf)


def _update(points, labels, valid, k):
    """Per-cluster sums and counts of the valid points: one product of the
    ``(N, K)`` one-hot block with the points (exact 0/1 weights)."""
    w = valid.to(points.dtype)
    onehot = (labels[:, None] == torch.arange(k, dtype=labels.dtype, device=labels.device)[None, :])
    onehot = onehot.to(points.dtype) * w[:, None]
    sums = torch.einsum("nk,nd->kd", onehot, points)
    counts = torch.sum(onehot, dim=0)
    return sums, counts


def _gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms in (0, 1): ``-log(-log u)``."""
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _kmeanspp_from_gumbel(gumbel, points, valid, k, metric):
    """k-means++ seeding with the ``(K, N)`` Gumbel noise given: centroid j
    is ``argmax(logits + gumbel[j])``, the logits ``log`` of the squared
    distance to the nearest chosen centroid (floored at ``log 1e-30``, so a
    chosen point is re-picked only when no distinct valid point is left;
    ``-inf`` for invalid points); centroid 0 has flat logits."""
    tile = _TILE_DISTS[metric]
    i0 = torch.argmax(torch.where(valid, 0.0, -torch.inf) + gumbel[0])
    cents = [points[i0]]
    d2 = tile(points, points[i0][None])[:, 0]
    for j in range(1, k):
        logits = torch.where(valid, torch.log(torch.clamp(d2, min=1e-30)), -torch.inf)
        c = points[torch.argmax(logits + gumbel[j])]
        d2 = torch.minimum(d2, tile(points, c[None])[:, 0])
        cents.append(c)
    return torch.stack(cents)


def _far_points(points, d_min, empty, k):
    """Centroids for the empty clusters: the e-th empty one takes the e-th
    farthest valid point from its centroid (the first of equals)."""
    n_far = min(k, points.shape[0])
    far_idx = torch.sort(d_min, descending=True, stable=True).indices[:n_far]
    empty_rank = torch.cumsum(empty.to(torch.int32), 0) - 1
    return points[far_idx[torch.clamp(empty_rank, 0, n_far - 1)]]


def _kmeans_from_draws(
    draws: torch.Tensor,
    points: torch.Tensor,
    num_clusters: int,
    *,
    valid: Optional[torch.Tensor] = None,
    max_iterations: int = 100,
    tol: float = 1e-7,
    metric: str = "l2",
    init: str = "k-means++",
) -> KMeansResult:
    """:func:`kmeans` with the init's noise given: ``(K, N)`` Gumbel noise
    for ``"k-means++"``, ``(N,)`` uniforms for ``"random"``."""
    n = points.shape[0]
    k = num_clusters
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    if init == "k-means++":
        centroids = _kmeanspp_from_gumbel(draws, points, valid, k, metric)
    elif init == "random":
        scores = draws + torch.where(valid, 0.0, 2.0)
        centroids = points[torch.topk(-scores, k, sorted=True).indices]
    else:
        raise ValueError(f"unknown init {init!r}")

    it, shift = 0, float("inf")
    while it < max_iterations and shift >= tol:
        labels, d_min = _assign(points, centroids, valid, metric)
        sums, counts = _update(points, labels, valid, k)
        empty = counts == 0
        means = sums / torch.clamp(counts, min=1.0)[:, None]
        moved = torch.max(torch.sum((means - centroids) ** 2, dim=1))
        any_empty, shift = torch.stack([torch.any(empty).to(moved.dtype), moved]).tolist()
        if any_empty:  # rare after the first assignment
            means = torch.where(empty[:, None], _far_points(points, d_min, empty, k), means)
            shift = torch.max(torch.sum((means - centroids) ** 2, dim=1)).item()
        centroids = means
        it += 1
    labels, _ = _assign(points, centroids, valid, metric)  # final consistent labels
    dev = points.device
    return KMeansResult(
        centroids=centroids,
        labels=labels,
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        converged=torch.tensor(shift < tol, device=dev),
    )


def kmeans(
    generator: Optional[torch.Generator],
    points,
    num_clusters: int,
    *,
    valid=None,
    max_iterations: int = 100,
    tol: float = 1e-7,
    metric: str = "l2",
    init: str = "k-means++",
    device=None,
) -> KMeansResult:
    """Lloyd k-means of ``points (N, D)`` into ``num_clusters``. Runs on
    the points' device (numpy: ``device``, the card by default);
    ``generator`` draws the init (the device's default if None)."""
    points = on_device(points, device, torch.float32)
    valid = on_device(valid, points.device, torch.bool)
    n = points.shape[0]
    if init == "random":
        draws = torch.rand((n,), generator=generator, device=points.device)
    else:  # k-means++ (an unknown init raises in the stage)
        draws = _gumbel_from_uniform(
            torch.rand((num_clusters, n), generator=generator, device=points.device))
    return _kmeans_from_draws(draws, points, num_clusters, valid=valid,
                              max_iterations=max_iterations, tol=tol, metric=metric, init=init)
