"""One neighbourhood-search interface over the engines (port of
``cilantro_tpu/neighbors/api.py``).

Three functions return fixed-shape :class:`Neighborhoods`:

* :func:`knn_search`           — the k nearest;
* :func:`radius_search`        — up to ``max_results`` within a radius;
* :func:`knn_in_radius_search` — the k nearest within a radius.

Distances are squared L2 (or the metric's value). The backend is chosen as
the JAX package chooses it, with "on the TPU" read as "CUDA tensors": large
3-D L2 radius searches with a cap of at most 16 take the compact kNN kernel,
other large 2-D/3-D L2 ones the grid, everything else brute force; each
reports fixed-capacity truncation per query in ``overflowed``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .bruteforce import INVALID_DIST, knn


@dataclasses.dataclass(frozen=True)
class Neighborhoods:
    """Fixed-shape neighbourhood set. ``indices (Q, k) int32`` are always
    safe to gather with (masked slots hold 0); ``mask (Q, k)`` marks real
    neighbours; ``distances (Q, k)`` holds the metric value,
    ``INVALID_DIST`` in masked slots; ``overflowed (Q,)``, when present,
    flags queries whose true result set the capacity truncated."""

    indices: torch.Tensor
    distances: torch.Tensor
    mask: torch.Tensor
    overflowed: Optional[torch.Tensor] = None

    @property
    def k(self) -> int:
        return self.indices.shape[-1]

    def counts(self) -> torch.Tensor:
        return torch.sum(self.mask, dim=-1)


def _finish(dist, idx, overflowed=None) -> Neighborhoods:
    mask = dist < INVALID_DIST
    return Neighborhoods(
        indices=torch.where(mask, idx, 0), distances=dist, mask=mask, overflowed=overflowed
    )


def knn_search(
    queries: torch.Tensor,
    keys: torch.Tensor,
    k: int,
    *,
    query_valid: Optional[torch.Tensor] = None,
    key_valid: Optional[torch.Tensor] = None,
    metric: str = "l2",
    exclude_self: bool = False,
    backend: str = "auto",
) -> Neighborhoods:
    """Exact kNN. ``backend``: ``'auto'`` (CUDA: the pruned kernel path for
    large L2 3-D problems, the full kernel otherwise; CPU: the tiled scan),
    ``'pruned'`` (force :func:`.fused_knn.knn_pruned`) or ``'brute'``
    (never prune)."""
    if backend not in ("auto", "pruned", "brute"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "pruned":
        if metric != "l2" or queries.shape[1] != 3:
            raise ValueError(
                "backend='pruned' supports the L2 metric in 3D only "
                f"(got metric={metric!r}, D={queries.shape[1]})"
            )
        from .fused_knn import knn_pruned

        dist, idx = knn_pruned(
            queries, keys, k, query_valid=query_valid, key_valid=key_valid,
            exclude_self=exclude_self,
        )
        return _finish(dist, idx)
    dist, idx = knn(
        queries, keys, k, query_valid=query_valid, key_valid=key_valid, metric=metric,
        exclude_self=exclude_self, allow_pruned=backend == "auto",
    )
    return _finish(dist, idx)


def radius_search(
    queries: torch.Tensor,
    keys: torch.Tensor,
    radius: float,
    max_results: int,
    *,
    query_valid: Optional[torch.Tensor] = None,
    key_valid: Optional[torch.Tensor] = None,
    metric: str = "l2",
    exclude_self: bool = False,
    backend: str = "auto",
) -> Neighborhoods:
    """All neighbours within ``radius`` (compared with the squared distance
    for L2), the closest ``max_results`` kept; ``overflowed`` flags queries
    whose set was truncated. ``backend``: ``'auto'``, ``'grid'``
    (:func:`.gridhash.radius_search_grid`), ``'pruned'``
    (:func:`.fused_knn.radius_search_pruned`; L2, 3-D) or ``'brute'``."""
    d = queries.shape[1]
    if backend == "grid" and (metric != "l2" or d not in (2, 3)):
        raise ValueError(
            "backend='grid' supports the L2 metric in 2D/3D only "
            f"(got metric={metric!r}, D={d})"
        )
    big = queries.shape[0] * keys.shape[0] >= 1 << 26
    if (
        backend == "auto"
        and metric == "l2"
        and d == 3
        and big
        and max_results <= 16
        and queries.device.type == "cuda"
    ):
        # The compact kernel's cost grows with the cap (a cap + 1 slot
        # top-k per query): small caps only, as in the JAX package.
        backend = "pruned"
    if backend == "pruned":
        if metric != "l2" or d != 3:
            raise ValueError(
                "backend='pruned' supports the L2 metric in 3D only "
                f"(got metric={metric!r}, D={d})"
            )
        from .fused_knn import radius_search_pruned

        dist, idx, over = radius_search_pruned(
            queries, keys, radius, max_results, query_valid=query_valid,
            key_valid=key_valid, exclude_self=exclude_self,
        )
        return _finish(dist, idx, over)
    if backend == "grid" or (backend == "auto" and metric == "l2" and d in (2, 3) and big):
        from .gridhash import radius_search_grid

        dist, idx, over = radius_search_grid(
            queries, keys, radius, max_results, query_valid=query_valid,
            key_valid=key_valid, exclude_self=exclude_self,
        )
        return _finish(dist, idx, over)

    # Brute: one neighbour more than the cap, so that truncation shows (the
    # (cap + 1)-th hit inside the radius means overflow).
    nb = knn_search(
        queries, keys, max_results + 1, query_valid=query_valid, key_valid=key_valid,
        metric=metric, exclude_self=exclude_self, backend=backend,
    )
    r = radius * radius if metric in ("l2", "so2") else radius
    full_mask = nb.mask & (nb.distances <= r)
    if nb.distances.shape[1] > max_results:
        over = full_mask[:, max_results]
    else:
        over = torch.zeros(queries.shape[0], dtype=torch.bool, device=queries.device)
    mask = full_mask[:, :max_results]
    return Neighborhoods(
        indices=torch.where(mask, nb.indices[:, :max_results], 0),
        distances=torch.where(mask, nb.distances[:, :max_results], INVALID_DIST),
        mask=mask,
        overflowed=over,
    )


def knn_in_radius_search(
    queries: torch.Tensor, keys: torch.Tensor, k: int, radius: float, **kwargs
) -> Neighborhoods:
    return radius_search(queries, keys, radius, k, **kwargs)
