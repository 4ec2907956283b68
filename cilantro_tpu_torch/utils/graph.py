"""Nearest-neighbour graph matrices (port of ``cilantro_tpu/utils/graph.py``):
degrees, dense adjacency, distance and function-valued matrices, and
fixed-shape COO triplets: the affinity inputs of spectral clustering and
MDS. Duplicate edges combine by a max scatter, exact in any order."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..neighbors.api import Neighborhoods


def neighborhood_degrees(nb: Neighborhoods) -> torch.Tensor:
    """Valid-neighbour count per point."""
    return nb.counts()


def _edges(nb: Neighborhoods):
    n, k = nb.indices.shape
    rows = torch.arange(n, device=nb.indices.device).repeat_interleave(k)
    return n, rows, nb.indices.reshape(-1).long()


def _scatter_max(n, rows, cols, vals, fill, symmetrize):
    a = torch.full((n * n,), fill, dtype=vals.dtype, device=vals.device)
    a = a.scatter_reduce(0, rows * n + cols, vals, "amax").reshape(n, n)
    return torch.maximum(a, a.T) if symmetrize else a


def adjacency_dense(nb: Neighborhoods, symmetrize: bool = True) -> torch.Tensor:
    """``(N, N)`` boolean adjacency."""
    n, rows, cols = _edges(nb)
    vals = nb.mask.reshape(-1).to(torch.uint8)
    return _scatter_max(n, rows, cols, vals, 0, symmetrize).bool()


def function_value_dense(
    nb: Neighborhoods,
    fn: Callable[[torch.Tensor], torch.Tensor],
    fill: float = 0.0,
    symmetrize: bool = True,
) -> torch.Tensor:
    """``(N, N)`` matrix of ``fn(squared distance)`` over the graph's edges,
    ``fill`` elsewhere (e.g. an RBF affinity)."""
    n, rows, cols = _edges(nb)
    vals = torch.where(nb.mask, fn(nb.distances), fill).reshape(-1)
    return _scatter_max(n, rows, cols, vals, fill, symmetrize)


def distance_dense(nb: Neighborhoods, fill: float = 0.0) -> torch.Tensor:
    """``(N, N)`` squared-distance matrix over the graph's edges."""
    return function_value_dense(nb, lambda d: d, fill=fill)


def function_value_sparse(
    nb: Neighborhoods, fn: Callable[[torch.Tensor], torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """COO triplets ``(rows, cols, values, mask)`` of ``fn(d²)`` over the
    edges, fixed shape ``(N·k,)``."""
    n, rows, _ = _edges(nb)
    cols = nb.indices.reshape(-1)
    mask = nb.mask.reshape(-1)
    vals = torch.where(mask, fn(nb.distances.reshape(-1)), 0.0)
    return rows.to(torch.int32), cols, vals, mask
