"""Connected components over neighbour graphs (port of
``cilantro_tpu/clustering/connected_components.py``).

Min-label propagation with pointer jumping over the fixed-shape ``(N, k)``
neighbour matrix: each round a point takes the least label of its masked
neighbours, pushes its own into them (a scatter-min on the reverse edges,
so a directed graph is symmetrized), then labels compress by ``l = l[l]``.
The JAX package's ``while_loop`` is a host loop with one read a round.
The scatter-min and the integer size counts are exact on every device.
Labels are ranked by component size (0 = largest), after the size
filters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..neighbors.api import Neighborhoods


@dataclasses.dataclass(frozen=True)
class ConnectedComponents:
    labels: torch.Tensor  # (N,) int32, size-ranked: 0 = largest; -1 = filtered/invalid
    num_components: torch.Tensor  # int32
    sizes: torch.Tensor  # (N,) int32 per size-ranked component (0-padded)


def propagate_labels(
    neighbor_idx: torch.Tensor,
    neighbor_mask: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    max_rounds: Optional[int] = None,
) -> torch.Tensor:
    """Exact connected-component labels (the representative is the least
    point index; ``N`` for invalid points), propagated along both
    directions of every masked edge."""
    n, k = neighbor_idx.shape
    dev = neighbor_idx.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    big = n
    lab = torch.where(valid, torch.arange(n, dtype=torch.int32, device=dev), big)
    idx = neighbor_idx.long()
    # Masked edges scatter into a dump slot n.
    tgt = torch.where(neighbor_mask, idx, n).reshape(-1)
    limit = max_rounds if max_rounds is not None else n
    rounds, changed = 0, True
    while changed and rounds < limit:
        # Forward: min over the neighbours' labels.
        nb = torch.where(neighbor_mask, lab[idx], big)
        fwd = torch.minimum(lab, torch.min(nb, dim=1).values)
        # Reverse: scatter my (updated) label into my neighbours.
        upd = fwd[:, None].expand(n, k).reshape(-1)
        rev = torch.full((n + 1,), big, dtype=torch.int32, device=dev)
        rev = rev.scatter_reduce(0, tgt, upd, "amin")[:n]
        new = torch.minimum(fwd, rev)
        # Pointer jumping (path compression).
        safe = torch.clamp(new, 0, n - 1).long()
        jumped = torch.where(new < big, new[safe], big)
        jumped = torch.where(valid, torch.minimum(new, jumped), big)
        changed = bool(torch.any(jumped != lab))
        lab = jumped
        rounds += 1
    return lab


def connected_components(
    neighborhoods: Neighborhoods,
    *,
    valid: Optional[torch.Tensor] = None,
    edge_mask: Optional[torch.Tensor] = None,
    min_size: int = 1,
    max_size: Optional[int] = None,
) -> ConnectedComponents:
    """Components of the neighbourhood graph, on its device; labels ranked
    by size (0 = largest), -1 for invalid points and components outside
    ``[min_size, max_size]``."""
    idx = neighborhoods.indices
    mask = neighborhoods.mask
    if edge_mask is not None:
        mask = mask & edge_mask
    n = idx.shape[0]
    dev = idx.device
    raw = propagate_labels(idx, mask, valid)  # representative indices, n = invalid

    ok = raw < n
    safe_raw = torch.where(ok, raw, 0).long()
    sizes_by_rep = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, safe_raw, ok.to(torch.int32))
    my_size = torch.where(ok, sizes_by_rep[safe_raw], 0)
    size_ok = (my_size >= min_size) & (my_size <= (max_size if max_size is not None else n))

    # Rank components by size (descending); representative slots only.
    ar = torch.arange(n, dtype=torch.int32, device=dev)
    is_rep = ok & (raw == ar) & size_ok
    rep_sizes = torch.where(is_rep, sizes_by_rep, -1)
    order = torch.argsort(-rep_sizes, stable=True)  # reps first, by size desc
    rank_of = torch.zeros(n, dtype=torch.int32, device=dev)
    rank_of[order] = ar
    labels = torch.where(ok & size_ok, rank_of[safe_raw], -1)
    sorted_sizes = rep_sizes[order]
    return ConnectedComponents(
        labels=labels,
        num_components=torch.sum(is_rep, dtype=torch.int32),
        sizes=torch.where(sorted_sizes > 0, sorted_sizes, 0),
    )


def edge_mask_from_evaluator(
    neighborhoods: Neighborhoods,
    points: torch.Tensor,
    normals: Optional[torch.Tensor] = None,
    colors: Optional[torch.Tensor] = None,
    *,
    max_distance: Optional[float] = None,
    max_normal_angle: Optional[float] = None,
    max_color_diff: Optional[float] = None,
) -> torch.Tensor:
    """Similarity gates of the proximity evaluators: distance, normal angle
    (radians, sign-invariant) and Euclidean colour difference."""
    idx = neighborhoods.indices.long()
    m = neighborhoods.mask
    if max_distance is not None:
        diff = points[idx] - points[:, None, :]
        m = m & (torch.sum(diff * diff, dim=-1) <= max_distance * max_distance)
    if max_normal_angle is not None and normals is not None:
        dots = torch.abs(torch.einsum("nkd,nd->nk", normals[idx], normals))
        m = m & (dots >= torch.cos(torch.as_tensor(max_normal_angle, dtype=dots.dtype)))
    if max_color_diff is not None and colors is not None:
        cdiff = colors[idx] - colors[:, None, :]
        m = m & (torch.sum(cdiff * cdiff, dim=-1) <= max_color_diff * max_color_diff)
    return m
