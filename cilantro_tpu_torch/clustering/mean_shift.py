"""Mean shift clustering (port of ``cilantro_tpu/clustering/mean_shift.py``).

All seeds shift in lockstep: each iteration is one ``(S, N)`` distance
block and a masked weighted mean (the dense, exact path), or with
``max_neighbors=R`` a radius search keeping the closest ``R`` and a
gathered mean (the capped path for large N; on the card a 3-D search with
``R ≤ 16`` over ≥ 2²⁶ pairs runs the compact kNN kernel). Converged seeds
stop moving; the loop ends when the largest squared shift falls below
``tol``, a host loop with one read an iteration. Modes closer than
``merge_distance`` merge through connected components of their proximity
graph: dense, or a second capped radius search and :func:`propagate_labels`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import on_device
from ..neighbors.api import radius_search
from .connected_components import propagate_labels


@dataclasses.dataclass(frozen=True)
class MeanShiftResult:
    modes: torch.Tensor  # (K, D) cluster modes (slot-padded)
    labels: torch.Tensor  # (S,) int32 cluster id per seed
    num_clusters: torch.Tensor  # int32
    iterations: torch.Tensor  # int32
    # True when a capped neighbourhood was truncated: the result may then
    # deviate from the exact dense path. Always False on the dense path.
    overflowed: torch.Tensor


def _pairwise_sq(a, b):
    aa = torch.sum(a * a, dim=1, keepdim=True)
    bb = torch.sum(b * b, dim=1)[None, :]
    return torch.clamp(aa + bb - 2.0 * (a @ b.T), min=0.0)


def _merge_labels(adj):
    """Connected components of a small dense adjacency by min-label
    propagation with pointer jumping (a host read a round)."""
    s = adj.shape[0]
    lab = torch.arange(s, dtype=torch.int32, device=adj.device)
    changed, it = True, 0
    while changed and it < s:
        neigh_min = torch.min(torch.where(adj, lab[None, :], s), dim=1).values
        new = torch.minimum(lab, neigh_min)
        new = new[new.long()]  # pointer jumping
        changed = bool(torch.any(new != lab))
        lab = new
        it += 1
    return lab


def mean_shift(
    points,
    radius: float,
    *,
    seeds=None,
    valid=None,
    max_iterations: int = 100,
    tol: float = 1e-7,
    merge_distance: Optional[float] = None,
    kernel: str = "flat",
    weight_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    max_neighbors: Optional[int] = None,
    merge_cap: int = 32,
    device=None,
) -> MeanShiftResult:
    """Shift ``seeds`` (default: all points) to their kernel density modes.
    ``radius`` is the kernel support; ``merge_distance`` (default
    ``radius / 2``) merges converged modes. ``max_neighbors=None`` is the
    exact dense path (one ``(S, N)`` block an iteration: its memory bounds
    the scale); ``max_neighbors=R`` the capped path. Runs on the points'
    device (numpy: ``device``, the card by default)."""
    points = on_device(points, device, torch.float32)
    dev = points.device
    n = points.shape[0]
    seeds = points if seeds is None else on_device(seeds, dev, torch.float32)
    valid = torch.ones(n, dtype=torch.bool, device=dev) if valid is None else on_device(valid, dev, torch.bool)
    r2 = radius * radius
    if merge_distance is None:
        merge_distance = radius * 0.5
    if weight_fn is None and kernel not in ("flat", "normal", "gaussian"):
        raise ValueError(f"unknown kernel {kernel!r}")

    def kernel_w(dist2):
        if weight_fn is not None:
            return weight_fn(dist2)
        if kernel in ("normal", "gaussian"):
            return torch.exp(-dist2 / (2.0 * r2))
        return torch.ones_like(dist2)  # flat

    def step(pos):
        """The next positions and whether a neighbourhood overflowed."""
        if max_neighbors is None:
            dist2 = _pairwise_sq(pos, points)  # (S, N)
            w = torch.where((dist2 <= r2) & valid[None, :], kernel_w(dist2), 0.0)
            wsum = torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1e-30)
            return (w @ points) / wsum, None
        nb = radius_search(pos, points, radius, max_neighbors, key_valid=valid)
        w = torch.where(nb.mask, kernel_w(torch.clamp(nb.distances, min=0.0)), 0.0)
        gathered = points[nb.indices.long()]  # (S, R, D)
        wsum = torch.clamp(torch.sum(w, dim=1, keepdim=True), min=1e-30)
        new_pos = torch.einsum("sr,srd->sd", w, gathered) / wsum
        # Seeds with an empty neighbourhood stay put.
        return torch.where(torch.any(nb.mask, dim=1)[:, None], new_pos, pos), torch.any(nb.overflowed)

    modes, it, shift = seeds, 0, float("inf")
    overflowed = torch.zeros((), dtype=torch.bool, device=dev)
    while it < max_iterations and shift >= tol:
        new_pos, over = step(modes)
        shift = torch.max(torch.sum((new_pos - modes) ** 2, dim=1)).item()
        if over is not None:
            overflowed = overflowed | over
        modes = new_pos
        it += 1

    # Merge modes closer than merge_distance → cluster labels.
    s = modes.shape[0]
    if max_neighbors is None:
        raw = _merge_labels(_pairwise_sq(modes, modes) <= merge_distance * merge_distance)
    else:
        # A truncated merge neighbourhood is not folded into `overflowed`:
        # converged modes of one cluster nearly coincide, so every capped
        # list shares the cluster's lowest-index core and the graph stays
        # connected.
        nb = radius_search(modes, modes, merge_distance, merge_cap)
        raw = torch.clamp(propagate_labels(nb.indices, nb.mask), max=s - 1)
    # Compact labels to 0..K-1 (raw labels are representative seed indices).
    is_rep = raw == torch.arange(s, dtype=torch.int32, device=dev)
    compact = torch.cumsum(is_rep.to(torch.int32), 0, dtype=torch.int32) - 1
    labels = compact[raw.long()]
    # Each cluster's representative mode: one nonzero row a segment, so the
    # sum is exact in any order.
    cluster_modes = torch.zeros_like(modes).index_add_(
        0, compact.long(), torch.where(is_rep[:, None], modes, 0.0))
    return MeanShiftResult(
        modes=cluster_modes,
        labels=labels,
        num_clusters=torch.sum(is_rep, dtype=torch.int32),
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        overflowed=overflowed,
    )
