"""Voxel-grid binning and downsampling (port of ``cilantro_tpu/core/grid.py``).

Points are sorted by voxel coordinate (successive stable sorts, least
significant key first: the port of ``jnp.lexsort``) and reduced per bin.
The per-bin sums are ``torch.segment_reduce`` over the sorted segments: a
deterministic sum in segment order on every device, where ``index_add_``
on CUDA would add with atomics in an order that changes from run to run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .containers import PointCloud

_INT32_MAX = 2**31 - 1


def floor_int32(x: torch.Tensor) -> torch.Tensor:
    """``floor(x)`` as int32, saturating as XLA converts: out-of-range
    values (points at 1e30) go to the int32 limits and NaN to 0, where a
    plain ``.to(torch.int32)`` is undefined."""
    f = torch.floor(x)
    big = f >= 2.0**31
    small = f < -(2.0**31)
    i = torch.where(big | small | torch.isnan(f), 0.0, f).to(torch.int32)
    return torch.where(big, _INT32_MAX, torch.where(small, -(2**31), i))


def voxel_coords(points: torch.Tensor, bin_size) -> torch.Tensor:
    """Integer grid coordinates ``floor(p / bin)``, divided by a 0-d tensor
    so that the division is a true one on every device."""
    b = torch.as_tensor(bin_size, dtype=points.dtype).to(points.device)
    return floor_int32(points / b)


@dataclasses.dataclass(frozen=True)
class GridBins:
    """Sorted-groupby view of a point set's voxels: ``order (N,)`` sorts the
    points by voxel (invalid last); ``segment_ids (N,)`` is the bin of each
    sorted point; ``bin_of_point (N,)`` the bin of each original point;
    ``counts (N,)`` the valid points per bin; ``num_bins`` the occupied
    bins."""

    order: torch.Tensor
    segment_ids: torch.Tensor
    bin_of_point: torch.Tensor
    counts: torch.Tensor
    num_bins: torch.Tensor


def _lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort``: the last key is primary; ties keep input order."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _segment_sum(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sums of consecutive segments of ``values`` (sorted by segment), one
    per entry of ``lengths`` (0 for an empty segment)."""
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=0)


def build_grid_bins(
    points: torch.Tensor, bin_size, valid: Optional[torch.Tensor] = None
) -> GridBins:
    n, d = points.shape
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=points.device)
    # Invalid points share a sentinel cell that sorts last.
    coords = torch.where(valid[:, None], voxel_coords(points, bin_size), _INT32_MAX)
    keys = [coords[:, i] for i in range(d - 1, -1, -1)] + [(~valid).to(torch.int32)]
    order = _lexsort(keys)
    sc = coords[order]
    sv = valid[order]
    first = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=points.device), torch.any(sc[1:] != sc[:-1], dim=1)]
    )
    seg = torch.cumsum(first, dim=0) - 1
    counts = torch.zeros(n, dtype=torch.int32, device=points.device)
    counts.index_add_(0, seg, sv.to(torch.int32))
    inv = torch.empty(n, dtype=torch.int32, device=points.device)
    inv[order] = seg.to(torch.int32)
    return GridBins(
        order=order,
        segment_ids=seg.to(torch.int32),
        bin_of_point=inv,
        counts=counts,
        num_bins=torch.sum(counts > 0),
    )


def _lengths(seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    return torch.bincount(seg.long(), minlength=num_segments)


def segment_mean(
    values_sorted: torch.Tensor,
    seg: torch.Tensor,
    counts: torch.Tensor,
    weights_sorted: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    w = weights_sorted
    v = values_sorted if w is None else values_sorted * w[..., None]
    lengths = _lengths(seg, counts.shape[0])
    s = _segment_sum(v, lengths)
    denom = counts.to(v.dtype) if w is None else _segment_sum(w, lengths)
    return s / torch.clamp(denom, min=1e-30)[..., None]


def grid_downsample(
    cloud: PointCloud,
    bin_size,
    min_points_in_bin: int = 1,
    capacity: Optional[int] = None,
) -> PointCloud:
    """Voxel downsample: per-bin mean of points (and colors), sign-consistent
    mean of normals (each anchored to its bin's first sorted normal). With
    ``capacity`` below the input size the ``capacity`` most occupied bins
    are kept, ties broken by a hash of the bin id (a stable descending sort,
    as ``lax.top_k``)."""
    n = cloud.capacity
    dev = cloud.points.device
    valid = cloud.valid_mask()
    bins = build_grid_bins(cloud.points, bin_size, valid)
    seg, order, counts = bins.segment_ids, bins.order, bins.counts
    sv = valid[order].to(torch.float32)
    lengths = _lengths(seg, n)

    pts = segment_mean(cloud.points[order], seg, counts, sv)

    normals = None
    if cloud.normals is not None:
        ns = cloud.normals[order]
        start = torch.cumsum(lengths, dim=0) - lengths  # first sorted point of each bin
        anchor = ns[start[seg.long()]]
        sign = torch.where(torch.sum(ns * anchor, -1, keepdim=True) < 0, -1.0, 1.0)
        nsum = _segment_sum(ns * sign * sv[:, None], lengths)
        norm = torch.linalg.vector_norm(nsum, dim=-1, keepdim=True)
        normals = nsum / torch.clamp(norm, min=1e-30)

    colors = None
    if cloud.colors is not None:
        colors = segment_mean(cloud.colors[order], seg, counts, sv)

    bin_valid = counts >= min_points_in_bin
    pts = torch.where(bin_valid[:, None], pts, 1e30)
    if capacity is not None and capacity < n:
        ids = torch.arange(n, dtype=torch.int64, device=dev)
        tie = (((ids * 2654435761) & 0xFFFFFFFF) >> 16).to(torch.float32) / 65536.0
        key = torch.where(bin_valid, counts.to(torch.float32) + tie * 0.5, -1.0)
        keep = torch.sort(key, descending=True, stable=True).indices[:capacity]
        pts = pts[keep]
        normals = normals[keep] if normals is not None else None
        colors = colors[keep] if colors is not None else None
        bin_valid = bin_valid[keep]
        pts = torch.where(bin_valid[:, None], pts, 1e30)
    return PointCloud(points=pts, normals=normals, colors=colors, valid=bin_valid)


def grid_bin_ids(
    points: torch.Tensor, bin_size, valid: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Point→bin map and per-bin counts."""
    bins = build_grid_bins(points, bin_size, valid)
    return bins.bin_of_point, bins.counts
