"""Masked fixed-capacity point clouds (port of
``cilantro_tpu/core/containers.py``, the methods that need no kNN and no
file I/O; normals estimation and PLY input/output wait for later slices).

A :class:`PointCloud` holds row-major ``(N, D)`` tensors and a boolean
``valid`` mask: removal clears mask bits, :func:`append` concatenates
capacities and :func:`compact` repacks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from .transforms import Transform, transform_normals, transform_points


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """``points (N, D)``; ``normals (N, D)`` / ``colors (N, 3)`` or None;
    ``valid (N,)`` bool or None (all valid)."""

    points: torch.Tensor
    normals: Optional[torch.Tensor] = None
    colors: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    def has_normals(self) -> bool:
        return self.normals is not None

    def has_colors(self) -> bool:
        return self.colors is not None

    def valid_mask(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.capacity, dtype=torch.bool, device=self.points.device)
        return self.valid

    def num_valid(self) -> torch.Tensor:
        return torch.sum(self.valid_mask())

    def transformed(self, tf: Transform, rigid: bool = True) -> "PointCloud":
        normals = (
            transform_normals(tf, self.normals, rigid=rigid)
            if self.normals is not None
            else None
        )
        return dataclasses.replace(
            self, points=transform_points(tf, self.points), normals=normals
        )

    def select(self, indices: torch.Tensor) -> "PointCloud":
        """Gather a subcloud by index."""
        take = lambda a: None if a is None else a[indices]  # noqa: E731
        return PointCloud(
            points=self.points[indices],
            normals=take(self.normals),
            colors=take(self.colors),
            valid=take(self.valid),
        )

    def remove(self, indices: torch.Tensor) -> "PointCloud":
        """Mask out points by index."""
        valid = self.valid_mask().clone()
        valid[indices] = False
        return dataclasses.replace(self, valid=valid)

    def remove_invalid(self) -> "PointCloud":
        """Mask non-finite points, normals and colors."""
        ok = torch.all(torch.isfinite(self.points), dim=-1)
        if self.normals is not None:
            ok &= torch.all(torch.isfinite(self.normals), dim=-1)
        if self.colors is not None:
            ok &= torch.all(torch.isfinite(self.colors), dim=-1)
        return dataclasses.replace(self, valid=self.valid_mask() & ok)

    def grid_downsampled(self, bin_size: float, min_points_in_bin: int = 1) -> "PointCloud":
        from .grid import grid_downsample

        return grid_downsample(self, bin_size, min_points_in_bin)


def from_numpy(
    points: np.ndarray,
    normals: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    capacity: Optional[int] = None,
    dtype=torch.float32,
    device="cuda",
) -> PointCloud:
    """A cloud on ``device`` from host arrays, optionally padded to
    ``capacity``; padding points sit at 1e30 so that distance-based kernels
    exclude them even before masking."""
    dev = resolve_device(device)
    n, d = points.shape
    cap = capacity if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} is below the {n} points given")

    def pad(a, fill, width):
        out = np.full((cap, width), fill, np.float32)
        out[:n] = a
        return torch.as_tensor(out, dtype=dtype, device=dev)

    return PointCloud(
        points=pad(points, 1e30, d),
        normals=pad(normals, 0.0, d) if normals is not None else None,
        colors=pad(colors, 0.0, colors.shape[1]) if colors is not None else None,
        valid=torch.as_tensor(np.arange(cap) < n, device=dev),
    )


def compact(cloud: PointCloud) -> PointCloud:
    """Drop invalid slots (shapes change; reads the mask back to the host)."""
    idx = torch.nonzero(cloud.valid_mask()).reshape(-1)
    take = lambda a: None if a is None else a[idx]  # noqa: E731
    return PointCloud(
        points=take(cloud.points),
        normals=take(cloud.normals),
        colors=take(cloud.colors),
        valid=torch.ones(idx.shape[0], dtype=torch.bool, device=cloud.points.device),
    )


def append(a: PointCloud, b: PointCloud) -> PointCloud:
    """Concatenate capacities; a side without normals or colors
    contributes zeros."""

    def cat(x, y, width):
        if x is None and y is None:
            return None
        if x is None:
            x = torch.zeros((a.capacity, width), dtype=y.dtype, device=y.device)
        if y is None:
            y = torch.zeros((b.capacity, width), dtype=x.dtype, device=x.device)
        return torch.cat([x, y], dim=0)

    return PointCloud(
        points=torch.cat([a.points, b.points], dim=0),
        normals=cat(a.normals, b.normals, a.dim),
        colors=cat(a.colors, b.colors, 3),
        valid=torch.cat([a.valid_mask(), b.valid_mask()]),
    )
