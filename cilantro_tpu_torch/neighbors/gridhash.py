"""Morton codes and box distances (port of the part of
``cilantro_tpu/neighbors/gridhash.py`` that the nn1 prune plans use).

``radius_search_grid`` waits for the neighbour-engine slice.
"""

from __future__ import annotations

import torch

from ..core.grid import floor_int32


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``x`` so bit i lands at position 3i."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _part1by1(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 16 bits of ``x`` so bit i lands at position 2i."""
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def morton_code(
    points: torch.Tensor, origin: torch.Tensor, cell: torch.Tensor
) -> torch.Tensor:
    """Morton (z-order) int32 code of each point's voxel cell: 3-D 10
    bits/axis, 2-D 16 bits/axis; coordinates beyond the range clamp to the
    boundary cell. ``cell`` is a 0-d float32 tensor, so that the division is
    a true division on every device, as in JAX (a Python float divisor
    becomes a product with its reciprocal on CUDA, and points on cell
    borders would change cell)."""
    d = points.shape[-1]
    ij = floor_int32((points - origin) / cell)
    if d == 3:
        ij = torch.clamp(ij, 0, 1023)
        return (
            _part1by2(ij[..., 0])
            | (_part1by2(ij[..., 1]) << 1)
            | (_part1by2(ij[..., 2]) << 2)
        )
    if d == 2:
        ij = torch.clamp(ij, 0, 65535)
        return _part1by1(ij[..., 0]) | (_part1by1(ij[..., 1]) << 1)
    raise ValueError(f"morton_code supports 2D/3D, got D={d}")


def _aabb_dist2(qmin, qmax, kmin, kmax) -> torch.Tensor:
    """Pairwise squared distance between AABB sets (nq, D) × (nk, D); the
    D squares are summed left to right, so CPU and card agree bit for bit."""
    gap = torch.clamp(
        torch.maximum(
            qmin[:, None, :] - kmax[None, :, :],
            kmin[None, :, :] - qmax[:, None, :],
        ),
        min=0.0,
    )
    sq = gap * gap
    out = sq[..., 0]
    for j in range(1, sq.shape[-1]):
        out = out + sq[..., j]
    return out
