"""Exact single nearest neighbour (port of the nn1 half of
``cilantro_tpu/neighbors/bruteforce.py``).

:func:`nn1` launches the fused CUDA kernel (:func:`.fused_nn.nn1_fused`) for
CUDA tensors, L2 and dim ≤ 6, the counterpart of the JAX package's
``_use_pallas`` dispatch to its TPU kernel. Otherwise it runs
:func:`_nn1_tiled`, the counterpart of ``_nn1_xla``, which is what JAX runs
on the CPU. ``knn`` waits for the neighbour-engine slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

# Distance of a masked or missing result; callers test ``dist < INVALID_DIST``.
INVALID_DIST = 3.0e38


def _pad_rows(a: torch.Tensor, multiple: int, fill) -> torch.Tensor:
    pad = (-a.shape[0]) % multiple
    if pad == 0:
        return a
    tail = torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=a.device)
    return torch.cat([a, tail])


def _tile_dist2_l2(q: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances ``(TQ, TM)`` from one full-float32 product."""
    qq = torch.sum(q * q, dim=-1, keepdim=True)
    mm = torch.sum(m * m, dim=-1)[None, :]
    cross = q @ m.T
    return torch.clamp(qq + mm - 2.0 * cross, min=0.0)


def _tile_dist_l1(q: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(q[:, None, :] - m[None, :, :]), dim=-1)


def _tile_dist_so2(q: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Squared angular distance between (N, 1) angles, wrapped to (−π, π]."""
    diff = q[:, None, 0] - m[None, :, 0]
    wrapped = torch.remainder(diff + math.pi, 2.0 * math.pi) - math.pi
    return wrapped * wrapped


def _tile_dist_so3(q: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``1 − (q·q')²`` between (N, 4) unit quaternions."""
    dots = q @ m.T
    return torch.clamp(1.0 - dots * dots, min=0.0)


_TILE_DISTS = {
    "l2": _tile_dist2_l2,
    "l1": _tile_dist_l1,
    "so2": _tile_dist_so2,
    "so3": _tile_dist_so3,
}


def _use_fused(metric: str, queries: torch.Tensor) -> bool:
    """The fused kernel takes L2 in ≤ 6 dims (the augmented layout holds
    D+2 ≤ 8 columns), on CUDA tensors."""
    return metric == "l2" and queries.shape[1] <= 6 and queries.device.type == "cuda"


def _nn1_tiled(
    queries: torch.Tensor,
    keys: torch.Tensor,
    *,
    query_valid: Optional[torch.Tensor] = None,
    key_valid: Optional[torch.Tensor] = None,
    metric: str = "l2",
    tile_m: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single nearest neighbour over key tiles with an elementwise running
    min (port of ``_nn1_xla``): ``(dist (Q,), idx (Q,) int32)``, squared
    for L2, ``INVALID_DIST`` where no valid key or the query is invalid."""
    qn, d = queries.shape
    mn = keys.shape[0]
    dev = queries.device
    kv = torch.ones(mn, dtype=torch.bool, device=dev) if key_valid is None else key_valid
    kp = _pad_rows(keys.float(), tile_m, 0.0)
    kvp = _pad_rows(kv, tile_m, False)
    tile_dist = _TILE_DISTS[metric]
    q = queries.float()
    best_d = torch.full((qn,), INVALID_DIST, dtype=torch.float32, device=dev)
    best_i = torch.zeros(qn, dtype=torch.int32, device=dev)
    for m0 in range(0, kp.shape[0], tile_m):
        dist = tile_dist(q, kp[m0 : m0 + tile_m])
        dist = torch.where(kvp[None, m0 : m0 + tile_m], dist, INVALID_DIST)
        tile_best, tile_arg = torch.min(dist, dim=1)
        better = tile_best < best_d
        best_d = torch.where(better, tile_best, best_d)
        best_i = torch.where(better, (tile_arg + m0).to(torch.int32), best_i)
    if query_valid is not None:
        best_d = torch.where(query_valid, best_d, INVALID_DIST)
    return best_d, best_i


def nn1(
    queries: torch.Tensor,
    keys: torch.Tensor,
    *,
    query_valid: Optional[torch.Tensor] = None,
    key_valid: Optional[torch.Tensor] = None,
    metric: str = "l2",
    tile_m: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact single NN: the fused CUDA kernel for CUDA tensors (L2, dim ≤
    6), the tiled PyTorch scan otherwise."""
    if _use_fused(metric, queries):
        from .fused_nn import nn1_fused

        return nn1_fused(queries, keys, query_valid=query_valid, key_valid=key_valid)
    return _nn1_tiled(
        queries, keys, query_valid=query_valid, key_valid=key_valid,
        metric=metric, tile_m=tile_m,
    )
