"""Exact nearest neighbours by brute force (port of
``cilantro_tpu/neighbors/bruteforce.py``).

:func:`nn1` and :func:`knn` launch the CUDA kernels for CUDA tensors, L2 and
dim ≤ 6, the counterpart of the JAX package's ``_use_pallas`` dispatch to
its TPU kernels: :func:`.fused_nn.nn1_fused`, and for kNN the Morton-tile
pruned :func:`.fused_knn.knn_pruned` (3-D, Q·M ≥ 2²⁶) or
:func:`.fused_knn.knn_fused`. Otherwise they run :func:`_nn1_tiled` and
:func:`_knn_tiled`, the counterparts of ``_nn1_xla`` and ``_knn_xla``, which
is what JAX runs on the CPU.
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


def _valid_or_all(valid: Optional[torch.Tensor], n: int, device) -> torch.Tensor:
    """``valid``, or an all-true mask of ``n`` rows when it is None."""
    return torch.ones(n, dtype=torch.bool, device=device) if valid is None else valid


def _merge_topk(bd, bi, dist, cols):
    """Merge a ``(R, C)`` block of distances whose columns are key indices
    ``cols`` into the ascending ``(R, k)`` slots ``(bd, bi)``: a stable sort
    of the slots followed by the block, the first k kept, so that equal
    distances keep the slot (earlier key) first, as JAX's ``top_k`` does."""
    k = bd.shape[1]
    cand_d = torch.cat([bd, dist], dim=1)
    cand_i = torch.cat([bi, cols.expand(dist.shape[0], -1)], dim=1)
    sd, order = torch.sort(cand_d, dim=1, stable=True)
    return sd[:, :k], cand_i.gather(1, order[:, :k])


def _knn_tiled(
    queries: torch.Tensor,
    keys: torch.Tensor,
    k: int,
    *,
    query_valid: Optional[torch.Tensor] = None,
    key_valid: Optional[torch.Tensor] = None,
    metric: str = "l2",
    tile_q: int = 1024,
    tile_m: int = 2048,
    exclude_self: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest keys over key tiles with a running top-k merge (port
    of ``_knn_xla``): ``(dist (Q, k), idx (Q, k) int32)``, ascending, squared
    for L2. Slots beyond the valid keys hold ``INVALID_DIST`` and index 0;
    invalid queries get ``INVALID_DIST``. ``exclude_self`` drops key ``i``
    for query ``i``. Each tile is folded in by :func:`_merge_topk`, so equal
    distances keep the smaller key index."""
    qn, d = queries.shape
    mn = keys.shape[0]
    k = min(k, mn)
    dev = queries.device
    kp = _pad_rows(keys.float(), tile_m, 0.0)
    kvp = _pad_rows(_valid_or_all(key_valid, mn, dev), tile_m, False)
    tile_dist = _TILE_DISTS[metric]
    q = queries.float()
    best_d = torch.full((qn, k), INVALID_DIST, dtype=torch.float32, device=dev)
    best_i = torch.zeros((qn, k), dtype=torch.int32, device=dev)
    for q0 in range(0, qn, tile_q):
        qt = q[q0 : q0 + tile_q]
        rows = torch.arange(q0, q0 + qt.shape[0], dtype=torch.int32, device=dev)
        bd, bi = best_d[q0 : q0 + tile_q], best_i[q0 : q0 + tile_q]
        for m0 in range(0, kp.shape[0], tile_m):
            dist = tile_dist(qt, kp[m0 : m0 + tile_m])
            cols = torch.arange(m0, m0 + tile_m, dtype=torch.int32, device=dev)
            dist = torch.where(kvp[None, m0 : m0 + tile_m], dist, INVALID_DIST)
            if exclude_self:
                dist = torch.where(cols[None, :] == rows[:, None], INVALID_DIST, dist)
            bd, bi = _merge_topk(bd, bi, dist, cols)
        best_d[q0 : q0 + tile_q], best_i[q0 : q0 + tile_q] = bd, bi
    if query_valid is not None:
        best_d = torch.where(query_valid[:, None], best_d, INVALID_DIST)
    return best_d, best_i


def knn(
    queries: torch.Tensor,
    keys: torch.Tensor,
    k: int,
    *,
    query_valid: Optional[torch.Tensor] = None,
    key_valid: Optional[torch.Tensor] = None,
    metric: str = "l2",
    tile_q: int = 1024,
    tile_m: int = 2048,
    exclude_self: bool = False,
    allow_pruned: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN: on CUDA tensors (L2, dim ≤ 6) the pruned kernel path for
    3-D problems of Q·M ≥ 2²⁶ (unless ``allow_pruned=False``) and the full
    kernel otherwise; the tiled PyTorch scan elsewhere. The pruned route
    breaks distance ties by the smallest Morton-sorted key position, so
    equidistant neighbours may come back under another index. See
    :func:`_knn_tiled` for the result conventions. ``tile_q`` and ``tile_m``
    are the scan's; the kernels keep their own."""
    if _use_fused(metric, queries):
        from .fused_knn import knn_fused, knn_pruned

        kw = dict(query_valid=query_valid, key_valid=key_valid, exclude_self=exclude_self)
        if allow_pruned and queries.shape[1] == 3 and queries.shape[0] * keys.shape[0] >= (1 << 26):
            return knn_pruned(queries, keys, k, **kw)
        return knn_fused(queries, keys, k, **kw)
    return _knn_tiled(
        queries, keys, k, query_valid=query_valid, key_valid=key_valid, metric=metric,
        tile_q=tile_q, tile_m=tile_m, exclude_self=exclude_self,
    )


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
    kp = _pad_rows(keys.float(), tile_m, 0.0)
    kvp = _pad_rows(_valid_or_all(key_valid, mn, dev), tile_m, False)
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
