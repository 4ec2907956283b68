"""Grid-bucketed radius search, Morton codes and box distances (port of
``cilantro_tpu/neighbors/gridhash.py``).

Both clouds are sorted by the Morton code of their ``radius``-sized voxel
and cut into tiles with exact boxes; each query tile keeps its nearest
``max_key_tiles`` key tiles within the radius, and one dense distance block
per query tile gives the ``max_results`` closest keys. A per-query
``overflowed`` flag says where a fixed capacity truncated the true result
set. There is no kernel here: it is plain tensor code in the JAX package
too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.grid import floor_int32
from .bruteforce import INVALID_DIST, _pad_rows, _valid_or_all

_GROUP_PAIRS = 1 << 26  # (query, candidate) pairs per block of query tiles


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


def _sort_tiles(points, valid, origin, cell, tile):
    """Morton-sort a masked cloud (a stable sort, invalid points last) and
    cut it into ``tile``-row blocks: ``(perm, blocks (nt, T, D), orig_idx
    (nt, T), valid (nt, T), aabb_min (nt, D), aabb_max (nt, D))``; invalid
    points take no part in the boxes."""
    d = points.shape[1]
    code = torch.where(valid, morton_code(points, origin, cell), 0x7FFFFFFF)
    perm = torch.argsort(code, stable=True).to(torch.int32)
    pts_p = _pad_rows(points[perm.long()], tile, 0.0)
    val_p = _pad_rows(valid[perm.long()], tile, False)
    idx_p = _pad_rows(perm, tile, 0)
    nt = pts_p.shape[0] // tile
    blocks = pts_p.reshape(nt, tile, d)
    vblocks = val_p.reshape(nt, tile)
    big = 3e38
    aabb_min = torch.where(vblocks[..., None], blocks, big).amin(dim=1)
    aabb_max = torch.where(vblocks[..., None], blocks, -big).amax(dim=1)
    return perm, blocks, idx_p.reshape(nt, tile), vblocks, aabb_min, aabb_max


def radius_search_grid(
    queries: torch.Tensor,
    keys: torch.Tensor,
    radius: float,
    max_results: int,
    *,
    query_valid: Optional[torch.Tensor] = None,
    key_valid: Optional[torch.Tensor] = None,
    tile: int = 256,
    max_key_tiles: int = 32,
    exclude_self: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Radius-bounded NN, the closest ``max_results`` kept, squared L2
    ascending: ``(dist (Q, R), idx (Q, R), overflowed (Q,))`` with ``R =
    min(max_results, M)``. ``overflowed[i]`` is set when more than
    ``max_results`` keys lay within the radius or query i's tile met more
    than ``max_key_tiles`` key tiles within it (candidates unseen); without
    it the result is exact. Ties keep the earlier candidate (a stable sort,
    as JAX's ``top_k``)."""
    qn, d = queries.shape
    mn = keys.shape[0]
    dev = queries.device
    qv = _valid_or_all(query_valid, qn, dev)
    kv = _valid_or_all(key_valid, mn, dev)
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=dev)
    cell = torch.tensor(radius, dtype=torch.float32, device=dev)
    big = 3e38
    origin = torch.minimum(
        torch.where(qv[:, None], queries, big).amin(dim=0),
        torch.where(kv[:, None], keys, big).amin(dim=0),
    )
    qperm, qblocks, _, _, qmin, qmax = _sort_tiles(queries, qv, origin, cell, tile)
    _, kblocks, kib, kvb, kmin, kmax = _sort_tiles(keys, kv, origin, cell, tile)
    n_qt, n_kt = qblocks.shape[0], kblocks.shape[0]
    n_sel = min(max_key_tiles, n_kt)

    # Tile-pair pruning on exact boxes: each query tile's nearest key tiles.
    tdist = _aabb_dist2(qmin, qmax, kmin, kmax)
    tdist = torch.where(kvb.any(dim=1)[None, :], tdist, big)
    tile_overflow = (tdist <= r2).sum(dim=1) > n_sel
    sel_d, sel = torch.sort(tdist, dim=1, stable=True)
    sel_d, sel = sel_d[:, :n_sel], sel[:, :n_sel]
    sel_ok = sel_d <= r2
    cap = min(max_results, mn)
    qidx = _pad_rows(qperm, tile, 0).reshape(n_qt, tile)

    dist_s = torch.empty((n_qt, tile, cap), dtype=torch.float32, device=dev)
    idx_s = torch.empty((n_qt, tile, cap), dtype=torch.int32, device=dev)
    n_in_s = torch.empty((n_qt, tile), dtype=torch.int64, device=dev)
    group = max(1, _GROUP_PAIRS // (tile * n_sel * tile))
    for g0 in range(0, n_qt, group):
        g = slice(g0, g0 + group)
        ks = sel[g]
        cand = kblocks[ks].reshape(ks.shape[0], n_sel * tile, d)
        cand_idx = kib[ks].reshape(ks.shape[0], n_sel * tile)
        cand_ok = (kvb[ks] & sel_ok[g][..., None]).reshape(ks.shape[0], n_sel * tile)
        q = qblocks[g]
        qq = torch.sum(q * q, dim=-1, keepdim=True)
        cc = torch.sum(cand * cand, dim=-1)[:, None, :]
        dist = torch.clamp(qq + cc - 2.0 * (q @ cand.transpose(1, 2)), min=0.0)
        ok = cand_ok[:, None, :] & (dist <= r2)
        if exclude_self:
            ok &= cand_idx[:, None, :] != qidx[g][..., None]
        dist = torch.where(ok, dist, INVALID_DIST)
        n_in_s[g] = ok.sum(dim=-1)
        sd, pos = torch.sort(dist, dim=-1, stable=True)
        dist_s[g] = sd[..., :cap]
        idx_s[g] = cand_idx[:, None, :].expand_as(pos).gather(-1, pos[..., :cap])
    dist_s = dist_s.reshape(-1, cap)[:qn]
    idx_s = idx_s.reshape(-1, cap)[:qn]
    over_s = tile_overflow.repeat_interleave(tile)[:qn] | (n_in_s.reshape(-1)[:qn] > cap)

    from .fused_nn import _inverse_perm  # fused_nn imports this module

    inv = _inverse_perm(qperm).long()
    dist = torch.where(qv[:, None], dist_s[inv], INVALID_DIST)
    return dist, idx_s[inv], over_s[inv] & qv
