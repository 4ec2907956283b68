"""Exact k nearest neighbours over augmented coordinates, with Morton-tile
pruning (port of the kNN and radius half of
``cilantro_tpu/neighbors/pallas_nn.py``; the augmentation, sorts, tile boxes
and pair lists come from :mod:`.fused_nn`).

Squared distances are the 8-term dot products of augmented rows that
:mod:`.fused_nn` describes. Two CUDA C++ kernels (``csrc/knn_kernels.cu``,
built for ``sm_90a`` at first CUDA use) carry the search, each with a plain
PyTorch version beside it; a wrapper runs the plain version only when its
tensors lie on the CPU, and for CUDA tensors launches the kernel or raises.
Every launch adds one to ``native.launch_counts[<name>]``.

- :func:`knn_full_rows` ("knn_full") replaces ``_knn_kernel`` /
  ``_knn_pallas_full`` (``pallas_nn.py:701,854``): every query against
  every key.
- :func:`knn_compact_rows` ("knn_compact") replaces ``_knn_kernel_compact``
  / ``_knn_pallas_compact`` (``pallas_nn.py:726,763``): the (query tile,
  key chunk) pairs of a compacted list.

Contract of both, per query row: the k smallest ``(Σ_j q̂[j]·k̂[m, j], m)``
pairs over the visited keys ``m`` in lexicographic order, ascending, the sum
taken left to right in float32 (no FMA, no TF32), starting from
``(INVALID_DIST, 0)`` in every slot. A key enters only if its sum is
strictly below the current k-th (so a NaN sum, and a masked key's 3e38,
never enter); with ``exclude_diag`` the key whose position equals the
query's row is skipped. Kernel and plain version agree bit for bit. The TPU
kernels keep the same order and tie rule (``_fold_block_topk`` extracts a
chunk's first minimum and inserts it after every slot ``<=`` it); their MXU
product sums in another order, so distances agree with JAX to float32
rounding and near-tied neighbours may swap.

What bounds the kernels: arithmetic, as for the nn1 kernels (10 float32
operations per visited pair of 3-D points at 67 TFLOP/s on an H100 SXM),
with the top-k merges on top for the keys that enter. Every comparison in
the kernels is between ``(sum, position)`` pairs, so the result does not
depend on the order of the keys or on how their range is split: the full
kernel has two designs, a thread per query and a warp per query, and
:func:`_full_plan` picks one and its key splits from the shapes; the
compact kernel takes work items balanced over the pair list
(:func:`_compact_items`) and visits chunks nearest first; both merge
partial lists in the same launch. See the source for the designs.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from .bruteforce import INVALID_DIST, _merge_topk, _valid_or_all
from .fused_nn import (
    _PLAIN_BLOCK,
    _aug_dist,
    _augment,
    _augment_keys,
    _augment_queries,
    _check_cuda,
    _check_rows,
    _inverse_perm,
    _live_pairs,
    _morton_sort,
    _pair_list,
    _sq_norm,
    _tile_aabbs,
    _unpermute_key_indices,
)
from .gridhash import _aabb_dist2

_BIG = 3e38


# ---------------------------------------------------------------------------
# Plain versions: the kernels' arithmetic as PyTorch ops.
# ---------------------------------------------------------------------------


def _init_slots(rows: int, k: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.full((rows, k), INVALID_DIST, dtype=torch.float32, device=device),
        torch.zeros((rows, k), dtype=torch.int32, device=device),
    )


def _fold_k(bd, bi, dist, col0, rows=None):
    """Fold a ``(R, C)`` block of sums whose columns are key positions
    ``col0 + c`` (all above those already in ``(bd, bi)``) into the
    ascending ``(R, k)`` slots: the k lexicographically smallest ``(sum,
    position)`` pairs. A sum not below ``INVALID_DIST`` (NaN included) and,
    where ``rows`` (the global query rows) is given, the diagonal never
    enter; :func:`.bruteforce._merge_topk` keeps earlier positions first
    among equal sums."""
    cols = col0 + torch.arange(dist.shape[1], dtype=torch.int32, device=dist.device)
    out = ~(dist < INVALID_DIST)
    if rows is not None:
        out |= cols[None, :] == rows[:, None]
    # The k slots sort before every excluded (inf) candidate.
    return _merge_topk(bd, bi, torch.where(out, float("inf"), dist), cols)


def knn_full_rows_plain(qp: torch.Tensor, kp: torch.Tensor, k: int, exclude_diag: bool = False):
    """Plain version of :func:`knn_full_rows`."""
    bd, bi = _init_slots(qp.shape[0], k, qp.device)
    step_q = max(1, min(qp.shape[0], _PLAIN_BLOCK // max(kp.shape[0], 1)))
    step_m = max(1, min(kp.shape[0], _PLAIN_BLOCK // step_q))
    for q0 in range(0, qp.shape[0], step_q):
        q = qp[q0 : q0 + step_q]
        rows = None
        if exclude_diag:
            rows = torch.arange(q0, q0 + q.shape[0], dtype=torch.int32, device=qp.device)
        d, i = bd[q0 : q0 + step_q], bi[q0 : q0 + step_q]
        for m0 in range(0, kp.shape[0], step_m):
            d, i = _fold_k(d, i, _aug_dist(q, kp[m0 : m0 + step_m]), m0, rows)
        bd[q0 : q0 + step_q], bi[q0 : q0 + step_q] = d, i
    return bd, bi


def knn_compact_rows_plain(qp, kp, qt, kt, flags, k, tile_q, tile_m, exclude_diag=False):
    """Plain version of :func:`knn_compact_rows`: key chunks in ascending
    order, each folded into the query tiles whose live list entries name
    it, so only the surviving pairs are computed."""
    n_qt, n_mt = qp.shape[0] // tile_q, kp.shape[0] // tile_m
    live = (flags & 2) != 0
    mask = np.zeros((n_qt, n_mt), bool)
    mask[qt[live].cpu().numpy(), kt[live].cpu().numpy()] = True
    bd, bi = _init_slots(qp.shape[0], k, qp.device)
    group = max(1, _PLAIN_BLOCK // (tile_q * tile_m))
    offs = torch.arange(tile_q, device=qp.device)
    for c in range(n_mt):
        tiles = np.flatnonzero(mask[:, c])
        keys = kp[c * tile_m : (c + 1) * tile_m]
        for g0 in range(0, len(tiles), group):
            sel = torch.as_tensor(tiles[g0 : g0 + group], device=qp.device)
            rows = (sel[:, None] * tile_q + offs).reshape(-1)
            bd[rows], bi[rows] = _fold_k(
                bd[rows], bi[rows], _aug_dist(qp[rows], keys), c * tile_m,
                rows.to(torch.int32) if exclude_diag else None,
            )
    return bd, bi


# ---------------------------------------------------------------------------
# The two kernel wrappers.
# ---------------------------------------------------------------------------


def _check_k(name, qp, k) -> None:
    if k < 1:
        raise ValueError(f"{name}: k={k} must be at least 1")
    if qp.shape[0] * k >= 2**31:
        raise ValueError(f"{name}: {qp.shape[0]} rows x k={k} reach 2^31 slots")


# The kernels' shapes, as csrc/knn_kernels.cu names them. A thread a query:
# queries a block (kFullQueries; the compact kernel's kMaxQueries), keys
# staged at a time (kStage), distances in flight a thread (kChains) and
# candidate queue slots a query (kQueue). The wrappers pick the rest and
# pass it to the launch: a key split of at least 512 keys and 16·k while the
# grid is short of _BLOCKS_PER_SM blocks an SM, the compact block (256
# queries, 128 when tile_q is an odd multiple of 128), parts of at most
# _PART_KEYS keys, and the slot template (:func:`_slot_bucket`).
_FULL_BLOCK = 128
_COMPACT_BLOCK = 256
_STAGE = 512
_CHAINS = 4
_QUEUE = 16
_BLOCKS_PER_SM = 4
_PART_KEYS = 16384
_REG_BUCKETS = (1, 4, 8, 12, 16, 24, 32)
# A warp a query: keys staged at a time (kWarpStage), keys a lane takes a
# step (kWarpKeys) and the largest k its register lists hold; the wrapper
# picks the warps (queries) a block, _WARPS_LONG where a walk crosses at
# least _WARP_LONG_KEYS keys (a stage is then shared by more queries) and
# _WARPS below (more, smaller blocks for small grids), and key splits of at
# least a stage and 16·k while the grid is short of _WARP_BLOCKS_PER_SM
# blocks an SM.
_WARP_STAGE = 1024
_WARP_KEYS = 1
_WARP_MAX_K = 1024
_WARPS = 4
_WARPS_LONG = 8
_WARP_LONG_KEYS = 2 * _WARP_STAGE
_WARP_BLOCKS_PER_SM = 2
# The route: the thread design takes k <= 32 where its grid, key splits
# included, holds at least this many blocks an SM (set by the A/B of the two
# on the card: chip_smoke.py phase 40, tools/knn_full_ab.py; PERF.md §6).
_THREAD_BLOCKS_PER_SM = 1


def _slot_bucket(k: int) -> int:
    """The kernels' slot template for ``k``: ``K > 0`` keeps the k slots in
    K registers; ``-W`` (k > 32) keeps a list row in device memory, merged
    over windows of 32·W pairs."""
    for bucket in _REG_BUCKETS:
        if k <= bucket:
            return bucket
    return -2 if k <= 64 else -3 if k <= 96 else -4 if k <= 128 else -8


def _compact_rows(tile_q: int) -> int:
    """Queries a block of the compact kernel."""
    return _COMPACT_BLOCK if tile_q % _COMPACT_BLOCK == 0 else _FULL_BLOCK


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _key_splits(n_keys: int, query_blocks: int, stage: int, least: int, blocks: int) -> Tuple[int, int]:
    """``(splits, keys per split)``: enough key splits that ``query_blocks``
    × splits reaches ``blocks``, each split a whole number of ``stage``-key
    stages and at least ``least`` keys long."""
    least = stage * max(1, _ceil_div(least, stage))
    wanted = _ceil_div(blocks, max(query_blocks, 1))
    splits = max(1, min(wanted, n_keys // least))
    length = stage * _ceil_div(_ceil_div(n_keys, splits), stage)
    return max(1, _ceil_div(n_keys, length)), length


def _full_splits(n_queries: int, n_keys: int, k: int, sms: int) -> Tuple[int, int]:
    """``(splits, keys per split)`` of the thread design: enough key splits
    that the grid holds about ``_BLOCKS_PER_SM`` blocks per SM, each split a
    whole number of stages and long enough (512 keys and 16·k) that its
    partial list costs less than its keys."""
    return _key_splits(n_keys, _ceil_div(n_queries, _FULL_BLOCK), _STAGE, 16 * k, _BLOCKS_PER_SM * sms)


def _full_plan(n_queries: int, n_keys: int, k: int, sms: int, design: Optional[str] = None) -> dict:
    """The full kernel's design and grid at these shapes, a function of
    ``(n_queries, n_keys, k, sms)`` alone: ``{"design": "thread" | "warp",
    "queries_per_block", "splits", "keys_per_split", "blocks"}``.

    The route: a thread a query (the earlier design, slots in registers) for
    k ≤ 32 while its grid, key splits included (:func:`_full_splits`),
    holds at least ``_THREAD_BLOCKS_PER_SM`` blocks an SM, and past k =
    ``_WARP_MAX_K`` (list rows in device memory); a warp a query otherwise,
    ``_WARPS_LONG`` warps a block from ``_WARP_LONG_KEYS`` keys on
    (``_WARPS`` below), with key splits toward ``_WARP_BLOCKS_PER_SM``
    blocks an SM. So small clouds and every 32 < k ≤ 1,024 take the warp
    design. ``design`` forces one, for the A/B of the two on the card
    (``chip_smoke.py`` phase 40); no entry point passes it."""
    t_splits, t_len = _full_splits(n_queries, n_keys, k, sms)
    t_blocks = _ceil_div(n_queries, _FULL_BLOCK) * t_splits
    if design is None:
        fills = k <= 32 and t_blocks >= _THREAD_BLOCKS_PER_SM * sms
        design = "thread" if fills or k > _WARP_MAX_K else "warp"
    if design == "thread":
        return dict(design="thread", queries_per_block=_FULL_BLOCK, splits=t_splits, keys_per_split=t_len,
                    blocks=t_blocks)
    if design != "warp" or k > _WARP_MAX_K:
        raise ValueError(f"knn_full: no design {design!r} for k={k}")
    warps = _WARPS_LONG if n_keys >= _WARP_LONG_KEYS else _WARPS
    query_blocks = _ceil_div(n_queries, warps)
    splits, length = _key_splits(n_keys, query_blocks, _WARP_STAGE, 16 * k, _WARP_BLOCKS_PER_SM * sms)
    return dict(design="warp", queries_per_block=warps, splits=splits, keys_per_split=length,
                blocks=query_blocks * splits)


def _warp_lists(k: int) -> Tuple[int, int]:
    """The warp design's list slots (the least 32·2^i ≥ k) and queue pairs
    a lane (slots / 32 clamped to 4..8)."""
    slots = 32
    while slots < k:
        slots *= 2
    return slots, min(max(slots // 32, 4), 8)


def kernel_design(
    name: str, n_queries: int, n_keys: int, k: int, tile_q: int = 0, tile_m: int = 0, sms: int = 132
) -> dict:
    """The kernels' launch parameters at these shapes, from the values the
    wrappers compute (for reports)."""
    if name == "knn_full":
        plan = _full_plan(n_queries, n_keys, k, sms)
        if plan["design"] == "warp":
            slots, queue = _warp_lists(k)
            return dict(plan, queries_per_warp=1, slots=f"registers, {slots} a warp ({slots // 32} a lane)",
                        queue_pairs_per_lane=queue, keys_per_lane_step=_WARP_KEYS, stage_keys=_WARP_STAGE)
    bucket = _slot_bucket(k)
    design = {
        "slots": f"registers, bucket K={bucket}" if bucket > 0
        else f"device memory rows, merge windows of {-32 * bucket} pairs",
        "queries_per_thread": 1, "distances_in_flight": _CHAINS, "queue_slots": _QUEUE,
    }
    if name == "knn_full":
        return dict(design, **plan)
    return dict(design, queries_per_block=_compact_rows(tile_q),
                chunks_per_part=max(1, _PART_KEYS // max(tile_m, 1)),
                order="work items by live chunks, most first; chunks nearest first")


def _outputs(qp, k):
    return (
        torch.empty((qp.shape[0], k), dtype=torch.float32, device=qp.device),
        torch.empty((qp.shape[0], k), dtype=torch.int32, device=qp.device),
    )


def knn_full_rows(
    qp: torch.Tensor, kp: torch.Tensor, *, k: int, exclude_diag: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest keys of every augmented query row over all key rows:
    ``(dist (Qp, k) f32, idx (Qp, k) i32)``, raw (not clamped or gated).
    Any number of rows on either side; the design and grid are
    :func:`_full_plan`'s."""
    name = "knn_full"
    _check_rows(name, qp, kp, 1, 1)
    _check_k(name, qp, k)
    if native.on_cpu(name, qp, kp):
        return knn_full_rows_plain(qp, kp, k, exclude_diag)
    if qp.shape[0] == 0 or kp.shape[0] == 0:
        raise ValueError(f"{name}: {qp.shape[0]} query rows and {kp.shape[0]} key rows, wants at least 1")
    # Any number of query rows: a block of either design is one tile.
    _check_cuda(name, _FULL_BLOCK, ("qp", qp), ("kp", kp))
    plan = _full_plan(qp.shape[0], kp.shape[0], k, _sm_count(qp.device))
    return _full_launch(qp, kp, k, exclude_diag, plan)


def _full_launch(qp, kp, k: int, exclude_diag: bool, plan: dict):
    """The full kernel's launch in ``plan``'s design and grid (outputs and
    scratch allocated here): the thread design writes whole blocks of 128
    rows, so its outputs are views of the first ``Qp`` rows."""
    n, splits, length = qp.shape[0], plan["splits"], plan["keys_per_split"]
    rows = n if plan["design"] == "warp" else _ceil_div(n, _FULL_BLOCK) * _FULL_BLOCK
    if rows * k >= 2**31:
        raise ValueError(f"knn_full: {rows} rows x k={k} reach 2^31 slots")
    dist = torch.empty((rows, k), dtype=torch.float32, device=qp.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=qp.device)
    # Partial lists of the key splits and one ticket per query block.
    part = (splits if splits > 1 else 0, rows, k)
    part_d = torch.empty(part, dtype=torch.float32, device=qp.device)
    part_i = torch.empty(part, dtype=torch.int32, device=qp.device)
    tickets = torch.zeros(_ceil_div(n, plan["queries_per_block"]), dtype=torch.int32, device=qp.device)
    if plan["design"] == "warp":
        native.launch(
            "knn_full_warp_launch", qp.data_ptr(), kp.data_ptr(), n, kp.shape[0], k, int(exclude_diag),
            plan["queries_per_block"], splits,
            length, part_d.data_ptr(), part_i.data_ptr(), tickets.data_ptr(), dist.data_ptr(), idx.data_ptr(),
        )
    else:
        native.launch(
            "knn_full_launch", qp.data_ptr(), kp.data_ptr(), n, kp.shape[0], k, _slot_bucket(k),
            int(exclude_diag), splits, length, part_d.data_ptr(), part_i.data_ptr(), tickets.data_ptr(),
            dist.data_ptr(), idx.data_ptr(),
        )
    return dist[:n], idx[:n]


def knn_compact_rows(
    qp: torch.Tensor,
    kp: torch.Tensor,
    qt: torch.Tensor,
    kt: torch.Tensor,
    flags: torch.Tensor,
    *,
    k: int,
    tile_q: int,
    tile_m: int,
    exclude_diag: bool = False,
    max_live: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn_full_rows` over a compacted pair list: entry s names query
    tile ``qt[s]`` and key chunk ``kt[s]``, and counts if ``flags[s] & 2``;
    a query tile that no live entry names keeps ``(INVALID_DIST, 0)``.
    ``max_live``: at most this many entries are live (``_knn_compact``
    passes the count it has read back; default the list's length). It sizes
    the kernel's grid and scratch, so that the wrapper reads nothing back."""
    name = "knn_compact"
    _check_rows(name, qp, kp, tile_q, tile_m)
    budget = qt.shape[0]
    for what, t in (("qt", qt), ("kt", kt), ("flags", flags)):
        native.check(name, t, what, (torch.int32,), (budget,))
    _check_k(name, qp, k)
    if native.on_cpu(name, qp, kp, qt, kt, flags):
        return knn_compact_rows_plain(qp, kp, qt, kt, flags, k, tile_q, tile_m, exclude_diag)
    _check_cuda(
        name, tile_q, ("qp", qp), ("kp", kp), ("qt", qt), ("kt", kt), ("flags", flags)
    )
    live = budget if max_live is None else min(max_live, budget)
    work = _compact_items(qt, kt, flags, qp.shape[0] // tile_q, tile_q, tile_m, live)
    return _compact_launch(qp, kp, work, k=k, tile_q=tile_q, tile_m=tile_m, exclude_diag=exclude_diag)


def _compact_launch(qp, kp, work, *, k: int, tile_q: int, tile_m: int, exclude_diag: bool):
    """The compact kernel's launch on the work that :func:`_compact_items`
    built (its outputs and scratch allocated here)."""
    kt_live, starts, items, rows, split_items = work
    dist, idx = _outputs(qp, k)
    part = (split_items * rows, k)
    part_d = torch.empty(part, dtype=torch.float32, device=qp.device)
    part_i = torch.empty(part, dtype=torch.int32, device=qp.device)
    tickets = torch.zeros(qp.shape[0] // rows, dtype=torch.int32, device=qp.device)
    native.launch(
        "knn_compact_launch", qp.data_ptr(), kp.data_ptr(), kt_live.data_ptr(), starts.data_ptr(),
        items.data_ptr(), items.shape[0], rows, qp.shape[0], kp.shape[0], tile_q, tile_m, k,
        _slot_bucket(k), int(exclude_diag), part_d.data_ptr(), part_i.data_ptr(),
        tickets.data_ptr(), dist.data_ptr(), idx.data_ptr(),
    )
    return dist, idx


def _compact_items(qt, kt, flags, n_qt: int, tile_q: int, tile_m: int, max_live: int):
    """The compact kernel's work, built on the device with no read-back:
    ``(kt_live, starts, items, rows, split_items)``. The list's live chunks
    sorted by query tile (the dead entries after them) and, for query tile
    t, its run ``kt_live[starts[t]:starts[t + 1]]``. One work item per block
    of ``rows`` queries and part of at most ``_PART_KEYS`` keys of its
    tile's run, ``(tile, block of the tile, part, parts)``, the tiles with
    the longest runs first, so that no long run starts last and the split
    items (parts > 1), which alone need partial lists, come first. With at
    most ``max_live`` live entries there are at most ``len(items)`` items,
    the spare ones ``tile = -1``, and at most ``split_items`` split ones."""
    dev = qt.device
    rows = _compact_rows(tile_q)
    per_tile = tile_q // rows
    per_part = max(1, _PART_KEYS // tile_m)
    tile_of = torch.where((flags & 2) != 0, qt, n_qt)
    tile_of, by_tile = torch.sort(tile_of, stable=True)
    kt_live = kt[by_tile].contiguous()
    tiles = torch.arange(n_qt + 1, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(tile_of, tiles).to(torch.int32)
    runs = starts[1:] - starts[:-1]
    parts = torch.clamp((runs + per_part - 1) // per_part, min=1)
    order = torch.argsort(runs, descending=True, stable=True).to(torch.int32)
    block_tile = order[:, None].expand(n_qt, per_tile).reshape(-1)
    block_sub = torch.arange(per_tile, dtype=torch.int32, device=dev).repeat(n_qt)
    block_parts = parts[block_tile.long()]
    end = torch.cumsum(block_parts, 0)
    # A tile takes max(1, ceil(run / per_part)) ≤ 1 + run / per_part parts;
    # a split tile's run exceeds per_part, so its parts are ≤ 2·run /
    # (per_part + 1).
    n_items = per_tile * (n_qt + -(-max_live // per_part))
    split_items = min(n_items, per_tile * (2 * max_live // (per_part + 1)))
    item = torch.arange(n_items, device=dev)
    block = torch.searchsorted(end, item, right=True)
    spare = block >= n_qt * per_tile
    block = torch.clamp(block, max=n_qt * per_tile - 1)
    part = item - (end[block] - block_parts[block])
    items = torch.stack(
        [torch.where(spare, -1, block_tile[block]), block_sub[block], part, block_parts[block]], 1
    ).to(torch.int32).contiguous()
    return kt_live, starts, items, rows, split_items


# ---------------------------------------------------------------------------
# The JAX package's wrappers around its kernels.
# ---------------------------------------------------------------------------


def _knn_compact(
    qp, kp, tile_mask, *, k: int, budget: int, tile_q: int, tile_m: int,
    exclude_diag: bool = False, ids: Optional[torch.Tensor] = None,
):
    """Port of ``_knn_pallas_compact``: ``(dist (Qp, k), idx (Qp, k))``
    through the compact kernel when at most ``budget`` tile pairs survive,
    else through the full kernel (the JAX ``lax.cond`` becomes a host
    branch on the survivor count). ``ids``: the mask's live pairs
    (``fused_nn._live_pairs``) when the caller has read them back already;
    otherwise this reads them (one sync)."""
    if ids is None:
        ids = _live_pairs(tile_mask)
    if ids.shape[0] > budget:
        return knn_full_rows(qp, kp, k=k, exclude_diag=exclude_diag)
    lst = _pair_list(ids, tile_mask.shape[1], budget)
    return knn_compact_rows(
        qp, kp, *lst, k=k, tile_q=tile_q, tile_m=tile_m, exclude_diag=exclude_diag,
        max_live=ids.shape[0],
    )


def _drop_self_slot(dist, idx, keep_k: int):
    """Self-exclusion postlude of the radius search: from ``keep_k + 1``
    ascending slots drop each query's first real self hit (or the last,
    overflow-probe slot when there is none) and keep ``keep_k``. Returns
    ``(dist, idx, any_self, last_slot_hit)``; the flags feed the exact
    overflow flag."""
    rows = torch.arange(dist.shape[0], dtype=idx.dtype, device=idx.device)
    hit = dist < INVALID_DIST * 0.5
    is_self = (idx == rows[:, None]) & hit
    any_self = is_self.any(dim=1)
    first_self = torch.argmax(is_self.to(torch.int32), dim=1)
    drop = torch.where(any_self, first_self, keep_k)
    # Output j reads slot j before the dropped one and slot j + 1 after it.
    pos = torch.arange(keep_k, device=dist.device)[None, :]
    sel = pos + (pos >= drop[:, None]).to(pos.dtype)
    return dist.gather(1, sel), idx.gather(1, sel), any_self, hit[:, keep_k]


def _pad_slots(dist, idx, k: int):
    """Pad ``(Q, k_eff)`` results to ``k`` columns of ``(INVALID_DIST, 0)``."""
    extra = k - dist.shape[1]
    if extra <= 0:
        return dist, idx
    d_pad, i_pad = _init_slots(dist.shape[0], extra, dist.device)
    return torch.cat([dist, d_pad], dim=1), torch.cat([idx, i_pad], dim=1)


def knn_fused(
    queries: torch.Tensor,
    keys: torch.Tensor,
    k: int,
    *,
    query_valid: Optional[torch.Tensor] = None,
    key_valid: Optional[torch.Tensor] = None,
    tile_q: int = 512,
    tile_m: int = 2048,
    exclude_self: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN through the full kernel (port of ``knn_pallas``):
    ``(dist² (Q, k), idx (Q, k) int32)``, ascending. ``exclude_self`` drops
    the diagonal (queries and keys positionally one cloud). The tiles only
    pad the operands, as JAX's do; the kernel sees the real rows alone
    (padding keys never enter, padding queries are dropped)."""
    qn, mn = queries.shape[0], keys.shape[0]
    k_eff = min(k, mn)
    qp, kp = _augment(queries, keys, key_valid, tile_q, tile_m)
    dist, idx = knn_full_rows(qp[:qn], kp[:mn], k=k_eff, exclude_diag=exclude_self)
    dist = torch.clamp(dist, min=0.0)
    dist = torch.where(dist >= INVALID_DIST * 0.5, INVALID_DIST, dist)
    if query_valid is not None:
        dist = torch.where(query_valid[:, None], dist, INVALID_DIST)
    return _pad_slots(dist, idx, k)


def knn_pruned(
    queries: torch.Tensor,
    keys: torch.Tensor,
    k: int,
    *,
    query_valid: Optional[torch.Tensor] = None,
    key_valid: Optional[torch.Tensor] = None,
    init_radius: Optional[float] = None,
    tile_q: int = 256,
    tile_m: int = 1024,
    exclude_self: bool = False,
    max_rounds: int = 6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN by Morton-tile pruning with radius doubling (port of
    ``knn_pruned``): each round runs the compact kernel over the tile pairs
    within the current radius of the unresolved query tiles and resolves a
    query when its k-th distance is within the radius, or when its tile's
    pairs covered every occupied key chunk (fewer than k valid keys); the
    radius doubles for the rest. The first radius is ``init_radius``, or
    by default a surface-density guess from the keys' extent; it also sizes
    the Morton cells. The JAX ``while_loop`` is a host loop with one
    read-back per round (the survivor list, whose emptiness says that every
    query is resolved), at most ``max_rounds`` rounds, then a full pass for
    whatever is still unresolved. With ``exclude_self`` both sides share one
    Morton permutation (by ``query_valid | key_valid``), so the sorted
    diagonal stays the self pairs."""
    qn, mn = queries.shape[0], keys.shape[0]
    if exclude_self and qn != mn:
        raise ValueError(
            "exclude_self requires queries and keys to be the same cloud "
            f"(got {qn} queries vs {mn} keys)"
        )
    dev = queries.device
    k_eff = min(k, mn)
    qv = _valid_or_all(query_valid, qn, dev)
    kv = _valid_or_all(key_valid, mn, dev)

    kext_min = torch.where(kv[:, None], keys, _BIG).amin(dim=0)
    kext_max = torch.where(kv[:, None], keys, -_BIG).amax(dim=0)
    if init_radius is None:
        diag = torch.sqrt(_sq_norm((kext_max - kext_min)[None, :]))[0, 0]
        # Surface-density guess: spacing ~ diag·sqrt(1/M) on a 2-manifold.
        frac = torch.tensor(float(max(k_eff, 1)), device=dev) / torch.tensor(float(mn), device=dev)
        r0 = torch.clamp(diag * torch.sqrt(frac), min=1e-6)
    else:
        r0 = torch.tensor(init_radius, dtype=torch.float32, device=dev)

    origin = torch.minimum(torch.where(qv[:, None], queries, _BIG).amin(dim=0), kext_min)
    if exclude_self:
        perm, _, _ = _morton_sort(queries, qv | kv, origin, r0)
        qperm = kperm = perm
        qs, ks = queries[perm.long()], keys[perm.long()]
        qvs, kvs = qv[perm.long()], kv[perm.long()]
    else:
        qperm, qs, qvs = _morton_sort(queries, qv, origin, r0)
        kperm, ks, kvs = _morton_sort(keys, kv, origin, r0)

    qmin, qmax, q_occ = _tile_aabbs(qs, qvs, tile_q)
    kmin, kmax, k_occ = _tile_aabbs(ks, kvs, tile_m)
    aabb_d2 = _aabb_dist2(qmin, qmax, kmin, kmax)
    qp = _augment_queries(qs, tile_q)
    kp = _augment_keys(ks, kvs, tile_m)
    n_qt, n_mt = qp.shape[0] // tile_q, kp.shape[0] // tile_m
    qn_pad = qp.shape[0]
    budget = n_qt * min(max(n_mt // 4, 8), max(n_mt, 1))
    nearest = torch.argmin(torch.where(k_occ[None, :], aabb_d2, _BIG), dim=1)
    tiles = torch.arange(n_qt, device=dev)

    dist, idx = _init_slots(qn_pad, k_eff, dev)
    resolved = torch.ones(qn_pad, dtype=torch.bool, device=dev)
    resolved[:qn] = ~qvs  # invalid and padding rows are resolved
    radius = r0
    for _ in range(max_rounds):
        r2 = radius * radius
        tile_unres = (~resolved).reshape(n_qt, tile_q).any(dim=1) & q_occ
        mask = (aabb_d2 <= r2) & tile_unres[:, None] & k_occ[None, :]
        mask[tiles, nearest] |= tile_unres
        ids = _live_pairs(mask)  # the round's read-back
        if ids.shape[0] == 0:  # no unresolved query tile is left
            break
        d_new, i_new = _knn_compact(
            qp, kp, mask, k=k_eff, budget=budget, tile_q=tile_q, tile_m=tile_m,
            exclude_diag=exclude_self, ids=ids,
        )
        kth = d_new[:, k_eff - 1]
        # A tile whose pairs covered every occupied chunk is exact whatever
        # its k-th distance (fewer than k valid keys).
        covered = ((mask | ~k_occ[None, :]).all(dim=1) & tile_unres).repeat_interleave(tile_q)
        visited = tile_unres.repeat_interleave(tile_q)
        if ids.shape[0] > budget:
            # The full kernel ran: every answer is exact.
            newly = ~resolved
        else:
            newly = ~resolved & visited & ((kth <= r2) | covered)
        dist = torch.where(newly[:, None], d_new, dist)
        idx = torch.where(newly[:, None], i_new, idx)
        resolved = resolved | newly
        radius = radius * 2.0
    else:
        if not bool(resolved.all()):
            # Safety net after max_rounds under-guesses: one full pass.
            d_f, i_f = knn_full_rows(qp, kp, k=k_eff, exclude_diag=exclude_self)
            dist = torch.where(resolved[:, None], dist, d_f)
            idx = torch.where(resolved[:, None], idx, i_f)

    dist = torch.clamp(dist[:qn], min=0.0)
    dist = torch.where(dist >= INVALID_DIST * 0.5, INVALID_DIST, dist)
    idx = torch.where(
        dist < INVALID_DIST * 0.5, _unpermute_key_indices(kperm, idx[:qn], mn), 0
    )
    dist = torch.where(qvs[:, None], dist, INVALID_DIST)
    qinv = _inverse_perm(qperm).long()
    return _pad_slots(dist[qinv], idx[qinv], k)


def radius_search_pruned(
    queries: torch.Tensor,
    keys: torch.Tensor,
    radius: float,
    max_results: int,
    *,
    query_valid: Optional[torch.Tensor] = None,
    key_valid: Optional[torch.Tensor] = None,
    tile_q: int = 256,
    tile_m: int = 1024,
    exclude_self: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Radius-bounded NN through the compact kernel (port of
    ``radius_search_pruned``): one pass with ``k = max_results + 1`` over
    the tile pairs within ``radius``, then a radius gate. Returns ``(dist
    (Q, R), idx (Q, R), overflowed (Q,))``; the kernel sees every key within
    the radius, so the probe slot ``max_results`` landing inside it says
    exactly that more than ``max_results`` keys are there. ``exclude_self``
    searches one slot more and drops the self hit."""
    if exclude_self:
        dist, idx, over_inner = radius_search_pruned(
            queries, keys, radius, max_results + 1, query_valid=query_valid,
            key_valid=key_valid, tile_q=tile_q, tile_m=tile_m,
        )
        dist, idx, any_self, hit_last = _drop_self_slot(dist, idx, max_results)
        # More than max_results + 1 inside, or exactly max_results + 1 of
        # which none was the query itself.
        return dist, idx, over_inner | (hit_last & ~any_self)

    qn, mn = queries.shape[0], keys.shape[0]
    dev = queries.device
    k_eff = min(max_results + 1, mn)
    qv = _valid_or_all(query_valid, qn, dev)
    kv = _valid_or_all(key_valid, mn, dev)
    r = torch.tensor(radius, dtype=torch.float32, device=dev)
    r2 = r * r

    origin = torch.minimum(
        torch.where(qv[:, None], queries, _BIG).amin(dim=0),
        torch.where(kv[:, None], keys, _BIG).amin(dim=0),
    )
    qperm, qs, qvs = _morton_sort(queries, qv, origin, r)
    kperm, ks, kvs = _morton_sort(keys, kv, origin, r)
    qmin, qmax, q_occ = _tile_aabbs(qs, qvs, tile_q)
    kmin, kmax, k_occ = _tile_aabbs(ks, kvs, tile_m)
    aabb_d2 = _aabb_dist2(qmin, qmax, kmin, kmax)
    within = (aabb_d2 <= r2) & q_occ[:, None] & k_occ[None, :]
    n_qt = within.shape[0]
    nearest = torch.argmin(torch.where(k_occ[None, :], aabb_d2, _BIG), dim=1)
    within[torch.arange(n_qt, device=dev), nearest] = True

    qp = _augment_queries(qs, tile_q)
    kp = _augment_keys(ks, kvs, tile_m)
    n_mt = kp.shape[0] // tile_m
    budget = n_qt * min(max(n_mt // 4, 8), max(n_mt, 1))
    dist, idx = _knn_compact(
        qp, kp, within, k=k_eff, budget=budget, tile_q=tile_q, tile_m=tile_m
    )
    dist = torch.clamp(dist[:qn], min=0.0)
    idx = idx[:qn]
    ok = (dist <= r2) & qvs[:, None]
    over = ok[:, k_eff - 1] & (k_eff == max_results + 1)
    dist = torch.where(ok, dist, INVALID_DIST)
    idx = torch.where(ok, _unpermute_key_indices(kperm, idx, mn), 0)
    qinv = _inverse_perm(qperm).long()
    dist, idx = _pad_slots(dist[qinv][:, :max_results], idx[qinv][:, :max_results], max_results)
    return dist, idx, over[qinv]

