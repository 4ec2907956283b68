"""Exact single nearest neighbour over augmented coordinates, with
Morton-tile pruning (port of the nn1 half of
``cilantro_tpu/neighbors/pallas_nn.py``; its kNN and radius half waits for
the neighbour-engine slice).

Squared distances come from one 8-term dot product of augmented rows,
``q̂ = [−2q, ‖q‖², 1]`` and ``k̂ = [k, 1, ‖k‖²]`` zero-padded to 8 columns:
``q̂·k̂ = ‖q‖² + ‖k‖² − 2q·k``. Masked and padding keys carry
``INVALID_DIST`` (3e38) in the ‖k‖² slot, so they never win.

Three CUDA C++ kernels (``csrc/nn1_kernels.cu``, built for ``sm_90a`` at
first CUDA use) carry the search, each with a plain PyTorch version beside
it; a wrapper runs the plain version only when its tensors lie on the CPU,
and for CUDA tensors launches the kernel or raises. Every launch adds one to
``launch_counts[<name>]``.

- :func:`fused_rows` ("nn1_fused") replaces ``_nn1_kernel`` / ``nn1_pallas``
  (``pallas_nn.py:92,151``): every query against every key.
- :func:`masked_rows` ("nn1_masked") replaces ``_nn1_kernel_masked`` /
  ``_nn1_pallas_masked`` (``pallas_nn.py:176,247``): the (query tile, key
  chunk) pairs a mask allows.
- :func:`compact_rows` ("nn1_compact") replaces ``_nn1_kernel_compact`` /
  ``_nn1_pallas_compact`` (``pallas_nn.py:262,363``): the pairs of a
  compacted list.

Contract of all three, per query row: the least ``Σ_j q̂[j]·k̂[m, j]`` over
the visited keys, summed left to right in float32 (no FMA, no TF32), and the
smallest key position that reaches it, starting from ``(INVALID_DIST, 0)``.
Kernel and plain version agree bit for bit. The TPU kernels take the same
minimum with the same tie rule (strict ``<`` across key chunks, smallest
column within one); their MXU product sums in another order, so distances
agree with JAX to float32 rounding. A NaN sum never wins here, while a TPU
chunk holding one is skipped whole; NaNs arise only for invalid queries at
1e30, whose rows every wrapper gates.

What bounds the kernels: arithmetic. For D-dimensional points the function
needs D + 2 products, D + 1 sums and a compare per visited (query, key)
pair (10 operations for 3-D points; the kernels' other 3 products and sums
multiply zero padding). The least time is that count over the published
float32 rate off the tensor cores (67 TFLOP/s on an H100 SXM), which counts
an FMA as two operations; the kernels issue no FMA, for bit-exactness, so
they cannot reach it. See the source for the design.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import native
from .bruteforce import INVALID_DIST
from .gridhash import _aabb_dist2, morton_code

launch_counts: Dict[str, int] = {
    "nn1_fused": 0,
    "nn1_masked": 0,
    "nn1_compact": 0,
}

_DPAD = 8  # augmented row width
_BLOCK_Q = 128  # queries per CUDA block: query tiles are multiples of it
_PLAIN_BLOCK = 1 << 26  # (query, key) pairs per plain-version block (256 MB)
_INT32_MAX = 2**31 - 1


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# Augmented coordinates.
# ---------------------------------------------------------------------------


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """Row sums of squares, ``(N, 1)``, summed left to right (the same
    float32 result on every device)."""
    out = x[:, :1] * x[:, :1]
    for j in range(1, x.shape[1]):
        out = out + x[:, j : j + 1] * x[:, j : j + 1]
    return out


def _pad_aug_rows(x: torch.Tensor, mult: int) -> torch.Tensor:
    n = x.shape[0]
    rows = ((n + mult - 1) // mult) * mult
    out = torch.zeros((rows, _DPAD), dtype=torch.float32, device=x.device)
    out[:n, : x.shape[1]] = x
    return out


def _augment_queries(queries: torch.Tensor, tile_q: int) -> torch.Tensor:
    """``q̂ = [−2q, ‖q‖², 1]`` padded to a ``tile_q`` multiple."""
    q = queries.float()
    qq = _sq_norm(q)
    qhat = torch.cat([-2.0 * q, qq, torch.ones_like(qq)], dim=1)
    return _pad_aug_rows(qhat, tile_q)


def _augment_keys(
    keys: torch.Tensor, key_valid: Optional[torch.Tensor], tile_m: int
) -> torch.Tensor:
    """``k̂ = [k, 1, ‖k‖² (INVALID_DIST if masked)]`` padded to a ``tile_m``
    multiple; padding keys get INVALID_DIST in the ‖k‖² slot."""
    d = keys.shape[1]
    k = keys.float()
    kk = _sq_norm(k)
    if key_valid is not None:
        kk = torch.where(key_valid[:, None], kk, INVALID_DIST)
    khat = torch.cat([k, torch.ones_like(kk), kk], dim=1)
    mn = keys.shape[0]
    kp = _pad_aug_rows(khat, tile_m)
    if kp.shape[0] > mn:
        kp[mn:, d + 1] = INVALID_DIST
    return kp


def _augment(queries, keys, key_valid, tile_q, tile_m):
    return _augment_queries(queries, tile_q), _augment_keys(keys, key_valid, tile_m)


# ---------------------------------------------------------------------------
# Plain versions: the kernels' arithmetic as PyTorch ops.
# ---------------------------------------------------------------------------


def _aug_dist(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``(Q, M)`` sums ``Σ_j q[:, j]·k[:, j]`` left to right, one float32
    rounding per product and per sum, as the kernels take them."""
    acc = q[:, 0:1] * k[None, :, 0]
    for j in range(1, _DPAD):
        acc = acc + q[:, j : j + 1] * k[None, :, j]
    return acc


def _fold(bd, bi, dist, col0):
    """Fold a ``(R, C)`` distance block whose columns are key positions
    ``col0 + c`` into the running best: first minimum of the block, then a
    strict ``<`` against the running best. NaN never wins."""
    dist = torch.where(torch.isnan(dist), float("inf"), dist)
    cols = torch.arange(dist.shape[1], dtype=torch.int32, device=dist.device)
    low = dist.min(dim=1, keepdim=True).values
    arg = torch.where(dist <= low, cols, _INT32_MAX).min(dim=1).values
    val = dist.gather(1, arg[:, None].long())[:, 0]
    better = val < bd
    return torch.where(better, val, bd), torch.where(better, arg + col0, bi)


def _init_best(rows: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.full((rows,), INVALID_DIST, dtype=torch.float32, device=device),
        torch.zeros(rows, dtype=torch.int32, device=device),
    )


def fused_rows_plain(qp: torch.Tensor, kp: torch.Tensor):
    """Plain version of :func:`fused_rows`."""
    bd, bi = _init_best(qp.shape[0], qp.device)
    step_q = max(1, min(qp.shape[0], _PLAIN_BLOCK // max(kp.shape[0], 1)))
    step_m = max(1, min(kp.shape[0], _PLAIN_BLOCK // step_q))
    for q0 in range(0, qp.shape[0], step_q):
        q = qp[q0 : q0 + step_q]
        d, i = bd[q0 : q0 + step_q], bi[q0 : q0 + step_q]
        for m0 in range(0, kp.shape[0], step_m):
            d, i = _fold(d, i, _aug_dist(q, kp[m0 : m0 + step_m]), m0)
        bd[q0 : q0 + step_q], bi[q0 : q0 + step_q] = d, i
    return bd, bi


def masked_rows_plain(qp, kp, tile_mask, tile_q, tile_m):
    """Plain version of :func:`masked_rows`: key chunks in ascending order,
    each against the query tiles its mask column allows."""
    bd, bi = _init_best(qp.shape[0], qp.device)
    mask = tile_mask.cpu().numpy() != 0
    group = max(1, _PLAIN_BLOCK // (tile_q * tile_m))
    offs = torch.arange(tile_q, device=qp.device)
    for kt in range(mask.shape[1]):
        tiles = np.flatnonzero(mask[:, kt])
        keys = kp[kt * tile_m : (kt + 1) * tile_m]
        for g0 in range(0, len(tiles), group):
            sel = torch.as_tensor(tiles[g0 : g0 + group], device=qp.device)
            rows = (sel[:, None] * tile_q + offs).reshape(-1)
            bd[rows], bi[rows] = _fold(
                bd[rows], bi[rows], _aug_dist(qp[rows], keys), kt * tile_m
            )
    return bd, bi


def compact_rows_plain(qp, kp, qt, kt, flags, tile_q, tile_m):
    """Plain version of :func:`compact_rows`: the masked plain version over
    the pairs that the list's live entries name."""
    n_qt, n_mt = qp.shape[0] // tile_q, kp.shape[0] // tile_m
    live = (flags & 2) != 0
    mask = torch.zeros((n_qt, n_mt), dtype=torch.int32, device=qp.device)
    mask[qt[live].long(), kt[live].long()] = 1
    return masked_rows_plain(qp, kp, mask, tile_q, tile_m)


# ---------------------------------------------------------------------------
# Kernel library and argument checks.
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "nn1_fused_launch": (_P, _P, _I, _I, _P, _P, _P),
    "nn1_masked_launch": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "nn1_compact_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
}


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = native.load("nn1_kernels")
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _launch(name: str, *args) -> None:
    err = getattr(_kernels(), f"{name}_launch")(
        *args, torch.cuda.current_stream().cuda_stream
    )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launch_counts[name] += 1


def _check_rows(name, qp, kp, tile_q, tile_m) -> Tuple[int, int]:
    """Checks the augmented operands; returns ``(n_qt, n_mt)``."""
    native.check(name, qp, "qp", (torch.float32,), (qp.shape[0], _DPAD))
    native.check(name, kp, "kp", (torch.float32,), (kp.shape[0], _DPAD))
    if qp.shape[0] % tile_q or kp.shape[0] % tile_m:
        raise ValueError(
            f"{name}: {qp.shape[0]} query rows / {kp.shape[0]} key rows are not "
            f"multiples of tile_q={tile_q} / tile_m={tile_m}"
        )
    return qp.shape[0] // tile_q, kp.shape[0] // tile_m


def _check_cuda(name, tile_q, *named) -> None:
    if tile_q % _BLOCK_Q:
        raise ValueError(
            f"{name}: query tiles of {tile_q} rows are not a multiple of {_BLOCK_Q} on CUDA"
        )
    for what, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")


# ---------------------------------------------------------------------------
# The three kernel wrappers.
# ---------------------------------------------------------------------------


def fused_rows(qp: torch.Tensor, kp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest key of every augmented query row over all key rows:
    ``(dist (Qp,) f32, idx (Qp,) i32)``, raw (not clamped or gated)."""
    name = "nn1_fused"
    _check_rows(name, qp, kp, 1, 1)
    if native.on_cpu(name, qp, kp):
        return fused_rows_plain(qp, kp)
    _check_cuda(name, qp.shape[0], ("qp", qp), ("kp", kp))
    dist = torch.empty(qp.shape[0], dtype=torch.float32, device=qp.device)
    idx = torch.empty(qp.shape[0], dtype=torch.int32, device=qp.device)
    _launch(
        name, qp.data_ptr(), kp.data_ptr(), qp.shape[0], kp.shape[0],
        dist.data_ptr(), idx.data_ptr(),
    )
    return dist, idx


def masked_rows(
    qp: torch.Tensor, kp: torch.Tensor, tile_mask: torch.Tensor, *, tile_q: int, tile_m: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_rows` over the (query tile, key chunk) pairs whose
    ``tile_mask (n_qt, n_mt) int32`` entry is not 0."""
    name = "nn1_masked"
    n_qt, n_mt = _check_rows(name, qp, kp, tile_q, tile_m)
    native.check(name, tile_mask, "tile_mask", (torch.int32,), (n_qt, n_mt))
    if native.on_cpu(name, qp, kp, tile_mask):
        return masked_rows_plain(qp, kp, tile_mask, tile_q, tile_m)
    _check_cuda(name, tile_q, ("qp", qp), ("kp", kp), ("tile_mask", tile_mask))
    dist = torch.empty(qp.shape[0], dtype=torch.float32, device=qp.device)
    idx = torch.empty(qp.shape[0], dtype=torch.int32, device=qp.device)
    _launch(
        name, qp.data_ptr(), kp.data_ptr(), tile_mask.data_ptr(), qp.shape[0],
        n_mt, tile_q, tile_m, dist.data_ptr(), idx.data_ptr(),
    )
    return dist, idx


def compact_rows(
    qp: torch.Tensor,
    kp: torch.Tensor,
    qt: torch.Tensor,
    kt: torch.Tensor,
    flags: torch.Tensor,
    *,
    tile_q: int,
    tile_m: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_rows` over a compacted pair list: entry s names query
    tile ``qt[s]`` and key chunk ``kt[s]``, and counts if ``flags[s] & 2``.
    The list is sorted by ``qt`` (as :func:`_compact_list` builds it); a
    query tile that no live entry names keeps ``(INVALID_DIST, 0)``."""
    name = "nn1_compact"
    n_qt, n_mt = _check_rows(name, qp, kp, tile_q, tile_m)
    budget = qt.shape[0]
    for what, t in (("qt", qt), ("kt", kt), ("flags", flags)):
        native.check(name, t, what, (torch.int32,), (budget,))
    if native.on_cpu(name, qp, kp, qt, kt, flags):
        return compact_rows_plain(qp, kp, qt, kt, flags, tile_q, tile_m)
    _check_cuda(
        name, tile_q, ("qp", qp), ("kp", kp), ("qt", qt), ("kt", kt), ("flags", flags)
    )
    dist = torch.empty(qp.shape[0], dtype=torch.float32, device=qp.device)
    idx = torch.empty(qp.shape[0], dtype=torch.int32, device=qp.device)
    _launch(
        name, qp.data_ptr(), kp.data_ptr(), qt.data_ptr(), kt.data_ptr(),
        flags.data_ptr(), budget, qp.shape[0], tile_q, tile_m,
        dist.data_ptr(), idx.data_ptr(),
    )
    return dist, idx


# ---------------------------------------------------------------------------
# The JAX package's wrappers around its kernels.
# ---------------------------------------------------------------------------


def nn1_fused(
    queries: torch.Tensor,
    keys: torch.Tensor,
    *,
    query_valid: Optional[torch.Tensor] = None,
    key_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact single NN (port of ``nn1_pallas``): ``(dist² (Q,), idx (Q,)
    int32)``. Key invalidation rides in the augmented ‖k‖² column. The
    kernel has no tiles: queries are padded to its block of rows, keys not
    at all (JAX's tile padding only adds keys that never win)."""
    qn = queries.shape[0]
    qp, kp = _augment(queries, keys, key_valid, _BLOCK_Q, 1)
    dist, idx = fused_rows(qp, kp)
    dist = torch.clamp(dist[:qn], min=0.0)
    dist = torch.where(dist >= INVALID_DIST * 0.5, INVALID_DIST, dist)
    idx = idx[:qn]
    if query_valid is not None:
        dist = torch.where(query_valid, dist, INVALID_DIST)
    return dist, idx


def _nn1_masked(qp, kp, tile_mask, *, tile_q: int = 1024, tile_m: int = 2048):
    """Port of ``_nn1_pallas_masked``: raw ``(n_qt, tile_q)`` results."""
    dist, idx = masked_rows(qp, kp, tile_mask, tile_q=tile_q, tile_m=tile_m)
    return dist.reshape(-1, tile_q), idx.reshape(-1, tile_q)


def _compact_list(tile_mask: torch.Tensor, budget: int):
    """The compacted pair list of ``_nn1_pallas_compact``: the row-major
    nonzeros of ``tile_mask`` as ``(qt, kt, flags)`` of length ``budget``,
    padded by repeats of the last entry (flags: bit 0 first step of a query
    tile, bit 1 live, bit 2 last step). ``None`` when more than ``budget``
    pairs survive. Reads the survivor count back to the host (one sync)."""
    n_mt = tile_mask.shape[1]
    ids = torch.nonzero(tile_mask.reshape(-1)).reshape(-1).to(torch.int32)
    count = ids.shape[0]
    if count > budget:
        return None
    fill = ids[-1:] if count else torch.zeros(1, dtype=torch.int32, device=ids.device)
    ids = torch.cat([ids, fill.expand(budget - count)])
    live = torch.arange(budget, device=ids.device) < count
    qt = ids // n_mt
    kt = ids % n_mt
    true = torch.ones(1, dtype=torch.bool, device=ids.device)
    first = torch.cat([true, qt[1:] != qt[:-1]])
    last = torch.cat([qt[:-1] != qt[1:], true])
    flags = first.to(torch.int32) + 2 * live.to(torch.int32) + 4 * last.to(torch.int32)
    return qt, kt, flags


def _nn1_compact(qp, kp, tile_mask, *, budget: int, tile_q: int = 1024, tile_m: int = 2048):
    """Port of ``_nn1_pallas_compact``: the compact kernel when at most
    ``budget`` pairs survive, else the masked kernel (the JAX ``lax.cond``
    becomes a host branch on the survivor count). Every row of
    ``tile_mask`` must allow at least one pair."""
    lst = _compact_list(tile_mask, budget)
    if lst is None:
        return _nn1_masked(qp, kp, tile_mask.to(torch.int32), tile_q=tile_q, tile_m=tile_m)
    dist, idx = compact_rows(qp, kp, *lst, tile_q=tile_q, tile_m=tile_m)
    return dist.reshape(-1, tile_q), idx.reshape(-1, tile_q)


# ---------------------------------------------------------------------------
# Morton-tile prune plans.
# ---------------------------------------------------------------------------


class NN1PrunePlan(NamedTuple):
    """Loop-invariant state for repeated radius-bounded nn1 passes against a
    fixed key cloud and a query cloud that moves a little per pass (ICP):
    the Morton sorts, the augmented sorted keys and their chunk AABBs. Each
    pass recomputes the query-tile AABBs from the actual positions, so it
    stays exact; query motion only loosens the tiles."""

    radius: torch.Tensor  # 0-d f32
    kperm: torch.Tensor  # (M,) original key index of each sorted position
    kp: torch.Tensor  # (Mp, 8) augmented sorted keys
    kmin: torch.Tensor  # (n_mt, D) key-chunk AABBs
    kmax: torch.Tensor
    k_occ: torch.Tensor  # (n_mt,) chunk has a valid key
    qperm: torch.Tensor  # (Q,) query sort (from the hint positions)
    qinv: torch.Tensor  # (Q,) inverse of qperm
    qvs: torch.Tensor  # (Q,) query validity in sorted order
    tile_q: int
    tile_m: int


def _morton_sort(points, valid, origin, cell):
    """``(perm, points[perm], valid[perm])`` by Morton code of the
    ``cell``-sized voxel, invalid points last; a stable sort, as
    ``jnp.argsort``, so equal codes keep their input order."""
    code = torch.where(valid, morton_code(points, origin, cell), _INT32_MAX)
    perm = torch.argsort(code, stable=True)
    return perm.to(torch.int32), points[perm], valid[perm]


def _inverse_perm(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


def _unpermute_key_indices(kperm, idx, mn):
    """Map sorted-key indices back to original key order."""
    return kperm[torch.clamp(idx, 0, mn - 1).long()]


def _tile_aabbs(pts, val, tile):
    big = 3e38
    d = pts.shape[1]
    pad = (-pts.shape[0]) % tile
    if pad:
        pts = torch.cat([pts, pts.new_zeros((pad, d))])
        val = torch.cat([val, val.new_zeros(pad)])
    blocks = pts.reshape(-1, tile, d)
    vb = val.reshape(-1, tile)
    amin = torch.where(vb[..., None], blocks, big).amin(dim=1)
    amax = torch.where(vb[..., None], blocks, -big).amax(dim=1)
    return amin, amax, vb.any(dim=1)


def prune_eligible(q_shape, k_shape, max_distance, metric: str = "l2", *, device=None) -> bool:
    """One predicate for "should this gated NN search take the Morton-tile
    pruned kernel": L2, 3-D points, Q·M ≥ 2²⁶ (where pruning beats the
    fused kernel), a distance gate to serve as the prune bound, and the
    tensors on CUDA (the JAX package asks for the TPU backend)."""
    return (
        max_distance is not None
        and metric == "l2"
        and q_shape[1] == 3
        and q_shape[0] * k_shape[0] >= (1 << 26)
        and device is not None
        and torch.device(device).type == "cuda"
    )


def maybe_make_nn1_prune_plan(
    keys: torch.Tensor,
    max_corr_dist_sq,
    query_hint: torch.Tensor,
    *,
    key_valid: Optional[torch.Tensor] = None,
    query_valid: Optional[torch.Tensor] = None,
) -> Optional[NN1PrunePlan]:
    """A prune plan iff :func:`prune_eligible` picks the pruned kernel for
    this problem (``max_corr_dist_sq`` is the squared gate); else None."""
    if not prune_eligible(
        query_hint.shape, keys.shape, max_corr_dist_sq, device=query_hint.device
    ):
        return None
    radius = torch.sqrt(torch.as_tensor(max_corr_dist_sq, dtype=torch.float32))
    return make_nn1_prune_plan(
        keys, radius, query_hint, key_valid=key_valid, query_valid=query_valid
    )


def make_nn1_prune_plan(
    keys: torch.Tensor,
    radius,
    query_hint: torch.Tensor,
    *,
    key_valid: Optional[torch.Tensor] = None,
    query_valid: Optional[torch.Tensor] = None,
    tile_q: int = 512,
    tile_m: int = 1024,
) -> NN1PrunePlan:
    """Morton-sort both clouds (queries by their ``query_hint`` positions),
    augment the sorted keys and take the key-chunk AABBs."""
    dev = keys.device
    qn, mn = query_hint.shape[0], keys.shape[0]
    qv = torch.ones(qn, dtype=torch.bool, device=dev) if query_valid is None else query_valid
    kv = torch.ones(mn, dtype=torch.bool, device=dev) if key_valid is None else key_valid
    radius = torch.as_tensor(radius, dtype=torch.float32).to(dev)
    big = 3e38
    origin = torch.minimum(
        torch.where(qv[:, None], query_hint, big).amin(dim=0),
        torch.where(kv[:, None], keys, big).amin(dim=0),
    )
    qperm, _, _ = _morton_sort(query_hint, qv, origin, radius)
    kperm, ks, kvs = _morton_sort(keys, kv, origin, radius)
    kmin, kmax, k_occ = _tile_aabbs(ks, kvs, tile_m)
    return NN1PrunePlan(
        radius=radius,
        kperm=kperm,
        kp=_augment_keys(ks, kvs, tile_m),
        kmin=kmin,
        kmax=kmax,
        k_occ=k_occ,
        qperm=qperm,
        qinv=_inverse_perm(qperm),
        qvs=qv[qperm.long()],
        tile_q=tile_q,
        tile_m=tile_m,
    )


def prune_mask(queries: torch.Tensor, plan: NN1PrunePlan):
    """The per-pass tile pairs of :func:`nn1_pruned_planned`: ``(qs,
    within (n_qt, n_mt) bool, budget)`` for ``queries`` at their current
    positions. Every query tile keeps at least its nearest occupied key
    chunk, so every output row is visited."""
    qs = queries[plan.qperm.long()]
    qmin, qmax, q_occ = _tile_aabbs(qs, plan.qvs, plan.tile_q)
    aabb_d2 = _aabb_dist2(qmin, qmax, plan.kmin, plan.kmax)
    within = (aabb_d2 <= plan.radius * plan.radius) & q_occ[:, None] & plan.k_occ[None, :]
    n_qt = within.shape[0]
    nearest = torch.argmin(torch.where(plan.k_occ[None, :], aabb_d2, 3e38), dim=1)
    within[torch.arange(n_qt, device=within.device), nearest] = True
    n_mt = plan.kp.shape[0] // plan.tile_m
    budget = n_qt * min(max(n_mt // 4, 8), max(n_mt, 1))
    return qs, within, budget


def nn1_pruned_planned(
    queries: torch.Tensor, plan: NN1PrunePlan
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Radius-bounded exact nn1 for ``queries`` at their current positions,
    reusing the plan's sorts: matches within the plan's radius are exact,
    others ``INVALID_DIST`` with index 0."""
    qn = queries.shape[0]
    mn = plan.kperm.shape[0]
    qs, within, budget = prune_mask(queries, plan)
    qp = _augment_queries(qs, plan.tile_q)
    dist, idx = _nn1_compact(
        qp, plan.kp, within, budget=budget, tile_q=plan.tile_q, tile_m=plan.tile_m
    )
    dist = torch.clamp(dist.reshape(-1)[:qn], min=0.0)
    idx = idx.reshape(-1)[:qn]
    ok = (dist <= plan.radius * plan.radius) & plan.qvs
    dist = torch.where(ok, dist, INVALID_DIST)
    idx = torch.where(ok, _unpermute_key_indices(plan.kperm, idx, mn), 0)
    inv = plan.qinv.long()
    return dist[inv], idx[inv]


def nn1_pruned(
    queries: torch.Tensor,
    keys: torch.Tensor,
    radius,
    *,
    query_valid: Optional[torch.Tensor] = None,
    key_valid: Optional[torch.Tensor] = None,
    tile_q: int = 1024,
    tile_m: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Radius-bounded exact nn1 with Morton-tile pruning: matches within
    ``radius`` are exact; queries with no key inside return INVALID_DIST."""
    qv = (
        torch.ones(queries.shape[0], dtype=torch.bool, device=queries.device)
        if query_valid is None
        else query_valid
    )
    plan = make_nn1_prune_plan(
        keys, radius, queries, key_valid=key_valid, query_valid=qv,
        tile_q=tile_q, tile_m=tile_m,
    )
    return nn1_pruned_planned(queries, plan)
