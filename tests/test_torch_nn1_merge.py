"""The two invariants the CUDA masked and compact nn1 kernels rest on, in
plain PyTorch and numpy (no JAX, no card):

(a) On rows from ``_augment``, the left-to-right float32 sum of the first
    D + 2 products equals ``_aug_dist``'s 8-term sum bit for bit, and is
    never -0: the columns past D + 1 are +0 in both operands, and term D
    (``|q|^2 * k^[D]``, with ``k^[D]`` 1 or 0) is >= +0 or NaN.
(b) Folding the visited keys in ascending order with a strict ``<`` from
    ``(3e38, 0)`` gives the lexicographic minimum of ``(dist, pos)`` over
    the non-NaN keys, so any split of those keys into parts, each folded
    alone and merged by the maximum of ``~(order_key(dist) << 32 | pos)``
    over a scratch cleared to 0, gives ``masked_rows_plain``'s bits.
"""

import numpy as np
import pytest
import torch

from cilantro_tpu_torch.neighbors import fused_nn as nn

INVALID = np.float32(3e38)


def _cloud(rng, dim, qn, mn):
    """Queries and keys with exact duplicates, -0.0 coordinates, invalid
    queries at 1e30 and 10% masked keys."""
    q = rng.uniform(-0.5, 0.5, (qn, dim)).astype(np.float32)
    k = rng.uniform(-0.5, 0.5, (mn, dim)).astype(np.float32)
    k[:20] = q[:20]  # distance-0 ties
    k[40:60] = k[:20]  # repeated keys: index ties
    q[20:25] = -0.0
    k[60:65] = -0.0
    q[25:30, 0] = -0.0
    q[30:33] = 1e30  # invalid queries, as the pruned path leaves them
    kv = rng.random(mn) < 0.9
    return torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(kv)


def _terms_dist(q, k, terms):
    acc = q[:, 0:1] * k[None, :, 0]
    for j in range(1, terms):
        acc = acc + q[:, j : j + 1] * k[None, :, j]
    return acc


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("dim", [2, 3])
def test_live_terms_sum_is_the_eight_term_sum(dim):
    rng = np.random.default_rng(dim)
    q, k, kv = _cloud(rng, dim, 200, 300)
    # tile 128 pads both sides: zero query rows, padding keys at 3e38.
    qp, kp = nn._augment(q, k, kv, 128, 128)
    assert qp.shape[0] > q.shape[0] and kp.shape[0] > k.shape[0]
    assert not qp[:, dim + 2 :].any() and not kp[:, dim + 2 :].any()
    full = nn._aug_dist(qp, kp)
    live = _terms_dist(qp, kp, nn._live_terms(dim))
    nan = torch.isnan(full)
    assert torch.equal(nan, torch.isnan(live))
    assert torch.equal(_bits(full)[~nan], _bits(live)[~nan])
    assert nan.any() and (full == INVALID).any() and (full == 0).any()
    # Never -0 once term D has been added, whatever the earlier terms gave.
    for terms in range(dim + 1, nn._DPAD + 1):
        s = _terms_dist(qp, kp, terms)
        assert not ((s == 0) & torch.signbit(s)).any()
    assert ((_terms_dist(qp, kp, 1) == 0) & torch.signbit(_terms_dist(qp, kp, 1))).any()


def _order_key(d):
    b = d.view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint64)


def _from_order_key(key):
    key = key.astype(np.uint32)
    return np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key).astype(np.uint32).view(np.float32)


def _fold(dist, keys):
    """Strict-``<`` fold of the key columns ``keys`` (ascending) of
    ``dist (Q, M)`` from ``(3e38, 0)``, one key at a time."""
    bd = np.full(dist.shape[0], INVALID, np.float32)
    bi = np.zeros(dist.shape[0], np.int32)
    for m in keys:
        better = dist[:, m] < bd  # NaN is below nothing
        bd = np.where(better, dist[:, m], bd)
        bi = np.where(better, m, bi)
    return bd, bi


def _merge(parts):
    best = np.zeros(parts[0][0].shape[0], np.uint64)
    for bd, bi in parts:
        x = ~((_order_key(bd) << np.uint64(32)) | bi.astype(np.uint32).astype(np.uint64))
        best = np.maximum(best, np.where(bd < INVALID, x, np.uint64(0)))
    p = ~best
    dist = np.where(best == 0, INVALID, _from_order_key(p >> np.uint64(32)))
    idx = np.where(best == 0, 0, (p & np.uint64(0xFFFFFFFF)).astype(np.int64)).astype(np.int32)
    return dist.astype(np.float32), idx


def _split(rng, kind, cols, tile_m, parts):
    """Lists of visited key positions, one per part."""
    if kind == "chunks":  # each chunk to a random part
        owner = rng.integers(0, parts, len(cols))
        return [[c * tile_m + j for c, o in zip(cols, owner) if o == p for j in range(tile_m)] for p in range(parts)]
    if kind == "rank":  # the masked kernel's rank-modulo split of the chunks
        return [[c * tile_m + j for r, c in enumerate(cols) if r % parts == p for j in range(tile_m)] for p in range(parts)]
    keys = [c * tile_m + j for c in cols for j in range(tile_m)]  # single keys
    owner = rng.integers(0, parts, len(keys))
    return [[m for m, o in zip(keys, owner) if o == p] for p in range(parts)]


@pytest.mark.parametrize("kind", ["chunks", "rank", "keys"])
@pytest.mark.parametrize("parts", [2, 5])
def test_split_folds_merged_by_packed_min_are_the_plain_result(kind, parts):
    rng = np.random.default_rng(parts * 7 + len(kind))
    tq, tm = 64, 32
    q, k, kv = _cloud(rng, 3, 250, 200)
    kv[96:128] = False  # key chunk 3 all masked
    qp, kp = nn._augment(q, k, kv, tq, tm)
    n_qt, n_mt = qp.shape[0] // tq, kp.shape[0] // tm
    mask = rng.random((n_qt, n_mt)) < 0.5
    mask[0] = False
    mask[0, 3] = True  # tile 0 visits only masked keys: keeps (3e38, 0)
    mask[1, -1] = True  # tile 1 visits the padding keys too
    want_d, want_i = nn.masked_rows_plain(qp, kp, torch.from_numpy(mask).to(torch.int32), tq, tm)
    dist = nn._aug_dist(qp, kp).numpy()
    got_d = np.empty(qp.shape[0], np.float32)
    got_i = np.empty(qp.shape[0], np.int32)
    for t in range(n_qt):
        rows = slice(t * tq, (t + 1) * tq)
        cols = list(np.flatnonzero(mask[t]))
        lists = _split(rng, kind, cols, tm, parts)
        got_d[rows], got_i[rows] = _merge([_fold(dist[rows], sorted(lst)) for lst in lists])
    assert np.array_equal(got_d.view(np.int32), want_d.numpy().view(np.int32))
    assert np.array_equal(got_i, want_i.numpy())
    assert (got_d[:tq] == INVALID).all() and (got_i[:tq] == 0).all()
    assert (got_d == 0).any()  # distance-0 ties were decided


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mn", [1, 130, 300, 1000])
@pytest.mark.parametrize("splits", [2, 3, 7])
def test_contiguous_key_splits_merged_are_the_fused_fold(dim, mn, splits):
    """The fused kernel's split: parts of ``span`` consecutive keys (a
    multiple of the staging step, the last part the tail; keys unpadded, as
    ``nn1_fused`` leaves them), each folded alone over the D + 2 live terms,
    merged by the packed minimum, give ``fused_rows_plain``'s bits."""
    rng = np.random.default_rng(100 * dim + mn + splits)
    q, k, kv = _cloud(rng, dim, 300, max(mn, 70))
    k, kv = k[:mn], kv[:mn]
    if mn == 130:
        kv[:] = False  # every key masked: every row keeps (3e38, 0)
    qp, kp = nn._augment(q, k, kv, nn._fused_rows_multiple(q.shape[0]), 1)
    assert kp.shape[0] == mn and qp.shape[0] == 512
    want_d, want_i = nn.fused_rows_plain(qp, kp)
    dist = _terms_dist(qp, kp, nn._live_terms(dim)).numpy()
    step = 16
    span = max(step, -(-(-(-mn // splits)) // step) * step)
    parts = [range(k0, min(mn, k0 + span)) for k0 in range(0, mn, span)]
    assert sum(len(p) for p in parts) == mn
    got_d, got_i = _merge([_fold(dist, p) for p in parts])
    assert np.array_equal(got_d.view(np.int32), want_d.numpy().view(np.int32))
    assert np.array_equal(got_i, want_i.numpy())
    real = slice(0, q.shape[0])  # padding rows (zeros) are at 0 from every key
    if mn == 130:
        assert (got_d[real] == INVALID).all() and (got_i[real] == 0).all()
    else:
        assert (got_d[30:33] == INVALID).all()  # queries at 1e30 find nothing


@pytest.mark.parametrize("qn, rows", [(1, 128), (128, 128), (129, 256), (256, 256), (257, 512), (4096, 4096)])
def test_fused_query_padding_gives_the_kernel_four_rows_a_thread(qn, rows):
    """``nn1_fused`` pads queries to 128 rows a block times the rows a
    thread: 4 from 257 queries up, 2 or 1 below."""
    mult = nn._fused_rows_multiple(qn)
    assert -(-qn // mult) * mult == rows
    assert mult == 128 * {128: 1, 256: 2}.get(rows, 4)
