"""A model of the full kNN kernel's warp design and of its route, on the CPU.

``knn_full_warp_kernel`` (``cilantro_tpu_torch/csrc/knn_kernels.cu``, item
5) gives a query a warp: lane l takes keys l, l + 32, ..., queues the pairs
that pass the list's k-th in T registers of its own, and the warp merges
queue and list (32·P slots, slot e in register e / 32 of lane e % 32) with
bitonic networks of exact pair compares. The model below takes the same
steps with numpy, lane by lane: the votes, the queue pushes, the
register-major networks, the k-th read from slot k − 1, NaN-padded stages,
key splits and the merge of their partial lists. It must give the plain
version's bits (``knn_full_rows_plain``) on ties, the diagonal, invalid
queries and keys, and lists of every size. The card holds the kernel itself
to the same bits (``tests/test_torch_knn_cuda.py``). No JAX; a few seconds.

The route (``fused_knn._full_plan``) is plain Python: the cases that decide
it go to the design its docstring names, and ``kernel_design`` reports it.
"""

import numpy as np
import pytest
import torch

from cilantro_tpu_torch.neighbors import fused_knn as fk
from cilantro_tpu_torch.neighbors import fused_nn as nn

INVALID = np.float32(3.0e38)
BELOW_INVALID = np.nextafter(INVALID, np.float32(0))
NO_POS = 0x7FFFFFFF
LANES = np.arange(32)


def _less(ad, ap, bd, bp):
    return (ad < bd) | ((ad == bd) & (ap < bp))


def _lane_cas(d, p, s, keep_min):
    od, op = d[LANES ^ s], p[LANES ^ s]
    take = np.where(keep_min, _less(od, op, d, p), _less(d, p, od, op))
    return np.where(take, od, d), np.where(take, op, p)


def _pair_cas(d, p, r, r2, up):
    swap = _less(d[r2], p[r2], d[r], p[r]) if up else _less(d[r], p[r], d[r2], p[r2])
    d[r], d[r2] = np.where(swap, d[r2], d[r]), np.where(swap, d[r], d[r2])
    p[r], p[r2] = np.where(swap, p[r2], p[r]), np.where(swap, p[r], p[r2])


def warp_sort(d, p):
    """``warp_sort<N>``: (N, 32) register-major pairs sorted ascending."""
    n = d.shape[0]
    size = 2
    while size <= 32 * n:
        s = size >> 1
        while s > 0:
            for r in range(n):
                if s >= 32:
                    r2 = r ^ (s >> 5)
                    if r2 > r:
                        _pair_cas(d, p, r, r2, ((r * 32) & size) == 0)
                else:
                    up = ((r * 32 + LANES) & size) == 0
                    d[r], p[r] = _lane_cas(d[r], p[r], s, ((LANES & s) == 0) == up)
            s >>= 1
        size <<= 1


def warp_merge(ld, lp, qd, qp):
    """``warp_merge<P, T>``: the 32·P smallest of list and queue, sorted."""
    n_list, n_queue = ld.shape[0], qd.shape[0]
    for r in range(n_list):
        j = n_list - 1 - r
        if j < n_queue:
            od, op = qd[j][LANES ^ 31], qp[j][LANES ^ 31]
            take = _less(od, op, ld[r], lp[r])
            ld[r], lp[r] = np.where(take, od, ld[r]), np.where(take, op, lp[r])
    s = 16 * n_list
    while s > 0:
        for r in range(n_list):
            if s >= 32:
                r2 = r ^ (s >> 5)
                if r2 > r:
                    _pair_cas(ld, lp, r, r2, True)
            else:
                ld[r], lp[r] = _lane_cas(ld[r], lp[r], s, (LANES & s) == 0)
        s >>= 1


class WarpQuery:
    """``WarpQuery<P, T>`` of one warp."""

    def __init__(self, k, lists, queue):
        self.k, self.lists, self.queue = k, lists, queue
        self.init_list()

    def init_list(self):
        self.ld = np.full((self.lists, 32), INVALID, np.float32)
        self.lp = np.zeros((self.lists, 32), np.int64)
        self.qd = np.zeros((self.queue, 32), np.float32)
        self.qi = np.zeros((self.queue, 32), np.int64)
        self.cnt = np.zeros(32, np.int64)
        self.bound = BELOW_INVALID

    def push(self, lanes, d, pos):
        self.qd[self.cnt[lanes], lanes] = d[lanes]
        self.qi[self.cnt[lanes], lanes] = pos[lanes]
        self.cnt[lanes] += 1

    def merge_if(self, above):
        if not (self.cnt > above).any():
            return
        slot = np.arange(self.queue)[:, None]
        self.qd = np.where(slot < self.cnt, self.qd, np.float32(np.inf))
        self.qi = np.where(slot < self.cnt, self.qi, NO_POS)
        warp_sort(self.qd, self.qi)
        warp_merge(self.ld, self.lp, self.qd, self.qi)
        self.cnt[:] = 0
        kth = self.ld[(self.k - 1) >> 5, (self.k - 1) & 31]
        self.bound = kth if kth < INVALID else BELOW_INVALID

    def result(self):
        return self.ld.reshape(-1)[: self.k], self.lp.reshape(-1)[: self.k]


def _dist_rows(q_row, keys):
    """The kernel's 8-term sums of one query against ``keys`` (NaN rows
    included), in float32 left to right."""
    return nn._aug_dist(torch.from_numpy(q_row[None]), torch.from_numpy(keys))[0].numpy()


def model_full_warp(qp, kp, k, diag, splits=1, stage=fk._WARP_STAGE):
    """``knn_full_warp_kernel`` for every query row: ``(dist, idx)``."""
    slots, queue = fk._warp_lists(k)
    keys_a_step = fk._WARP_KEYS
    lists, step = slots // 32, 32 * keys_a_step
    n_keys = kp.shape[0]
    split_len = stage * -(-(-(-n_keys // splits)) // stage)
    out_d = np.zeros((qp.shape[0], k), np.float32)
    out_i = np.zeros((qp.shape[0], k), np.int64)
    for row in range(qp.shape[0]):
        parts = []
        for y in range(splits):
            w = WarpQuery(k, lists, queue)
            k0 = y * split_len
            length = min(split_len, n_keys - k0)
            for s0 in range(0, max(length, 0), stage):
                n = min(stage, length - s0)
                n_pad = -(-n // step) * step
                staged = np.full((n_pad, 8), np.nan, np.float32)
                staged[:n] = kp[k0 + s0 : k0 + s0 + n]
                d_all = _dist_rows(qp[row], staged)
                pos0 = k0 + s0
                on_diag = diag and pos0 <= row < pos0 + n
                for m in range(0, n_pad, step):
                    w.merge_if(queue - keys_a_step)
                    for u in range(keys_a_step):
                        j = m + 32 * u + LANES
                        pos = pos0 + j
                        ok = d_all[j] <= w.bound
                        if on_diag:
                            ok &= pos != row
                        w.push(np.flatnonzero(ok), d_all[j], pos)
            w.merge_if(0)
            parts.append(w.result())
        if splits == 1:
            out_d[row], out_i[row] = parts[0]
            continue
        w = WarpQuery(k, lists, queue)
        k_pad = -(-k // step) * step
        for pd, pi in parts:
            for j0 in range(0, k_pad, step):
                w.merge_if(queue - keys_a_step)
                for u in range(keys_a_step):
                    j = j0 + 32 * u + LANES
                    inside = j < k
                    d = np.where(inside, pd[np.minimum(j, k - 1)], np.float32(np.nan))
                    pos = pi[np.minimum(j, k - 1)]
                    w.push(np.flatnonzero(inside & (d <= w.bound)), d, pos)
        w.merge_if(0)
        out_d[row], out_i[row] = w.result()
    return out_d, out_i


def _operands(seed, qn, mn, same_cloud=False, grid=False, invalid_queries=False):
    """Augmented rows as in the card tests: exact copies (distance-0 ties),
    repeated keys (index ties), 10% masked keys, optional queries at 1e30.
    ``same_cloud``: the queries are the first ``qn`` keys (query i is key
    i, so the diagonal is the self pairs)."""
    rng = np.random.default_rng(seed)
    if grid:
        k = rng.integers(0, 4, (mn, 3)).astype(np.float32)
        q = rng.integers(0, 4, (qn, 3)).astype(np.float32)
    else:
        k = rng.uniform(-0.5, 0.5, (mn, 3)).astype(np.float32)
        q = rng.uniform(-0.5, 0.5, (qn, 3)).astype(np.float32)
    k[mn // 2 : mn // 2 + 20] = k[:20]
    if same_cloud:
        q = k[:qn].copy()
    else:
        k[: qn // 2] = q[: qn // 2]
    if invalid_queries:
        q[rng.random(qn) < 0.3] = 1e30
    kv = torch.from_numpy(rng.random(mn) < 0.9)
    return nn._augment(torch.from_numpy(q), torch.from_numpy(k), kv, 1, 1)


@pytest.mark.parametrize(
    "k,diag,splits,stage,kind",
    [
        (1, False, 1, 1024, "random"),
        (12, True, 1, 64, "random"),
        (12, False, 2, 64, "random"),
        (32, False, 2, 64, "grid"),
        (33, True, 1, 1024, "grid"),
        (33, False, 3, 64, "random"),
        (65, True, 2, 128, "random"),
        (200, False, 1, 1024, "invalid"),
        (513, True, 1, 1024, "random"),
    ],
)
def test_warp_model_matches_plain(k, diag, splits, stage, kind):
    """Every list size from 32 to 1,024 slots (k = 513 has 1,024), queues
    of 4 and 8 pairs, one stage or several (a 64-key stage is one or two
    steps), splits of 2-3 and the tie-heavy 4-point grid; the diagonal with
    the query rows inside the staged range."""
    qn, mn = (5, 900) if k > 64 else (6, 300)
    qp, kp = _operands(k, qn, mn, same_cloud=diag, grid=kind == "grid", invalid_queries=kind == "invalid")
    got = model_full_warp(qp.numpy(), kp.numpy(), k, diag, splits, stage)
    want = fk.knn_full_rows_plain(qp, kp, k, diag)
    np.testing.assert_array_equal(got[0].view(np.int32), want[0].numpy().view(np.int32))
    np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("n_queue", [1, 4, 8])
def test_warp_sort_and_merge_networks(n_queue):
    """The two networks alone on random pairs with repeated distances: the
    sort gives the pair order, and the merge the 32·P smallest of list and
    queue, for queues shorter, as long and longer than the list."""
    rng = np.random.default_rng(n_queue)
    d = rng.integers(0, 40, (n_queue, 32)).astype(np.float32)
    p = rng.permutation(32 * n_queue).reshape(n_queue, 32).astype(np.int64)
    sd, sp = d.copy(), p.copy()
    warp_sort(sd, sp)
    order = np.lexsort((p.T.reshape(-1), d.T.reshape(-1)))
    flat_d, flat_p = d.T.reshape(-1)[order], p.T.reshape(-1)[order]
    np.testing.assert_array_equal(sd.reshape(-1), flat_d)
    np.testing.assert_array_equal(sp.reshape(-1), flat_p)
    for n_list in (1, 2, 4):
        ld = np.sort(rng.integers(0, 40, 32 * n_list)).astype(np.float32)
        lp = 1000 + np.arange(32 * n_list)
        md, mp = ld.reshape(n_list, 32).copy(), lp.reshape(n_list, 32).copy()
        warp_merge(md, mp, sd, sp)
        both_d, both_p = np.concatenate([ld, flat_d]), np.concatenate([lp, flat_p])
        keep = np.lexsort((both_p, both_d))[: 32 * n_list]
        np.testing.assert_array_equal(md.reshape(-1), both_d[keep])
        np.testing.assert_array_equal(mp.reshape(-1), both_p[keep])


# The cases that decide the route (PERF.md §6, phase 40): (query rows, key rows,
# k) as the paths call the kernel, and the design the route gives them.
ROUTE_CASES = {
    "a: mean shift merge, 1,200 modes": ((1200, 1200, 33), "warp"),
    "b: mean shift, capped path": ((1200, 1200, 513), "warp"),
    "c: kd_tree radius search": ((2000, 120000, 33), "warp"),
    "d: spectral_and_components rings": ((600, 600, 12), "warp"),
    "e: dryrun ICP pair": ((16, 16, 4), "warp"),
    "f: random 4096, k = 33": ((4096, 4096, 33), "warp"),
    "f: random 4096, k = 65": ((4096, 4096, 65), "warp"),
    "f: random 4096, k = 200": ((4096, 4096, 200), "warp"),
    "g: phase 16, 7,968 points": ((7968, 7968, 12), "thread"),
    "g: random 4096, k = 1": ((4096, 4096, 1), "thread"),
    "g: random 4096, k = 12": ((4096, 4096, 12), "thread"),
    "h: spectral graph, 30,000 points": ((30000, 30000, 12), "thread"),
    "h: kd_tree kNN": ((2000, 120000, 5), "thread"),
    "h: robust_normals": ((4000, 4000, 24), "warp"),
    "h: batched_serving": ((512, 341, 8), "warp"),
    "past the register lists": ((1200, 1200, 1025), "thread"),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_of_the_deciding_cases(case):
    (nq, nk, k), design = ROUTE_CASES[case]
    plan = fk._full_plan(nq, nk, k, 132)
    assert plan["design"] == design
    reported = fk.kernel_design("knn_full", nq, nk, k, sms=132)
    assert reported["design"] == design and reported["blocks"] == plan["blocks"]
    if design == "warp":
        per_block = fk._WARPS_LONG if nk >= fk._WARP_LONG_KEYS else fk._WARPS
    else:
        per_block = fk._FULL_BLOCK
    assert plan["queries_per_block"] == per_block
    assert plan["blocks"] == -(-nq // per_block) * plan["splits"]
    assert plan["splits"] * plan["keys_per_split"] >= nk > (plan["splits"] - 1) * plan["keys_per_split"]


def test_route_depends_on_shapes_alone():
    """Each side of every threshold the route uses: k = 32 | 33 on a grid
    the thread design fills, k = 1,024 | 1,025, the thread design's grid
    one block under and at ``_THREAD_BLOCKS_PER_SM`` blocks an SM, and the
    warp design's blocks on each side of ``_WARP_LONG_KEYS`` keys."""
    sms = 132
    assert fk._full_plan(4096, 4096, 32, sms)["design"] == "thread"
    assert fk._full_plan(4096, 4096, 33, sms)["design"] == "warp"
    assert fk._full_plan(4096, 4096, 1024, sms)["design"] == "warp"
    assert fk._full_plan(4096, 4096, 1025, sms)["design"] == "thread"
    # One key split (keys < 2 stages): the grid is the query blocks alone.
    least = fk._THREAD_BLOCKS_PER_SM * sms
    at = fk._FULL_BLOCK * least
    assert fk._full_plan(at, 1000, 12, sms)["design"] == "thread"
    assert fk._full_plan(at - fk._FULL_BLOCK, 1000, 12, sms)["design"] == "warp"
    # The warp design's blocks: 8 warps from a walk of 2,048 keys on.
    assert fk._full_plan(600, fk._WARP_LONG_KEYS - 1, 40, sms)["queries_per_block"] == fk._WARPS
    assert fk._full_plan(600, fk._WARP_LONG_KEYS, 40, sms)["queries_per_block"] == fk._WARPS_LONG
    for design in ("thread", "warp"):
        assert fk._full_plan(600, 600, 12, sms, design=design)["design"] == design
    with pytest.raises(ValueError, match="no design"):
        fk._full_plan(600, 600, 1025, sms, design="warp")
