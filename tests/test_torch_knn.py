"""The port's kNN engines (``cilantro_tpu_torch/neighbors/fused_knn.py`` and
``bruteforce.knn``) against ``cilantro_tpu/neighbors/`` on the CPU, the
Pallas kernels in interpret mode at the sizes of ``tests/test_pallas_nn.py``.

Tolerances. Both packages sum the same augmented terms, JAX through a
matrix product in another order, so a squared distance differs by float32
rounding of ‖q‖² + ‖k‖² − 2q·k: distances are held to ``4e-6 · max(1,
‖q‖²)`` (a few float32 ulps of the largest term). Indices must be equal,
except where the two answers are a tie within that tolerance in float64 (a
near tie may swap places, or swap the k-th member of the set). Hit masks,
overflow flags and the selection helpers are exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cilantro_tpu.neighbors import bruteforce as jbf
from cilantro_tpu.neighbors import pallas_nn as jnn
from cilantro_tpu_torch import native
from cilantro_tpu_torch.neighbors import bruteforce as tbf
from cilantro_tpu_torch.neighbors import fused_knn as tk
from cilantro_tpu_torch.neighbors import fused_nn as tnn

INVALID = 3.0e38


def _t(a):
    return torch.from_numpy(np.array(a))


def _tol(q):
    q = np.asarray(q, np.float64)
    ok = np.abs(q).max(axis=1) < 1e29
    return 4e-6 * max(1.0, float((q[ok] ** 2).sum(1).max()) if ok.any() else 1.0)


def _assert_knn_close(q, k, d_port, i_port, d_jax, i_jax):
    """Hit masks equal; distances within :func:`_tol`; a differing index
    only where both keys lie within that tolerance of each other's true
    (float64) distance."""
    d_port, i_port = np.asarray(d_port), np.asarray(i_port)
    d_jax, i_jax = np.asarray(d_jax), np.asarray(i_jax)
    assert d_port.shape == d_jax.shape
    hit = d_jax < INVALID * 0.5
    np.testing.assert_array_equal(d_port < INVALID * 0.5, hit)
    atol = _tol(q)
    np.testing.assert_allclose(d_port[hit], d_jax[hit], rtol=0, atol=atol)
    rows, cols = np.nonzero(hit & (i_port != i_jax))
    q64, k64 = np.asarray(q, np.float64), np.asarray(k, np.float64)
    dp = np.sum((q64[rows] - k64[i_port[rows, cols]]) ** 2, axis=1)
    dj = np.sum((q64[rows] - k64[i_jax[rows, cols]]) ** 2, axis=1)
    assert np.all(np.abs(dp - dj) <= 2 * atol), f"{len(rows)} differing indices, not all ties"


def _clouds(seed, qn, mn):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-0.5, 0.5, (qn, 3)).astype(np.float32)
    k = rng.uniform(-0.5, 0.5, (mn, 3)).astype(np.float32)
    k[: mn // 10] = q[: mn // 10]  # exact matches: distance-0 ties
    return rng, q, k


def _padded(a, rows):
    out = np.zeros((rows, a.shape[1]), np.float32)
    out[: len(a)] = a
    return out


# ---------------------------------------------------------------------------
# The plain versions of kernels 8 and 9 against the interpret-mode kernels.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "seed,k,diag,valid_share", [(0, 1, False, 0.9), (1, 12, False, 0.9), (2, 12, True, 0.9), (3, 9, False, 0.01)]
)
def test_full_plain_matches_pallas(seed, k, diag, valid_share):
    """``valid_share`` 0.01 leaves fewer valid keys than k."""
    rng, q, keys = _clouds(seed, 300, 700)
    if diag:
        keys = q.copy()
    kv = rng.random(len(keys)) < valid_share
    qp, kp = jnn._augment(jnp.asarray(q), jnp.asarray(keys), jnp.asarray(kv), 128, 256)
    dj, ij = jnn._knn_pallas_full(
        qp, kp, k=k, tile_q=128, tile_m=256, exclude_diag=diag, interpret=True
    )
    dt, it = tk.knn_full_rows(_t(qp), _t(kp), k=k, exclude_diag=diag)
    _assert_knn_close(_padded(q, qp.shape[0]), _padded(keys, kp.shape[0]), dt, it, dj, ij)
    assert dt.dtype == torch.float32 and it.dtype == torch.int32


@pytest.mark.parametrize("budget,diag", [("roomy", False), ("roomy", True), ("overflow", False)])
def test_compact_plain_matches_pallas(budget, diag):
    """The compact wrapper (list, kernel or full fallback) against JAX's;
    every query tile names at least one key chunk (JAX leaves the others
    undefined)."""
    rng, q, keys = _clouds(4, 500, 700)
    if diag:
        keys = q.copy()[:500]
    kv = rng.random(len(keys)) < 0.9
    qp, kp = jnn._augment(jnp.asarray(q), jnp.asarray(keys), jnp.asarray(kv), 128, 256)
    n_qt, n_mt = qp.shape[0] // 128, kp.shape[0] // 256
    mask = rng.random((n_qt, n_mt)) < 0.5
    mask[np.arange(n_qt), rng.integers(0, n_mt, n_qt)] = True
    count = int(mask.sum())
    b = {"roomy": mask.size, "overflow": count - 1}[budget]
    dj, ij = jnn._knn_pallas_compact(
        qp, kp, jnp.asarray(mask), k=10, budget=b, tile_q=128, tile_m=256,
        exclude_diag=diag, interpret=True,
    )
    native.reset_launch_counts()
    dt, it = tk._knn_compact(_t(qp), _t(kp), _t(mask), k=10, budget=b, tile_q=128, tile_m=256,
                             exclude_diag=diag)
    _assert_knn_close(_padded(q, qp.shape[0]), _padded(keys, kp.shape[0]), dt, it, dj, ij)
    assert sum(native.launch_counts.values()) == 0  # CPU tensors: plain versions


def _tie_case(name):
    """Augmented ``(qp, kp, k, exclude_diag)`` of one bit-exactness case
    (256 query rows, 512 key rows, tiles 128/128): ``random`` points with
    exact copies, ``duplicates`` (every point four times: whole groups of
    equal distances), ``grid`` (integer grid points: equal distances
    everywhere, across every split), ``diag`` (one cloud, the diagonal
    excluded), ``masked`` (40% of the keys at 3e38), ``nan_rows`` (queries
    at 1e30: inf and NaN sums) and ``few_valid`` (3 valid keys, k = 9)."""
    rng = np.random.default_rng(11)
    q = rng.uniform(-0.5, 0.5, (256, 3)).astype(np.float32)
    keys = rng.uniform(-0.5, 0.5, (512, 3)).astype(np.float32)
    keys[:60] = q[:60]
    kv, k, diag = None, 7, False
    if name == "duplicates":
        keys = np.repeat(keys[:128], 4, axis=0)
        q = keys[::2].copy()
    elif name == "grid":
        q = rng.integers(0, 5, (256, 3)).astype(np.float32)
        keys = rng.integers(0, 5, (512, 3)).astype(np.float32)
        k = 12
    elif name == "diag":
        keys = np.concatenate([q, q[::-1]])
        diag = True
    elif name == "masked":
        kv = rng.random(512) < 0.6
    elif name == "nan_rows":
        q[rng.random(256) < 0.3] = 1e30
    elif name == "few_valid":
        kv = np.zeros(512, bool)
        kv[[3, 200, 400]] = True
        k = 9
    qp, kp = tnn._augment(_t(q), _t(keys), None if kv is None else _t(kv), 128, 128)
    return qp, kp, k, diag


def _reference_topk(qp, kp, k, diag):
    """The invariant, stated directly: per query row, the k
    lexicographically smallest ``(sum, position)`` pairs of the plain 8-term
    sums, a NaN sum, a sum >= 3e38 and (with ``diag``) the row's own
    position left out, ``(3e38, 0)`` in the slots no key fills."""
    sums = tnn._aug_dist(qp, kp).numpy()
    pos = np.broadcast_to(np.arange(sums.shape[1]), sums.shape)
    out = ~(sums < INVALID)
    if diag:
        out |= pos == np.arange(sums.shape[0])[:, None]
    d = np.full((sums.shape[0], k), INVALID, np.float32)
    i = np.zeros((sums.shape[0], k), np.int32)
    for r in range(sums.shape[0]):
        keep = np.flatnonzero(~out[r])
        order = keep[np.lexsort((keep, sums[r, keep]))][:k]
        d[r, : len(order)], i[r, : len(order)] = sums[r, order], order
    return d, i


def _lex_fold(parts, k):
    """Fold partial ``(dist, idx)`` lists, in the given order, into k slots
    starting from ``(3e38, 0)``, comparing ``(distance, position)`` pairs:
    what the kernels' merges do. A pair not below 3e38 never enters."""
    d = np.full((parts[0][0].shape[0], k), INVALID, np.float32)
    i = np.zeros(d.shape, np.int32)
    for pd, pi in parts:
        pd, pi = np.asarray(pd), np.asarray(pi)
        cd, ci = np.concatenate([d, pd], 1), np.concatenate([i, pi], 1)
        cd = np.where(cd < INVALID, cd, INVALID)
        ci = np.where(cd < INVALID, ci, 0)
        order = np.lexsort((ci, cd), axis=1)[:, :k]
        d, i = np.take_along_axis(cd, order, 1), np.take_along_axis(ci, order, 1)
    return d, i


CASES = ["random", "duplicates", "grid", "diag", "masked", "nan_rows", "few_valid"]


@pytest.mark.parametrize("name", CASES)
def test_plain_versions_agree_bit_for_bit(name):
    """On a full pair list the compact plain version gives the full one's
    bits, and both equal a float64-free reference: the k smallest (sum,
    position) pairs of the plain 8-term sums."""
    qp, kp, k, diag = _tie_case(name)
    full = torch.ones((2, 4), dtype=torch.bool)
    lst = tnn._compact_list(full, 8)
    df, i_f = tk.knn_full_rows(qp, kp, k=k, exclude_diag=diag)
    dc, ic = tk.knn_compact_rows(qp, kp, *lst, k=k, tile_q=128, tile_m=128, exclude_diag=diag)
    assert torch.equal(dc.view(torch.int32), df.view(torch.int32)) and torch.equal(ic, i_f)
    d_ref, i_ref = _reference_topk(qp, kp, k, diag)
    np.testing.assert_array_equal(i_f.numpy(), i_ref)
    np.testing.assert_array_equal(df.numpy().view(np.int32), d_ref.view(np.int32))


def _only_keys(kp, lo, hi):
    """``kp`` with every key outside ``[lo, hi)`` masked (3e38 in its ‖k‖²
    slot), so that a search over it visits that range at its own
    positions."""
    out = kp.clone()
    out[:lo, 4] = INVALID
    out[hi:, 4] = INVALID
    return out


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("cuts", [(256,), (100, 384), (1, 128, 129, 511), (50, 60, 300, 301, 450)])
def test_split_then_merge_is_the_unsplit_result(name, cuts):
    """The key range split at ``cuts``, each piece searched on its own (the
    full plain version over the piece), the partial lists folded by pairs in
    ascending and in reversed order: both equal the unsplit search bit for
    bit. So do the compact plain version's chunks visited one at a time in
    reversed order. This is what lets the full kernel split its key range
    across blocks and the compact kernel visit chunks nearest first."""
    qp, kp, k, diag = _tie_case(name)
    want_d, want_i = (t.numpy() for t in tk.knn_full_rows(qp, kp, k=k, exclude_diag=diag))
    edges = (0, *cuts, kp.shape[0])
    parts = [tk.knn_full_rows_plain(qp, _only_keys(kp, a, b), k, diag) for a, b in zip(edges, edges[1:])]
    for order in (parts, parts[::-1]):
        d, i = _lex_fold(order, k)
        np.testing.assert_array_equal(i, want_i)
        np.testing.assert_array_equal(d.view(np.int32), want_d.view(np.int32))
    chunks = []
    for c in reversed(range(kp.shape[0] // 128)):
        one = torch.zeros((2, 4), dtype=torch.bool)
        one[:, c] = True
        lst = tnn._compact_list(one, 8)
        chunks.append(tk.knn_compact_rows(qp, kp, *lst, k=k, tile_q=128, tile_m=128, exclude_diag=diag))
    d, i = _lex_fold(chunks, k)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_array_equal(d.view(np.int32), want_d.view(np.int32))


def test_tie_heavy_plain_matches_pallas():
    """Integer-grid points against JAX's interpret-mode full kernel: equal
    distances everywhere, so indices may differ only between keys tied
    within float32 rounding."""
    rng = np.random.default_rng(12)
    q = rng.integers(0, 5, (300, 3)).astype(np.float32)
    keys = rng.integers(0, 5, (700, 3)).astype(np.float32)
    kv = rng.random(700) < 0.9
    qp, kp = jnn._augment(jnp.asarray(q), jnp.asarray(keys), jnp.asarray(kv), 128, 256)
    dj, ij = jnn._knn_pallas_full(qp, kp, k=12, tile_q=128, tile_m=256, interpret=True)
    dt, it = tk.knn_full_rows(_t(qp), _t(kp), k=12)
    _assert_knn_close(_padded(q, qp.shape[0]), _padded(keys, kp.shape[0]), dt, it, dj, ij)


@pytest.mark.parametrize("shuffle_dead", [False, True])
def test_compact_work_items_cover_each_live_chunk_once(shuffle_dead):
    """The compact kernel's work (``_compact_items``, plain tensor code):
    every live chunk of every tile falls to exactly one part of each of the
    tile's query blocks, parts as the kernel deals them (the n-th chunk of
    the run to part n % parts), long runs split into parts of at most
    ``_PART_KEYS`` keys, longest runs first, every tile at least once. The
    split items come first and fit the partial rows, the real ones fit the
    grid sized from the live count, and dead entries anywhere in the list
    (``shuffle_dead``: spread among the live ones) are never visited."""
    rng = np.random.default_rng(13)
    n_qt, n_mt, tile_q, tile_m = 6, 200, 512, 128
    mask = torch.from_numpy(rng.random((n_qt, n_mt)) < 0.3)
    mask[2] = True  # 200 chunks of 128 keys: two parts
    mask[4] = False  # no live chunk: one item keeps the starting state
    live = int(mask.sum())
    qt, kt, flags = tnn._compact_list(mask, mask.numel())
    if shuffle_dead:
        # Dead entries naming other tiles and chunks between the live ones.
        pick = torch.from_numpy(np.sort(rng.permutation(mask.numel())[:live]))
        flags = torch.where(torch.isin(torch.arange(mask.numel()), pick), 2, 0).to(torch.int32)
        qt_all = torch.full((mask.numel(),), -7, dtype=torch.int32)
        kt_all = torch.from_numpy(rng.integers(0, n_mt, mask.numel()).astype(np.int32))
        qt_all[pick], kt_all[pick] = qt[:live], kt[:live]
        qt, kt = qt_all, kt_all
    kt_live, starts, items, rows, split_items = tk._compact_items(qt, kt, flags, n_qt, tile_q, tile_m, live)
    assert rows == 256
    real = items[items[:, 0] >= 0].tolist()
    assert items[: len(real), 0].min() >= 0  # the spare items come last
    split = [parts > 1 for *_, parts in real]
    assert split == sorted(split, reverse=True) and sum(split) <= split_items
    seen = {}
    for tile, sub, part, parts in real:
        run = kt_live[starts[tile] : starts[tile + 1]].tolist()
        assert parts == max(1, -(-len(run) // (tk._PART_KEYS // tile_m)))
        for n, c in enumerate(run):
            if n % parts == part:
                seen.setdefault((tile, sub), []).append(c)
    for tile in range(n_qt):
        for sub in range(tile_q // rows):
            assert sorted(seen.get((tile, sub), [])) == np.flatnonzero(mask[tile].numpy()).tolist()
    runs = [int(starts[t + 1] - starts[t]) for t, *_ in real]
    assert runs == sorted(runs, reverse=True) and max(p for *_, p in real) == 2


@pytest.mark.parametrize("n_queries,n_keys,k", [(128, 8192, 12), (8192, 8192, 12), (4096, 4096, 65), (307200, 307200, 12), (256, 100, 3)])
def test_full_kernel_splits_cover_the_keys(n_queries, n_keys, k):
    """The full kernel's key splits: whole stages, at least 16·k keys each
    where there are that many, every key in exactly one split, more
    splits only while the grid is short of blocks."""
    splits, length = tk._full_splits(n_queries, n_keys, k, 132)
    assert length % 512 == 0 and (splits - 1) * length < n_keys <= splits * length
    assert splits == 1 or length >= 16 * k
    assert splits == 1 or (n_queries // 128) * (splits - 1) < 4 * 132


def test_wrappers_check_their_operands():
    qp, kp = torch.zeros((256, 8)), torch.zeros((512, 8))
    with pytest.raises(ValueError, match="at least 1"):
        tk.knn_full_rows(qp, kp, k=0)
    with pytest.raises(TypeError, match="dtype"):
        tk.knn_full_rows(qp.double(), kp, k=3)
    lst = tnn._compact_list(torch.ones((2, 2), dtype=torch.bool), 4)
    with pytest.raises(ValueError, match="multiples"):
        tk.knn_compact_rows(qp, kp, *lst, k=3, tile_q=96, tile_m=256)


def test_drop_self_slot_matches_jax():
    rng = np.random.default_rng(6)
    qn, kk = 50, 5
    d = np.sort(rng.uniform(0, 1, (qn, kk + 1)).astype(np.float32), axis=1)
    i = rng.integers(0, qn, (qn, kk + 1)).astype(np.int32)
    i[::3, 2] = np.arange(qn)[::3]  # self hits in slot 2
    d[::7, 4:] = INVALID  # misses
    want = jnn._drop_self_slot(jnp.asarray(d), jnp.asarray(i), kk)
    got = tk._drop_self_slot(_t(d), _t(i), kk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# The engines around the kernels.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_fused_matches_knn_pallas(exclude_self):
    rng, q, keys = _clouds(7, 300, 300)
    if exclude_self:
        keys = q
    qv = rng.random(300) < 0.9
    kv = rng.random(300) < 0.8
    args = dict(query_valid=qv, key_valid=kv, tile_q=128, tile_m=256, exclude_self=exclude_self)
    dj, ij = jnn.knn_pallas(jnp.asarray(q), jnp.asarray(keys), 11, interpret=True,
                            **{n: jnp.asarray(v) if isinstance(v, np.ndarray) else v for n, v in args.items()})
    dt, it = tk.knn_fused(_t(q), _t(keys), 11, **{n: _t(v) if isinstance(v, np.ndarray) else v
                                                  for n, v in args.items()})
    _assert_knn_close(q, keys, dt, it, dj, ij)


def _surface(rng):
    g = np.linspace(-0.2, 0.2, 45)
    gx, gy = np.meshgrid(g, g)
    gz = 1.5 + 0.05 * np.sin(10 * gx) * np.cos(8 * gy)
    pts = np.column_stack([gx.ravel(), gy.ravel(), gz.ravel()]).astype(np.float32)
    q = (pts[::2] + rng.normal(0, 1e-3, pts[::2].shape)).astype(np.float32)
    return q, pts


def _pruned_case(name):
    """(queries, keys, k, kwargs) of one knn_pruned case."""
    rng = np.random.default_rng(8)
    if name == "surface":  # the density guess's home: a sheet 1.5 m away
        q, pts = _surface(rng)
        return q, pts, 5, {}
    pts = rng.uniform(-1, 1, (1500, 3)).astype(np.float32)
    # The volume cases pass a key mask, so that they share one compiled
    # JAX program.
    kv = np.ones(1500, bool)
    if name == "volume":  # the surface guess under-shoots: more rounds
        return rng.uniform(-1, 1, (400, 3)).astype(np.float32), pts, 8, {"key_valid": kv}
    if name == "few_valid_keys":  # 3 valid keys, k = 8: covered tiles resolve
        kv[:] = False
        kv[[10, 700, 1200]] = True
        return rng.uniform(-1, 1, (400, 3)).astype(np.float32), pts, 8, {"key_valid": kv}
    # exclude_self with query_valid != key_valid: one shared permutation.
    pts = pts[:300] * 0.5
    qv, kv = rng.random(300) < 0.7, rng.random(300) < 0.6
    qv[:5] = kv[:5] = True
    return pts, pts, 4, {"query_valid": qv, "key_valid": kv, "exclude_self": True}


@pytest.mark.parametrize("name", ["surface", "volume", "few_valid_keys", "self_mismatched_masks"])
def test_knn_pruned_matches_jax(name):
    q, keys, k, kw = _pruned_case(name)
    jkw = {n: jnp.asarray(v) if isinstance(v, np.ndarray) else v for n, v in kw.items()}
    tkw = {n: _t(v) if isinstance(v, np.ndarray) else v for n, v in kw.items()}
    dj, ij = jnn.knn_pruned(jnp.asarray(q), jnp.asarray(keys), k, tile_q=128, tile_m=256,
                            interpret=True, **jkw)
    dt, it = tk.knn_pruned(_t(q), _t(keys), k, tile_q=128, tile_m=256, **tkw)
    _assert_knn_close(q, keys, dt, it, dj, ij)
    if kw.get("exclude_self"):
        hit = dt.numpy() < INVALID * 0.5
        assert not np.any((it.numpy() == np.arange(len(q))[:, None]) & hit)


def test_knn_pruned_safety_net_matches_jax(monkeypatch):
    """One radius-doubling round on the volume cloud, whose first radius
    under-guesses: the queries still unresolved get the full-kernel pass,
    as JAX's ``knn_pruned(..., max_rounds=1)`` gives them."""
    q, keys, k, kw = _pruned_case("volume")
    full_calls = []
    full = tk.knn_full_rows
    monkeypatch.setattr(tk, "knn_full_rows", lambda *a, **kw: full_calls.append(1) or full(*a, **kw))
    dj, ij = jnn.knn_pruned(jnp.asarray(q), jnp.asarray(keys), k, tile_q=128, tile_m=256,
                            max_rounds=1, interpret=True, key_valid=jnp.asarray(kw["key_valid"]))
    dt, it = tk.knn_pruned(_t(q), _t(keys), k, tile_q=128, tile_m=256, max_rounds=1,
                           key_valid=_t(kw["key_valid"]))
    assert full_calls == [1]  # the budget holds every pair: only the safety net ran it
    _assert_knn_close(q, keys, dt, it, dj, ij)


@pytest.mark.parametrize("init_radius,full_pass", [(0.05, True), (1.0, False)])
def test_knn_pruned_init_radius_matches_jax(monkeypatch, init_radius, full_pass):
    """``init_radius`` replaces the density guess (and sizes the Morton
    cells) as in JAX: on the volume cloud with one round, 0.05 under-guesses
    (the safety net's full pass finishes the search) and 1.0 resolves every
    query in the round. The radius is traced in JAX, so both cases share
    one compiled program."""
    q, keys, k, kw = _pruned_case("volume")
    full_calls = []
    full = tk.knn_full_rows
    monkeypatch.setattr(tk, "knn_full_rows", lambda *a, **kw: full_calls.append(1) or full(*a, **kw))
    dj, ij = jnn.knn_pruned(jnp.asarray(q), jnp.asarray(keys), k, init_radius=init_radius, tile_q=128,
                            tile_m=256, max_rounds=1, interpret=True, key_valid=jnp.asarray(kw["key_valid"]))
    dt, it = tk.knn_pruned(_t(q), _t(keys), k, init_radius=init_radius, tile_q=128, tile_m=256, max_rounds=1,
                           key_valid=_t(kw["key_valid"]))
    assert full_calls == ([1] if full_pass else [])
    _assert_knn_close(q, keys, dt, it, dj, ij)


def test_knn_pruned_exclude_self_needs_one_cloud():
    with pytest.raises(ValueError, match="exclude_self"):
        tk.knn_pruned(torch.zeros((128, 3)), torch.zeros((256, 3)), 3, exclude_self=True)


@pytest.mark.parametrize("exclude_self,cap,radius", [(False, 8, 0.04), (True, 6, 0.04), (False, 8, 0.03)])
def test_radius_search_pruned_matches_jax(exclude_self, cap, radius):
    """Overflow flags exactly; the capped sets as kNN sets. At 0.03 every
    ball holds at most 5 keys, so the probe slot stays beyond them (no
    overflow); the radius is traced, so that case reuses the first one's
    compiled JAX program."""
    rng = np.random.default_rng(9)
    keys = rng.uniform(-0.2, 0.2, (1200, 3)).astype(np.float32)
    q = keys[:800] if exclude_self else rng.uniform(-0.2, 0.2, (500, 3)).astype(np.float32)
    if exclude_self:
        keys = q
    kv = rng.random(len(keys)) < 0.9
    dj, ij, oj = jnn.radius_search_pruned(
        jnp.asarray(q), jnp.asarray(keys), radius, cap, key_valid=jnp.asarray(kv),
        exclude_self=exclude_self, tile_q=128, tile_m=128, interpret=True,
    )
    dt, it, ot = tk.radius_search_pruned(
        _t(q), _t(keys), radius, cap, key_valid=_t(kv), exclude_self=exclude_self,
        tile_q=128, tile_m=128,
    )
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert bool(ot.any()) == (radius == 0.04)
    _assert_knn_close(q, keys, dt, it, dj, ij)


@pytest.mark.parametrize("metric,dim", [("l2", 3), ("l2", 6), ("l1", 3), ("so2", 1), ("so3", 4)])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_knn_tiled_matches_knn_xla(metric, dim, exclude_self):
    """On the CPU both packages' ``knn`` take the tiled scan (``_knn_xla``),
    here at 128/512 tiles: 2 query tiles, 3 key tiles without
    ``exclude_self``."""
    rng = np.random.default_rng(10)
    q = rng.uniform(-1, 1, (200, dim)).astype(np.float32)
    k = q if exclude_self else rng.uniform(-1, 1, (1200, dim)).astype(np.float32)
    if metric == "so3":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        k = q if exclude_self else k / np.linalg.norm(k, axis=1, keepdims=True)
    kv = rng.random(len(k)) < 0.8
    qv = rng.random(200) < 0.9
    kw = dict(query_valid=qv, key_valid=kv, metric=metric, exclude_self=exclude_self,
              tile_q=128, tile_m=512)
    dj, ij = jbf.knn(jnp.asarray(q), jnp.asarray(k), 9,
                     **{n: jnp.asarray(v) if isinstance(v, np.ndarray) else v for n, v in kw.items()})
    dt, it = tbf.knn(_t(q), _t(k), 9, **{n: _t(v) if isinstance(v, np.ndarray) else v for n, v in kw.items()})
    dj, ij = np.asarray(dj), np.asarray(ij)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=_tol(q))
    assert (it.numpy() == ij)[qv].mean() > 0.99  # near ties may swap
