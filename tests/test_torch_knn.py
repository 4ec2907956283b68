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
    tk.reset_launch_counts()
    dt, it = tk._knn_compact(_t(qp), _t(kp), _t(mask), k=10, budget=b, tile_q=128, tile_m=256,
                             exclude_diag=diag)
    _assert_knn_close(_padded(q, qp.shape[0]), _padded(keys, kp.shape[0]), dt, it, dj, ij)
    assert sum(tk.launch_counts.values()) == 0  # CPU tensors: plain versions


def test_plain_versions_agree_bit_for_bit():
    """On a full pair list the compact plain version gives the full one's
    bits, and both equal a float64-free reference: the k smallest (sum,
    position) pairs of the plain 8-term sums."""
    _, q, keys = _clouds(5, 256, 512)
    qp, kp = tnn._augment(_t(q), _t(keys), None, 128, 256)
    full = torch.ones((2, 2), dtype=torch.bool)
    lst = tnn._compact_list(full, 4)
    df, i_f = tk.knn_full_rows(qp, kp, k=7)
    dc, ic = tk.knn_compact_rows(qp, kp, *lst, k=7, tile_q=128, tile_m=256)
    assert torch.equal(dc.view(torch.int32), df.view(torch.int32)) and torch.equal(ic, i_f)
    sums = tnn._aug_dist(qp, kp).numpy()
    order = np.lexsort((np.broadcast_to(np.arange(sums.shape[1]), sums.shape), sums), axis=1)[:, :7]
    np.testing.assert_array_equal(i_f.numpy(), order)
    np.testing.assert_array_equal(df.numpy(), np.take_along_axis(sums, order, 1))


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
    monkeypatch.setattr(tk, "_MAX_ROUNDS", 1)
    monkeypatch.setattr(tk, "knn_full_rows", lambda *a, **kw: full_calls.append(1) or full(*a, **kw))
    dj, ij = jnn.knn_pruned(jnp.asarray(q), jnp.asarray(keys), k, tile_q=128, tile_m=256,
                            max_rounds=1, interpret=True, key_valid=jnp.asarray(kw["key_valid"]))
    dt, it = tk.knn_pruned(_t(q), _t(keys), k, tile_q=128, tile_m=256, key_valid=_t(kw["key_valid"]))
    assert full_calls == [1]  # the budget holds every pair: only the safety net ran it
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
