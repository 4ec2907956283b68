"""The port's nn1 search (``cilantro_tpu_torch/neighbors/``) against
``cilantro_tpu/neighbors/`` on the CPU, the Pallas kernels in interpret
mode at the sizes of ``tests/test_pallas_nn.py``.

Tolerances: distances 1e-6 (both packages sum the same augmented terms,
JAX through a matrix product in another order, so they differ by float32
rounding; clouds lie in the unit cube around the origin); indices equal,
except where the two answers are a tie within 1e-6 (checked in float64).
Morton codes, sorts and prune plans are integer or selection results and
must be equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cilantro_tpu.neighbors import bruteforce as jbf
from cilantro_tpu.neighbors import gridhash as jgh
from cilantro_tpu.neighbors import pallas_nn as jnn
from cilantro_tpu_torch import native
from cilantro_tpu_torch.neighbors import bruteforce as tbf
from cilantro_tpu_torch.neighbors import fused_nn as tnn
from cilantro_tpu_torch.neighbors import gridhash as tgh

INVALID = 3.0e38


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_nn_close(q, k, d_port, i_port, d_jax, i_jax, hit=None):
    """Distances within 1e-6 where JAX found a key; indices equal unless
    both keys lie within 1e-6 of each other's distance (a tie)."""
    d_port, i_port = np.asarray(d_port).reshape(-1), np.asarray(i_port).reshape(-1)
    d_jax, i_jax = np.asarray(d_jax).reshape(-1), np.asarray(i_jax).reshape(-1)
    if hit is None:
        hit = d_jax < INVALID * 0.5
    assert np.array_equal(hit, d_port < INVALID * 0.5)
    np.testing.assert_allclose(d_port[hit], d_jax[hit], rtol=0, atol=1e-6)
    rows = np.flatnonzero(hit)
    q64, k64 = q.astype(np.float64), k.astype(np.float64)
    dp = np.sum((q64[rows] - k64[i_port[rows]]) ** 2, axis=1)
    dj = np.sum((q64[rows] - k64[i_jax[rows]]) ** 2, axis=1)
    differ = i_port[rows] != i_jax[rows]
    assert np.all(np.abs(dp - dj)[differ] <= 1e-6), f"{differ.sum()} non-tie index differences"


def _clouds(seed, qn, mn):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-0.5, 0.5, (qn, 3)).astype(np.float32)
    k = rng.uniform(-0.5, 0.5, (mn, 3)).astype(np.float32)
    k[: mn // 10] = q[: mn // 10]  # exact matches: distance 0 ties
    return rng, q, k


@pytest.mark.parametrize("seed,qn,mn", [(0, 100, 150), (1, 300, 700)])
def test_fused_plain_matches_pallas(seed, qn, mn):
    rng, q, k = _clouds(seed, qn, mn)
    kv = rng.random(mn) < 0.8
    qv = rng.random(qn) < 0.9
    dj, ij = jnn.nn1_pallas(
        jnp.asarray(q), jnp.asarray(k), query_valid=jnp.asarray(qv),
        key_valid=jnp.asarray(kv), tile_q=8, tile_m=128, interpret=True,
    )
    dt, it = tnn.nn1_fused(_t(q), _t(k), query_valid=_t(qv), key_valid=_t(kv))
    _assert_nn_close(q, k, dt.numpy(), it.numpy(), dj, ij)
    assert dt.dtype == torch.float32 and it.dtype == torch.int32


def _augmented(seed, qn, mn, tq, tm):
    rng, q, k = _clouds(seed, qn, mn)
    kv = rng.random(mn) < 0.9
    qp, kp = jnn._augment(jnp.asarray(q), jnp.asarray(k), jnp.asarray(kv), tq, tm)
    tqp, tkp = tnn._augment(_t(q), _t(k), _t(kv), tq, tm)
    np.testing.assert_array_equal(tqp.numpy(), np.asarray(qp))
    np.testing.assert_array_equal(tkp.numpy(), np.asarray(kp))
    n_qt, n_mt = qp.shape[0] // tq, kp.shape[0] // tm
    mask = rng.random((n_qt, n_mt)) < rng.uniform(0.2, 0.8)
    mask[np.arange(n_qt), rng.integers(0, n_mt, n_qt)] = True
    # The masked kernel's reference: brute force over the visited pairs.
    qq = np.zeros((qp.shape[0], 3), np.float32)
    qq[:qn] = q
    kk = np.zeros((kp.shape[0], 3), np.float32)
    kk[:mn] = k
    return q, k, qq, kk, qp, kp, tqp, tkp, mask, kv


@pytest.mark.parametrize("seed,qn,mn,tq,tm", [(2, 500, 700, 128, 256), (3, 250, 400, 64, 128)])
def test_masked_plain_matches_pallas(seed, qn, mn, tq, tm):
    q, k, qq, kk, qp, kp, tqp, tkp, mask, kv = _augmented(seed, qn, mn, tq, tm)
    dj, ij = jnn._nn1_pallas_masked(
        qp, kp, jnp.asarray(mask.astype(np.int32)), tile_q=tq, tile_m=tm, interpret=True
    )
    dt, it = tnn._nn1_masked(tqp, tkp, _t(mask.astype(np.int32)), tile_q=tq, tile_m=tm)
    assert tuple(dt.shape) == tuple(dj.shape)
    _assert_nn_close(qq, kk, dt.numpy(), it.numpy(), dj, ij)


@pytest.mark.parametrize("budget", ["roomy", "exact", "overflow"])
def test_compact_plain_matches_pallas(budget):
    q, k, qq, kk, qp, kp, tqp, tkp, mask, kv = _augmented(4, 500, 700, 128, 256)
    count = int(mask.sum())
    b = {"roomy": mask.size, "exact": count, "overflow": count - 1}[budget]
    dj, ij = jnn._nn1_pallas_compact(
        qp, kp, jnp.asarray(mask), budget=b, tile_q=128, tile_m=256, interpret=True
    )
    native.reset_launch_counts()
    dt, it = tnn._nn1_compact(tqp, tkp, _t(mask), budget=b, tile_q=128, tile_m=256)
    _assert_nn_close(qq, kk, dt.numpy(), it.numpy(), dj, ij)
    assert sum(native.launch_counts.values()) == 0  # CPU tensors: plain versions


def test_compact_list_matches_pallas_wrapper_layout():
    """The pair list is JAX's: row-major nonzeros padded by repeats of the
    last one, flags first/live/last; None past the budget."""
    mask = np.zeros((3, 4), bool)
    mask[0, [1, 3]] = True
    mask[2, [0, 2]] = True
    qt, kt, fl = tnn._compact_list(_t(mask), 6)
    assert qt.tolist() == [0, 0, 2, 2, 2, 2]
    assert kt.tolist() == [1, 3, 0, 2, 2, 2]
    assert fl.tolist() == [1 + 2, 2 + 4, 1 + 2, 2, 0, 4]
    assert tnn._compact_list(_t(mask), 3) is None


def test_plain_versions_agree_bit_for_bit():
    """The three plain versions run the same arithmetic: on a full mask
    they return the fused result exactly."""
    q, k, qq, kk, qp, kp, tqp, tkp, mask, kv = _augmented(5, 300, 500, 128, 256)
    full = torch.ones((tqp.shape[0] // 128, tkp.shape[0] // 256), dtype=torch.int32)
    df, i_f = tnn.fused_rows(tqp, tkp)
    dm, im = tnn.masked_rows(tqp, tkp, full, tile_q=128, tile_m=256)
    dc, ic = tnn._nn1_compact(tqp, tkp, full.bool(), budget=full.numel(), tile_q=128, tile_m=256)
    for d, i in ((dm, im), (dc.reshape(-1), ic.reshape(-1))):
        assert torch.equal(d.view(torch.int32), df.view(torch.int32))
        assert torch.equal(i, i_f)


def test_wrappers_check_their_operands():
    qp = torch.zeros((256, 8))
    kp = torch.zeros((512, 8))
    with pytest.raises(TypeError, match="dtype"):
        tnn.fused_rows(qp.double(), kp)
    with pytest.raises(ValueError, match="shape"):
        tnn.fused_rows(qp[:, :6], kp)
    with pytest.raises(ValueError, match="multiples"):
        tnn.masked_rows(qp, kp, torch.ones((2, 2), dtype=torch.int32), tile_q=96, tile_m=256)
    with pytest.raises(ValueError, match="shape"):
        tnn.masked_rows(qp, kp, torch.ones((2, 3), dtype=torch.int32), tile_q=128, tile_m=256)
    with pytest.raises(TypeError, match="dtype"):
        lst = tnn._compact_list(torch.ones((2, 2), dtype=torch.bool), 4)
        tnn.compact_rows(qp, kp, lst[0].long(), lst[1], lst[2], tile_q=128, tile_m=256)


@pytest.mark.parametrize("dim", [2, 3])
def test_morton_sort_matches_jax(dim):
    rng = np.random.default_rng(6 + dim)
    pts = rng.uniform(-0.3, 0.3, (2000, dim)).astype(np.float32)
    pts[::7] = pts[3]  # many equal codes: the sort must be stable
    pts[5::11] = 1e30  # invalid points sit far away, masked
    valid = pts[:, 0] < 1e29
    origin = pts[valid].min(0)
    cell = np.float32(0.02)
    cj = jgh.morton_code(jnp.asarray(pts[valid]), jnp.asarray(origin), jnp.float32(cell))
    ct = tgh.morton_code(_t(pts[valid]), _t(origin), torch.tensor(cell))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    pj, sj, vj = jnn._morton_sort(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(origin), jnp.float32(cell)
    )
    pt, st, vt = tnn._morton_sort(_t(pts), _t(valid), _t(origin), torch.tensor(cell))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(tnn._inverse_perm(pt).numpy(), np.asarray(jnn._inverse_perm(pj)))


def test_aabb_dist2_matches_jax():
    rng = np.random.default_rng(9)
    a, b = rng.uniform(-1, 1, (2, 12, 3)).astype(np.float32)
    c, d = rng.uniform(-1, 1, (2, 9, 3)).astype(np.float32)
    qmin, qmax, kmin, kmax = np.minimum(a, b), np.maximum(a, b), np.minimum(c, d), np.maximum(c, d)
    want = jgh._aabb_dist2(*map(jnp.asarray, (qmin, qmax, kmin, kmax)))
    got = tgh._aabb_dist2(*map(_t, (qmin, qmax, kmin, kmax)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _surface(rng, n=3000):
    g = np.linspace(-0.2, 0.2, 55)
    gx, gy = np.meshgrid(g, g)
    gz = 0.05 * np.sin(10 * gx) * np.cos(8 * gy)
    pts = np.column_stack([gx.ravel(), gy.ravel(), gz.ravel()])[:n]
    return (pts + rng.normal(0, 5e-4, pts.shape)).astype(np.float32)


def test_prune_plan_and_planned_pass_match_jax():
    """The plan (sorts, augmented keys, chunk boxes) equals JAX's; passes
    after the queries moved match JAX's interpret-mode compact kernel."""
    rng = np.random.default_rng(10)
    k = _surface(rng)
    kv = rng.random(len(k)) < 0.9
    q0 = (k[::2] + rng.normal(0, 2e-3, k[::2].shape)).astype(np.float32)
    qv = rng.random(len(q0)) < 0.95
    radius = np.float32(0.02)
    pj = jnn.make_nn1_prune_plan(
        jnp.asarray(k), radius, jnp.asarray(q0), key_valid=jnp.asarray(kv),
        query_valid=jnp.asarray(qv), tile_q=128, tile_m=256,
    )
    pt = tnn.make_nn1_prune_plan(
        _t(k), radius, _t(q0), key_valid=_t(kv), query_valid=_t(qv), tile_q=128, tile_m=256
    )
    for name in ("kperm", "qperm", "qinv", "qvs", "kp", "kmin", "kmax", "k_occ"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)), name)
    q = q0
    for _ in range(2):
        q = (q + rng.normal(0, 3e-3, q.shape)).astype(np.float32)
        dj, ij = jnn.nn1_pruned_planned(jnp.asarray(q), pj, interpret=True)
        dt, it = tnn.nn1_pruned_planned(_t(q), pt)
        _assert_nn_close(q, k, dt.numpy(), it.numpy(), dj, ij)


def test_nn1_pruned_matches_jax():
    rng = np.random.default_rng(11)
    k = rng.uniform(-0.1, 0.1, (1000, 3)).astype(np.float32)
    kv = np.ones(1000, bool)
    kv[::2] = False
    q = np.concatenate([k[:200] + 1e-3, rng.uniform(5.0, 5.1, (56, 3))]).astype(np.float32)
    dj, ij = jnn.nn1_pruned(
        jnp.asarray(q), jnp.asarray(k), 0.05, key_valid=jnp.asarray(kv),
        tile_q=128, tile_m=256, interpret=True,
    )
    dt, it = tnn.nn1_pruned(_t(q), _t(k), 0.05, key_valid=_t(kv), tile_q=128, tile_m=256)
    _assert_nn_close(q, k, dt.numpy(), it.numpy(), dj, ij)
    assert (dt.numpy()[200:] == INVALID).all()


@pytest.mark.parametrize("metric,dim", [("l2", 3), ("l2", 6), ("l1", 3), ("so2", 1), ("so3", 4)])
def test_nn1_cpu_matches_jax(metric, dim):
    """On the CPU both packages' ``nn1`` take the tiled scan (JAX's
    ``_nn1_xla``)."""
    rng = np.random.default_rng(12)
    q = rng.uniform(-1, 1, (200, dim)).astype(np.float32)
    k = rng.uniform(-1, 1, (5000, dim)).astype(np.float32)
    if metric == "so3":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        k /= np.linalg.norm(k, axis=1, keepdims=True)
    kv = rng.random(5000) < 0.8
    qv = rng.random(200) < 0.9
    dj, ij = jbf.nn1(
        jnp.asarray(q), jnp.asarray(k), query_valid=jnp.asarray(qv),
        key_valid=jnp.asarray(kv), metric=metric,
    )
    dt, it = tbf.nn1(_t(q), _t(k), query_valid=_t(qv), key_valid=_t(kv), metric=metric)
    dj, ij = np.asarray(dj), np.asarray(ij)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-6, atol=1e-6)
    assert (it.numpy() == ij)[qv].mean() > 0.99


def test_prune_eligible_needs_cuda_tensors():
    big = (1 << 13, 3)
    assert not tnn.prune_eligible(big, big, 0.01, device=torch.device("cpu"))
    assert tnn.prune_eligible(big, big, 0.01, device="cuda")
    assert not tnn.prune_eligible(big, big, None, device="cuda")
    assert not tnn.prune_eligible((100, 3), big, 0.01, device="cuda")
    assert tnn.maybe_make_nn1_prune_plan(torch.zeros(big), 0.01, torch.zeros(big)) is None
