"""The port's covariance and normal estimation (``cilantro_tpu_torch/core/
covariance.py``, ``core/normals.py``, ``PointCloud.with_normals_*``) and the
slice as a whole (kNN normals of a target, then combined-metric ICP)
against the JAX package on the CPU.

Tolerances. Means and covariances 1e-6 absolute at unit scale (float32
einsums summed in another order). The MCD fits get JAX's own uniforms, so
they pick the same subsets and agree to 1e-5 (the Mahalanobis distances go
through a float32 inverse in each package). Normals: the eigenvector of the
smallest eigenvalue moves by rounding / eigengap, so they are compared on
neighbourhoods whose two smallest eigenvalues lie apart (curvature below
0.05 on the test surfaces) as n_port · n_jax ≥ 1 − 1e-5 after the
view-point flip, and everywhere as validity masks equal. Where each package
runs its own search, 99% of those points must agree so (a near tie swaps a
neighbour of the rest) and all must lie on the same side.
Whole registrations agree within 1e-4, the card-vs-CPU bound of the ICP
slice.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu.core import containers as jcontainers
from cilantro_tpu.core import covariance as jcov
from cilantro_tpu.core import normals as jnormals
from cilantro_tpu.neighbors import api as japi
from cilantro_tpu.neighbors import bruteforce as jbf
from cilantro_tpu_torch import interop
from cilantro_tpu_torch.core import containers as tcontainers
from cilantro_tpu_torch.core import covariance as tcov
from cilantro_tpu_torch.core import normals as tnormals
from cilantro_tpu_torch.registration import icp as ticp

jicp = importlib.import_module("cilantro_tpu.registration.icp")


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def small_scan_tiles(monkeypatch):
    """JAX's tiled kNN scan at 128/512 instead of 1024/2048, which pad
    these clouds to twice their rows or more (the tiles change no result)."""
    scan = jbf._knn_xla
    monkeypatch.setattr(jbf, "_knn_xla", lambda *a, tile_q, tile_m, **kw: scan(*a, tile_q=128, tile_m=512, **kw))


def _surface(seed=0, n=1500, noise=2e-3):
    """A smooth height field 1.5 m from the origin, as a depth camera sees."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.3, 0.3, (n, 2))
    z = 1.5 + 0.05 * np.sin(6 * xy[:, 0]) * np.cos(5 * xy[:, 1]) + rng.normal(0, noise, n)
    return rng, np.column_stack([xy, z]).astype(np.float32)


def _assert_normals_close(got, want, share=1.0, curv_max=0.05):
    """Validity equal; on flat valid points normals within 1e-5 in |cos|
    and curvatures within 1e-5 for at least ``share`` of them, and every
    one on the same side (cos > 0). ``share`` < 1 where each package
    runs its own search: a near tie at the k-th slot or at the radius
    swaps one neighbour of a few points."""
    (nt, ct, vt), (nj, cj, vj) = [tuple(np.asarray(a) for a in x) for x in (got, want)]
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(nt[~vt], 0.0)
    flat = vj & (cj < curv_max)
    assert flat.sum() > 0.5 * vj.sum()
    dots = np.sum(nt[flat] * nj[flat], axis=1)
    same = (dots >= 1 - 1e-5) & (np.abs(ct[flat] - cj[flat]) <= 1e-5)
    assert same.mean() >= share, same.mean()
    assert dots.min() > 0, dots.min()


# ---------------------------------------------------------------------------
# Covariance and MCD.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_mean_and_covariance_matches_jax(masked):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(7, 30, 3)).astype(np.float32)
    mask = rng.random((7, 30)) < 0.6 if masked else None
    if masked:
        mask[0, 3:] = False  # too few samples: invalid
    want = jcov.mean_and_covariance(jnp.asarray(pts), None if mask is None else jnp.asarray(mask))
    got = tcov.mean_and_covariance(_t(pts), _t(mask))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_neighborhood_mean_cov_logdet_and_mahalanobis_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    idx = rng.integers(0, 200, (50, 10)).astype(np.int32)
    mask = rng.random((50, 10)) < 0.8
    want = jcov.neighborhood_mean_cov(jnp.asarray(pts), jnp.asarray(idx), jnp.asarray(mask))
    got = tcov.neighborhood_mean_cov(_t(pts), _t(idx), _t(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    cov = got[1].numpy()
    np.testing.assert_allclose(tcov._logdet_psd(got[1]).numpy(),
                               np.asarray(jcov._logdet_psd(jnp.asarray(cov))), rtol=1e-5, atol=1e-5)
    m2_t = tcov.mahalanobis2(_t(pts[:20]), got[0][:1], got[1][:1])
    m2_j = jcov.mahalanobis2(jnp.asarray(pts[:20]), jnp.asarray(got[0][:1].numpy()), jnp.asarray(cov[:1]))
    np.testing.assert_allclose(m2_t.numpy(), np.asarray(m2_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", ["random", "planar", "degenerate"])
def test_eigh_sym_matches_float64_lapack(dim, kind):
    """The Jacobi solver against numpy's float64 ``eigh`` of the same float32
    matrices: eigenvalues within 2e-6 of the largest (float32 rounding of
    the rotations), smallest eigenvectors within 1e-5 in |cos| where the
    two smallest eigenvalues lie apart (else the vector is not
    determined), batch dimensions kept."""
    rng = np.random.default_rng(11)
    if kind == "degenerate":  # zero matrices, multiples of I, one repeated pair
        m = np.zeros((3, 4, dim, dim))
        m[1] = 2.5 * np.eye(dim)
        m[2] = np.diag([1.0] * (dim - 1) + [3.0])
    else:
        scale = [3e-3, 2e-3, 1e-5][:dim] if kind == "planar" else [1.0] * dim
        pts = rng.normal(size=(50, 6, 12, dim)) * np.array(scale)
        rot = np.linalg.qr(rng.normal(size=(50, 6, dim, dim)))[0]
        pts = pts @ rot
        c = pts - pts.mean(-2, keepdims=True)
        m = np.einsum("...ki,...kj->...ij", c, c) / 11
    m = m.astype(np.float32)
    w, v = tcov.eigh_sym(_t(m))
    assert w.shape == m.shape[:-1] and v.shape == m.shape
    w64, v64 = np.linalg.eigh(m.astype(np.float64))
    top = np.abs(w64).max(-1, keepdims=True)
    assert np.all(np.abs(w.numpy() - w64) <= 2e-6 * top)
    apart = (w64[..., 1] - w64[..., 0]) > 1e-3 * top[..., 0]
    cos = np.abs(np.sum(v.numpy()[..., :, 0] * v64[..., :, 0], axis=-1))
    assert np.all(cos[apart] >= 1 - 1e-5)
    np.testing.assert_allclose(np.swapaxes(v.numpy(), -1, -2) @ v.numpy(),
                               np.broadcast_to(np.eye(dim), m.shape), atol=1e-6)


def _jax_trial_scores(key, n, num_trials=6):
    """The uniforms JAX's ``mcd_mean_cov`` draws: one (n,) row per trial."""
    keys = jax.random.split(key, num_trials)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))


@pytest.mark.parametrize("chi", [-1.0, 7.81])
@pytest.mark.parametrize("query_outlier", [False, True])
def test_mcd_with_jax_uniforms_matches_jax(chi, query_outlier):
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.normal(size=(80, 3)) * 0.1, rng.normal(size=(20, 3)) * 10 + 5])
    pts = pts.astype(np.float32)
    if query_outlier:
        pts[0] = [5.0, 5.0, 5.0]
    mask = np.ones(100, bool)
    mask[90:] = False
    key = jax.random.PRNGKey(4)
    want = jcov.mcd_mean_cov(key, jnp.asarray(pts), jnp.asarray(mask), chi_square_threshold=chi)
    got = tcov._mcd_from_scores(_t(_jax_trial_scores(key, 100)), _t(pts), _t(mask),
                                chi_square_threshold=chi)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    assert bool(got[2]) == bool(want[2])
    if chi > 0 and query_outlier:
        assert not bool(got[2])
    assert np.linalg.norm(got[0].numpy()) < 0.3  # the inliers' centre


def test_mcd_mean_cov_draws_from_its_generator():
    rng = np.random.default_rng(5)
    pts = _t(np.concatenate([rng.normal(size=(80, 3)) * 0.1, rng.normal(size=(20, 3)) * 10 + 5])
             .astype(np.float32))
    a = tcov.mcd_mean_cov(torch.Generator().manual_seed(0), pts)
    b = tcov.mcd_mean_cov(torch.Generator().manual_seed(0), pts)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert bool(a[2]) and float(a[0].norm()) < 0.3
    assert float(torch.linalg.eigvalsh(a[1]).max()) < 0.1


# ---------------------------------------------------------------------------
# Normals.
# ---------------------------------------------------------------------------


def test_normals_from_jax_neighborhoods_match_jax():
    """The same neighbourhoods (JAX's, through ``interop``): covariance,
    eigh and the flip alone."""
    _, pts = _surface(6)
    nb = japi.knn_search(jnp.asarray(pts), jnp.asarray(pts), 12)
    view = np.float32([0.0, 0.0, 0.0])
    want = jnormals.normals_from_neighborhoods(jnp.asarray(pts), nb, view_point=jnp.asarray(view))
    port_nb = interop.neighborhoods_from_numpy(
        np.asarray(nb.indices), np.asarray(nb.distances), np.asarray(nb.mask), device="cpu"
    )
    assert port_nb.overflowed is None and port_nb.k == 12
    got = tnormals.normals_from_neighborhoods(_t(pts), port_nb, view_point=_t(view))
    _assert_normals_close(got, want)
    assert np.all(got[0].numpy()[:, 2] <= 0)  # turned toward the origin
    ref = np.zeros_like(pts)
    ref[:, 2] = 1.0
    want = jnormals.normals_from_neighborhoods(jnp.asarray(pts), nb, reference_normals=jnp.asarray(ref))
    got = tnormals.normals_from_neighborhoods(_t(pts), port_nb, reference_normals=_t(ref))
    _assert_normals_close(got, want)
    assert np.all(got[0].numpy()[:, 2] >= 0)


@pytest.mark.parametrize("estimator", ["knn", "radius", "knn_in_radius"])
def test_estimators_match_jax(estimator):
    rng, pts = _surface(7)
    valid = rng.random(len(pts)) < 0.9
    view = np.float32([0.1, -0.1, 0.0])
    kw = dict(valid=valid, view_point=view)
    jkw = {n: jnp.asarray(v) for n, v in kw.items()}
    tkw = {n: _t(v) for n, v in kw.items()}
    if estimator == "knn":
        want = jnormals.estimate_normals_knn(jnp.asarray(pts), 10, **jkw)
        got = tnormals.estimate_normals_knn(_t(pts), 10, **tkw)
    elif estimator == "radius":
        want = jnormals.estimate_normals_radius(jnp.asarray(pts), 0.05, 16, **jkw)
        got = tnormals.estimate_normals_radius(_t(pts), 0.05, 16, **tkw)
    else:
        want = jnormals.estimate_normals_knn_in_radius(jnp.asarray(pts), 8, 0.03, **jkw)
        got = tnormals.estimate_normals_knn_in_radius(_t(pts), 8, 0.03, **tkw)
    _assert_normals_close(got, want, share=0.99)
    assert not got[2].numpy()[~valid].any()


def test_robust_normals_with_jax_uniforms_match_jax():
    """A plane with 20% gross outliers (``tests/test_viz_metrics.py``'s
    case); the port's MCD gets each point's trial uniforms as JAX draws
    them (one key per point, split again per trial)."""
    rng = np.random.default_rng(8)
    n, k, trials = 300, 16, 6
    pts = np.zeros((n, 3), np.float32)
    pts[:, :2] = rng.uniform(-1, 1, (n, 2))
    out = rng.choice(n, n // 5, replace=False)
    pts[out, 2] = rng.uniform(0.5, 1.0, len(out))
    view = np.float32([0, 0, 10.0])
    key = jax.random.PRNGKey(0)
    want = jnormals.estimate_normals_robust(key, jnp.asarray(pts), k=k, view_point=jnp.asarray(view))
    point_keys = jax.random.split(key, n)
    scores = np.stack([_jax_trial_scores(pk, k, trials) for pk in point_keys])
    nb = tnormals.knn_search(_t(pts), _t(pts), k)
    got = tnormals._normals_robust_from_scores(_t(scores), _t(pts), nb, view_point=_t(view))
    nt, vt = got[0].numpy(), got[2].numpy()
    nj, vj = np.asarray(want[0]), np.asarray(want[2])
    np.testing.assert_array_equal(vt, vj)
    inlier = np.ones(n, bool)
    inlier[out] = False
    sel = vt & inlier
    assert np.sum(nt[sel] * nj[sel], axis=1).min() >= 1 - 1e-5
    assert np.median(np.abs(nt[sel][:, 2])) > 0.99
    # The public function draws from its generator.
    a = tnormals.estimate_normals_robust(torch.Generator().manual_seed(1), _t(pts), k=k, view_point=_t(view))
    b = tnormals.estimate_normals_robust(torch.Generator().manual_seed(1), _t(pts), k=k, view_point=_t(view))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert np.median(np.abs(a[0].numpy()[a[2].numpy() & inlier][:, 2])) > 0.99


@pytest.mark.parametrize("method", ["with_normals_knn", "with_normals_radius"])
def test_point_cloud_normals_match_jax(method):
    """Padded clouds (capacity above the points), the origin as view
    point by default."""
    _, pts = _surface(9, n=900)
    jc = jcontainers.from_numpy(pts, capacity=1024)
    tc = tcontainers.from_numpy(pts, capacity=1024, device="cpu")
    args = (12,) if method == "with_normals_knn" else (0.05, 16)
    want, got = getattr(jc, method)(*args), getattr(tc, method)(*args)
    _assert_normals_close(
        (got.normals, torch.zeros(1024), got.valid), (want.normals, np.zeros(1024), want.valid),
        share=0.99,
    )
    assert not got.valid[900:].any() and got.points.shape == (1024, 3)


# ---------------------------------------------------------------------------
# The slice as a whole.
# ---------------------------------------------------------------------------


def test_knn_normals_then_combined_icp_match_jax():
    """``tests/test_registration.py``'s combined-ICP case: kNN normals of
    the target (view point above it), then ``icp(metric="combined")``."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(-1, 1, (2000, 2)).astype(np.float32)
    pts = np.column_stack([xy, (0.3 * np.sin(2 * xy[:, 0]) * np.cos(2 * xy[:, 1])).astype(np.float32)])
    ang = 0.04
    r = np.array([[1, 0, 0], [0, np.cos(ang), -np.sin(ang)], [0, np.sin(ang), np.cos(ang)]], np.float32)
    t = np.array([-0.01, 0.02, 0.01], np.float32)
    dst = pts @ r.T + t
    view = np.float32([0.0, 0.0, 5.0])
    jn, _, _ = jnormals.estimate_normals_knn(jnp.asarray(dst), k=10, view_point=jnp.asarray(view))
    tn, _, _ = tnormals.estimate_normals_knn(_t(dst), k=10, view_point=_t(view))
    assert np.sum(tn.numpy() * np.asarray(jn), axis=1).min() > 0.999
    kw = dict(metric="combined", max_corr_dist_sq=0.25, max_iterations=30, convergence_tol=1e-7)
    want = jicp.icp(jnp.asarray(pts), jnp.asarray(dst), dst_normals=jn, **kw)
    got = ticp.icp(_t(pts), _t(dst), dst_normals=tn, **kw)
    np.testing.assert_allclose(got.transform.linear.numpy(), np.asarray(want.transform.linear), atol=1e-4)
    np.testing.assert_allclose(got.transform.translation.numpy(), np.asarray(want.transform.translation),
                               atol=1e-4)
    assert np.linalg.norm(got.transform.linear.numpy() - r) < 2e-3
    assert np.linalg.norm(got.transform.translation.numpy() - t) < 2e-3
