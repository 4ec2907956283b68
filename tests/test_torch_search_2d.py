"""The port's 2-D estimators and helpers and its remaining correspondence
searches against the JAX package on the same numpy-seeded inputs, on the
CPU: ``rot2d``, ``gn_update_2d``, the 2-D combined and symmetric metrics
(``registration/transform_estimation.py``) and the bidirectional, oracle
and combined-metric correspondences (``correspondence/search.py``).

Tolerances: rotations and GN updates 1e-6 (the same expressions); the 2-D
GN estimates 1e-5 (float32 sums in another order); correspondences exactly
(indices, masks) and distances 2e-6 absolute (brute force on both sides:
the ‖q‖² + ‖k‖² − 2q·k expansion of unit-scale points keeps ~5e-7 of
float32 cancellation, summed in another order)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu.core import transforms as jt
from cilantro_tpu.registration import transform_estimation as jte
from cilantro_tpu_torch.core import transforms as tt
from cilantro_tpu_torch.correspondence import search as ts
from cilantro_tpu_torch.registration import transform_estimation as tte

js = importlib.import_module("cilantro_tpu.correspondence.search")


def test_rot2d_and_gn_update_2d_match_jax():
    rng = np.random.default_rng(0)
    theta = rng.uniform(-3, 3, (7,)).astype(np.float32)
    np.testing.assert_allclose(tt.rot2d(torch.as_tensor(theta)).numpy(),
                               np.asarray(jt.rot2d(jnp.asarray(theta))), rtol=0, atol=1e-6)
    assert tt.rot2d(torch.tensor(0.5), dtype=torch.float64).dtype == torch.float64
    step = rng.standard_normal((5, 3)).astype(np.float32)
    j, t = jt.gn_update_2d(jnp.asarray(step)), tt.gn_update_2d(torch.as_tensor(step))
    np.testing.assert_allclose(t.linear.numpy(), np.asarray(j.linear), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.translation.numpy(), np.asarray(j.translation), rtol=0, atol=1e-6)


def _planar_problem(seed=1, n=300):
    """A 2-D curve moved by a small rigid motion, with its normals."""
    rng = np.random.default_rng(seed)
    s = np.sort(rng.uniform(0, 2 * np.pi, n)).astype(np.float32)
    src = np.stack([np.cos(s) * 1.5, np.sin(2 * s) * 0.7], 1).astype(np.float32)
    tang = np.stack([-1.5 * np.sin(s), 1.4 * np.cos(2 * s)], 1)
    nrm = np.stack([tang[:, 1], -tang[:, 0]], 1)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    ang = 0.05
    r = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]], np.float32)
    dst = (src @ r.T + np.float32([0.03, -0.02])).astype(np.float32)
    dst_n = (nrm @ r.T).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    return src, dst, nrm, dst_n, w


@pytest.mark.parametrize("metric", ["combined", "symmetric"])
@pytest.mark.parametrize("iterations", [1, 5])
def test_2d_gn_metrics_match_jax(metric, iterations):
    src, dst, src_n, dst_n, w = _planar_problem()
    kw = dict(point_weights=w, plane_weights=1.0 - w, max_iterations=iterations, convergence_tol=1e-7)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    if metric == "combined":
        jtf, jok = jte.estimate_rigid_combined_metric(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(dst_n), **jkw)
        ttf, tok = tte.estimate_rigid_combined_metric(torch.as_tensor(src), torch.as_tensor(dst),
                                                      torch.as_tensor(dst_n), **tkw)
    else:
        jtf, jok = jte.estimate_rigid_symmetric_metric(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(src_n),
                                                       jnp.asarray(dst_n), **jkw)
        ttf, tok = tte.estimate_rigid_symmetric_metric(torch.as_tensor(src), torch.as_tensor(dst),
                                                       torch.as_tensor(src_n), torch.as_tensor(dst_n), **tkw)
    assert bool(tok) == bool(jok)
    np.testing.assert_allclose(ttf.linear.numpy(), np.asarray(jtf.linear), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ttf.translation.numpy(), np.asarray(jtf.translation), rtol=0, atol=1e-5)


def test_2d_metric_refuses_a_batch():
    src, dst, _, dst_n, _ = _planar_problem(n=20)
    batch = [torch.as_tensor(np.stack([a, a])) for a in (src, dst, dst_n)]
    with pytest.raises(ValueError, match="one problem"):
        tte.estimate_rigid_combined_metric(*batch)


def _clouds(seed=2, n=400, m=350, d=3):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    b = (a[:m] + rng.normal(0, 0.02, (m, d))).astype(np.float32)
    va, vb = rng.random(n) < 0.9, rng.random(m) < 0.9
    return a, b, va, vb


def _same_correspondences(t, j):
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.dst_idx.numpy(), np.asarray(j.dst_idx))
    np.testing.assert_allclose(t.distances.numpy(), np.asarray(j.distances), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(t.weights.numpy(), np.asarray(j.weights))


@pytest.mark.parametrize("reciprocal", [True, False])
@pytest.mark.parametrize("fraction", [1.0, 0.8])
@pytest.mark.parametrize("d", [2, 3])
def test_bidirectional_matches_jax(reciprocal, fraction, d):
    a, b, va, vb = _clouds(d=d)
    kw = dict(max_distance=0.004, inlier_fraction=fraction, require_reciprocal=reciprocal)
    j = js.find_nn_correspondences_bidirectional(jnp.asarray(a), jnp.asarray(b), src_valid=jnp.asarray(va),
                                                 dst_valid=jnp.asarray(vb), **kw)
    t = ts.find_nn_correspondences_bidirectional(torch.as_tensor(a), torch.as_tensor(b),
                                                 src_valid=torch.as_tensor(va), dst_valid=torch.as_tensor(vb), **kw)
    assert int(t.count()) == int(j.count()) > 0
    _same_correspondences(t, j)


def test_oracle_correspondences_match_jax():
    a, b, _, _ = _clouds(seed=3)
    rng = np.random.default_rng(4)
    idx = rng.integers(0, len(b), len(a)).astype(np.int32)
    mask = rng.random(len(a)) < 0.7
    lin, tr = np.asarray(jt.rot2d(jnp.float32(0.1))), np.float32([0.01, 0.02])
    lin3 = np.eye(3, dtype=np.float32)
    lin3[:2, :2] = lin
    tr3 = np.float32([0.01, 0.02, -0.01])
    for tf_args, gate in ((None, None), ((lin3, tr3), 0.5)):
        jtf = None if tf_args is None else jt.Transform(jnp.asarray(tf_args[0]), jnp.asarray(tf_args[1]))
        ttf = None if tf_args is None else tt.Transform(torch.as_tensor(tf_args[0]), torch.as_tensor(tf_args[1]))
        j = js.oracle_correspondences(jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx), jnp.asarray(mask),
                                      jtf, gate)
        t = ts.oracle_correspondences(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(idx),
                                      torch.as_tensor(mask), ttf, gate)
        _same_correspondences(t, j)


def test_combine_metric_correspondences_match_jax():
    a, b, va, vb = _clouds(seed=5)
    nrm = np.random.default_rng(6).standard_normal(b.shape).astype(np.float32)
    jp = js.find_nn_correspondences(jnp.asarray(a), jnp.asarray(b), max_distance=0.004)
    jl = js.find_nn_correspondences(jnp.asarray(a), jnp.asarray(b), max_distance=0.002)
    tp = ts.find_nn_correspondences(torch.as_tensor(a), torch.as_tensor(b), max_distance=0.004)
    tl = ts.find_nn_correspondences(torch.as_tensor(a), torch.as_tensor(b), max_distance=0.002)
    want = js.combine_metric_correspondences(jp, jl, jnp.asarray(b), jnp.asarray(nrm), point_weight=0.3,
                                             plane_weight=2.0)
    got = ts.combine_metric_correspondences(tp, tl, torch.as_tensor(b), torch.as_tensor(nrm), point_weight=0.3,
                                            plane_weight=2.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # The stacked sets feed the combined metric as the JAX docstring says.
    s2 = np.concatenate([a, a])
    jtf, _ = jte.estimate_rigid_combined_metric(jnp.asarray(s2), want[0], want[1], point_weights=want[2],
                                                plane_weights=want[3])
    ttf, _ = tte.estimate_rigid_combined_metric(torch.as_tensor(s2), got[0], got[1], point_weights=got[2],
                                                plane_weights=got[3])
    np.testing.assert_allclose(ttf.linear.numpy(), np.asarray(jtf.linear), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ttf.translation.numpy(), np.asarray(jtf.translation), rtol=0, atol=1e-5)
