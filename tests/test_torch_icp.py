"""The port's rigid ICP slice (``cilantro_tpu_torch/registration/``,
``correspondence/search.py``, ``entry.py``) against the JAX package on the
CPU, with JAX's Pallas kernels in interpret mode where its path reaches
them.

The same numpy inputs go through both packages. Tolerances: estimators
1e-5 (float32 normal equations summed in another order); transforms after
whole registrations 1e-4 (the same bound as the card-vs-CPU check: a
near-tie correspondence may flip between the packages and move the pose by
float32 noise); correspondence sets equal up to ties within 1e-6.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cilantro_tpu.neighbors.pallas_nn as jnn
from cilantro_tpu.core.rgbd import CameraIntrinsics as JIntrinsics
from cilantro_tpu.core.rgbd import depth_to_points_normals as j_depth_to_points_normals
from cilantro_tpu.core.transforms import Transform as JTransform
from cilantro_tpu.correspondence import search as jsearch
from cilantro_tpu.registration import transform_estimation as jte
from cilantro_tpu.slam.driver import synthetic_sequence
from __graft_entry__ import entry as j_entry
from cilantro_tpu_torch import interop
from cilantro_tpu_torch.correspondence import search as tsearch
from cilantro_tpu_torch.entry import entry as t_entry
from cilantro_tpu_torch.neighbors import fused_nn as tnn
from cilantro_tpu_torch.registration import icp as ticp
from cilantro_tpu_torch.registration import transform_estimation as tte

# The package re-exports the function ``icp`` under the module's name.
jicp = importlib.import_module("cilantro_tpu.registration.icp")
BENCH_LEVELS = ((0.02, 10, 32768, 0.0064), (None, 3, None, 0.01))


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _assert_tf_close(t_lin, t_tr, j_lin, j_tr, atol):
    np.testing.assert_allclose(np.asarray(t_lin), np.asarray(j_lin), rtol=0, atol=atol)
    np.testing.assert_allclose(np.asarray(t_tr), np.asarray(j_tr), rtol=0, atol=atol)


def _rot_z(ang):
    return np.array(
        [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32
    )


def _sheet_pair(n=3000, seed=0, ang=0.03, t=(0.01, -0.008, 0.012)):
    """``tests/test_pallas_nn.py``'s plan-path pair: a wavy sheet and its
    rotated, shifted copy, plane normals +z."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pts[:, 2] = 0.2 * np.sin(4 * pts[:, 0]) * np.cos(3 * pts[:, 1])
    r = _rot_z(ang)
    dst = (pts @ r.T + np.float32(t)).astype(np.float32)
    nrm = np.zeros_like(dst)
    nrm[:, 2] = 1.0
    return pts, dst, nrm, r, np.float32(t)


def _corr_data(seed=1, n=400):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    dst = (src + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    nrm = rng.normal(0, 1, src.shape)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    nsrc = rng.normal(0, 1, src.shape)
    nsrc = (nsrc / np.linalg.norm(nsrc, axis=1, keepdims=True)).astype(np.float32)
    w1 = rng.uniform(0, 1, n).astype(np.float32)
    w2 = (rng.random(n) < 0.8).astype(np.float32)
    return src, dst, nrm, nsrc, w1, w2


@pytest.mark.parametrize(
    "name", ["rigid_p2p", "affine_p2p", "rigid_combined", "rigid_combined_gn3", "symmetric", "affine_combined"]
)
def test_estimators_match_jax(name):
    src, dst, nrm, nsrc, w1, w2 = _corr_data()
    s, d, n, ns = (_t(a) for a in (src, dst, nrm, nsrc))
    js, jd, jn, jns = (_j(a) for a in (src, dst, nrm, nsrc))
    kw_t = dict(point_weights=_t(w1 * 0.3), plane_weights=_t(w2))
    kw_j = dict(point_weights=_j(w1 * 0.3), plane_weights=_j(w2))
    if name == "rigid_p2p":
        (tt, tv), (jt, jv) = tte.estimate_rigid_point_to_point(s, d, _t(w1)), jte.estimate_rigid_point_to_point(js, jd, _j(w1))
    elif name == "affine_p2p":
        (tt, tv), (jt, jv) = tte.estimate_affine_point_to_point(s, d, _t(w1)), jte.estimate_affine_point_to_point(js, jd, _j(w1))
    elif name == "rigid_combined":
        tt, tv = tte.estimate_rigid_combined_metric(s, d, n, **kw_t)
        jt, jv = jte.estimate_rigid_combined_metric(js, jd, jn, **kw_j)
    elif name == "rigid_combined_gn3":
        tt, tv = tte.estimate_rigid_combined_metric(s, d, n, max_iterations=3, convergence_tol=1e-9, **kw_t)
        jt, jv = jte.estimate_rigid_combined_metric(js, jd, jn, max_iterations=3, convergence_tol=1e-9, **kw_j)
    elif name == "symmetric":
        tt, tv = tte.estimate_rigid_symmetric_metric(s, d, ns, n, max_iterations=2, **kw_t)
        jt, jv = jte.estimate_rigid_symmetric_metric(js, jd, jns, jn, max_iterations=2, **kw_j)
    else:
        tt, tv = tte.estimate_affine_combined_metric(s, d, n, **kw_t)
        jt, jv = jte.estimate_affine_combined_metric(js, jd, jn, **kw_j)
    _assert_tf_close(tt.linear, tt.translation, jt.linear, jt.translation, 1e-5)
    assert bool(tv) == bool(jv)


def test_residuals_combined_metric_match_jax():
    src, dst, nrm, _, _, _ = _corr_data()
    r = _rot_z(0.02)
    t = np.float32([0.01, 0.0, -0.02])
    got = tte.residuals_combined_metric(interop.transform_from_numpy(r, t, device="cpu"), _t(src), _t(dst), _t(nrm), 0.3, 1.0)
    want = jte.residuals_combined_metric(JTransform(_j(r), _j(t)), _j(src), _j(dst), _j(nrm), 0.3, 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize(
    "max_distance,inlier_fraction,one_to_one",
    [(None, 1.0, False), (0.0004, 1.0, False), (0.0004, 0.7, False), (0.001, 1.0, True)],
)
def test_find_nn_correspondences_match_jax(max_distance, inlier_fraction, one_to_one):
    rng = np.random.default_rng(2)
    dst = rng.uniform(-0.3, 0.3, (1500, 3)).astype(np.float32)
    src = (dst[::2] + rng.normal(0, 0.01, dst[::2].shape)).astype(np.float32)
    qv = rng.random(len(src)) < 0.9
    dv = rng.random(len(dst)) < 0.9
    kw = dict(max_distance=max_distance, inlier_fraction=inlier_fraction, one_to_one=one_to_one)
    ct = tsearch.find_nn_correspondences(_t(src), _t(dst), query_valid=_t(qv), dst_valid=_t(dv), **kw)
    cj = jsearch.find_nn_correspondences(_j(src), _j(dst), query_valid=_j(qv), dst_valid=_j(dv), **kw)
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    np.testing.assert_array_equal(ct.dst_idx.numpy(), np.asarray(cj.dst_idx))
    np.testing.assert_allclose(ct.distances.numpy(), np.asarray(cj.distances), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ct.weights.numpy(), np.asarray(cj.weights))
    assert int(ct.count()) == int(cj.count())


@pytest.mark.parametrize("metric", ["point_to_point", "combined", "symmetric", "affine"])
def test_icp_matches_jax(metric):
    pts, dst, nrm, _, _ = _sheet_pair(n=1500, seed=3)
    src_n = nrm if metric == "symmetric" else None
    kw = dict(metric=metric, point_weight=0.3, max_corr_dist_sq=0.25, max_iterations=8, convergence_tol=1e-6)
    rt = ticp.icp(_t(pts), _t(dst), dst_normals=_t(nrm), src_normals=None if src_n is None else _t(src_n), **kw)
    rj = jicp.icp(_j(pts), _j(dst), dst_normals=_j(nrm), src_normals=None if src_n is None else _j(src_n), **kw)
    got = interop.icp_result_to_numpy(rt)
    _assert_tf_close(got["linear"], got["translation"], rj.transform.linear, rj.transform.translation, 1e-4)
    assert got["iterations"] == int(rj.iterations)
    assert got["num_correspondences"] == int(rj.num_correspondences)


@pytest.mark.parametrize("name", ["simple_point_to_point_icp", "simple_combined_metric_icp"])
def test_simple_instances_match_jax(name):
    pts, dst, nrm, _, _ = _sheet_pair(n=800, seed=4)
    args_t, args_j = [_t(pts), _t(dst)], [_j(pts), _j(dst)]
    if name == "simple_combined_metric_icp":
        args_t.append(_t(nrm))
        args_j.append(_j(nrm))
    kw = dict(max_corr_dist_sq=0.25, max_iterations=6)
    rt = getattr(ticp, name)(*args_t, **kw)
    rj = getattr(jicp, name)(*args_j, **kw)
    _assert_tf_close(rt.transform.linear, rt.transform.translation, rj.transform.linear, rj.transform.translation, 1e-4)


@pytest.fixture()
def pruned_on_cpu(monkeypatch):
    """Both packages' ``prune_eligible`` on for CPU problems, JAX's compact
    kernel in interpret mode; records the port's planned passes. JAX's jit
    caches are cleared around it: a trace made without pruning would
    otherwise be reused."""
    eligible = lambda q_shape, k_shape, max_distance, metric="l2", **kw: (  # noqa: E731
        max_distance is not None and metric == "l2" and q_shape[1] == 3
    )
    monkeypatch.setattr(jnn, "prune_eligible", eligible)
    monkeypatch.setattr(tnn, "prune_eligible", eligible)
    j_orig, t_orig = jnn.nn1_pruned_planned, tnn.nn1_pruned_planned
    calls = {"jax": 0, "port": 0}

    def j_planned(q, p, **kw):
        calls["jax"] += 1
        return j_orig(q, p, interpret=True)

    def t_planned(q, p):
        calls["port"] += 1
        return t_orig(q, p)

    monkeypatch.setattr(jnn, "nn1_pruned_planned", j_planned)
    monkeypatch.setattr(tnn, "nn1_pruned_planned", t_planned)
    jax.clear_caches()
    yield calls
    jax.clear_caches()


def test_icp_prune_plan_path_matches_jax(pruned_on_cpu):
    pts, dst, nrm, r, t = _sheet_pair()
    kw = dict(
        metric="combined", point_weight=0.3, max_corr_dist_sq=0.25,
        max_iterations=20, convergence_tol=1e-7,
    )
    rt = ticp.icp(_t(pts), _t(dst), dst_normals=_t(nrm), **kw)
    rj = jicp.icp(_j(pts), _j(dst), dst_normals=_j(nrm), **kw)
    assert pruned_on_cpu["jax"] and pruned_on_cpu["port"] == int(rt.iterations)
    _assert_tf_close(rt.transform.linear, rt.transform.translation, rj.transform.linear, rj.transform.translation, 1e-4)
    assert np.abs(rt.transform.translation.numpy() - t).max() < 2e-3
    assert np.abs(rt.transform.linear.numpy() - r).max() < 2e-3


@pytest.fixture(scope="module")
def depth_pair():
    """Two consecutive 64×80 frames of the synthetic sequence as clouds
    (JAX's ``depth_to_points_normals``), and the true relative pose."""
    k = JIntrinsics.make(65.625, 65.625, 39.5, 31.5)
    depths, gt = synthetic_sequence(2, 64, 80, k, seed=0)
    clouds = [
        [np.asarray(a) for a in j_depth_to_points_normals(jnp.asarray(d), k)] for d in depths
    ]
    rel = np.linalg.inv(gt[0]) @ gt[1]
    return clouds, rel


def _multires(pkg, clouds, cast):
    (p0, n0, v0), (p1, _, v1) = clouds
    return pkg.icp_multires(
        cast(p1), cast(p0), dst_normals=cast(n0), src_valid=cast(v1), dst_valid=cast(v0),
        metric="combined", convergence_tol=1e-4, levels=BENCH_LEVELS,
    )


def test_icp_multires_matches_jax(depth_pair):
    clouds, rel = depth_pair
    rt = _multires(ticp, clouds, _t)
    rj = _multires(jicp, clouds, _j)
    _assert_tf_close(rt.transform.linear, rt.transform.translation, rj.transform.linear, rj.transform.translation, 1e-4)
    np.testing.assert_allclose(rt.transform.translation.numpy(), rel[:3, 3], atol=2e-3)


def test_icp_multires_pruned_matches_jax(depth_pair, pruned_on_cpu):
    clouds, rel = depth_pair
    rt = _multires(ticp, clouds, _t)
    rj = _multires(jicp, clouds, _j)
    assert pruned_on_cpu["port"] >= 2 and pruned_on_cpu["jax"] >= 2  # both levels
    _assert_tf_close(rt.transform.linear, rt.transform.translation, rj.transform.linear, rj.transform.translation, 1e-4)


@pytest.fixture()
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_entry_forward_matches_jax(one_torch_thread):
    """The toy registration stops unconverged after its 10 iterations, so
    float32 reduction order shows in its result: the port's moves with
    torch's CPU thread count, JAX's not with XLA's. On one thread the
    port's result is the same in every run."""
    fwd_t, args_t = t_entry(device="cpu")
    fwd_j, args_j = j_entry()
    for a, b in zip(args_t, args_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    lin_t, tr_t = fwd_t(*args_t)
    lin_j, tr_j = fwd_j(*args_j)
    _assert_tf_close(lin_t, tr_t, lin_j, tr_j, 1e-4)


def test_icp_residuals_match_jax():
    pts, dst, nrm, r, t = _sheet_pair(n=1000, seed=5)
    tf_t = interop.transform_from_numpy(r, t, device="cpu")
    tf_j = JTransform(_j(r), _j(t))
    for normals in (None, nrm):
        got = ticp.icp_residuals(tf_t, _t(pts), _t(dst), None if normals is None else _t(normals), point_weight=0.3)
        want = jicp.icp_residuals(tf_j, _j(pts), _j(dst), None if normals is None else _j(normals), point_weight=0.3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-9)
