"""The port's keyframe graph and loop closure
(``cilantro_tpu_torch/slam/keyframes.py``) against the JAX package's on
the CPU: ``tests/test_keyframes.py``'s four cases, each run through both
packages on the same clouds.

Keyframe clouds, gates and odometry edges are host numpy in both packages,
so they are equal bit for bit. The loop-closure edges must form the same
set, their ICP measurements within 1e-4 (both run multires ICP with the
same levels; the nearest-neighbour scans and the normal equations sum in
other orders). One exception: the default loop-closure levels stop the
drift case's ICP unconverged (6 and 4 iterations, a last update of
1.7e-2), where one coarse correspondence at the 0.1 m gate flips with the
sums' order (1,471 against 1,472 pairs) and moves the unconverged result
by up to 3e-4; there the measurement is held within 1e-3, and the same
pair run to convergence within 1e-4. The optimized poses are held within
1e-3: the drifted graph is inconsistent (its loop edge disagrees with the
odometry), and on such a graph both packages' pose-graph steps keep a
noise floor of a few 1e-4 from their float32 forward differences
(``tests/test_torch_pose_graph.py``)."""

import numpy as np
import pytest

from cilantro_tpu import slam as jslam
from cilantro_tpu_torch import interop
from cilantro_tpu_torch import slam as tslam


def rot_z(a):
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)


def _graphs():
    return jslam.KeyframeGraph.empty(), tslam.KeyframeGraph.empty()


def _spawn_both(graphs, *args, **kwargs):
    ids = [pkg.spawn_keyframe(g, *args, **kwargs) for pkg, g in zip((jslam, tslam), graphs)]
    assert ids[0] == ids[1]


def _close_both(graphs, atol=1e-4, **kwargs):
    jg, tg = graphs
    added = (jslam.detect_loop_closures(jg, **kwargs),
             tslam.detect_loop_closures(tg, device="cpu", **kwargs))
    assert added[0] == added[1]
    assert list(zip(jg.edge_i, jg.edge_j)) == list(zip(tg.edge_i, tg.edge_j))
    assert jg.edge_weights == tg.edge_weights
    for zj, zt in zip(jg.measurements, tg.measurements):
        np.testing.assert_allclose(zt, zj, rtol=0, atol=atol)
    return added[1]


@pytest.mark.parametrize("levels, atol", [
    (None, 1e-3),  # the default levels: unconverged, see the module docstring
    (((0.04, 6, 8192, 0.01), (None, 40, None, 0.25)), 1e-4),  # run to convergence
])
def test_loop_closure_corrects_drift(rng, levels, atol):
    # 8 keyframes around a square loop with accumulated odometry drift; the
    # last revisits the first.
    n_kf = 9
    true_poses = []
    for i in range(n_kf):
        a = 2 * np.pi * i / (n_kf - 1)
        p = np.eye(4, dtype=np.float32)
        p[:3, :3] = rot_z(a)
        p[:3, 3] = [np.cos(a) - 1.0, np.sin(a), 0.0]
        true_poses.append(p)
    scene = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
    scene[:, 2] = 0.3 * np.sin(3 * scene[:, 0]) * np.cos(2 * scene[:, 1]) + 3.0

    graphs = _graphs()
    drift = np.eye(4, dtype=np.float32)
    est_poses = []
    for i, tp in enumerate(true_poses):
        if i > 0:
            d = np.eye(4, dtype=np.float32)
            d[:3, :3] = rot_z(0.01)
            d[:3, 3] = [0.01, -0.005, 0.0]
            drift = drift @ d
        est = (tp @ drift).astype(np.float32)
        est_poses.append(est)
        cam_pts = (scene - tp[:3, 3]) @ tp[:3, :3]
        _spawn_both(graphs, i, est, cam_pts, None, subsample=2000)
    jg, tg = graphs
    for a, b in zip(jg.keyframes, tg.keyframes):
        assert np.array_equal(a.points, b.points) and np.array_equal(a.pose, b.pose)
    for a, b in zip(jg.measurements, tg.measurements):
        assert np.array_equal(a, b)

    err_before = np.linalg.norm(est_poses[-1][:3, 3] - true_poses[-1][:3, 3])
    assert err_before > 0.02
    added = _close_both(graphs, atol, min_separation=3, max_translation=0.6,
                        icp_max_corr_dist_sq=0.25, icp_levels=levels)
    assert added >= 1

    jref, jdn = jg.optimize(max_iterations=25)
    tref, tdn = tg.optimize(max_iterations=25, device="cpu")
    for a, b in zip(jref, tref):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-3)
    err_after = np.linalg.norm(tref[-1][:3, 3] - true_poses[-1][:3, 3])
    assert err_after < err_before * 0.5, (err_before, err_after)


def test_relative_pose_roundtrip(rng):
    a = np.eye(4, dtype=np.float32)
    a[:3, :3] = rot_z(0.3)
    a[:3, 3] = rng.standard_normal(3)
    b = np.eye(4, dtype=np.float32)
    b[:3, :3] = rot_z(-0.2)
    b[:3, 3] = rng.standard_normal(3)
    z = tslam.relative_pose(a, b)
    assert np.array_equal(z, jslam.relative_pose(a, b))
    np.testing.assert_allclose(a @ z, b, atol=1e-5)


def test_loop_closure_min_separation_inclusive(rng):
    # A pair separated by exactly min_separation qualifies.
    scene = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
    scene[:, 2] = 0.3 * np.sin(3 * scene[:, 0]) + 3.0
    graphs = _graphs()
    for i in range(4):
        _spawn_both(graphs, i, np.eye(4, dtype=np.float32), scene, None, subsample=2000)
    _close_both(graphs, min_separation=3, max_translation=0.5, icp_max_corr_dist_sq=0.25)
    assert (0, 3) in set(zip(graphs[1].edge_i, graphs[1].edge_j))


def test_loop_closure_never_self_pairs(rng):
    # min_separation=0 must not register a keyframe against itself.
    scene = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    scene[:, 2] += 3.0
    graphs = _graphs()
    for i in range(3):
        _spawn_both(graphs, i, np.eye(4, dtype=np.float32), scene, None, subsample=1500)
    _close_both(graphs, min_separation=0, max_translation=0.5, icp_max_corr_dist_sq=0.25)
    assert all(i < j for i, j in zip(graphs[1].edge_i, graphs[1].edge_j))


@pytest.mark.parametrize("with_normals", [False, True])
def test_interop_graph_copy_detaches(rng, with_normals):
    """``keyframe_graph_from_numpy`` copies a JAX graph: equal arrays, and
    edges added to the copy leave the original alone."""
    jg = jslam.KeyframeGraph.empty()
    for i in range(3):
        pts = rng.standard_normal((50, 3)).astype(np.float32)
        jslam.spawn_keyframe(jg, 4 * i, np.eye(4, dtype=np.float32), pts,
                             pts / np.linalg.norm(pts, axis=1, keepdims=True) if with_normals else None)
    tg = interop.keyframe_graph_from_numpy(jg.keyframes, jg.edge_i, jg.edge_j, jg.measurements,
                                           jg.edge_weights)
    for a, b in zip(jg.keyframes, tg.keyframes):
        assert a.index == b.index and np.array_equal(a.points, b.points)
        assert (a.normals is None) == (b.normals is None) == (not with_normals)
    tg.add_edge(0, 2, np.eye(4, dtype=np.float32), 5.0)
    tg.keyframes[0].points[0] = 7.0
    assert len(jg.edge_i) == 2 and jg.keyframes[0].points[0, 0] != 7.0
