"""The port's ``run_slam`` (``cilantro_tpu_torch/slam/slam.py``) against the
JAX package's on the CPU, at ``tests/test_slam_loop.py``'s shape: 48
frames of a 72×96 drifting panorama sweep (``seed=3``,
``depth_noise=0.008``), keyframes every 5 frames, landmark BA on.

Each package runs once per module (the fixtures). Two kinds of check:

* each backend stage of the port started from the exact state the JAX
  package reached (carried across by :mod:`cilantro_tpu_torch.interop`):
  keyframe clouds, loop closures, pose graph, BA association and solve,
  the correction's propagation and the map rebuild;
* the whole run held to JAX's keyframes and loop-edge set, its refined
  poses within 1e-2 and its max orientation errors within 0.5° of JAX's,
  and to the JAX test's own bounds. Those tolerances are wide because the
  odometry is: single z-buffer winners flip with float32 order from frame
  4 on and the random-walk drift the sweep is built to produce amplifies
  them, so the two packages' odometry parts by up to 3.8e-3 (a matrix
  element) and 0.16° of max orientation error over the 48 frames.

Each stage's tolerance is stated where it is checked."""

import copy
from unittest import mock

import numpy as np
import pytest
import torch

import cilantro_tpu.slam.bundle_adjustment as jba_mod
import cilantro_tpu.slam.slam as jslam_mod
from cilantro_tpu import slam as jslam
from cilantro_tpu.core.rgbd import CameraIntrinsics as JIntrinsics
from cilantro_tpu.slam.fusion import FusionConfig as JFusionConfig
from cilantro_tpu_torch import interop
from cilantro_tpu_torch import slam as tslam
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics, depth_to_points_normals
from cilantro_tpu_torch.slam import slam as tslam_mod
from cilantro_tpu_torch.slam.fusion import FusionConfig

H, W, FRAMES = 72, 96, 48
SLAM = dict(keyframe_every=5, loop_min_separation=3, loop_edge_weight=5.0, run_ba=True)
FUSION = dict(localize_stride=1, icp_iterations=8)


def _intr(cls):
    return cls.make(fx=W * 525.0 / 640.0, fy=W * 525.0 / 640.0, cx=(W - 1) / 2.0, cy=(H - 1) / 2.0)


K, JK = _intr(CameraIntrinsics), _intr(JIntrinsics)


def _rot_err_deg(p, g):
    rel = p[:3, :3].T @ g[:3, :3]
    return np.degrees(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1)))


def _edges(graph):
    return set(zip(graph.edge_i, graph.edge_j))


def _copy_graph(g):
    return interop.keyframe_graph_from_numpy(g.keyframes, g.edge_i, g.edge_j, g.measurements,
                                             g.edge_weights)


@pytest.fixture(scope="module")
def sequence():
    return jslam.synthetic_panorama_sequence(FRAMES, H, W, JK, seed=3, depth_noise=0.008)


@pytest.fixture(scope="module")
def jax_run(sequence):
    """JAX's run with every stage's input and output kept: the keyframe
    graph before and after the loop closures, the pose graph's poses, the
    BA problem and its solution."""
    depths, _ = sequence
    kept = {}
    detect, optimize, refine = jslam_mod.detect_loop_closures, jslam.KeyframeGraph.optimize, jslam_mod._refine_ba
    solve = jba_mod.bundle_adjust

    def detect_kept(graph, **kw):
        kept["graph_before_loops"] = copy.deepcopy(graph)
        n = detect(graph, **kw)
        kept["graph"] = copy.deepcopy(graph)
        return n

    def optimize_kept(self, **kw):
        out = optimize(self, **kw)
        kept["pose_graph"] = out
        return out

    def refine_kept(graph, refined, cfg):
        out = refine(graph, refined, cfg)
        kept["refine_ba"] = (refined, out)
        return out

    def solve_kept(*args, **kw):
        out = solve(*args, **kw)
        poses0, lmks, cam, lmk, obs = args
        kept["ba_problem"] = tuple(np.asarray(a) for a in (
            poses0.linear, poses0.translation, lmks, cam, lmk, obs))
        kept["ba_solution"] = tuple(np.asarray(a) for a in (out[0].linear, out[0].translation, out[1]))
        return out

    with mock.patch.object(jslam_mod, "detect_loop_closures", detect_kept), \
            mock.patch.object(jslam.KeyframeGraph, "optimize", optimize_kept), \
            mock.patch.object(jslam_mod, "_refine_ba", refine_kept), \
            mock.patch.object(jba_mod, "bundle_adjust", solve_kept):
        fmap, res = jslam.run_slam(depths, JK, map_capacity=8 * H * W, cfg=JFusionConfig(**FUSION),
                                   slam=jslam.SlamConfig(**SLAM))
    kept["points"] = np.asarray(fmap.points)[np.asarray(fmap.valid)]
    return res, kept


@pytest.fixture(scope="module")
def port_run(sequence):
    depths, _ = sequence
    kept = {}
    detect = tslam_mod.detect_loop_closures

    def detect_kept(graph, **kw):
        n = detect(graph, **kw)
        kept["graph"] = copy.deepcopy(graph)
        return n

    stats = {}
    with mock.patch.object(tslam_mod, "detect_loop_closures", detect_kept):
        fmap, res = tslam.run_slam(depths, K, map_capacity=8 * H * W, cfg=FusionConfig(**FUSION),
                                   slam=tslam.SlamConfig(**SLAM), device="cpu", stats=stats)
    kept["stats"] = stats
    return fmap, res, kept


def test_run_slam_matches_jax(jax_run, port_run, sequence):
    (jres, jkept), (_, tres, tkept) = jax_run, port_run
    _, gt = sequence
    assert tres.keyframe_indices == jres.keyframe_indices
    assert tres.num_loop_closures == jres.num_loop_closures >= 1
    assert _edges(tkept["graph"]) == _edges(jkept["graph"])
    for a, b in zip(jres.refined_poses, tres.refined_poses):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-2)
    for poses in ("odometry_poses", "refined_poses"):
        j = max(_rot_err_deg(p, g) for p, g in zip(getattr(jres, poses), gt))
        t = max(_rot_err_deg(p, g) for p, g in zip(getattr(tres, poses), gt))
        assert abs(t - j) < 0.5, (poses, j, t)
    assert set(tkept["stats"]["stage_seconds"]) == {
        "frontend", "keyframes", "loop_closures", "pose_graph", "ba", "rebuild"}


def test_run_slam_meets_the_jax_test_bounds(port_run, sequence):
    """``tests/test_slam_loop.py::test_slam_loop_corrects_drift``'s
    assertions on the port's result."""
    fmap, res, _ = port_run
    _, gt = sequence
    assert res.num_loop_closures >= 1
    ate_before = tslam.ate_rmse(res.odometry_poses, gt, device="cpu")
    ate_after = tslam.ate_rmse(res.refined_poses, gt, device="cpu")
    yaw_before = max(_rot_err_deg(p, g) for p, g in zip(res.odometry_poses, gt))
    yaw_after = max(_rot_err_deg(p, g) for p, g in zip(res.refined_poses, gt))
    assert yaw_before > 1.0
    assert yaw_after < 0.65 * yaw_before, (yaw_before, yaw_after)
    end_before = _rot_err_deg(res.odometry_poses[-1], gt[-1])
    end_after = _rot_err_deg(res.refined_poses[-1], gt[-1])
    assert end_after < 0.65 * end_before, (end_before, end_after)
    assert ate_after <= ate_before * 1.2, (ate_before, ate_after)
    assert int(fmap.num_points()) > H * W
    pts = fmap.points[fmap.valid].numpy()
    rad = np.linalg.norm(pts[:, [0, 2]], axis=1)
    assert (np.abs(rad - 2.5) < 0.7).mean() > 0.95


def test_keyframes_on_jax_odometry(jax_run, sequence):
    """Keyframe clouds from JAX's odometry: the same pixels kept (the
    validity tests compare depths exactly) and the same poses and odometry
    edges bit for bit; points within 1e-6 m and normals within 1e-5 (the
    unprojection's and cross products' float32 order)."""
    jres, jkept = jax_run
    depths, _ = sequence
    want = jkept["graph_before_loops"]
    got = tslam.KeyframeGraph.empty()
    for f in jres.keyframe_indices:
        pts, nrm, valid = depth_to_points_normals(torch.as_tensor(depths[f]), K)
        tslam.spawn_keyframe(got, f, np.asarray(jres.odometry_poses[f], np.float32), pts.numpy(),
                             nrm.numpy(), valid=valid.numpy())
    assert len(got.keyframes) == len(want.keyframes)
    for a, b in zip(want.keyframes, got.keyframes):
        assert a.index == b.index and np.array_equal(a.pose, b.pose)
        assert a.points.shape == b.points.shape
        np.testing.assert_allclose(b.points, a.points, rtol=0, atol=1e-6)
        np.testing.assert_allclose(b.normals, a.normals, rtol=0, atol=1e-5)
    assert _edges(got) == _edges(want)
    for a, b in zip(want.measurements, got.measurements):
        assert np.array_equal(a, b)


def test_loop_closures_on_jax_graph(jax_run):
    """The loop-closure stage on JAX's keyframe graph: the same edges, each
    measurement within 1e-4 (converged multires ICP, sums in other
    orders)."""
    _, jkept = jax_run
    want = jkept["graph"]
    got = _copy_graph(jkept["graph_before_loops"])
    cfg = tslam.SlamConfig(**SLAM)
    n = tslam.detect_loop_closures(
        got, min_separation=cfg.loop_min_separation, max_translation=cfg.loop_max_translation,
        max_rotation_deg=cfg.loop_max_rotation_deg, icp_max_corr_dist_sq=cfg.loop_icp_max_corr_dist_sq,
        icp_levels=cfg.loop_icp_levels, convergence_tol=1e-5, weight=cfg.loop_edge_weight, device="cpu",
    )
    assert n >= 1
    assert list(zip(got.edge_i, got.edge_j)) == list(zip(want.edge_i, want.edge_j))
    assert got.edge_weights == want.edge_weights
    for a, b in zip(want.measurements, got.measurements):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)


def test_pose_graph_on_jax_graph(jax_run):
    """The pose graph on JAX's graph (its loop edges included): poses
    within 1e-3, the noise floor of both packages' forward-difference steps
    on an inconsistent graph (``tests/test_torch_pose_graph.py``)."""
    _, jkept = jax_run
    want, _ = jkept["pose_graph"]
    got, dn = _copy_graph(jkept["graph"]).optimize(max_iterations=25, device="cpu")
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-3)
    assert dn < 1e-2


def test_bundle_adjust_on_jax_problem(jax_run):
    """The BA on the problem JAX's association built (landmarks, indices
    and observations as JAX passed them): poses and landmarks within 1e-4
    of JAX's solution. The association itself runs nn1, whose near-tied
    neighbours may swap between the packages, so it is held apart
    (:func:`test_ba_association_on_jax_graph`)."""
    _, jkept = jax_run
    problem = interop.ba_problem_from_numpy(*jkept["ba_problem"], device="cpu")
    poses, lmks, resid = tslam.bundle_adjust(*problem, device="cpu")
    lin, tr, want_lmks = jkept["ba_solution"]
    np.testing.assert_allclose(poses.linear.numpy(), lin, rtol=0, atol=1e-4)
    np.testing.assert_allclose(poses.translation.numpy(), tr, rtol=0, atol=1e-4)
    np.testing.assert_allclose(lmks.numpy(), want_lmks, rtol=0, atol=1e-4)
    assert np.isfinite(float(resid))


def test_ba_association_on_jax_graph(jax_run):
    """The association on JAX's graph and pose-graph poses: the same
    landmarks an edge (the ``default_rng(0)`` draw keeps 512 of each
    edge's matches), the same cameras, and the observations of at least
    99% of the landmarks equal."""
    _, jkept = jax_run
    refined, _ = jkept["refine_ba"]
    got = tslam_mod._ba_problem(jkept["graph"], refined, tslam.SlamConfig(**SLAM), "cpu")
    lin, tr, lmks, cam, lmk, obs = jkept["ba_problem"]
    np.testing.assert_array_equal(got[0], lin)
    np.testing.assert_array_equal(got[1], tr)
    assert np.array_equal(got[3], cam) and np.array_equal(got[4], lmk)
    same = np.all(got[5] == obs, axis=1)
    assert same.mean() > 0.99, same.mean()


def test_propagate_correction_on_jax_state(jax_run, sequence):
    """The correction's propagation is host numpy in both packages: bit for
    bit from JAX's odometry, keyframes and BA poses."""
    jres, jkept = jax_run
    _, kf_refined = jkept["refine_ba"]
    got = tslam_mod._propagate_correction(jres.odometry_poses, jres.keyframe_indices, kf_refined)
    want = jslam_mod._propagate_correction(jres.odometry_poses, jres.keyframe_indices, kf_refined)
    for a, b in zip(want, got):
        assert np.array_equal(a, b)
    for a, b in zip(jres.refined_poses, got):
        assert np.array_equal(a, b)


def test_rebuild_on_jax_poses(jax_run, sequence):
    """The map rebuilt at JAX's refined poses: live points within 0.5% of
    JAX's count (single z-buffer winners flip with float32 order) and on
    the wall as the JAX test requires."""
    jres, jkept = jax_run
    depths, _ = sequence
    fmap = tslam.integrate_sequence(depths, jres.refined_poses, K, map_capacity=8 * H * W,
                                    cfg=FusionConfig(**FUSION), device="cpu")
    pts = fmap.points[fmap.valid].numpy()
    assert abs(len(pts) - len(jkept["points"])) <= 0.005 * len(jkept["points"])
    rad = np.linalg.norm(pts[:, [0, 2]], axis=1)
    assert (np.abs(rad - 2.5) < 0.7).mean() > 0.95


@pytest.fixture
def world_of_one():
    """A gloo world of one in this process (``make_mesh`` makes it),
    destroyed at teardown."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    yield
    dist.destroy_process_group()


def test_sharded_ba_runs(jax_run, world_of_one):
    """``SlamConfig.ba_mesh`` runs the landmark-sharded BA: on a mesh of one
    rank (gloo), the BA stage on JAX's graph and pose-graph poses gives
    JAX's BA stage's poses within 1e-4 (measured 3.2e-6; the sharded
    solve runs all 10 outer iterations and reduces its camera sums
    through the collectives; ``tests/test_torch_parallel_ba.py`` runs it
    on two ranks)."""
    from cilantro_tpu_torch.parallel import make_mesh

    _, jkept = jax_run
    refined, want = jkept["refine_ba"]
    mesh = make_mesh(device="cpu")
    got = tslam_mod._refine_ba(_copy_graph(jkept["graph"]), refined, tslam.SlamConfig(**SLAM, ba_mesh=mesh),
                               device="cpu")
    assert len(got) == len(want)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
