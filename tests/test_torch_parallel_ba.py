"""The port's landmark-sharded bundle adjustment (``bundle_adjust_sharded``
in ``cilantro_tpu_torch/slam/bundle_adjustment.py``) and ``run_slam`` with
``SlamConfig.ba_mesh`` on a gloo group of 2 subprocess ranks, against the
JAX package's on a (2, 1) mesh of the conftest's virtual CPU devices.

* The BA: ``tests/test_slam_backend.py``'s problem (4 cameras, 64
  landmarks, partitioned by landmark as its sharded test does, 15
  iterations): poses within 1e-4 of JAX's and the JAX test's residual
  bound (1e-6).
* ``run_slam`` at ``tests/test_torch_slam_loop.py``'s row (48 frames of a
  72×96 drifting panorama, keyframes every 5 frames, BA on) with the BA
  sharded: JAX's keyframes, loop closures and loop-edge set, refined poses
  within 1e-2 of JAX's and max orientation errors within 0.5° of JAX's
  (that test's bounds: the two packages' odometry parts in float32 order,
  see it), and that test's drift bounds.
* Every replicated output bit-identical across the two ranks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cilantro_tpu import slam as jslam
from cilantro_tpu.core.rgbd import CameraIntrinsics as JIntrinsics
from cilantro_tpu.core.transforms import Transform as JTransform
from cilantro_tpu.parallel import make_mesh
from cilantro_tpu.slam.fusion import FusionConfig as JFusionConfig
from torch_parallel_ranks import Ranks
from torch_parallel_worker import SLAM_FRAMES, SLAM_FUSION, SLAM_HW, SLAM_KW, ba_partition, small_ba

WORLD = 2
H, W = SLAM_HW
JK = JIntrinsics.make(fx=W * 525.0 / 640.0, fy=W * 525.0 / 640.0, cx=(W - 1) / 2.0, cy=(H - 1) / 2.0)


def _rot_err_deg(p, g):
    rel = p[:3, :3].T @ g[:3, :3]
    return np.degrees(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1)))


@pytest.fixture(scope="module")
def sequence():
    return jslam.synthetic_panorama_sequence(SLAM_FRAMES, H, W, JK, seed=3, depth_noise=0.008)


@pytest.fixture(scope="module")
def ranks(sequence, tmp_path_factory):
    depths, _ = sequence
    return Ranks("ba", WORLD, tmp_path_factory.mktemp("ba"), {"depths": np.stack(depths)})


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(WORLD, 1, devices=jax.devices()[:WORLD])


def test_sharded_ba_matches_jax(ranks, jax_slam, mesh):
    # ``jax_slam`` runs JAX's run_slam while the ranks work.
    lin, tr, x0, cam, lmk, obs = small_ba()
    order, local = ba_partition(cam, lmk, len(x0), WORLD)
    poses, _, resid = jslam.bundle_adjust_sharded(
        JTransform(jnp.asarray(lin), jnp.asarray(tr)), jnp.asarray(x0), jnp.asarray(cam[order]),
        jnp.asarray(local), jnp.asarray(obs[order]), jnp.ones(len(order), bool), mesh=mesh, max_iterations=15)
    assert float(resid) < 1e-6
    res = ranks.results()
    for r in res:
        np.testing.assert_allclose(r["small"]["linear"], np.asarray(poses.linear), rtol=0, atol=1e-4)
        np.testing.assert_allclose(r["small"]["translation"], np.asarray(poses.translation), rtol=0, atol=1e-4)
        assert r["small"]["residual"] < 1e-6
    for key in ("linear", "translation", "residual", "cg_iterations"):
        assert np.array_equal(res[0]["small"][key], res[1]["small"][key]), key


@pytest.fixture(scope="module")
def jax_slam(sequence, mesh):
    depths, _ = sequence
    edges = {}
    import cilantro_tpu.slam.slam as jslam_mod
    from unittest import mock

    detect = jslam_mod.detect_loop_closures

    def detect_kept(graph, **kw):
        n = detect(graph, **kw)
        edges["edges"] = sorted(zip(graph.edge_i, graph.edge_j))
        return n

    with mock.patch.object(jslam_mod, "detect_loop_closures", detect_kept):
        _, res = jslam.run_slam(depths, JK, map_capacity=8 * H * W, cfg=JFusionConfig(**SLAM_FUSION),
                                slam=jslam.SlamConfig(**SLAM_KW, ba_mesh=mesh))
    return res, edges["edges"]


def test_run_slam_with_ba_mesh_matches_jax(ranks, jax_slam, sequence):
    jres, jedges = jax_slam
    _, gt = sequence
    res = ranks.results()
    port = res[0]["slam"]
    assert port["keyframes"] == list(jres.keyframe_indices)
    assert port["loops"] == jres.num_loop_closures >= 1
    assert [tuple(e) for e in port["edges"]] == [tuple(e) for e in jedges]
    for a, b in zip(jres.refined_poses, port["refined"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-2)
    for poses in ("odometry", "refined"):
        j = max(_rot_err_deg(p, g) for p, g in zip(getattr(jres, f"{poses}_poses"), gt))
        t = max(_rot_err_deg(p, g) for p, g in zip(port[poses], gt))
        assert abs(t - j) < 0.5, (poses, j, t)
    # tests/test_slam_loop.py's drift bounds on the port's run.
    yaw_before = max(_rot_err_deg(p, g) for p, g in zip(port["odometry"], gt))
    yaw_after = max(_rot_err_deg(p, g) for p, g in zip(port["refined"], gt))
    assert yaw_before > 1.0 and yaw_after < 0.65 * yaw_before, (yaw_before, yaw_after)
    end_before, end_after = _rot_err_deg(port["odometry"][-1], gt[-1]), _rot_err_deg(port["refined"][-1], gt[-1])
    assert end_after < 0.65 * end_before, (end_before, end_after)
    assert port["map_points"] > H * W
    for key in ("refined", "odometry", "keyframes", "edges", "map_points"):
        assert np.array_equal(np.asarray(res[1]["slam"][key]), np.asarray(port[key])), key
