"""Checkpoint and resume in the port (``cilantro_tpu_torch/slam/checkpoint.py``
and ``run_fusion_sequence``'s ``resume_from`` / ``checkpoint_path`` /
``checkpoint_every``) on the CPU, against the JAX package's files.

The port's own kill and resume gives its uninterrupted run's trajectory
bit for bit. Resumed from a checkpoint the JAX package wrote, the port's
tail is held to JAX's uninterrupted run within 1e-5 m / rad: from the
same carry the two packages track the remaining frames with float32 sums
in other orders (the pool driver's poses part by ~1e-7 a frame,
``tests/test_torch_fusion.py``)."""

import numpy as np
import pytest

from cilantro_tpu import slam as jslam
from cilantro_tpu.core.rgbd import CameraIntrinsics as JIntrinsics
from cilantro_tpu_torch import slam as tslam
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics

K = CameraIntrinsics.make(100.0, 100.0, 31.5, 23.5)
JK = JIntrinsics.make(100.0, 100.0, 31.5, 23.5)
H, W = 48, 64


def test_kill_and_resume_bit_identical(tmp_path):
    depths, _ = tslam.synthetic_sequence(8, H, W, K, seed=3)
    ckpt = str(tmp_path / "ck.npz")
    _, full = tslam.run_fusion_sequence(depths, K, device="cpu")
    tslam.run_fusion_sequence(depths[:5], K, checkpoint_path=ckpt, device="cpu")
    _, resumed = tslam.run_fusion_sequence(depths, K, resume_from=ckpt, device="cpu")
    assert len(resumed.poses) == len(full.poses)
    assert resumed.icp_iterations == full.icp_iterations
    for i, (a, b) in enumerate(zip(full.poses, resumed.poses)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")


@pytest.mark.parametrize("every", [2, 3])
def test_checkpoint_every_resumes_bit_identical(tmp_path, every):
    """Checkpoints every ``every`` frames: the last one written resumes to
    the uninterrupted run's bits."""
    depths, _ = tslam.synthetic_sequence(7, H, W, K, seed=5)
    ckpt = str(tmp_path / "ck.npz")
    _, full = tslam.run_fusion_sequence(depths, K, checkpoint_path=ckpt, checkpoint_every=every,
                                        device="cpu")
    ck = tslam.load_checkpoint(ckpt)
    assert ck.next_frame == 1 + every * ((len(depths) - 1) // every)
    _, resumed = tslam.run_fusion_sequence(depths, K, resume_from=ckpt, device="cpu")
    for a, b in zip(full.poses, resumed.poses):
        np.testing.assert_array_equal(a, b)


def test_resume_from_a_jax_checkpoint(tmp_path):
    depths, _ = jslam.synthetic_sequence(8, H, W, JK, seed=3)
    ckpt = str(tmp_path / "jax.npz")
    _, jax_full = jslam.run_fusion_sequence(depths, JK)
    jslam.run_fusion_sequence(depths[:5], JK, checkpoint_path=ckpt)
    _, resumed = tslam.run_fusion_sequence(depths, K, resume_from=ckpt, device="cpu")
    assert len(resumed.poses) == len(jax_full.poses)
    for i in range(5):  # the carried trajectory comes back as written
        np.testing.assert_array_equal(resumed.poses[i], np.asarray(jax_full.poses[i]))
    for i in range(5, len(depths)):
        np.testing.assert_allclose(resumed.poses[i], np.asarray(jax_full.poses[i]), rtol=0, atol=1e-5)


def test_checkpoint_roundtrip_fields(tmp_path):
    depths, _ = tslam.synthetic_sequence(3, H, W, K, seed=4)
    ckpt = str(tmp_path / "ck.npz")
    fmap, met = tslam.run_fusion_sequence(depths, K, checkpoint_path=ckpt, device="cpu")
    ck = tslam.load_checkpoint(ckpt)
    np.testing.assert_array_equal(ck.map_data, fmap.data.numpy())
    assert ck.next_frame == 3 and len(ck.poses) == 3
    assert ck.index_map is not None and ck.index_map.shape == (H, W)
    assert list(ck.icp_iterations) == met.icp_iterations
    assert ck.fusion_map(device="cpu").data.dtype == fmap.data.dtype


def _graph(pkg):
    g = pkg.KeyframeGraph.empty()
    rng = np.random.default_rng(0)
    for i in range(3):
        g.add_keyframe(pkg.Keyframe(
            index=i * 5,
            pose=np.eye(4, dtype=np.float32),
            points=rng.standard_normal((20, 3)).astype(np.float32),
            normals=None if i == 1 else rng.standard_normal((20, 3)).astype(np.float32),
        ))
    g.add_edge(0, 1, np.eye(4, dtype=np.float32), 2.0)
    return g


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_keyframe_graph_crosses_packages(tmp_path, writer):
    """A checkpoint with a keyframe graph written by either package loads
    in the other with the same keys and arrays."""
    p = str(tmp_path / "g.npz")
    eye = [np.eye(4, dtype=np.float32)]
    if writer == "jax":
        jslam.save_checkpoint(p, jslam.empty_map(64), eye, 1, graph=_graph(jslam))
        ck, g = tslam.load_checkpoint(p), _graph(tslam)
    else:
        tslam.save_checkpoint(p, tslam.empty_map(64, device="cpu"), eye, 1, graph=_graph(tslam))
        ck, g = jslam.load_checkpoint(p), _graph(jslam)
    with np.load(p) as z:
        assert sorted(z.files) == sorted(
            ["map_data", "poses", "next_frame", "n_keyframes", "edge_i", "edge_j", "edge_z", "edge_w"]
            + [f"kf{i}_{f}" for i in range(3) for f in ("index", "pose", "points")]
            + ["kf0_normals", "kf2_normals"])
    assert len(ck.graph.keyframes) == 3
    assert ck.graph.keyframes[1].normals is None and ck.graph.keyframes[2].normals is not None
    assert ck.graph.edge_i == [0] and ck.graph.edge_weights == [2.0]
    np.testing.assert_array_equal(ck.graph.keyframes[0].points, g.keyframes[0].points)
