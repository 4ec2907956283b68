"""The port's pipelined driver (``cilantro_tpu_torch/slam/pipeline.py``)
on the CPU: against the port's scanned driver bit for bit (stage 1 is the
same graph-form fusion step on the same inputs) and against the JAX
package's two-stage program on two virtual CPU devices, at
``tests/test_pipeline.py``'s case (48×64, 6 frames, seed 3). Tolerances
against JAX: poses 1e-4 (the pool driver's bound) and the same ICP
iteration counts."""

import jax
import numpy as np
import pytest
import torch

from cilantro_tpu.core.rgbd import CameraIntrinsics as JK
from cilantro_tpu.slam import fusion as jf
from cilantro_tpu.slam import pipeline as jp
from cilantro_tpu_torch import native
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics as TK
from cilantro_tpu_torch.slam import driver as tdrv
from cilantro_tpu_torch.slam import fusion as tf_
from cilantro_tpu_torch.slam import pipeline as tp

H, W = 48, 64
ARGS = (100.0, 100.0, 31.5, 23.5)
CAP = 2 * H * W


@pytest.fixture(scope="module")
def sequence():
    return tdrv.synthetic_sequence(6, H, W, TK.make(*ARGS), seed=3)


@pytest.fixture(scope="module")
def port_pipelined(sequence):
    depths, _ = sequence
    stats = {}
    fmap, met = tp.run_fusion_sequence_pipelined(depths, TK.make(*ARGS), map_capacity=CAP,
                                                 cfg=tf_.FusionConfig(), device="cpu", stats=stats)
    return fmap, met, stats


def test_pipelined_equals_scanned_bit_for_bit(sequence, port_pipelined):
    depths, gt = sequence
    fmap_p, met_p, stats = port_pipelined
    fmap_s, met_s = tdrv.run_fusion_sequence_scanned(depths, TK.make(*ARGS), map_capacity=CAP,
                                                     cfg=tf_.FusionConfig(), device="cpu")
    assert met_p.frames == met_s.frames == 6
    np.testing.assert_array_equal(np.stack(met_p.poses), np.stack(met_s.poses))
    assert met_p.icp_iterations == met_s.icp_iterations
    assert torch.equal(fmap_p.data.view(torch.int32), fmap_s.data.view(torch.int32))
    assert met_p.num_map_points == met_s.num_map_points
    assert stats == {"device_seconds_per_frame": None,
                     "launches_per_frame": dict.fromkeys(native.launch_counts, 0)}
    assert met_p.seconds_per_frame > 0
    assert tdrv.ate_rmse(met_p.poses, gt, device="cpu") < 5e-3


def test_pipelined_matches_jax_two_devices(sequence, port_pipelined):
    depths, _ = sequence
    _, met_t, _ = port_pipelined
    mesh = jp.make_pipeline_mesh(jax.devices()[:2])
    _, met_j = jp.run_fusion_sequence_pipelined(depths, JK.make(*ARGS), mesh=mesh, map_capacity=CAP,
                                                cfg=jf.FusionConfig())
    assert len(met_t.poses) == len(met_j.poses) == 6
    np.testing.assert_allclose(np.stack(met_t.poses), np.stack(met_j.poses), rtol=0, atol=1e-4)
    assert met_t.icp_iterations == met_j.icp_iterations


def test_pipelined_single_frame():
    depths, _ = tdrv.synthetic_sequence(1, H, W, TK.make(*ARGS), seed=0)
    stats = {}
    fmap, met = tp.run_fusion_sequence_pipelined(depths, TK.make(*ARGS), device="cpu", stats=stats)
    _, met_j = jp.run_fusion_sequence_pipelined(depths, JK.make(*ARGS))
    assert met.frames == 1 and len(met.poses) == 1 and met.icp_iterations == [0]
    assert met.num_map_points == met_j.num_map_points > 0
    assert fmap.capacity == 4 * H * W and stats["launches_per_frame"] == {}


def test_pipeline_mesh_requires_two_devices():
    with pytest.raises(ValueError):
        tp.make_pipeline_mesh(["cpu"])
    assert tp.make_pipeline_mesh(["cpu", "cpu", "cpu"]) == (torch.device("cpu"),) * 2
