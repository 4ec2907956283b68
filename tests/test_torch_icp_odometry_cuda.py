"""``run_icp_odometry`` on the card, where both levels' nn1 passes take the
Morton-tile pruned kernels (compact or masked), held to the benchmark's
plain reference (``portbench/reference/icp.py``: exact gated nearest
neighbours, eager PyTorch) on the same card, on one 640×480 pair. No JAX:
run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_icp_odometry_cuda.py
"""

import pytest
import torch

from cilantro_tpu_torch import native
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
from cilantro_tpu_torch.neighbors import fused_nn
from cilantro_tpu_torch.slam.odometry import OdometryConfig, run_icp_odometry
from portbench import clips, compare
from portbench.reference import icp as ref_icp
from portbench.reference.geometry import Intrinsics

SENSOR = {"height": 480, "width": 640, "fx": 525.0, "fy": 525.0, "cx": 319.5, "cy": 239.5}
# The icp.pairs cell's limits (portbench/limits/icp.pairs.json): the
# program's float32 ‖q‖² + ‖k‖² − 2q·k picks another of two targets within
# about 1e-6 m² of each other, which moves a pose by about 1e-5.
POSE_TOL_M = 3e-4
POSE_TOL_RAD = 3e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the nn1 kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_entry_on_the_card_matches_the_plain_reference(cuda):
    depths, _ = clips.make_clips(2147470101, 1, 2, SENSOR, 0.004, cuda)
    k = CameraIntrinsics.make(SENSOR["fx"], SENSOR["fy"], SENSOR["cx"], SENSOR["cy"])
    cfg = OdometryConfig()
    native.reset_launch_counts()
    poses, iterations = run_icp_odometry(depths[0], k, cfg=cfg, device=cuda)
    launches = dict(native.launch_counts)
    assert launches["nn1_fused"] == 0
    assert launches["nn1_compact"] + launches["nn1_masked"] == int(iterations.sum())
    settings = dict(levels=cfg.levels, convergence_tol=cfg.convergence_tol,
                    point_weight=cfg.point_weight, plane_weight=cfg.plane_weight,
                    max_gn_iterations=cfg.max_gn_iterations)
    ref, ref_its = ref_icp.run(depths, Intrinsics.make(SENSOR["fx"], SENSOR["fy"], SENSOR["cx"],
                                                       SENSOR["cy"]), settings, cuda)
    gap_m, gap_rad = compare.pose_gaps(poses, ref[0])
    assert gap_m <= POSE_TOL_M and gap_rad <= POSE_TOL_RAD, (gap_m, gap_rad)
    assert iterations.tolist() == ref_its[0]
