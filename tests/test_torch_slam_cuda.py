"""The port's SLAM backend on the card, against the port's own CPU run.

Two card solves of one BA problem give the same bits (sorted segment
reductions, no atomics), as do two pose-graph solves; one BA step (blocks,
PCG, back-substitution, camera update) makes no host sync.
Card and CPU sum in other orders, so solutions are held within 1e-4 (the
BA, the consistent pose graph) and ``run_slam`` to its own bounds. The
tests skip on a machine without a CUDA device. This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_slam_cuda.py
"""

import numpy as np
import pytest
import torch

from cilantro_tpu_torch import interop
from cilantro_tpu_torch import slam as tslam
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
from cilantro_tpu_torch.slam import bundle_adjustment as tba
from cilantro_tpu_torch.slam import pose_graph as tpg
from cilantro_tpu_torch.tools import slam_problems as sp


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _solve(problem, dev, **kw):
    return tba.bundle_adjust(*interop.ba_problem_from_numpy(*problem, device=dev),
                             device=dev, **kw)


@pytest.mark.cuda
def test_bundle_adjust_two_card_solves_same_bits(cuda):
    problem = sp.mapping_ba_problem(64, 20_000, 60_000)
    a = _solve(problem, cuda, max_iterations=3, max_cg=30)
    b = _solve(problem, cuda, max_iterations=3, max_cg=30)
    for x, y in ((a[0].linear, b[0].linear), (a[0].translation, b[0].translation), (a[1], b[1]),
                 (a[2], b[2])):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_bundle_adjust_card_matches_cpu(cuda):
    problem = sp.mapping_ba_problem(k=16, l=2_000, o=6_000, seed=1)
    card = _solve(problem, cuda, max_iterations=3, max_cg=30)
    cpu = _solve(problem, "cpu", max_iterations=3, max_cg=30)
    np.testing.assert_allclose(card[0].linear.cpu().numpy(), cpu[0].linear.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(card[0].translation.cpu().numpy(), cpu[0].translation.numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(card[1].cpu().numpy(), cpu[1].numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(card[2]), float(cpu[2]), rtol=1e-3)


@pytest.mark.cuda
def test_ba_step_makes_no_host_sync(cuda):
    """The PCG runs all ``max_cg`` iterations masked, so a BA step has no
    host read; anything else that waits on the host raises here."""
    problem = sp.mapping_ba_problem(64, 20_000, 60_000)
    poses, lmks, cam, lmk, obs = interop.ba_problem_from_numpy(*problem, device=cuda)
    k = poses.translation.shape[0]
    seg = tba._Segments.of(cam, lmk, k, lmks.shape[0])
    fixed = torch.zeros(k, dtype=torch.bool, device=cuda)
    fixed[0] = True
    w = torch.ones(cam.shape[0], device=cuda)
    args = (poses, lmks, cam, lmk, obs, w, seg, fixed, 1.0 - fixed.float(), 1e-6, 60)
    tba._ba_step(*args)  # warm-up: cuBLAS / cuSOLVER handles and workspaces
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tba._ba_step(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out[2])


@pytest.mark.cuda
def test_pose_graph_card_matches_cpu_and_repeats(cuda):
    _, init, ei, ej, z = sp.pose_graph_chain(np.random.default_rng(0))

    def run(dev):
        mats = np.stack(init).astype(np.float32)
        zs = np.stack(z).astype(np.float32)
        poses = interop.transform_from_numpy(mats[:, :3, :3], mats[:, :3, 3], device=dev)
        meas = interop.transform_from_numpy(zs[:, :3, :3], zs[:, :3, 3], device=dev)
        return tpg.optimize_pose_graph(poses, torch.as_tensor(ei, device=dev), torch.as_tensor(ej, device=dev),
                                       meas, max_iterations=20)

    a, b, cpu = run(cuda), run(cuda), run("cpu")
    assert torch.equal(a[0].linear, b[0].linear) and torch.equal(a[0].translation, b[0].translation)
    np.testing.assert_allclose(a[0].linear.cpu().numpy(), cpu[0].linear.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(a[0].translation.cpu().numpy(), cpu[0].translation.numpy(), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_run_slam_scanned_on_the_card(cuda):
    """``run_slam`` with the scanned front end and BA on the card at the CPU
    tests' shape (72×96, 48 frames): a loop closes and the JAX test's
    orientation, ATE and map bounds hold."""
    h, w = 72, 96
    k = CameraIntrinsics.make(fx=w * 525.0 / 640.0, fy=w * 525.0 / 640.0, cx=(w - 1) / 2.0, cy=(h - 1) / 2.0)
    depths, gt = tslam.synthetic_panorama_sequence(48, h, w, k, seed=3, depth_noise=0.008)
    fmap, res = tslam.run_slam(
        depths, k, map_capacity=8 * h * w, cfg=tslam.FusionConfig(localize_stride=1, icp_iterations=8),
        slam=tslam.SlamConfig(keyframe_every=5, loop_min_separation=3, loop_edge_weight=5.0, run_ba=True),
        frontend="scanned", device=cuda,
    )

    def rot_err(p, g):
        rel = p[:3, :3].T @ g[:3, :3]
        return np.degrees(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1)))

    assert res.num_loop_closures >= 1
    before = max(rot_err(p, g) for p, g in zip(res.odometry_poses, gt))
    after = max(rot_err(p, g) for p, g in zip(res.refined_poses, gt))
    assert before > 1.0 and after < 0.65 * before, (before, after)
    ate_before = tslam.ate_rmse(res.odometry_poses, gt, device=cuda)
    ate_after = tslam.ate_rmse(res.refined_poses, gt, device=cuda)
    assert ate_after <= ate_before * 1.2, (ate_before, ate_after)
    pts = fmap.points[fmap.valid].cpu().numpy()
    rad = np.linalg.norm(pts[:, [0, 2]], axis=1)
    assert len(pts) > h * w and (np.abs(rad - 2.5) < 0.7).mean() > 0.95
