"""The CUDA ``project_to_rotation`` kernel against its plain PyTorch
version, and the scanned drivers' CUDA-graph replays on the card.

The kernel repeats the plain version's operations one IEEE rounding each,
so the two agree bit for bit (compared as int32 views). A replay must
equal the eager graph-form steps within 1e-5 (the captured cuBLAS calls
may sum in another order) and launch what one captured step records. The
tests skip on a machine without a CUDA device. This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_scanned_cuda.py
"""

import numpy as np
import pytest
import torch

from cilantro_tpu_torch.core import transforms as tt
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
from cilantro_tpu_torch.slam import driver as td
from cilantro_tpu_torch.slam import splat_fusion as tsf
from cilantro_tpu_torch.slam.fusion import FusionConfig


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _matrices(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "near_identity":
        a = np.eye(3) + 1e-6 * rng.standard_normal((n, 3, 3))
    elif kind == "general":
        a = rng.standard_normal((n, 3, 3))
    elif kind == "scaled":  # Kabsch cross-covariances reach 1e4 and more
        a = 1e4 * rng.standard_normal((n, 3, 3))
    else:  # exact and tied entries
        a = rng.integers(-2, 3, size=(n, 3, 3)).astype(np.float64)
        a[0] = 0.0
    return a.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["near_identity", "general", "scaled", "small_integers"])
@pytest.mark.parametrize("n", [1, 127, 4099])
def test_rotation_kernel_matches_plain(cuda, kind, n):
    x = torch.from_numpy(_matrices(kind, n, seed=n)).to(cuda)
    before = tt.launch_counts["project_to_rotation"]
    got = tt.project_to_rotation(x)
    torch.cuda.synchronize()
    assert tt.launch_counts["project_to_rotation"] - before == 1
    want = tt.project_to_rotation_plain(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.isfinite(got).all()


@pytest.mark.cuda
def test_rotation_kernel_takes_views_and_batches(cuda):
    x = torch.from_numpy(_matrices("general", 24)).to(cuda)
    view = x.reshape(2, 12, 3, 3).transpose(-1, -2)  # not contiguous
    got = tt.project_to_rotation(view)
    assert got.shape == (2, 12, 3, 3)
    assert torch.equal(got.view(torch.int32), tt.project_to_rotation_plain(view).view(torch.int32))


@pytest.mark.cuda
def test_rotation_kernel_does_not_wait_on_the_host(cuda):
    x = torch.from_numpy(_matrices("general", 64)).to(cuda)
    tt.project_to_rotation(x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tt.project_to_rotation(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _eager_graph_form_splat(depths, k, cfg, dev):
    staged = [torch.as_tensor(d, device=dev) for d in depths]
    smap = tsf.init_splat_map(*tsf._frame_images(staged[0], k, *depths[0].shape), cfg)
    pose = tt.identity(3, device=dev)
    poses = [pose.matrix()]
    for d in staged[1:]:
        smap, pose = tsf.splat_fusion_step(smap, d, pose, k, cfg=cfg, loop="graph")
        poses.append(pose.matrix())
    return np.stack([p.cpu().numpy() for p in poses])


@pytest.mark.cuda
def test_scanned_splat_replays_the_graph_form(cuda):
    k = CameraIntrinsics.make(140.0, 140.0, 79.5, 63.5)
    depths, gt = td.synthetic_sequence(4, 128, 160, k, seed=0)
    cfg = tsf.SplatConfig(radius=2, margin=16)
    stats = {}
    _, poses, spf, launches = tsf.run_splat_sequence_scanned(depths, k, cfg=cfg, stats=stats)
    np.testing.assert_allclose(np.stack(poses), _eager_graph_form_splat(depths, k, cfg, cuda),
                               atol=1e-5, rtol=0)
    n = cfg.icp_iterations
    assert stats["launches_per_frame"] == {
        "window_read_codes": n, "splat_argmin2": 1, "flow_select_rows": 1, "project_to_rotation": n,
    }
    assert launches == [{"window_read_codes": n, "splat_argmin2": 1, "flow_select_rows": 1}] * 3
    assert spf > 0 and stats["device_seconds_per_frame"] > 0
    assert all(1 <= i <= n for i in stats["iterations"])
    assert td.ate_rmse(poses, gt) < 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_scanned_pool_replays_the_graph_form(cuda, stride):
    k = CameraIntrinsics.make(120.0, 120.0, 63.5, 47.5)
    depths, gt = td.synthetic_sequence(6, 96, 128, k, seed=0)
    cfg = FusionConfig(localize_stride=stride)
    stats = {}
    fmap, m = td.run_fusion_sequence_scanned(depths, k, map_capacity=4 * 96 * 128, cfg=cfg, stats=stats)
    _, loop = td.run_fusion_sequence(depths, k, map_capacity=4 * 96 * 128, cfg=cfg)
    np.testing.assert_allclose(np.stack(m.poses), np.stack(loop.poses), atol=1e-5, rtol=0)
    assert m.icp_iterations == loop.icp_iterations
    # A pool of 4·H·W rows takes the row-scatter update (no gather), so a
    # frame gathers once to integrate and once an ICP iteration.
    assert stats["launches_per_frame"] == {"coalesced_gather": 1 + cfg.icp_iterations,
                                           "project_to_rotation": cfg.icp_iterations}
    assert fmap.data.device.type == "cuda" and m.num_map_points == int(fmap.num_points())
    assert td.ate_rmse(m.poses, gt) < 0.01
