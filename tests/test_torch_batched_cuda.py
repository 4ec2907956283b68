"""Multi-stream and pipelined fusion on the card: the B-stream step
replayed from a CUDA graph (captured by the call, or kept from an earlier
one) against the same step run eagerly, each gather
stream of the batched path against the gather's plain version, the
launches of a replay at two batch sizes, and the pipelined driver against
the scanned one.

The graph replays the kernels the eager step launches on the same inputs,
so both agree bit for bit (compared as int32 views), as the single-stream
pool replay does. The tests skip on a machine without a CUDA device. This
file imports neither JAX nor the JAX package, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_batched_cuda.py
"""

from unittest import mock

import numpy as np
import pytest
import torch

from cilantro_tpu_torch import native
from cilantro_tpu_torch.core import coalesced
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics, depth_to_points_normals
from cilantro_tpu_torch.core.transforms import identity
from cilantro_tpu_torch.correspondence import projective
from cilantro_tpu_torch.slam import batched_fusion as tbf
from cilantro_tpu_torch.slam import driver as td
from cilantro_tpu_torch.slam import fusion
from cilantro_tpu_torch.slam.pipeline import run_fusion_sequence_pipelined

H, W = 96, 128
K = CameraIntrinsics.make(120.0, 120.0, 63.5, 47.5)
CAP = int(1.4 * H * W)
CFG = fusion.FusionConfig(localize_stride=2)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def stacks(bsz, frames=4, seed=0):
    return np.stack([np.stack(td.synthetic_sequence(frames, H, W, K, seed=s)[0])
                     for s in range(seed, seed + bsz)])


def same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def eager_run(depth, dev):
    """The driver's steps run eagerly on the card: ``(pools, poses (B, F,
    4, 4))``."""
    d = torch.as_tensor(depth, device=dev)
    bsz = d.shape[0]
    p, n, v = depth_to_points_normals(d[:, 0], K)
    data = tbf.stack_maps([fusion.init_map_from_frame(CAP, p[b], n[b], None, v[b]) for b in range(bsz)])
    poses = identity(3, batch_shape=(bsz,), device=dev)
    _, packed = tbf.batched_seed_localize_target(data, poses, K, H, W)
    mats = [poses.matrix()]
    for f in range(1, d.shape[1]):
        p, n, v = depth_to_points_normals(d[:, f], K)
        data, poses, _, _, packed = tbf.batched_fusion_step(
            data, p, n, None, v, poses, K, packed, height=H, width=W, cfg=CFG)
        mats.append(poses.matrix())
    return data, torch.stack(mats, 1)


@pytest.mark.cuda
def test_batched_replay_equals_eager_steps(cuda):
    depth = stacks(3)
    data, met = tbf.run_batched_fusion_sequences(depth, K, map_capacity=CAP, cfg=CFG)
    e_data, e_poses = eager_run(depth, cuda)
    assert same_bits(torch.from_numpy(met.poses), e_poses.cpu())
    assert same_bits(data, e_data)
    for b in range(3):
        _, single = td.run_fusion_sequence_scanned(list(depth[b]), K, map_capacity=CAP, cfg=CFG)
        np.testing.assert_allclose(met.poses[b], np.stack(single.poses), rtol=0, atol=1e-4)
        assert met.num_map_points[b] == single.num_map_points


@pytest.mark.cuda
def test_kept_batched_replay_equals_eager_steps(cuda):
    """A call on new streams with the first call's key replays the kept
    graph, and its pools and poses are still the eager steps' bits."""
    from cilantro_tpu_torch.slam import scan

    scan.clear()
    tbf.run_batched_fusion_sequences(stacks(3), K, map_capacity=CAP, cfg=CFG)
    graph = scan._kept["batched_fusion"][1]
    depth = stacks(3, seed=5)
    data, met = tbf.run_batched_fusion_sequences(depth, K, map_capacity=CAP, cfg=CFG)
    assert scan._kept["batched_fusion"][1] is graph
    e_data, e_poses = eager_run(depth, cuda)
    assert same_bits(torch.from_numpy(met.poses), e_poses.cpu())
    assert same_bits(data, e_data)


@pytest.mark.cuda
def test_batched_gather_streams_match_plain(cuda):
    """Every gather of one eager batched step (model rows, the inverse-
    gather update, each ICP iteration's targets) against the plain
    version on the same inputs."""
    depth = torch.as_tensor(stacks(3, frames=2), device=cuda)
    p, n, v = depth_to_points_normals(depth[:, 0], K)
    data = tbf.stack_maps([fusion.init_map_from_frame(CAP, p[b], n[b], None, v[b]) for b in range(3)])
    poses = identity(3, batch_shape=(3,), device=cuda)
    _, packed = tbf.batched_seed_localize_target(data, poses, K, H, W)
    calls = []
    gather = coalesced.coalesced_gather

    def recording(src, idx):
        calls.append((src, idx))
        return gather(src, idx)

    p, n, v = depth_to_points_normals(depth[:, 1], K)
    with mock.patch.object(tbf, "coalesced_gather", recording), \
            mock.patch.object(fusion, "coalesced_gather", recording), \
            mock.patch.object(projective, "coalesced_gather", recording):
        tbf.batched_fusion_step(data, p, n, None, v, poses, K, packed, height=H, width=W, cfg=CFG)
    shapes = sorted({(tuple(s.shape), tuple(i.shape)) for s, i in calls})
    assert shapes == sorted({((3 * H * W, 8), (3 * (H // 2) * (W // 2),)),
                             ((3 * CAP, 16), (3 * H * W,)), ((3 * H * W, 16), (3 * CAP,))})
    assert len(calls) == 2 + CFG.icp_iterations
    for src, idx in calls:
        assert same_bits(coalesced.coalesced_gather(src, idx), coalesced.coalesced_gather_plain(src, idx))


@pytest.mark.cuda
def test_batched_launches_do_not_grow_with_streams(cuda):
    launches = {}
    for bsz in (1, 3):
        stats = {}
        tbf.run_batched_fusion_sequences(stacks(bsz, frames=3), K, map_capacity=CAP, cfg=CFG, stats=stats)
        launches[bsz] = stats["launches_per_step"]
        assert stats["device_seconds_per_step"] > 0
    n = CFG.icp_iterations
    assert launches[1] == launches[3] == dict(dict.fromkeys(native.launch_counts, 0),
                                              coalesced_gather=2 + n, project_to_rotation=n)


@pytest.mark.cuda
def test_pipelined_equals_scanned(cuda):
    depths, gt = td.synthetic_sequence(6, H, W, K, seed=3)
    stats_p, stats_s = {}, {}
    fmap_p, met_p = run_fusion_sequence_pipelined(depths, K, map_capacity=CAP, cfg=CFG, stats=stats_p)
    fmap_s, met_s = td.run_fusion_sequence_scanned(depths, K, map_capacity=CAP, cfg=CFG, stats=stats_s)
    np.testing.assert_array_equal(np.stack(met_p.poses), np.stack(met_s.poses))
    assert met_p.icp_iterations == met_s.icp_iterations
    assert same_bits(fmap_p.data, fmap_s.data)
    assert stats_p["launches_per_frame"] == stats_s["launches_per_frame"]
    assert td.ate_rmse(met_p.poses, gt) < 0.01
