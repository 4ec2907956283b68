"""The multi-device paths on the card: a world of one over NCCL in this
process, and gloo groups of 2 and 4 subprocess ranks on the one card with
CUDA tensors (``tests/torch_parallel_worker.py`` with DEVICE ``cuda``:
gloo's gathers and point-to-point calls stage through host memory, its
all-reduces and broadcasts take the CUDA tensors). The tests skip on a
machine without a CUDA device. This file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

Tolerances: registrations within 1e-4 of the true motion and the ring
within 1e-5 of the tournament with the same iterations; the ring's
nearest neighbours bit for bit ``nn1_fused``'s; the small BA at the JAX
test's residual bound (1e-6) and within 1e-4 of ``bundle_adjust``; the
sharded warp at world 1 bit for bit the one-device solve; the two-rank
pipeline bit for bit the scanned driver; replicated outputs
bit-identical across ranks."""

import numpy as np
import pytest
import torch

from torch_parallel_ranks import Ranks
from torch_parallel_worker import ICP_KW, WARP_ICP_KW, ba_partition, icp_case, ring_case, small_ba, warp_case


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture()
def nccl_mesh(cuda):
    """A world of one over NCCL (``make_mesh`` makes it), destroyed after."""
    import torch.distributed as dist

    from cilantro_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device="cuda")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_world_of_one_runs_the_sharded_entry_points(nccl_mesh):
    import torch.distributed as dist

    from cilantro_tpu_torch import slam as tslam
    from cilantro_tpu_torch.core.transforms import Transform
    from cilantro_tpu_torch.neighbors.fused_nn import nn1_fused
    from cilantro_tpu_torch.parallel import (
        ring_nn1, shard_cloud_arrays, sharded_combined_icp, sharded_combined_icp_ring,
    )

    mesh = nccl_mesh
    assert dist.get_backend() == "nccl" and mesh.size() == 1
    pts, dst, nrm, r, t = icp_case()
    ones = np.ones(len(pts), bool)
    a, ia = sharded_combined_icp(*shard_cloud_arrays(mesh, "points", pts, ones),
                                 *shard_cloud_arrays(mesh, "map", dst, nrm, ones), mesh=mesh, **ICP_KW)
    b, ib = sharded_combined_icp_ring(*shard_cloud_arrays(mesh, "points", pts, ones, dst, nrm, ones), mesh=mesh,
                                      **ICP_KW)
    assert a.linear.is_cuda and int(ia) == int(ib)
    for tf in (a, b):
        assert np.abs(tf.linear.cpu().numpy() - r).max() < 1e-4
        assert np.abs(tf.translation.cpu().numpy() - t).max() < 1e-4
    assert torch.allclose(a.linear, b.linear, rtol=0, atol=1e-5)
    q, keys, payload = ring_case()
    d, pay = ring_nn1(*shard_cloud_arrays(mesh, "points", q, np.ones(len(q), bool)),
                      *shard_cloud_arrays(mesh, "points", keys, payload, np.ones(len(keys), bool)), mesh=mesh)
    od, oi = nn1_fused(torch.as_tensor(q, device="cuda"), torch.as_tensor(keys, device="cuda"))
    assert torch.equal(d, od) and torch.equal(pay, torch.as_tensor(payload, device="cuda")[oi.long()])
    lin, tr, x0, cam, lmk, obs = small_ba()
    order, local = ba_partition(cam, lmk, len(x0), 1)
    poses0 = Transform(torch.as_tensor(lin, device="cuda"), torch.as_tensor(tr, device="cuda"))
    p, _, resid = tslam.bundle_adjust_sharded(
        poses0, *shard_cloud_arrays(mesh, "points", x0, cam[order], local, obs[order], np.ones(len(order), bool)),
        mesh=mesh, max_iterations=15)
    q1, _, _ = tslam.bundle_adjust(poses0, x0, cam, lmk, obs, max_iterations=15, device="cuda")
    assert float(resid) < 1e-6
    assert torch.allclose(p.linear, q1.linear, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_nccl_world_of_one_warp_is_the_one_device_solve(nccl_mesh):
    """At world 1 every sum of the sharded warp is the one-device solve's
    sorted reduction: the same bits, and the same bits in a second run."""
    from cilantro_tpu_torch.parallel import sharded_icp_warp_field
    from cilantro_tpu_torch.registration import warp_field as tw

    src, dst, nodes = warp_case()
    graph = tw.build_deformation_graph(torch.as_tensor(src, device="cuda"), torch.as_tensor(nodes, device="cuda"),
                                       device="cuda")
    want, want_it, _ = tw.icp_warp_field(graph, src, dst, device="cuda", **WARP_ICP_KW)
    for _ in range(2):
        tf, it, _ = sharded_icp_warp_field(graph, src, dst, mesh=nccl_mesh, **WARP_ICP_KW)
        assert int(it) == int(want_it)
        for a, b in ((tf.linear, want.linear), (tf.translation, want.translation)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("suite, world", [("icp", 4), ("ba", 2), ("pipeline", 2)])
def test_gloo_ranks_on_the_card(cuda, tmp_path, suite, world):
    inputs = {}
    if suite == "pipeline":
        from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
        from cilantro_tpu_torch.slam.driver import synthetic_sequence
        from torch_parallel_worker import FUSION_HW, FUSION_K

        depths, _ = synthetic_sequence(6, *FUSION_HW, CameraIntrinsics.make(*FUSION_K), seed=3)
        inputs["depths"] = np.stack(depths)
    res = Ranks(suite, world, tmp_path, inputs, device="cuda", wait_timeout=300.0).results()
    if suite == "icp":
        _, _, _, r, t = icp_case()
        for key, rec in res[0].items():
            if key == "ring_nn1":
                continue
            assert np.abs(rec["linear"] - r).max() < 1e-4 and np.abs(rec["translation"] - t).max() < 1e-4, key
        for other in res[1:]:
            for key in res[0]:
                if key != "ring_nn1":
                    assert np.array_equal(other[key]["linear"], res[0][key]["linear"]), key
                    assert other[key]["iterations"] == res[0][key]["iterations"], key
    elif suite == "ba":
        assert all(rec["small"]["residual"] < 1e-6 for rec in res)
        assert np.array_equal(res[0]["small"]["linear"], res[1]["small"]["linear"])
    else:
        for rec in res:
            p, s = rec["pipelined"], rec["scanned"]
            assert np.array_equal(p["poses"], s["poses"]) and p["iterations"] == s["iterations"]
            assert np.array_equal(p["data"], s["data"])
        assert np.array_equal(res[0]["pipelined"]["data"], res[1]["pipelined"]["data"])
