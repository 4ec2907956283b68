"""The port's non-rigid warp fields on the card, against the port's own CPU
run (the plain versions of every kernel the path launches).

Small sizes: a 1,500-point height-field surface with a 0.25 control grid,
the recipe of ``tests/test_warp_field.py``. The graph is built on the card
(the kNN kernels) and copied to the CPU, so that both runs solve on the
same graph; card and CPU sum in other orders, so warped points are held
within 1e-4 m at the median and 1e-3 m at the max, with the same
iteration counts. Two direct solves on the card give the same bits (sorted
segment reductions, no atomics), and one direct GN step makes no host
sync. The tests skip on a machine without a CUDA device. This file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_warp_cuda.py
"""

import numpy as np
import pytest
import torch

from cilantro_tpu_torch.core import transforms as tt
from cilantro_tpu_torch.core.coalesced import launch_counts as gather_counts
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics, depth_to_points_normals
from cilantro_tpu_torch.neighbors import fused_knn, fused_nn
from cilantro_tpu_torch.registration import warp_field as tw
from cilantro_tpu_torch.registration import warp_field_batched as twb


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _surface(rng, n):
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    z = (0.2 * np.sin(1.5 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])).astype(np.float32)
    return np.column_stack([xy, z])


def _bend(pts, amp=0.06):
    out = pts.copy()
    out[:, 2] += amp * np.sin(1.2 * pts[:, 0] + 0.4)
    out[:, 1] += 0.5 * amp * np.cos(1.0 * pts[:, 0])
    return out


def _nodes(pts, step=0.25):
    keys = np.round(pts[:, :2] / step).astype(np.int64)
    _, first = np.unique(keys[:, 0] * 10000 + keys[:, 1], return_index=True)
    return pts[np.sort(first)]


def _case(cuda, n=1500):
    src = _surface(np.random.default_rng(0), n)
    graph = tw.build_deformation_graph(src, _nodes(src), k_anchors=4, k_arcs=6, device=cuda)
    return src, _bend(src), graph


_KW = dict(max_corr_dist_sq=0.04, point_weight=1.0, plane_weight=0.0, stiffness=10.0,
           max_iterations=12, convergence_tol=1e-4, max_cg_iterations=60)


def _assert_warped_close(graph, tf_card, tf_cpu, src):
    got = tw.warp_points(graph, tf_card, src, device="cpu")
    want = tw.warp_points(graph.to("cpu"), tf_cpu, src, device="cpu")
    diff = torch.linalg.vector_norm(got - want, dim=-1)
    assert float(diff.median()) < 1e-4 and float(diff.max()) < 1e-3, (float(diff.median()), float(diff.max()))


@pytest.mark.cuda
def test_graph_on_card_launches_knn_and_matches_cpu(cuda):
    src = _surface(np.random.default_rng(0), 1500)
    nodes = _nodes(src)
    fused_knn.reset_launch_counts()
    card = tw.build_deformation_graph(src, nodes, k_anchors=4, k_arcs=6, device=cuda)
    assert fused_knn.launch_counts["knn_full"] >= 2  # anchors and arcs: Q·M < 2^26
    cpu = tw.build_deformation_graph(src, nodes, k_anchors=4, k_arcs=6, device="cpu")
    same = (card.anchors.cpu() == cpu.anchors).all(dim=1)
    assert float(same.float().mean()) > 0.998
    assert torch.allclose(card.anchor_weights.cpu()[same], cpu.anchor_weights[same], rtol=0, atol=2e-6)
    assert card.pair_uniq_count > 0 and card.ps_seg_lengths.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["direct", "cg"])
def test_icp_warp_field_card_matches_cpu(cuda, solver):
    src, dst, graph = _case(cuda)
    tt.reset_launch_counts()
    tf_card, it_card, _ = tw.icp_warp_field(graph, src, dst, solver=solver, device=cuda, **_KW)
    assert tt.launch_counts["project_to_rotation"] == int(it_card)
    tf_cpu, it_cpu, _ = tw.icp_warp_field(graph.to("cpu"), src, dst, solver=solver, device="cpu", **_KW)
    assert int(it_card) == int(it_cpu)
    _assert_warped_close(graph, tf_card, tf_cpu, src)


@pytest.mark.cuda
def test_dense_cg_card_matches_cpu(cuda):
    src = _surface(np.random.default_rng(0), 600)
    dst = src + np.float32([0.0, 0.0, 0.03])
    graph = tw.build_dense_graph(src, k_arcs=6, device=cuda)
    kw = dict(_KW, stiffness=5.0, max_iterations=10, convergence_tol=2.5e-3)
    tf_card, it_card, _ = tw.icp_warp_field(graph, src, dst, solver="cg", device=cuda, **kw)
    tf_cpu, it_cpu, _ = tw.icp_warp_field(graph.to("cpu"), src, dst, solver="cg", device="cpu", **kw)
    assert int(it_card) == int(it_cpu)
    _assert_warped_close(graph, tf_card, tf_cpu, src)


@pytest.mark.cuda
def test_projective_card_matches_cpu_through_the_gather_kernel(cuda):
    h, w = 48, 64
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = torch.from_numpy((1.2 + 0.04 * np.sin(0.25 * u) + 0.03 * np.cos(0.2 * v)).astype(np.float32))
    k = CameraIntrinsics.make(80.0, 80.0, 31.5, 23.5)
    src, _, ok = depth_to_points_normals(depth, k)
    src, ok = src.numpy(), ok.numpy()
    dst = src.copy()
    dst[:, 2] += 0.03 * np.sin(2.5 * src[:, 0])
    graph = tw.build_deformation_graph(src, _nodes(src[ok], 0.15), k_anchors=4, k_arcs=6, device=cuda)
    kw = dict(height=h, width=w, max_corr_dist_sq=0.01, point_weight=1.0, plane_weight=0.0,
              stiffness=5.0, max_iterations=12, convergence_tol=1e-4, src_valid=ok, dst_valid=ok)
    before = gather_counts["coalesced_gather"]
    tf_card, it_card, _ = tw.icp_warp_field_projective(graph, src, dst, k, device=cuda, **kw)
    assert gather_counts["coalesced_gather"] - before == int(it_card)
    tf_cpu, it_cpu, _ = tw.icp_warp_field_projective(graph.to("cpu"), src, dst, k, device="cpu", **kw)
    assert int(it_card) == int(it_cpu)
    _assert_warped_close(graph, tf_card, tf_cpu, src)


@pytest.mark.cuda
def test_two_direct_solves_give_the_same_bits(cuda):
    src, dst, graph = _case(cuda)
    a, it_a, _ = tw.icp_warp_field(graph, src, dst, solver="direct", device=cuda, **_KW)
    b, it_b, _ = tw.icp_warp_field(graph, src, dst, solver="direct", device=cuda, **_KW)
    assert int(it_a) == int(it_b)
    assert torch.equal(a.linear, b.linear) and torch.equal(a.translation, b.translation)


@pytest.mark.cuda
@pytest.mark.parametrize("with_normals", [False, True])
def test_direct_gn_step_makes_no_host_sync(cuda, with_normals):
    src, dst, graph = _case(cuda)
    rng = np.random.default_rng(1)
    nrm = rng.standard_normal(src.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    args = [torch.as_tensor(a, device=cuda) for a in (src, dst, nrm if with_normals else src)]
    w = torch.ones(len(src), device=cuda)
    kw = dict(point_weight=1.0, plane_weight=1.0 if with_normals else 0.0, stiffness=10.0,
              max_gn_iterations=1, gn_tol=0.0, solver="direct", device=cuda)
    assert tw.direct_route(graph, len(src), 3, False) == "sorted"

    def step():
        return tw.estimate_warp_field(graph, args[0], args[1], args[2] if with_normals else None, w, **kw)

    want = step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[0].linear, want[0].linear)


@pytest.mark.cuda
def test_batched_gn_step_makes_no_host_sync(cuda):
    src, dst, graph = _case(cuda)
    dstb = torch.as_tensor(np.stack([dst, src]), device=cuda).permute(1, 0, 2)
    src_t = torch.as_tensor(src, device=cuda)
    w = torch.ones((len(src), 2), device=cuda)

    def step():
        return twb.estimate_warp_field_batched(graph, src_t, dstb, None, w, point_weight=1.0,
                                               plane_weight=0.0, stiffness=10.0, device=cuda)

    want = step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[0].linear, want[0].linear)


@pytest.mark.cuda
def test_batched_card_matches_cpu_and_single_streams(cuda):
    rng = np.random.default_rng(0)
    src = rng.uniform(-0.5, 0.5, (3000, 3)).astype(np.float32)
    src[:, 2] *= 0.1
    dsts = np.stack([src + np.float32([0, 0.008 * b, 0.01]) * np.sin(4 * src[:, :1]) for b in range(3)])
    graph = tw.build_deformation_graph(src, src[::60], k_anchors=4, k_arcs=8, device=cuda)
    kw = dict(max_corr_dist_sq=0.0025, point_weight=1.0, plane_weight=0.0, stiffness=50.0,
              max_iterations=6)
    tf_card, it_card, _ = twb.icp_warp_field_batched(graph, src, dsts, device=cuda, **kw)
    tf_cpu, it_cpu, _ = twb.icp_warp_field_batched(graph.to("cpu"), src, dsts, device="cpu", **kw)
    assert int(it_card) == int(it_cpu)
    got = twb.warp_points_batched(graph, tf_card, src, device="cpu")
    want = twb.warp_points_batched(graph.to("cpu"), tt.Transform(tf_cpu.linear, tf_cpu.translation), src,
                                   device="cpu")
    diff = torch.linalg.vector_norm(got - want, dim=-1)
    assert float(diff.median()) < 1e-4 and float(diff.max()) < 1e-3
    for b in range(len(dsts)):
        # The streams iterate in lockstep: as many outer iterations as the batch.
        tf_s, _, _ = tw.icp_warp_field(graph, src, dsts[b], solver="direct", device=cuda,
                                       **dict(kw, max_iterations=int(it_card), convergence_tol=0.0))
        single = tw.warp_points(graph, tf_s, src, device="cpu")
        assert float(torch.linalg.vector_norm(single - got[:, b], dim=-1).median()) < 1e-4


@pytest.mark.cuda
def test_pruned_correspondences_at_scale(cuda):
    """A source of 2^13 + points against as many targets takes the prune
    plan (Q·M ≥ 2^26): the compact nn1 kernel runs once an outer
    iteration."""
    rng = np.random.default_rng(3)
    src = _surface(rng, 9000) * np.float32(0.36)
    dst = src.copy()
    dst[:, 2] += 0.02 * np.sin(8.0 * src[:, 0])
    graph = tw.build_deformation_graph(src, _nodes(src, 0.05), k_anchors=4, k_arcs=8, device=cuda)
    fused_nn.reset_launch_counts()
    tf, it, _ = tw.icp_warp_field(graph, src, dst, max_corr_dist_sq=0.0025, point_weight=1.0,
                                  plane_weight=0.0, stiffness=50.0, max_iterations=4, device=cuda)
    launched = fused_nn.launch_counts["nn1_compact"] + fused_nn.launch_counts["nn1_masked"]
    assert launched == int(it)
    warped = tw.warp_points(graph, tf, src, device=cuda)
    assert torch.isfinite(warped).all()
