"""The rigid 3-D Gauss-Newton step's three launches (``csrc/gn_kernels.cu``,
``registration/gn_step.py``) on the card.

Rows are recorded from the estimator's calls on two paths at the
benchmark's shapes: the fine level of an icp.pairs pair (``run_icp_odometry``,
640×480, the combined metric, 307,200 rows) and a pool.clip16 localize step
(``run_fusion_sequence``, 640×480 at stride 2, the symmetric metric, 76,800
rows of a packed target, rows 8 floats apart). Each is also run with point
weights, cut to a row count no block divides, and with every weight 0.

The launches equal the plain version bit for bit (each pass's partials,
the step's transform, the result), two runs equal each other, and a
captured CUDA graph equals the eager call. Against the einsum path the
result lies within 1e-5 (the CPU estimator tests' bound against the JAX
package: float32 JᵀJ summed by cuBLAS against float64 sums). Whole clips
on the card lie within 1e-4 of their CPU runs (the bound of the pool's
card-against-CPU check, which sums in another order). No GN iteration
launches nothing and gives the einsum path's bits; points without unit
stride along their last axis and scalar weights take the kernels with the
bits of the plain layout. No JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_gn_kernels_cuda.py
"""

import re
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cilantro_tpu_torch import native
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
from cilantro_tpu_torch.registration import gn_step
from cilantro_tpu_torch.registration import transform_estimation as te
from cilantro_tpu_torch.slam import driver as td
from cilantro_tpu_torch.slam.fusion import FusionConfig
from cilantro_tpu_torch.slam.odometry import OdometryConfig, run_icp_odometry
from portbench import clips

SENSOR = {"height": 480, "width": 640, "fx": 525.0, "fy": 525.0, "cx": 319.5, "cy": 239.5}
K = CameraIntrinsics.make(SENSOR["fx"], SENSOR["fy"], SENSOR["cx"], SENSOR["cy"])
SEED = 2147470101
COUNT = re.compile(r"cilantro\.count\.(\w+)=(-?\d+)$")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _record(run):
    """The arguments of every fused GN step ``run()`` takes."""
    calls, real = [], gn_step.gauss_newton_3d

    def rec(*args):
        calls.append(args[:6])
        return real(*args)

    with mock.patch.object(gn_step, "gauss_newton_3d", rec):
        run()
    return calls


@pytest.fixture(scope="module")
def recorded(cuda):
    """Rows of the two paths: ``{name: (src, dst, src_normals, dst_normals,
    point_weights, plane_weights)}``."""
    depths, _ = clips.make_clips(SEED, 1, 2, SENSOR, 0.004, cuda)
    icp_calls = _record(lambda: run_icp_odometry(depths[0], K, device=cuda))
    fine = max(icp_calls, key=lambda a: a[0].shape[0])
    pool_depths, _ = clips.make_clips(SEED, 1, 3, SENSOR, 0.004, cuda)
    cfg = FusionConfig(localize_stride=2)
    pool_calls = _record(lambda: td.run_fusion_sequence(list(pool_depths[0]), K,
                                                        map_capacity=int(1.4 * 480 * 640), cfg=cfg))
    local = pool_calls[-1]
    assert fine[2] is None and fine[0].shape[0] == 480 * 640
    assert local[2] is not None and local[0].shape[0] == 240 * 320 and local[1].stride(0) == 8
    return {"icp_fine": fine, "pool_localize": local}


def _variant(rows, kind):
    src, dst, ns, nd, wpp, wpl = rows
    if kind == "as_run":
        return rows
    if kind == "point_weights":
        return src, dst, ns, nd, 0.3 * wpl, wpl
    if kind == "ragged":  # 37 rows short of a whole block
        cut = src.shape[0] - 37
        return tuple(None if t is None else t[:cut] for t in rows)
    return src, dst, ns, nd, torch.zeros_like(wpl), torch.zeros_like(wpl)  # "no_weight"


CASES = [(path, kind) for path in ("icp_fine", "pool_localize")
         for kind in ("as_run", "point_weights", "ragged", "no_weight")]


def _kernel_steps(rows, iterations):
    """Each launcher call's ``(ws, out, valid)``."""
    ws, steps = None, []
    for _ in range(iterations):
        ws, out, valid = gn_step.gn_step_kernel(*rows, ws)
        steps.append((ws.clone(), out.clone(), valid.clone()))
    return steps


def _plain_steps(rows, iterations):
    ws, steps = None, []
    for _ in range(iterations):
        ws, out, valid = gn_step.gn_step_plain(*rows, ws)
        steps.append((ws, out, valid))
    return steps


_written = gn_step.written


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int64) if t.dtype == torch.float64 else t.view(torch.int32)


def _same(a, b):
    return torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("path, kind", CASES)
def test_launches_match_plain_bit_for_bit(cuda, recorded, path, kind):
    rows = _variant(recorded[path], kind)
    n = rows[0].shape[0]
    got, want = _kernel_steps(rows, 3), _plain_steps(rows, 3)
    for (gws, gout, gv), (pws, pout, pv) in zip(got, want):
        assert _same(_written(gws, n), _written(pws, n))
        assert _same(gout, pout)
        assert bool(gv) == bool(pv)
    assert bool(got[0][2]) == (kind != "no_weight")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["icp_fine", "pool_localize"])
def test_two_runs_give_the_same_bits(cuda, recorded, path):
    rows = _variant(recorded[path], "point_weights")
    a, b = _kernel_steps(rows, 2), _kernel_steps(rows, 2)
    n = rows[0].shape[0]
    for (aws, aout, _), (bws, bout, _) in zip(a, b):
        assert _same(_written(aws, n), _written(bws, n)) and _same(aout, bout)


def _estimate(rows, **kw):
    src, dst, ns, nd, wpp, wpl = rows
    if ns is None:
        return te.estimate_rigid_combined_metric(src, dst, nd, point_weights=wpp, plane_weights=wpl, **kw)
    return te.estimate_rigid_symmetric_metric(src, dst, ns, nd, point_weights=wpp, plane_weights=wpl, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["icp_fine", "pool_localize"])
def test_captured_graph_gives_the_eager_bits(cuda, recorded, path):
    rows = recorded[path]
    eager, ok = _estimate(rows)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _estimate(rows)  # warm-up off the default stream, as a capture wants
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = native.launch_counts["gn_step"]
    with torch.cuda.graph(graph):
        tf, valid = _estimate(rows)
    assert native.launch_counts["gn_step"] - before == 1
    graph.replay()
    torch.cuda.synchronize()
    assert _same(tf.linear, eager.linear) and _same(tf.translation, eager.translation)
    assert bool(valid) == bool(ok)


@pytest.mark.cuda
@pytest.mark.parametrize("path, kind", CASES)
@pytest.mark.parametrize("iterations", [1, 3])
def test_fused_step_matches_the_einsum_step(cuda, recorded, path, kind, iterations):
    rows = _variant(recorded[path], kind)
    kw = dict(max_iterations=iterations, convergence_tol=0.0)
    fused, fok = _estimate(rows, **kw)
    with mock.patch.object(gn_step, "takes", lambda *a: False):
        plain, pok = _estimate(rows, **kw)
    np.testing.assert_allclose(fused.linear.cpu(), plain.linear.cpu(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(fused.translation.cpu(), plain.translation.cpu(), rtol=0, atol=1e-5)
    assert bool(fok) == bool(pok)


SMALL = {"height": 60, "width": 80, "fx": 65.625, "fy": 65.625, "cx": 39.5, "cy": 29.5}


@pytest.mark.cuda
def test_icp_odometry_clip_card_matches_cpu(cuda):
    depths, _ = clips.make_clips(7, 1, 4, SMALL, 0.004, "cpu")
    k = CameraIntrinsics.make(SMALL["fx"], SMALL["fy"], SMALL["cx"], SMALL["cy"])
    card = []
    calls = _record(lambda: card.append(run_icp_odometry(depths[0], k, device=cuda)))
    cpu_poses, cpu_its = run_icp_odometry(depths[0], k, device="cpu")
    poses, its = card[0]
    assert len(calls) == int(its.sum())
    np.testing.assert_allclose(poses, cpu_poses, rtol=0, atol=1e-4)
    assert its.tolist() == cpu_its.tolist()


@pytest.mark.cuda
def test_pool_clip_card_matches_cpu(cuda):
    depths, _ = td.synthetic_sequence(6, 96, 128, CameraIntrinsics.make(120.0, 120.0, 63.5, 47.5), seed=0)
    k = CameraIntrinsics.make(120.0, 120.0, 63.5, 47.5)
    cfg = FusionConfig(localize_stride=2)
    card = []
    calls = _record(lambda: card.append(td.run_fusion_sequence(depths, k, map_capacity=4 * 96 * 128, cfg=cfg)))
    _, cpu = td.run_fusion_sequence(depths, k, map_capacity=4 * 96 * 128, cfg=cfg, device="cpu")
    _, m = card[0]
    assert len(calls) == sum(m.icp_iterations)
    np.testing.assert_allclose(np.stack(m.poses), np.stack(cpu.poses), rtol=0, atol=1e-4)
    assert m.icp_iterations == cpu.icp_iterations


@pytest.mark.cuda
def test_profiled_odometry_counts_the_fused_route(cuda):
    depths, _ = clips.make_clips(SEED, 1, 3, SENSOR, 0.004, cuda)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, iterations = run_icp_odometry(depths[0], K, cfg=OdometryConfig(), device=cuda)
    counts = {}
    for e in prof.events():
        m = COUNT.match(e.name)
        if m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + int(m.group(2))
    assert counts["gn_step_route_fused"] == counts["icp_iterations"] == int(iterations.sum())
    assert counts.get("gn_step_route_plain", 0) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["icp_fine", "pool_localize"])
def test_no_iteration_launches_nothing(cuda, recorded, path):
    """No GN iteration takes the einsum path: the uncentred identity, no
    launch."""
    rows = recorded[path]
    before = native.launch_counts["gn_step"]
    got, ok = _estimate(rows, max_iterations=0)
    assert native.launch_counts["gn_step"] == before
    with mock.patch.object(gn_step, "takes", lambda *a: False):
        want, wok = _estimate(rows, max_iterations=0)
    assert _same(got.linear, want.linear) and _same(got.translation, want.translation)
    assert torch.equal(got.linear, torch.eye(3, device=cuda)) and bool(ok) == bool(wok)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["icp_fine", "pool_localize"])
def test_any_layout_takes_the_kernels(cuda, recorded, path):
    """Points without unit stride along their last axis and scalar weights
    take the kernels too, with the bits of the plain layout."""
    src, dst, ns, nd, wpp, wpl = recorded[path]
    laid = tuple(None if t is None else t.T.contiguous().T for t in (src, dst, ns, nd))
    assert laid[0].stride(-1) != 1
    before = native.launch_counts["gn_step"]
    got, _ = _estimate(laid + (torch.tensor(0.25, device=cuda), torch.tensor(1.0, device=cuda)))
    assert native.launch_counts["gn_step"] == before + 1
    want, _ = _estimate((src, dst, ns, nd, torch.full_like(wpl, 0.25), torch.ones_like(wpl)))
    assert _same(got.linear, want.linear) and _same(got.translation, want.translation)
