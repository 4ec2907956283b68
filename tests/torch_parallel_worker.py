"""One rank of the port's multi-rank CPU tests (imports torch, numpy and
the port; never JAX). ``tests/torch_parallel_ranks.py`` starts it:

    python tests/torch_parallel_worker.py SUITE RANK WORLD STORE OUT TIMEOUT [DEVICE]

It joins a gloo group through the ``FileStore`` at STORE (every group with
TIMEOUT seconds), sets one CPU thread, runs every case of SUITE on the
inputs in ``OUT/inputs.npz`` and pickles its results (numpy) to
``OUT/SUITE_RANK.pkl``. DEVICE (default ``cpu``) is where the port runs:
``cuda`` puts every rank on the one card. The input generators here are
shared with the tests, which import this module."""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The JAX tests' ICP settings (tests/test_sharded_icp.py).
ICP_KW = dict(max_corr_dist_sq=0.25, max_iterations=30, convergence_tol=1e-5, point_weight=0.3)
ICP_MESHES = ((2, 2), (4, 1), (1, 4))
# tests/test_sharded_warp.py's settings.
WARP_EST_KW = dict(point_weight=1.0, plane_weight=0.0, stiffness=10.0, max_gn_iterations=4,
                   max_cg_iterations=80, solver="cg")
WARP_ICP_KW = dict(max_corr_dist_sq=0.04, point_weight=1.0, plane_weight=0.0, stiffness=10.0,
                   max_iterations=6, convergence_tol=1e-4, max_cg_iterations=60, solver="cg")
# tests/test_torch_slam_loop.py's run_slam row.
SLAM_HW, SLAM_FRAMES = (72, 96), 48
SLAM_KW = dict(keyframe_every=5, loop_min_separation=3, loop_edge_weight=5.0, run_ba=True)
SLAM_FUSION = dict(localize_stride=1, icp_iterations=8)
FUSION_HW, FUSION_K = (48, 64), (100.0, 100.0, 31.5, 23.5)


def icp_case(n=4096, seed=0):
    """tests/test_sharded_icp.py's surface pair (its ``rng`` fixture's
    draws): ``(src, dst, dst normals, R, t)``."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    z = (0.3 * np.sin(2 * xy[:, 0]) * np.cos(2 * xy[:, 1])).astype(np.float32)
    pts = np.column_stack([xy, z])
    ang = 0.05
    r = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    t = np.array([0.02, -0.01, 0.015], np.float32)
    dst = pts @ r.T + t
    nrm = np.zeros_like(dst)
    nrm[:, 2] = 1.0
    return pts, dst, nrm, r, t


def ring_case(n=1024, m=2048, seed=0):
    """tests/test_sharded_icp.py::test_ring_nn1_matches_local's clouds."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 3)).astype(np.float32)
    keys = rng.standard_normal((m, 3)).astype(np.float32)
    payload = np.concatenate([keys, keys * 2.0], axis=1).astype(np.float32)
    return q, keys, payload


def warp_case(n=2048, seed=0):
    """tests/test_sharded_warp.py's bent surface and control nodes."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    src = np.column_stack([xy, 0.1 * np.sin(2 * xy[:, 0]) * np.cos(2 * xy[:, 1])]).astype(np.float32)
    dst = src.copy()
    dst[:, 2] += 0.05 * np.sin(1.5 * src[:, 0])
    keys = np.round(src[:, :2] / 0.3).astype(np.int64)
    _, first = np.unique(keys[:, 0] * 10000 + keys[:, 1], return_index=True)
    return src, dst, src[np.sort(first)]


def small_ba(seed=0):
    """tests/test_slam_backend.py:28's problem (its ``rng`` fixture)."""
    from cilantro_tpu_torch.tools.slam_problems import small_ba_problem

    return small_ba_problem(np.random.default_rng(seed))[0]


def ba_partition(cam_idx, lmk_idx, n_landmarks, shards):
    """tests/test_slam_backend.py::test_sharded_matches's partition by
    landmark: the observation order and the local landmark ids."""
    lp = n_landmarks // shards
    order = np.argsort(lmk_idx // lp, kind="stable")
    return order, (lmk_idx[order] % lp).astype(np.int32)


SUITES = {}
# The group timeout main() was given: every group a suite makes gets it.
TIMEOUT = [datetime.timedelta(seconds=60)]


def suite(fn):
    SUITES[fn.__name__] = fn
    return fn


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _tf(tf):
    return {"linear": _np(tf.linear), "translation": _np(tf.translation)}


@suite
def icp(rank, world, inputs, dev):
    from cilantro_tpu_torch.parallel import (
        make_mesh, ring_nn1, shard_cloud_arrays, sharded_combined_icp, sharded_combined_icp_ring,
    )

    out = {}
    pts, dst, nrm, _, _ = icp_case()
    ones = np.ones(len(pts), bool)
    for p, q in ICP_MESHES:
        mesh = make_mesh(p, q, device=dev, timeout=TIMEOUT[0])
        src_s, sv = shard_cloud_arrays(mesh, "points", pts, ones)
        dst_s, dn, dv = shard_cloud_arrays(mesh, "map", dst, nrm, ones)
        tf, it = sharded_combined_icp(src_s, sv, dst_s, dn, dv, mesh=mesh, **ICP_KW)
        out[f"tournament_{p}x{q}"] = dict(_tf(tf), iterations=int(it))
    mesh = make_mesh(world, 1, device=dev, timeout=TIMEOUT[0])
    args = shard_cloud_arrays(mesh, "points", pts, ones, dst, nrm, ones)
    tf, it = sharded_combined_icp_ring(*args, mesh=mesh, **ICP_KW)
    out["ring"] = dict(_tf(tf), iterations=int(it))
    q, keys, payload = ring_case()
    qs, qv = shard_cloud_arrays(mesh, "points", q, np.ones(len(q), bool))
    ks, ps, kv = shard_cloud_arrays(mesh, "points", keys, payload, np.ones(len(keys), bool))
    d, pay = ring_nn1(qs, qv, ks, ps, kv, mesh=mesh)
    out["ring_nn1"] = {"dist": _np(d), "payload": _np(pay)}
    return out


@suite
def desync(rank, world, inputs, dev):
    """Rank 0 stops after 2 iterations, the others run on to 4: the others
    must fail within the mesh's timeout instead of waiting for ever."""
    from cilantro_tpu_torch.parallel import make_mesh, shard_cloud_arrays, sharded_combined_icp

    timeout = float(inputs["mesh_timeout"])
    mesh = make_mesh(world, 1, device=dev, timeout=datetime.timedelta(seconds=timeout))
    pts, dst, nrm, _, _ = icp_case(n=1024)
    ones = np.ones(len(pts), bool)
    src_s, sv = shard_cloud_arrays(mesh, "points", pts, ones)
    dst_s, dn, dv = shard_cloud_arrays(mesh, "map", dst, nrm, ones)
    kw = dict(ICP_KW, convergence_tol=0.0, max_iterations=2 if rank == 0 else 4)
    t0 = time.perf_counter()
    try:
        sharded_combined_icp(src_s, sv, dst_s, dn, dv, mesh=mesh, **kw)
        raised = None
    except RuntimeError as e:
        raised = f"{type(e).__name__}: {e}"[:300]
    return {"raised": raised, "seconds": time.perf_counter() - t0, "ended_at": time.time()}


@suite
def fusion(rank, world, inputs, dev):
    """Both runs of tests/test_sharded_fusion.py on a (1, WORLD) mesh,
    started from the JAX run's frames; the pool seeded by the port
    (``init_sharded_map``) and, for the steps, from JAX's seeded pool
    (``interop.sharded_map_from_numpy``)."""
    from cilantro_tpu_torch import interop
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.core.transforms import identity
    from cilantro_tpu_torch.parallel import init_sharded_map, make_mesh, sharded_fusion_step
    from cilantro_tpu_torch.slam.fusion import FusionConfig

    h, w = FUSION_HW
    k = CameraIntrinsics.make(*FUSION_K)
    mesh = make_mesh(1, world, device=dev, timeout=TIMEOUT[0])
    out = {}
    for name in ("run", "small"):
        pts, nrm, val = (torch.as_tensor(inputs[f"{name}_{a}"], device=dev) for a in ("points", "normals", "valid"))
        cap = int(inputs[f"{name}_capacity"])
        seeded = init_sharded_map(mesh, cap, pts[0], nrm[0], None, inputs[f"{name}_seed_valid"])
        sdata = interop.sharded_map_from_numpy(mesh, inputs[f"{name}_seed_pool"])
        rec = {"seed": _np(seeded), "poses": [], "widx": []}
        pose = identity(3, device=dev)
        for fi in range(1, pts.shape[0]):
            sdata, pose, widx = sharded_fusion_step(sdata, pts[fi], nrm[fi], None, val[fi], pose, k, mesh=mesh,
                                                    height=h, width=w, cfg=FusionConfig())
            rec["poses"].append(_np(pose.matrix()))
            rec["widx"].append(_np(widx))
        rec["data"] = _np(sdata)
        out[name] = rec
    return out


@suite
def warp(rank, world, inputs, dev):
    from cilantro_tpu_torch import interop
    from cilantro_tpu_torch.parallel import make_mesh, sharded_estimate_warp_field, sharded_icp_warp_field
    from cilantro_tpu_torch.registration import warp_field as tw

    leaves = {name[len("graph_"):]: inputs[name] for name in inputs.files if name.startswith("graph_")}
    leaves["caches_sorted"] = bool(leaves["caches_sorted"])
    graph = interop.deformation_graph_from_numpy(device=dev, **leaves)
    src, dst = inputs["src"], inputs["dst"]
    w = np.ones(len(src), np.float32)
    mesh = make_mesh(world, 1, device=dev, timeout=TIMEOUT[0])
    out = {}
    tf, conv, cg = sharded_estimate_warp_field(graph, src, dst, None, w, mesh=mesh, **WARP_EST_KW)
    out["estimate"] = dict(_tf(tf), warped=_np(tw.warp_points(graph, tf, src, device=dev)),
                           cg_iterations=int(cg))
    kw = dict(WARP_EST_KW, solver="direct", max_gn_iterations=2)
    tf, _, _ = sharded_estimate_warp_field(graph, src, dst, None, w, mesh=mesh, **kw)
    out["direct"] = dict(_tf(tf), warped=_np(tw.warp_points(graph, tf, src, device=dev)))
    tf, it, conv = sharded_icp_warp_field(graph, src, dst, mesh=mesh, **WARP_ICP_KW)
    out["icp"] = dict(_tf(tf), warped=_np(tw.warp_points(graph, tf, src, device=dev)), iterations=int(it))
    if rank == 0:  # the port's single-device solves of the same problems
        tf, _, cg = tw.estimate_warp_field(graph, src, dst, None, w, device=dev, **WARP_EST_KW)
        out["estimate_single"] = dict(warped=_np(tw.warp_points(graph, tf, src, device=dev)),
                                      cg_iterations=int(cg))
        tf, _, _ = tw.estimate_warp_field(graph, src, dst, None, w, device=dev, **kw)
        out["direct_single"] = dict(warped=_np(tw.warp_points(graph, tf, src, device=dev)))
        tf, it, _ = tw.icp_warp_field(graph, src, dst, device=dev, **WARP_ICP_KW)
        out["icp_single"] = dict(warped=_np(tw.warp_points(graph, tf, src, device=dev)), iterations=int(it))
    return out


@suite
def ba(rank, world, inputs, dev):
    from unittest import mock

    from cilantro_tpu_torch import slam as tslam
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.core.transforms import Transform
    from cilantro_tpu_torch.parallel import make_mesh, shard_cloud_arrays
    from cilantro_tpu_torch.slam import slam as tslam_mod
    from cilantro_tpu_torch.slam.fusion import FusionConfig

    out = {}
    mesh = make_mesh(world, 1, device=dev, timeout=TIMEOUT[0])
    lin, tr, x0, cam, lmk, obs = small_ba()
    order, local = ba_partition(cam, lmk, len(x0), world)
    shards = shard_cloud_arrays(mesh, "points", x0, cam[order], local, obs[order], np.ones(len(order), bool))
    stats = {}
    poses, lmks, resid = tslam.bundle_adjust_sharded(
        Transform(torch.as_tensor(lin), torch.as_tensor(tr)), *shards, mesh=mesh, max_iterations=15,
        stats=stats)
    out["small"] = dict(_tf(poses), landmarks=_np(lmks), residual=float(resid),
                        cg_iterations=stats["cg_iterations"])
    if "depths" in inputs.files:
        h, w = SLAM_HW
        k = CameraIntrinsics.make(fx=w * 525.0 / 640.0, fy=w * 525.0 / 640.0, cx=(w - 1) / 2.0,
                                  cy=(h - 1) / 2.0)
        edges = {}
        detect = tslam_mod.detect_loop_closures

        def detect_kept(graph, **kw):
            n = detect(graph, **kw)
            edges["edges"] = sorted(zip(graph.edge_i, graph.edge_j))
            return n

        with mock.patch.object(tslam_mod, "detect_loop_closures", detect_kept):
            fmap, res = tslam.run_slam(
                list(inputs["depths"]), k, map_capacity=8 * h * w, cfg=FusionConfig(**SLAM_FUSION),
                slam=tslam.SlamConfig(**SLAM_KW, ba_mesh=mesh), device=dev)
        out["slam"] = dict(refined=np.stack(res.refined_poses), odometry=np.stack(res.odometry_poses),
                           keyframes=list(res.keyframe_indices), loops=res.num_loop_closures,
                           edges=edges["edges"], map_points=int(fmap.num_points()))
    return out


@suite
def pipeline(rank, world, inputs, dev):
    from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
    from cilantro_tpu_torch.slam import FusionConfig, make_pipeline_mesh, run_fusion_sequence_pipelined
    from cilantro_tpu_torch.slam.driver import run_fusion_sequence_scanned

    h, w = FUSION_HW
    k = CameraIntrinsics.make(*FUSION_K)
    depths = list(inputs["depths"])
    mesh = make_pipeline_mesh(timeout=TIMEOUT[0])
    stats = {}
    fmap, met = run_fusion_sequence_pipelined(depths, k, mesh=mesh, map_capacity=2 * h * w, cfg=FusionConfig(),
                                              device=dev, stats=stats)
    out = {"pipelined": dict(poses=np.stack(met.poses), iterations=met.icp_iterations, data=_np(fmap.data),
                             rank=stats["rank"])}
    fmap, met = run_fusion_sequence_scanned(depths, k, map_capacity=2 * h * w, cfg=FusionConfig(), device=dev)
    out["scanned"] = dict(poses=np.stack(met.poses), iterations=met.icp_iterations, data=_np(fmap.data))
    return out


def main():
    name, rank, world, store, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    timeout = datetime.timedelta(seconds=float(sys.argv[6]))
    TIMEOUT[0] = timeout
    dev = sys.argv[7] if len(sys.argv) > 7 else "cpu"
    torch.set_num_threads(1)
    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world, timeout=timeout)
    inputs = np.load(os.path.join(out_dir, "inputs.npz"))
    result = SUITES[name](rank, world, inputs, torch.device(dev))
    with open(os.path.join(out_dir, f"{name}_{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    if name != "desync":  # a desynchronised group is left as it is
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
