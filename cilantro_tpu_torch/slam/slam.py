"""End-to-end SLAM: fusion odometry → keyframes → loop closure → pose graph
(+ optional landmark BA, on one device or sharded over a mesh of ranks) →
map rewrite (port of ``cilantro_tpu/slam/slam.py``).

The front end is the pool fusion tracker, as a host loop
(:func:`.driver.run_fusion_sequence`) or as one pass of its CUDA-graph
replay (``frontend="scanned"``). Keyframes spawn every
``keyframe_every`` frames with a subsampled cloud; keyframes that revisit
an older one are registered against it directly (loop closures); the pose
graph, and optionally a Schur-complement BA over landmarks associated along
the graph's edges, spread the drift; every frame's pose follows its
keyframe's correction, and the map is rebuilt at the corrected poses.
The graph and its gates are host numpy, as in the JAX package; the solves,
the ICP and the fusion run on ``device``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.rgbd import CameraIntrinsics, depth_to_points_normals
from ..core.transforms import Transform, from_matrix
from .driver import FusionMetrics, _fusion_scanned, run_fusion_sequence
from .fusion import FusionConfig, FusionMap, init_map_from_frame, integrate_frame
from .keyframes import KeyframeGraph, _matrix, detect_loop_closures, spawn_keyframe


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Backend knobs on top of :class:`.fusion.FusionConfig` (the JAX
    package's defaults, measured there on the panorama workload)."""

    keyframe_every: int = 4  # spawn a keyframe every N frames
    keyframe_subsample: int = 4096  # points kept per keyframe cloud
    loop_min_separation: int = 3  # keyframes, temporal gate
    loop_max_translation: float = 0.5  # m, spatial gate
    # Orientation gate: only high-overlap revisits (low-overlap pairs drag
    # partial-overlap ICP toward false matches).
    loop_max_rotation_deg: Optional[float] = 30.0
    loop_icp_max_corr_dist_sq: float = 0.0025
    # Coarse to fine, sized for several degrees of accumulated drift.
    loop_icp_levels: tuple = (
        (0.04, 20, 8192, 0.04),
        (0.01, 15, 8192, 0.0064),
        (None, 10, None, 0.0025),
    )
    pose_graph_iterations: int = 25
    loop_edge_weight: float = 5.0  # loop edges trusted over drifted odometry
    run_ba: bool = False  # refine with landmark BA after the pose graph
    ba_match_dist: float = 0.08  # m, landmark association gate
    ba_max_landmarks_per_edge: int = 512
    # A (points, map) DeviceMesh (parallel.make_mesh): the landmark BA is
    # then sharded over it (bundle_adjust_sharded). None = one device.
    ba_mesh: Optional[object] = None
    rebuild_map: bool = True  # re-integrate all frames at corrected poses


@dataclasses.dataclass
class SlamResult:
    odometry_poses: List[np.ndarray]  # (4,4) per frame, front-end only
    refined_poses: List[np.ndarray]  # (4,4) per frame, after the backend
    keyframe_indices: List[int]
    num_loop_closures: int
    pose_graph_update: float  # final GN update norm
    metrics: FusionMetrics  # front-end fusion metrics


def _propagate_correction(
    odometry: List[np.ndarray],
    kf_indices: List[int],
    kf_refined: List[np.ndarray],
) -> List[np.ndarray]:
    """Anchor every frame to its nearest preceding keyframe: the keyframe's
    refined pose composed with the frame's odometry increment since it."""
    out = []
    ki = 0
    for f, odo in enumerate(odometry):
        while ki + 1 < len(kf_indices) and kf_indices[ki + 1] <= f:
            ki += 1
        anchor = kf_indices[ki]
        rel = np.linalg.inv(odometry[anchor]) @ odo
        out.append((kf_refined[ki] @ rel).astype(np.float32))
    return out


def _ba_problem(graph: KeyframeGraph, refined: List[np.ndarray], cfg: SlamConfig, device):
    """The landmark BA problem over the graph: landmarks are nearest-point
    pairs within ``cfg.ba_match_dist`` along every edge, each observed in
    both cameras; at most ``ba_max_landmarks_per_edge`` an edge, drawn by
    ``default_rng(0)`` as the JAX package draws them. Returns ``(linear,
    translation, landmarks, cam_idx, lmk_idx, observations)`` as numpy
    (float32 / int32), or None when no pair matched."""
    from ..neighbors.bruteforce import nn1

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    cam_idx, lmk_idx, obs, lmks = [], [], [], []
    for i, j in zip(graph.edge_i, graph.edge_j):
        a, b = graph.keyframes[i], graph.keyframes[j]
        pa, pb = refined[i], refined[j]
        wa = a.points @ pa[:3, :3].T + pa[:3, 3]
        wb = b.points @ pb[:3, :3].T + pb[:3, 3]
        d, idx = nn1(torch.as_tensor(wb, device=dev), torch.as_tensor(wa, device=dev))
        d, idx = d.cpu().numpy(), idx.cpu().numpy()
        ok = np.flatnonzero(d <= cfg.ba_match_dist**2)
        if len(ok) == 0:
            continue
        if len(ok) > cfg.ba_max_landmarks_per_edge:
            ok = rng.choice(ok, cfg.ba_max_landmarks_per_edge, replace=False)
        base = len(lmks)
        lmks.extend(0.5 * (wb[ok] + wa[idx[ok]]))
        ids = base + np.arange(len(ok))
        cam_idx.extend([j] * len(ok))
        lmk_idx.extend(ids)
        obs.extend(b.points[ok])
        cam_idx.extend([i] * len(ok))
        lmk_idx.extend(ids)
        obs.extend(a.points[idx[ok]])
    if not lmks:
        return None
    return (
        np.stack([p[:3, :3] for p in refined]).astype(np.float32),
        np.stack([p[:3, 3] for p in refined]).astype(np.float32),
        np.asarray(lmks, np.float32),
        np.asarray(cam_idx, np.int32),
        np.asarray(lmk_idx, np.int32),
        np.asarray(obs, np.float32),
    )


def _refine_ba(
    graph: KeyframeGraph, refined: List[np.ndarray], cfg: SlamConfig, device="cuda"
) -> List[np.ndarray]:
    """Landmark BA over the keyframe graph (:func:`_ba_problem`): poses and
    landmarks refined jointly with the Schur solver on ``device``, or
    sharded over ``cfg.ba_mesh`` (:func:`_refine_ba_sharded`)."""
    from .bundle_adjustment import bundle_adjust

    dev = resolve_device(device)
    if cfg.ba_mesh is not None:
        return _refine_ba_sharded(graph, refined, cfg, dev)
    problem = _ba_problem(graph, refined, cfg, dev)
    if problem is None:
        return refined
    linear, translation, lmks, cam_idx, lmk_idx, obs = problem
    poses0 = Transform(torch.as_tensor(linear, device=dev), torch.as_tensor(translation, device=dev))
    new_poses, _, _ = bundle_adjust(poses0, lmks, cam_idx, lmk_idx, obs, device=dev)
    lin, tr = new_poses.linear.cpu().numpy(), new_poses.translation.cpu().numpy()
    return [_matrix(lin[i], tr[i]) for i in range(len(refined))]


def _refine_ba_sharded(graph: KeyframeGraph, refined: List[np.ndarray], cfg: SlamConfig, dev):
    """The landmark BA over ``cfg.ba_mesh``'s ``points`` axis. The rank at
    the mesh's origin builds the problem and broadcasts it, so every rank
    solves the same one; then, as the JAX package does, the landmarks are
    padded to a multiple of the mesh size (each pad landmark with two
    invalid observations: every landmark here has exactly two), the
    observations sorted by shard and each shard given its block with local
    landmark ids."""
    from ..parallel import collectives as cc
    from ..parallel.sharded import shard_cloud_arrays
    from .bundle_adjustment import bundle_adjust_sharded

    mesh = cfg.ba_mesh
    origin = all(cc.axis_index(mesh, a) == 0 for a in mesh.mesh_dim_names)
    problem = _ba_problem(graph, refined, cfg, dev) if origin else None
    for axis in reversed(mesh.mesh_dim_names):  # the origin's row, then every column
        problem = cc.broadcast_object(problem, mesh, axis)
    if problem is None:
        return refined
    linear, translation, lmks, cam_idx, lmk_idx, obs = problem
    d_sh = mesh.size()
    l0 = len(lmks)
    l_pad = -(-l0 // d_sh) * d_sh
    extra = l_pad - l0
    lmks = np.concatenate([lmks, np.zeros((extra, 3), np.float32)])
    cam_idx = np.concatenate([cam_idx, np.zeros(2 * extra, np.int32)])
    lmk_idx = np.concatenate([lmk_idx, np.repeat(np.arange(l0, l_pad), 2)]).astype(np.int32)
    obs = np.concatenate([obs, np.zeros((2 * extra, 3), np.float32)])
    valid = np.concatenate([np.ones(2 * l0, bool), np.zeros(2 * extra, bool)])
    lp = l_pad // d_sh
    order = np.argsort(lmk_idx // lp, kind="stable")
    local = shard_cloud_arrays(mesh, "points", lmks, cam_idx[order], (lmk_idx[order] % lp).astype(np.int32),
                               obs[order], valid[order])
    new_poses, _, _ = bundle_adjust_sharded(Transform(torch.as_tensor(linear), torch.as_tensor(translation)),
                                            *local, mesh=mesh)
    lin, tr = new_poses.linear.cpu().numpy(), new_poses.translation.cpu().numpy()
    return [_matrix(lin[i], tr[i]) for i in range(len(refined))]


def integrate_sequence(
    depths: Sequence[np.ndarray],
    poses: Sequence[np.ndarray],  # (4,4) camera-to-world per frame, FIXED
    intrinsics: CameraIntrinsics,
    *,
    map_capacity: Optional[int] = None,
    cfg: FusionConfig = FusionConfig(),
    device="cuda",
) -> FusionMap:
    """Map (re)construction at known poses on ``device``: seed from frame
    0, then fuse / augment / carve every later frame, with no
    localization."""
    dev = resolve_device(device)
    h, w = depths[0].shape
    if map_capacity is None:
        map_capacity = 4 * h * w

    def frame(fi):
        return depth_to_points_normals(torch.as_tensor(np.asarray(depths[fi], np.float32), device=dev),
                                       intrinsics)

    def pose(fi):
        return from_matrix(torch.as_tensor(np.asarray(poses[fi], np.float32), device=dev))

    pts, nrm, valid = frame(0)
    fmap = init_map_from_frame(map_capacity, pts, nrm, None, valid, pose=pose(0))
    for fi in range(1, len(depths)):
        pts, nrm, valid = frame(fi)
        fmap = integrate_frame(fmap, pts, nrm, None, valid, pose(fi), intrinsics,
                               height=h, width=w, cfg=cfg)
    return fmap


def run_slam(
    depths: Sequence[np.ndarray],
    intrinsics: CameraIntrinsics,
    *,
    map_capacity: Optional[int] = None,
    cfg: FusionConfig = FusionConfig(),
    slam: SlamConfig = SlamConfig(),
    frontend: str = "loop",
    device="cuda",
    stats: Optional[dict] = None,
) -> Tuple[FusionMap, SlamResult]:
    """Fusion odometry → keyframes → loop closure → pose graph (+ optional
    BA) → corrected trajectory → rebuilt map, on ``device``.

    ``frontend="scanned"`` takes the odometry from one pass of the
    CUDA-graph replay (:func:`.driver.run_fusion_sequence_scanned`'s step),
    "loop" from the host loop. Returns ``(map, result)``: the map is
    integrated at the corrected poses when ``slam.rebuild_map`` and a loop
    closed (the odometry map otherwise); ``result`` carries both
    trajectories. ``stats``, if given, receives ``stage_seconds`` (host
    clock, each stage ended by a synchronise): ``frontend``,
    ``keyframes``, ``loop_closures``, ``pose_graph``, ``ba``,
    ``rebuild``; and ``frontend``, the scanned driver's ``stats`` (empty
    for the host loop). With ``slam.ba_mesh`` every rank of the mesh calls
    this and the BA is sharded over it (:func:`_refine_ba_sharded`)."""
    if frontend not in ("loop", "scanned"):
        raise ValueError(f"frontend must be 'loop' or 'scanned', not {frontend!r}")
    dev = resolve_device(device)
    seconds = {}
    clock = [time.perf_counter()]

    def lap(name):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    # 1. Front end: odometry, and keyframes at the estimated poses.
    frontend_stats = {}
    if frontend == "scanned":
        fmap_odo, metrics = _fusion_scanned(depths, intrinsics, map_capacity, cfg, dev, frontend_stats, 1)
    else:
        fmap_odo, metrics = run_fusion_sequence(
            depths, intrinsics, map_capacity=map_capacity, cfg=cfg, device=dev
        )
    odometry = [np.asarray(p, np.float32) for p in metrics.poses]
    lap("frontend")

    graph = KeyframeGraph.empty()
    kf_indices: List[int] = []
    for f in range(0, len(depths), slam.keyframe_every):
        # Clouds with normals: the loop-closure ICP then runs the combined
        # metric, tighter than point-to-point on partial-overlap revisits.
        pts_d, nrm_d, valid_d = depth_to_points_normals(
            torch.as_tensor(np.asarray(depths[f], np.float32), device=dev), intrinsics
        )
        spawn_keyframe(
            graph, f, odometry[f], pts_d.cpu().numpy(), nrm_d.cpu().numpy(),
            valid=valid_d.cpu().numpy(), subsample=slam.keyframe_subsample,
        )
        kf_indices.append(f)
    lap("keyframes")

    # 2. Loop closures: temporally distant, spatially near keyframe pairs.
    n_loops = detect_loop_closures(
        graph,
        min_separation=slam.loop_min_separation,
        max_translation=slam.loop_max_translation,
        max_rotation_deg=slam.loop_max_rotation_deg,
        icp_max_corr_dist_sq=slam.loop_icp_max_corr_dist_sq,
        icp_levels=slam.loop_icp_levels,
        convergence_tol=1e-5,
        weight=slam.loop_edge_weight,
        device=dev,
    )
    lap("loop_closures")

    # 3. Backend: pose graph over the keyframes, the correction carried to
    # every frame; optional landmark BA.
    if n_loops > 0:
        kf_refined, upd = graph.optimize(max_iterations=slam.pose_graph_iterations, device=dev)
    else:  # nothing to correct against: keep the odometry
        kf_refined, upd = [kf.pose for kf in graph.keyframes], 0.0
    lap("pose_graph")
    if slam.run_ba and n_loops > 0:
        kf_refined = _refine_ba(graph, kf_refined, slam, device=dev)
    lap("ba")
    refined = _propagate_correction(odometry, kf_indices, kf_refined)

    # 4. The map rewritten at the corrected trajectory.
    fmap = (
        integrate_sequence(depths, refined, intrinsics, map_capacity=map_capacity, cfg=cfg, device=dev)
        if slam.rebuild_map and n_loops > 0
        else fmap_odo
    )
    lap("rebuild")
    if stats is not None:
        stats.update(stage_seconds=seconds, frontend=frontend_stats)
    return fmap, SlamResult(
        odometry_poses=odometry,
        refined_poses=refined,
        keyframe_indices=kf_indices,
        num_loop_closures=n_loops,
        pose_graph_update=float(upd),
        metrics=metrics,
    )
