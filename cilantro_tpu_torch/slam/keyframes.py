"""Keyframes, odometry and loop-closure edges (port of
``cilantro_tpu/slam/keyframes.py``).

The graph is host state, as in the JAX package: keyframe poses, clouds,
gates and measurements are numpy arrays, so a JAX ``KeyframeGraph`` carries
over by copy (:func:`..interop.keyframe_graph_from_numpy`). The pose-graph
solve and the loop-closure ICP run on ``device`` (default the card).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.transforms import Transform
from .pose_graph import optimize_pose_graph


@dataclasses.dataclass
class Keyframe:
    index: int  # frame index in the sequence
    pose: np.ndarray  # (4, 4) camera-to-world at spawn time
    points: np.ndarray  # (S, 3) subsampled frame points (camera frame)
    normals: Optional[np.ndarray]


def _transform(mats, dev) -> Transform:
    """A batched ``Transform`` from (4, 4) matrices, float32 on ``dev``."""
    m = np.stack(mats)
    return Transform(
        torch.as_tensor(m[:, :3, :3], dtype=torch.float32, device=dev),
        torch.as_tensor(m[:, :3, 3], dtype=torch.float32, device=dev),
    )


def _matrix(linear: np.ndarray, translation: np.ndarray) -> np.ndarray:
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = linear
    p[:3, 3] = translation
    return p


@dataclasses.dataclass
class KeyframeGraph:
    keyframes: List[Keyframe]
    edge_i: List[int]
    edge_j: List[int]
    measurements: List[np.ndarray]  # (4, 4) relative transforms Z_ij
    edge_weights: List[float]

    @staticmethod
    def empty() -> "KeyframeGraph":
        return KeyframeGraph([], [], [], [], [])

    def add_keyframe(self, kf: Keyframe) -> int:
        self.keyframes.append(kf)
        return len(self.keyframes) - 1

    def add_edge(self, i: int, j: int, z: np.ndarray, weight: float = 1.0):
        self.edge_i.append(i)
        self.edge_j.append(j)
        self.measurements.append(z)
        self.edge_weights.append(weight)

    def optimize(self, max_iterations: int = 20, device="cuda") -> Tuple[List[np.ndarray], float]:
        """Pose-graph GN over the stored keyframe poses on ``device``.
        Returns the refined (4, 4) poses and the final update norm."""
        dev = resolve_device(device)
        opt, dn = optimize_pose_graph(
            _transform([kf.pose for kf in self.keyframes], dev),
            torch.as_tensor(np.array(self.edge_i, np.int64), device=dev),
            torch.as_tensor(np.array(self.edge_j, np.int64), device=dev),
            _transform(self.measurements, dev),
            edge_weights=torch.as_tensor(np.array(self.edge_weights, np.float32), device=dev),
            max_iterations=max_iterations,
        )
        lin, tr = opt.linear.cpu().numpy(), opt.translation.cpu().numpy()
        return [_matrix(lin[i], tr[i]) for i in range(len(self.keyframes))], float(dn)


def relative_pose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Z_ab = a⁻¹ b."""
    return np.linalg.inv(a) @ b


def spawn_keyframe(
    graph: KeyframeGraph,
    frame_index: int,
    pose: np.ndarray,
    points: np.ndarray,
    normals: Optional[np.ndarray],
    valid: Optional[np.ndarray] = None,
    subsample: int = 4096,
) -> int:
    """Record a keyframe (a subsampled frame cloud) and the odometry edge
    from the previous keyframe."""
    pts = points if valid is None else points[valid]
    nrm = None if normals is None else (normals if valid is None else normals[valid])
    # Exactly min(subsample, len) rows, evenly spaced: every keyframe cloud
    # has one shape.
    sel = np.linspace(0, len(pts) - 1, min(subsample, len(pts))).astype(np.int64)
    kf = Keyframe(
        index=frame_index,
        pose=pose.copy(),
        points=np.asarray(pts[sel], np.float32),
        normals=None if nrm is None else np.asarray(nrm[sel], np.float32),
    )
    kid = graph.add_keyframe(kf)
    if kid > 0:
        prev = graph.keyframes[kid - 1]
        graph.add_edge(kid - 1, kid, relative_pose(prev.pose, pose))
    return kid


def detect_loop_closures(
    graph: KeyframeGraph,
    *,
    min_separation: int = 3,
    max_translation: float = 0.3,
    max_rotation_deg: Optional[float] = None,
    icp_max_corr_dist_sq: float = 0.01,
    icp_levels: Optional[tuple] = None,
    convergence_tol: float = 1e-5,
    weight: float = 1.0,
    device="cuda",
) -> int:
    """Register spatially close, temporally distant keyframe pairs with
    multires ICP on ``device`` and add loop-closure edges. Returns the
    number of edges added. ``max_rotation_deg`` also gates candidate pairs
    on relative orientation (an in-place sweep keeps every keyframe within
    ``max_translation`` of every other)."""
    from ..registration.icp import icp_multires

    dev = resolve_device(device)

    def on(a):
        return None if a is None else torch.as_tensor(a, dtype=torch.float32, device=dev)

    added = 0
    k = len(graph.keyframes)
    existing = set(zip(graph.edge_i, graph.edge_j))
    for j in range(k):
        # i < j with j - i >= min_separation: never a keyframe with itself.
        for i in range(min(j, j - min_separation + 1)):
            if (i, j) in existing:
                continue
            a, b = graph.keyframes[i], graph.keyframes[j]
            if np.linalg.norm(a.pose[:3, 3] - b.pose[:3, 3]) > max_translation:
                continue
            if max_rotation_deg is not None:
                rel = a.pose[:3, :3].T @ b.pose[:3, :3]
                ang = np.degrees(np.arccos(np.clip((np.trace(rel) - 1.0) / 2.0, -1.0, 1.0)))
                if ang > max_rotation_deg:
                    continue
            # Frame j onto frame i in i's camera frame, from the current
            # pose estimates.
            z0 = relative_pose(a.pose, b.pose)
            levels = icp_levels
            if levels is None:
                levels = ((0.04, 6, 8192, 0.01), (None, 4, None, icp_max_corr_dist_sq))
            res = icp_multires(
                on(b.points),
                on(a.points),
                src_normals=on(b.normals),
                dst_normals=on(a.normals),
                init=Transform(on(z0[:3, :3]), on(z0[:3, 3])),
                levels=levels,
                convergence_tol=convergence_tol,
                metric="combined" if a.normals is not None else "point_to_point",
            )
            z = _matrix(res.transform.linear.cpu().numpy(), res.transform.translation.cpu().numpy())
            graph.add_edge(i, j, z, weight)
            added += 1
    return added
