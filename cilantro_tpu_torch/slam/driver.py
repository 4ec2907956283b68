"""Trajectory metric and synthetic input (port of the host-only parts of
``cilantro_tpu/slam/driver.py``).

:func:`synthetic_sequence` is a verbatim copy of the JAX package's numpy
renderer: for the same arguments it returns bit-identical depths and poses.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.rgbd import CameraIntrinsics
from ..registration.transform_estimation import estimate_rigid_point_to_point


def ate_rmse(
    est_poses: Sequence[np.ndarray],
    gt_poses: Sequence[np.ndarray],
    *,
    device="cuda",
) -> float:
    """Absolute trajectory error (RMSE of positions) after rigid Umeyama
    alignment of the estimated trajectory onto the ground truth; the
    alignment is fitted on ``device``."""
    dev = resolve_device(device)
    est = np.stack([p[:3, 3] for p in est_poses])
    gt = np.stack([p[:3, 3] for p in gt_poses])
    if len(est) >= 3 and np.linalg.matrix_rank(est - est.mean(0)) >= 2:
        tf, ok = estimate_rigid_point_to_point(
            torch.as_tensor(est, dtype=torch.float32, device=dev),
            torch.as_tensor(gt, dtype=torch.float32, device=dev),
        )
        if bool(ok):
            est = est @ tf.linear.cpu().numpy().T + tf.translation.cpu().numpy()
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def synthetic_sequence(
    num_frames: int,
    h: int,
    w: int,
    intrinsics: CameraIntrinsics,
    *,
    seed: int = 0,
    motion_scale: float = 0.004,
    cache_dir: Optional[str] = None,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Render a wavy-room depth sequence from a smoothly moving camera.

    Returns (depth frames, ground-truth camera-to-world 4×4 poses). The
    scene is a dense height-field point set rendered through a numpy
    z-buffer — data generation stays entirely on the host (no device
    contact) so benchmarks measure the pipeline, not the renderer.

    ``cache_dir``: if given, the rendered stack is memoized to
    ``{cache_dir}/seq_{frames}x{h}x{w}_s{seed}_m{motion}.npz`` and later
    calls with the same key load instead of re-rendering (bench runs under a
    wall budget must not spend it re-rendering identical input).
    """
    cache_path = None
    if cache_dir is not None:
        import os as _os

        _os.makedirs(cache_dir, exist_ok=True)
        _k = "-".join(
            f"{float(np.asarray(v)):g}"
            for v in (intrinsics.fx, intrinsics.fy,
                      intrinsics.cx, intrinsics.cy)
        )
        cache_path = _os.path.join(
            cache_dir,
            f"seq_{num_frames}x{h}x{w}_s{seed}_m{motion_scale:g}_k{_k}.npz",
        )
        if _os.path.exists(cache_path):
            try:
                with np.load(cache_path) as z:
                    return (
                        [d for d in z["depths"]],
                        [p for p in z["poses"]],
                    )
            except Exception:
                pass  # corrupt cache: fall through and re-render
    rng = np.random.default_rng(seed)
    fx = float(np.asarray(intrinsics.fx))
    fy = float(np.asarray(intrinsics.fy))
    cx = float(np.asarray(intrinsics.cx))
    cy = float(np.asarray(intrinsics.cy))

    def render_depth(cam_pts: np.ndarray) -> np.ndarray:
        z = cam_pts[:, 2]
        ok = z > 0
        u = np.round(cam_pts[:, 0] * fx / np.where(ok, z, 1.0) + cx).astype(np.int64)
        v = np.round(cam_pts[:, 1] * fy / np.where(ok, z, 1.0) + cy).astype(np.int64)
        ok &= (u >= 0) & (u < w) & (v >= 0) & (v < h)
        pix = v[ok] * w + u[ok]
        zbuf = np.full(h * w, np.inf, np.float32)
        np.minimum.at(zbuf, pix, z[ok].astype(np.float32))
        return np.where(np.isinf(zbuf), 0.0, zbuf).reshape(h, w)
    # Dense scene: height field over x-y at ~2 m depth, 4 samples per pixel.
    gx, gy = np.meshgrid(
        np.linspace(-1.6, 1.6, 2 * w), np.linspace(-1.2, 1.2, 2 * h)
    )
    gz = (
        2.0
        + 0.25 * np.sin(2.0 * gx) * np.cos(1.5 * gy)
        + 0.05 * np.sin(7.0 * gx)
    )
    scene = np.column_stack(
        [gx.ravel(), gy.ravel(), gz.ravel()]
    ).astype(np.float32)

    depths, poses = [], []
    ang = 0.0
    pos = np.zeros(3)
    vel = rng.standard_normal(3) * motion_scale
    for i in range(num_frames):
        r = np.array(
            [
                [np.cos(ang), 0, np.sin(ang)],
                [0, 1, 0],
                [-np.sin(ang), 0, np.cos(ang)],
            ],
            np.float32,
        )
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = r
        pose[:3, 3] = pos
        poses.append(pose)
        # Render: scene in camera frame = R⁻¹(X − t).
        cam_pts = (scene - pose[:3, 3]) @ r  # (N, 3) @ R = Rᵀ applied rowwise
        dn = render_depth(cam_pts.astype(np.float32))
        # Fill tiny z-buffer holes from the 3×3 neighborhood. grey_dilation
        # is a MAX filter (holes carry 0, so any real neighbor wins); the
        # filled depth is therefore the FARTHEST neighbor, a conservative
        # choice that cannot hallucinate surface in front of the scene.
        holes = dn == 0
        if holes.any():
            from scipy.ndimage import grey_dilation

            filled = grey_dilation(np.where(holes, 0.0, dn), size=3)
            dn = np.where(holes, filled, dn)
        depths.append(dn.astype(np.float32))
        # Smooth random walk.
        ang += rng.standard_normal() * motion_scale
        vel = 0.9 * vel + rng.standard_normal(3) * motion_scale * 0.5
        pos = pos + vel
    if cache_path is not None:
        import os as _os

        tmp = cache_path + ".tmp"
        with open(tmp, "wb") as f:  # savez on a file object keeps the name
            np.savez(f, depths=np.stack(depths), poses=np.stack(poses))
        _os.replace(tmp, cache_path)
    return depths, poses
