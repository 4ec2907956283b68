"""Offline visualization artifacts (port of ``cilantro_tpu/viz/offline.py``).

The reference's visualization layer is an interactive Pangolin/OpenGL window
(``include/cilantro/visualization/`` + ``src/visualization/``) — out of scope
for headless machines. The equivalent capability surface here is *artifact
generation*:

* :func:`render_cloud_image` — renders a point cloud through the package's
  OWN z-buffer rasterizer (``core/rgbd.cloud_to_rgbd``) on the cloud's
  device; colors come from the cloud, a scalar channel via colormap, or
  normal shading (the ``RenderingProperties`` analogues);
* :func:`save_cloud_png` / :func:`save_trajectory_png` — PNG artifacts
  (host side). matplotlib is optional: the image writers encode the PNG
  themselves where it is absent (the same pixels); the plots import it
  when called, which raises ``ImportError`` where it is absent;
* :func:`dump_artifacts` — PLY + PNG bundle per run (map, trajectory), the
  headless replacement for the fusion app's interactive view; without
  matplotlib it leaves out the trajectory plot and says so in a warning.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core.containers import PointCloud
from ..core.rgbd import CameraIntrinsics, cloud_to_rgbd
from ..core.transforms import Transform
from ..utils.colormap import colormap
from .interactive import _host, _png_bytes


def auto_camera(points, valid=None, device=None):
    """A camera pose looking at the cloud centroid from outside its bounding
    sphere along −z (returns world-from-camera Transform), computed on the
    host; the Transform lies on ``points``' device if it is a tensor, else
    on ``device`` (the card by default)."""
    if device is None:
        device = points.device if isinstance(points, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    pts = _host(points)
    if valid is not None:
        pts = pts[_host(valid)]
    center = pts.mean(0)
    radius = float(np.percentile(np.linalg.norm(pts - center, axis=1), 95))
    eye = center + np.array([0.0, 0.0, -2.5 * radius])
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    r = np.stack([right, up2, fwd], axis=1).astype(np.float32)
    return Transform(torch.as_tensor(r, device=dev), torch.as_tensor(eye.astype(np.float32), device=dev))


def render_cloud_image(
    cloud: PointCloud,
    *,
    pose: Optional[Transform] = None,
    intrinsics: Optional[CameraIntrinsics] = None,
    h: int = 480,
    w: int = 640,
    color_by: str = "color",  # color | normal | z | scalar
    scalars=None,
    cmap: str = "jet",
    device=None,
) -> np.ndarray:
    """Z-buffer render on ``device`` (the cloud's own by default) → host
    (H, W, 3) float32 RGB in [0, 1], white where no point lands."""
    if device is not None:
        dev = resolve_device(device)
        move = lambda a: None if a is None else a.to(dev)  # noqa: E731
        cloud = PointCloud(points=move(cloud.points), normals=move(cloud.normals),
                           colors=move(cloud.colors), valid=move(cloud.valid))
        if pose is not None:
            pose = Transform(move(pose.linear), move(pose.translation))
    dev = cloud.points.device
    if pose is None:
        pose = auto_camera(cloud.points, cloud.valid_mask())
    if intrinsics is None:
        intrinsics = CameraIntrinsics.make(
            0.8 * w, 0.8 * w, (w - 1) / 2.0, (h - 1) / 2.0
        )
    cam_from_world = pose.inverse()
    pts_cam = cam_from_world.apply(cloud.points)

    if color_by == "color" and cloud.colors is not None:
        cols = cloud.colors
    elif color_by == "normal" and cloud.normals is not None:
        cols = 0.5 * (cloud.normals + 1.0)
    elif color_by == "scalar" and scalars is not None:
        cols = colormap(scalars, cmap, device=dev)
    else:  # depth shading
        z = pts_cam[:, 2]
        cols = colormap(z, cmap)
    cam_cloud = PointCloud(
        points=pts_cam, colors=cols, valid=cloud.valid_mask()
    )
    depth, rgb = cloud_to_rgbd(cam_cloud, intrinsics, h, w)
    bg = depth == 0
    return torch.where(bg[..., None], 1.0, rgb).cpu().numpy()


def save_cloud_png(path: str, cloud: PointCloud, **kwargs) -> None:
    img = render_cloud_image(cloud, **kwargs)
    with open(path, "wb") as f:
        f.write(_png_bytes(np.clip(img, 0, 1)))


def save_trajectory_png(
    path: str,
    poses: Sequence[np.ndarray],
    gt_poses: Optional[Sequence[np.ndarray]] = None,
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    est = np.stack([_host(p)[:3, 3] for p in poses])
    fig, ax = plt.subplots(1, 2, figsize=(10, 4))
    for a, (i, j, name) in zip(ax, [(0, 2, "x-z"), (0, 1, "x-y")]):
        a.plot(est[:, i], est[:, j], "b.-", label="estimated", ms=3)
        if gt_poses is not None:
            gt = np.stack([_host(p)[:3, 3] for p in gt_poses])
            a.plot(gt[:, i], gt[:, j], "g.--", label="ground truth", ms=3)
        a.set_title(name)
        a.axis("equal")
        a.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def dump_artifacts(
    out_dir: str,
    cloud: Optional[PointCloud] = None,
    poses: Optional[Sequence[np.ndarray]] = None,
    gt_poses: Optional[Sequence[np.ndarray]] = None,
    prefix: str = "run",
) -> None:
    """Write the standard artifact bundle: map PLY + render PNG + trajectory
    PNG (the headless analogue of the fusion app's save-on-exit,
    ``examples/fusion.cpp:262``)."""
    from ..utils.ply_io import write_point_cloud

    os.makedirs(out_dir, exist_ok=True)
    if cloud is not None:
        mask = _host(cloud.valid_mask())
        pts = _host(cloud.points)[mask]
        nrm = _host(cloud.normals)[mask] if cloud.normals is not None else None
        col = _host(cloud.colors)[mask] if cloud.colors is not None else None
        write_point_cloud(
            os.path.join(out_dir, f"{prefix}_map.ply"), pts, nrm, col
        )
        save_cloud_png(
            os.path.join(out_dir, f"{prefix}_map.png"),
            cloud,
            color_by="normal" if cloud.normals is not None else "z",
        )
    if poses is not None:
        try:
            save_trajectory_png(
                os.path.join(out_dir, f"{prefix}_trajectory.png"), poses, gt_poses
            )
        except ImportError as e:
            warnings.warn(f"dump_artifacts: no {prefix}_trajectory.png ({e}); the other artifacts are written",
                          RuntimeWarning, stacklevel=2)
        np.save(
            os.path.join(out_dir, f"{prefix}_poses.npy"), np.stack([_host(p) for p in poses])
        )


def save_correspondences_png(
    path: str,
    src_points,
    dst_points,
    correspondences,
    *,
    max_lines: int = 500,
    elev: float = 20.0,
    azim: float = -60.0,
) -> None:
    """Correspondence artifact — the reference's
    ``PointCorrespondencesRenderable`` (``common_renderables.hpp``) as a 3D
    line plot: both clouds plus up to ``max_lines`` match segments."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    s = _host(src_points)
    d = _host(dst_points)
    mask = _host(correspondences.mask)
    idx = _host(correspondences.dst_idx)
    rows = np.flatnonzero(mask)
    if len(rows) > max_lines:
        rows = rows[:: max(1, len(rows) // max_lines)][:max_lines]
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(*s[:: max(1, len(s) // 2000)].T, s=1, c="tab:blue", alpha=0.4)
    ax.scatter(*d[:: max(1, len(d) // 2000)].T, s=1, c="tab:orange", alpha=0.4)
    for r in rows:
        a, b = s[r], d[idx[r]]
        ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], c="gray", lw=0.3)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def save_mesh_png(
    path: str,
    vertices,
    faces,
    *,
    elev: float = 20.0,
    azim: float = -60.0,
    face_color=(0.6, 0.7, 0.9),
) -> None:
    """Triangle-mesh artifact — the reference's ``TriangleMeshRenderable``
    as a shaded matplotlib Poly3DCollection (e.g. convex-hull facets)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    v = _host(vertices)
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    tris = [v[_host(f)] for f in faces]
    coll = Poly3DCollection(
        tris, facecolor=face_color, edgecolor="k", linewidths=0.2, alpha=0.9
    )
    ax.add_collection3d(coll)
    lo, hi = v.min(0), v.max(0)
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    ax.set_zlim(lo[2], hi[2])
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
