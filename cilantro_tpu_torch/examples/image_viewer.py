"""ImageViewer demo (port of ``examples/image_viewer.py``) — the
reference's ``examples/image_viewer.cpp`` shows an RGB + depth image pair
from a camera stream; a headless host instead renders the pair from a
cloud through the device z-buffer rasterizer and exports two
zoomable/pannable HTML image views.

Usage: python -m cilantro_tpu_torch.examples.image_viewer [cloud.ply] [out_dir] [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..core.containers import PointCloud
from ..core.rgbd import CameraIntrinsics, cloud_to_rgbd
from ..utils.colormap import colormap
from ..viz import ImageViewer, auto_camera
from ._common import load_cloud, out_dir, parser


def main(argv=None) -> int:
    ap = parser(__doc__, cloud=True, out=True)
    ap.add_argument("out_dir", nargs="?", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = out_dir(args.out, args.out_dir, name="cilantro_tpu_torch_viz")

    (pts, normals, colors), _ = load_cloud(args.cloud, args.points)
    nrm_t = None if normals is None else torch.as_tensor(normals, device=dev)
    cloud = PointCloud(
        points=torch.as_tensor(pts, device=dev),
        normals=nrm_t,
        colors=torch.as_tensor(colors, device=dev) if colors is not None else 0.5 * (nrm_t + 1.0),
    )

    # Render RGB + depth through the device rasterizer (the package's own
    # points->RGBD conversion, core/rgbd.py).
    intr = CameraIntrinsics.kinect_640()
    pose = auto_camera(cloud.points)
    pts_cam = pose.inverse().apply(cloud.points)
    cam_cloud = PointCloud(points=pts_cam, colors=cloud.colors)
    depth, rgb = cloud_to_rgbd(cam_cloud, intr, 480, 640)

    rgb_np = rgb.cpu().numpy()
    depth_np = depth.cpu().numpy()
    print(f"rendered {rgb_np.shape} rgb + depth; "
          f"depth range [{depth_np[depth_np > 0].min():.3f}, {depth_np.max():.3f}] m")

    p1 = ImageViewer("rgb").set_image(rgb_np).export_html(
        os.path.join(out, "image_viewer_rgb.html"))
    valid = depth_np > 0
    lo, hi = depth_np[valid].min(), depth_np.max()
    norm = np.where(valid, (depth_np - lo) / max(hi - lo, 1e-9), 0.0)
    depth_vis = colormap(torch.as_tensor(norm, device=dev), "jet").cpu().numpy() * valid[..., None]
    p2 = ImageViewer("depth").set_image(depth_vis).export_html(
        os.path.join(out, "image_viewer_depth.html"))
    print(f"rgb -> {p1}\ndepth -> {p2}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
