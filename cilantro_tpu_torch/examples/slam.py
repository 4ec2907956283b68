"""End-to-end SLAM demo (port of ``examples/slam.py``): fusion odometry
over a drifting panorama sweep → keyframes → loop closure → pose graph
(+ landmark BA) → rebuilt map.

The reference's fusion app (``examples/fusion.cpp``) is the front half
only; this drives the full loop and reports trajectory error before/after
the backend correction.

Usage: python -m cilantro_tpu_torch.examples.slam [--frames 48] [--size 96 128] [--ba] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from .. import resolve_device
from ..core.rgbd import CameraIntrinsics
from ..slam import SlamConfig, ate_rmse, run_slam, synthetic_panorama_sequence
from ..slam.fusion import FusionConfig
from ._common import out_dir, parser


def rot_err_deg(p, g):
    rel = p[:3, :3].T @ g[:3, :3]
    return np.degrees(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1)))


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--size", type=int, nargs=2, default=(96, 128), metavar=("H", "W"))
    ap.add_argument("--noise", type=float, default=0.008)
    ap.add_argument("--ba", action="store_true", help="landmark BA polish")
    ap.add_argument("--cache", default=None, help="render cache directory (default: under the temp dir)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    h, w = args.size
    k = CameraIntrinsics.make(
        fx=w * 525.0 / 640.0, fy=w * 525.0 / 640.0,
        cx=(w - 1) / 2.0, cy=(h - 1) / 2.0,
    )
    print(f"rendering {args.frames}-frame panorama sweep at {h}x{w} "
          f"(noise {args.noise})...")
    depths, gt = synthetic_panorama_sequence(
        args.frames, h, w, k, seed=3, depth_noise=args.noise,
        cache_dir=out_dir(args.cache, name="cilantro_tpu_torch_pano"),
    )
    t0 = time.perf_counter()
    fmap, res = run_slam(
        depths, k,
        map_capacity=8 * h * w,
        cfg=FusionConfig(localize_stride=1, icp_iterations=8),
        slam=SlamConfig(keyframe_every=5, run_ba=args.ba),
        device=dev,
    )
    wall = time.perf_counter() - t0
    yaw_b = max(rot_err_deg(p, g) for p, g in zip(res.odometry_poses, gt))
    yaw_a = max(rot_err_deg(p, g) for p, g in zip(res.refined_poses, gt))
    print(f"keyframes: {len(res.keyframe_indices)}; "
          f"loop closures: {res.num_loop_closures}")
    if res.num_loop_closures == 0:
        print("  (no loop closed: the backend then has nothing to correct "
              "against — denser sweeps track better; the tested config is "
              "the default 48 frames)")
    print(f"max orientation error: {yaw_b:.2f} deg (odometry) -> "
          f"{yaw_a:.2f} deg (backend-corrected)")
    print(f"ATE: {ate_rmse(res.odometry_poses, gt, device=dev)*100:.2f} cm -> "
          f"{ate_rmse(res.refined_poses, gt, device=dev)*100:.2f} cm")
    print(f"rebuilt map: {int(fmap.num_points())} points; "
          f"front end {res.metrics.seconds_per_frame*1e3:.1f} ms/frame; "
          f"total {wall:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
