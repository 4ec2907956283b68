"""Headless RGBD fusion demo (port of ``examples/fusion.py``) — the
reference's ``examples/fusion.cpp`` pipeline (localize → fuse/augment/carve)
on a synthetic sequence, with artifact output.

Usage: python -m cilantro_tpu_torch.examples.fusion [num_frames] [out_dir] [--device cpu]
"""

from __future__ import annotations

from .. import resolve_device
from ..core.containers import PointCloud
from ..slam import ate_rmse, run_fusion_sequence, synthetic_sequence
from ..viz import dump_artifacts
from ._common import out_dir, parser, scaled_intrinsics


def main(argv=None) -> int:
    ap = parser(__doc__, out=True)
    ap.add_argument("frames", nargs="?", type=int, default=12)
    ap.add_argument("out_dir", nargs="?", default=None)
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640), metavar=("H", "W"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = out_dir(args.out, args.out_dir, name="fusion_out")

    h, w = args.size
    k = scaled_intrinsics(h, w)
    print("rendering synthetic sequence...")
    depths, gt = synthetic_sequence(args.frames, h, w, k, seed=0)

    fmap, metrics = run_fusion_sequence(depths, k, map_capacity=2 * h * w, device=dev)
    ate = ate_rmse(metrics.poses, gt, device=dev)
    print(
        f"{metrics.frames} frames, {metrics.seconds_per_frame*1e3:.1f} ms/frame, "
        f"ATE {ate*1e3:.2f} mm, {metrics.num_map_points} map points"
    )

    cloud = PointCloud(
        points=fmap.points, normals=fmap.normals,
        colors=fmap.colors, valid=fmap.valid,
    )
    dump_artifacts(out, cloud, metrics.poses, gt, prefix="fusion")
    print(f"artifacts in {out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
