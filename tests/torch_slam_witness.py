"""The JAX package's ``run_slam`` at its bench SLAM row's shape, with and
without the landmark BA: the reference readings that the port's
``chip_smoke.py`` phase 26 is held to.

``bench.py``'s SLAM row (``bench_slam``) runs 48 frames of a 320×240
drifting panorama sweep without the BA; ``tests/test_slam_loop.py`` runs
the BA at 72×96 only. This script runs both configurations at 320×240 on
the CPU and prints, for each, the keyframes, loop closures, max and
endpoint orientation error and translational ATE before and after the
backend, the ratio of the ATEs, and whether the JAX test's bounds hold.
It is not collected by pytest (it takes minutes); run it from the repo's
root as

    JAX_PLATFORMS=cpu python tests/torch_slam_witness.py [--out poses.npz]

``--out`` keeps both configurations' odometry and refined poses.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cilantro_tpu.core.rgbd import CameraIntrinsics  # noqa: E402
from cilantro_tpu.slam import SlamConfig, ate_rmse, run_slam, synthetic_panorama_sequence  # noqa: E402
from cilantro_tpu.slam.fusion import FusionConfig  # noqa: E402

H, W, FRAMES = 240, 320, 48


def rot_err_deg(p, g) -> float:
    rel = p[:3, :3].T @ g[:3, :3]
    return float(np.degrees(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1, 1))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write both runs' odometry and refined poses to this .npz")
    args = ap.parse_args()
    k = CameraIntrinsics.make(fx=W * 525.0 / 640.0, fy=W * 525.0 / 640.0, cx=(W - 1) / 2.0,
                              cy=(H - 1) / 2.0)
    depths, gt = synthetic_panorama_sequence(FRAMES, H, W, k, seed=3, depth_noise=0.008)
    kept = {}
    for run_ba in (False, True):
        t0 = time.perf_counter()
        fmap, res = run_slam(
            depths, k, map_capacity=8 * H * W,
            cfg=FusionConfig(localize_stride=1, icp_iterations=8),
            slam=SlamConfig(keyframe_every=5, loop_min_separation=3, loop_edge_weight=5.0,
                            run_ba=run_ba),
            frontend="scanned",
        )
        odo, ref = res.odometry_poses, res.refined_poses
        ate = [float(ate_rmse(p, gt)) for p in (odo, ref)]
        yaw = [max(rot_err_deg(p, g) for p, g in zip(poses, gt)) for poses in (odo, ref)]
        end = [rot_err_deg(poses[-1], gt[-1]) for poses in (odo, ref)]
        pts = np.asarray(fmap.points)[np.asarray(fmap.valid)]
        on_wall = float((np.abs(np.linalg.norm(pts[:, [0, 2]], axis=1) - 2.5) < 0.7).mean())
        print(json.dumps(dict(
            package="cilantro_tpu (JAX, CPU)", height=H, width=W, frames=FRAMES, run_ba=run_ba,
            keyframes=len(res.keyframe_indices), loop_closures=res.num_loop_closures,
            max_orientation_error_deg=yaw, endpoint_orientation_error_deg=end, ate_m=ate,
            ate_ratio=ate[1] / ate[0], ate_within_1_2=ate[1] <= 1.2 * ate[0],
            max_error_within_0_65=yaw[1] < 0.65 * yaw[0], map_points=len(pts), on_wall_share=on_wall,
            seconds=time.perf_counter() - t0)), flush=True)
        tag = "ba" if run_ba else "no_ba"
        kept[f"{tag}_odometry"] = np.stack(odo)
        kept[f"{tag}_refined"] = np.stack(ref)
    if args.out:
        np.savez(args.out, gt=np.stack(gt), **kept)


if __name__ == "__main__":
    main()
