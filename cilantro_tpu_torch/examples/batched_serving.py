"""Batched serving demos (port of ``examples/batched_serving.py``): what
one card serves at once beyond the reference, which serves one stream or
solve a process. Two demos:

1. splat fusion: dense bounded-window frame-to-model fusion (the headline
   fusion pipeline: no scatter, no pool gathers) on a synthetic sequence,
   one step captured in a CUDA graph and replayed a frame;
2. batched non-rigid warp: B deformed observations of one template
   registered together (shared-index gathers and one batched Cholesky;
   ``registration/warp_field_batched.py``).

Usage: python -m cilantro_tpu_torch.examples.batched_serving [n_frames] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import resolve_device
from ..core.containers import PointCloud
from ..core.grid import grid_downsample
from ..registration import build_deformation_graph, icp_warp_field_batched, warp_points_batched
from ..slam import SplatConfig, ate_rmse, extract_cloud, run_splat_sequence_scanned, synthetic_sequence
from ._common import parser, scaled_intrinsics


def splat_demo(frames: int, dev, size=(480, 640)):
    h, w = size
    k = scaled_intrinsics(h, w)
    print(f"rendering {frames}-frame synthetic {w}x{h} sequence...")
    depths, gt = synthetic_sequence(frames, h, w, k, seed=0)
    t0 = time.perf_counter()
    smap, poses, spf, _ = run_splat_sequence_scanned(
        depths, k, cfg=SplatConfig(radius=4, margin=16), device=dev
    )
    ate = ate_rmse(poses, gt, device=dev)
    pts, nrm, conf = extract_cloud(smap)
    print(
        f"splat fusion: {spf*1e3:.1f} ms/frame ({1/spf:.1f} fps), "
        f"ATE {ate*1e3:.3f} mm, {len(pts)} live surfels "
        f"(total {time.perf_counter()-t0:.0f}s incl. capture)"
    )


def batched_warp_demo(dev, streams: int = 4, n: int = 30000):
    rng = np.random.default_rng(0)
    src = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    src[:, 2] = 0.2 * np.sin(3 * src[:, 0]) * np.cos(2 * src[:, 1])
    dsts = []
    for b in range(streams):
        d = src.copy()
        d[:, 2] += 0.02 * np.sin((6 + b) * src[:, 0])
        dsts.append(d)
    src_t = torch.as_tensor(src, device=dev)
    ctrl = grid_downsample(PointCloud(points=src_t), 0.08, capacity=512)
    graph = build_deformation_graph(
        src_t, ctrl.points, node_valid=ctrl.valid, k_anchors=4, k_arcs=8, device=dev
    )
    t0 = time.perf_counter()
    tfb, iters, conv = icp_warp_field_batched(
        graph, src_t, torch.as_tensor(np.stack(dsts), device=dev),
        max_corr_dist_sq=0.0025, point_weight=1.0, plane_weight=0.0,
        stiffness=50.0, max_iterations=8, device=dev,
    )
    wb = warp_points_batched(graph, tfb, src_t, device=dev).cpu().numpy()
    errs = [
        np.median(np.linalg.norm(wb[:, b] - dsts[b], axis=1))
        for b in range(streams)
    ]
    print(
        f"batched warp x{streams}: {int(iters)} outer iters, converged "
        f"{conv.cpu().numpy().tolist()}, median errors "
        f"{[f'{e*1e3:.2f}mm' for e in errs]} "
        f"({time.perf_counter()-t0:.0f}s)"
    )


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("frames", nargs="?", type=int, default=8)
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640), metavar=("H", "W"),
                    help="the splat demo's frame size")
    ap.add_argument("--warp-points", type=int, default=30000, help="the warp demo's template size")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    splat_demo(args.frames, dev, tuple(args.size))
    batched_warp_demo(dev, n=args.warp_points)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
