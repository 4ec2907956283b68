"""I/O + RGBD conversions (port of ``examples/io_and_images.py``; reference
``examples/matrix_io.cpp`` + ``ply_io.cpp`` +
``image_point_cloud_conversions.cpp``): matrix round-trips (binary +
text), PLY round-trip through the native C++ codec, depth↔cloud
conversions and the z-buffered index map.

Usage: python -m cilantro_tpu_torch.examples.io_and_images [--out DIR] [--device cpu]
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .. import resolve_device
from ..core.rgbd import CameraIntrinsics, depth_to_points_normals, points_to_depth_image, points_to_index_map
from ..native import ply_read_native, ply_write_native
from ..utils.io import read_matrix, write_matrix
from ._common import parser


def main(argv=None) -> int:
    args = parser(__doc__, out=True).parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    tmp = args.out or tempfile.mkdtemp()
    os.makedirs(tmp, exist_ok=True)

    # --- matrix I/O ---------------------------------------------------------
    m = rng.standard_normal((17, 5)).astype(np.float32)
    for binary in (True, False):
        p = os.path.join(tmp, f"m_{binary}.dat")
        write_matrix(p, m, binary=binary)
        back = read_matrix(p, binary=binary)
        err = np.abs(back - m).max()
        print(f"matrix I/O ({'binary' if binary else 'text'}): max |Δ| {err:.1e}")

    # --- PLY through the native codec ---------------------------------------
    pts = rng.standard_normal((1000, 3)).astype(np.float32)
    nrm = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    col = rng.uniform(0, 1, (1000, 3)).astype(np.float32)
    ply = os.path.join(tmp, "c.ply")
    ok = ply_write_native(ply, pts, nrm, col)
    r_pts, r_nrm, r_col = ply_read_native(ply)
    print(
        f"native PLY roundtrip: write ok={ok}, points exact="
        f"{np.array_equal(r_pts, pts)}, colors within 1/255="
        f"{np.abs(r_col - col).max() < 1/255 + 1e-6}"
    )

    # --- RGBD conversions ---------------------------------------------------
    K = CameraIntrinsics.make(200.0, 200.0, 79.5, 59.5)
    H, W = 120, 160
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = (1.0 + 0.1 * np.sin(0.1 * u) * np.cos(0.08 * v)).astype(np.float32)
    cloud, normals, valid = depth_to_points_normals(torch.as_tensor(depth, device=dev), K)
    print(
        f"depth→cloud: {int(valid.sum())}/{H*W} valid points, "
        f"mean |n|={float(torch.linalg.vector_norm(normals, dim=1).mean()):.3f}"
    )

    re_depth = points_to_depth_image(cloud, K, H, W, valid=valid)
    err = np.abs(re_depth.cpu().numpy() - depth)[2:-2, 2:-2]
    print(f"cloud→depth roundtrip: max |Δdepth| {err.max():.2e} m")

    imap = points_to_index_map(cloud, K, H, W, valid=valid).cpu().numpy()
    hits = int((imap >= 0).sum())
    # For an organized cloud the index map is (nearly) the identity.
    ident = imap.reshape(-1) == np.arange(H * W)
    print(
        f"index map: {hits}/{H*W} pixels hit; identity at "
        f"{int(ident.sum())}/{H*W} pixels"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
