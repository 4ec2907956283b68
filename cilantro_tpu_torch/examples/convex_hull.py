"""Convex hulls (port of ``examples/convex_hull.py``; reference
``examples/convex_hull.cpp`` + ``flat_convex_hull.cpp``): V↔H duality,
topology, area/volume, intersection, and the PCA-projected flat hull of
near-planar points. The hulls are built on the host; containment runs on
the device.

Usage: python -m cilantro_tpu_torch.examples.convex_hull [--device cpu]
"""

from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..spatial import ConvexPolytope, flat_convex_hull_3d
from ._common import parser


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # Hull of a noisy unit cube's corners + interior fill.
    cube = rng.uniform(-1, 1, (2000, 3))
    hull = ConvexPolytope.from_points(cube)
    area, volume = hull.area_volume()
    print(
        f"cube hull: {len(hull.vertices)} vertices, {len(hull.normals)} facets, "
        f"area {area:.2f} (→ 24), volume {volume:.2f} (→ 8)"
    )

    # H-rep → V-rep roundtrip: intersect with a halfspace cutting the corner.
    n_new = np.vstack([hull.normals, [[1, 1, 1]]])
    b_new = np.concatenate([hull.offsets, [-1.5 * np.sqrt(3)]])
    cut = ConvexPolytope.from_halfspaces(n_new / 1.0, b_new)
    _, cut_vol = cut.area_volume()
    print(f"corner-cut hull: volume {cut_vol:.3f} (< 8, one corner removed)")

    # Intersection of two offset cubes.
    shifted = hull.transformed(np.eye(3), np.array([1.0, 0.0, 0.0]))
    inter = hull.intersection(shifted)
    _, iv = inter.area_volume()
    print(f"cube ∩ shifted cube: volume {iv:.2f} (→ 4)")

    # Containment / signed distances.
    probe = np.array([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0]])
    inside = inter.contains(probe, device=dev).cpu().numpy()
    print(f"containment: origin {bool(inside[0])}, (3,0,0) {bool(inside[1])}")

    # Flat hull of near-planar 3D points (reference FlatConvexHull3).
    plane_pts = np.column_stack(
        [
            rng.uniform(-1, 1, 500),
            rng.uniform(-0.5, 0.5, 500),
            rng.normal(0, 1e-4, 500),
        ]
    )
    flat, tf = flat_convex_hull_3d(plane_pts)
    print(
        f"flat hull of near-planar cloud: {len(flat.vertices)} 2D vertices, "
        f"plane basis stored as a (3,4) transform"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
