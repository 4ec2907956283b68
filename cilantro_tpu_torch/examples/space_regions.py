"""Space-region set algebra (port of ``examples/space_regions.py``;
reference ``examples/space_region_2d.cpp`` / ``space_region_3d.cpp``):
unions of polytopes, intersection, complement, containment (on the
device).

Usage: python -m cilantro_tpu_torch.examples.space_regions [--device cpu]
"""

from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..spatial import ConvexPolytope, SpaceRegion
from ._common import parser


def box(center, half, d=3):
    lo = np.asarray(center) - half
    hi = np.asarray(center) + half
    corners = np.array(
        np.meshgrid(*[[lo[i], hi[i]] for i in range(d)])
    ).reshape(d, -1).T
    return ConvexPolytope.from_points(corners)


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(1)

    def contains(region, points):
        return region.contains(np.asarray(points), device=dev).cpu().numpy()

    # --- 2D -----------------------------------------------------------------
    a2 = box([0, 0], 1.0, d=2)
    b2 = box([1.2, 0], 1.0, d=2)
    r = SpaceRegion([a2]).union(SpaceRegion([b2]))
    probes = np.array([[0.0, 0.0], [1.2, 0.0], [3.0, 0.0]])
    print("2D union contains:", [bool(v) for v in contains(r, probes)])

    inter = SpaceRegion([a2]).intersection(SpaceRegion([b2]))
    print(
        "2D intersection (overlap strip) contains (0.6, 0):",
        bool(contains(inter, [[0.6, 0.0]])[0]),
        "| (-0.5, 0):",
        bool(contains(inter, [[-0.5, 0.0]])[0]),
    )

    comp = SpaceRegion([a2]).complement()
    print(
        "2D complement contains (3, 3):",
        bool(contains(comp, [[3.0, 3.0]])[0]),
        "| origin:",
        bool(contains(comp, [[0.0, 0.0]])[0]),
    )

    # --- 3D -----------------------------------------------------------------
    a3 = box([0, 0, 0], 1.0)
    b3 = box([0.8, 0.8, 0.8], 1.0)
    r3 = SpaceRegion([a3]).intersection(SpaceRegion([b3]))
    probes3 = np.array([[0.9, 0.9, 0.9], [-0.9, -0.9, -0.9]])
    print("3D intersection contains:", [bool(v) for v in contains(r3, probes3)])

    u3 = SpaceRegion([a3]).union(SpaceRegion([b3]))
    mc = rng.uniform(-1.0, 1.8, (20000, 3))
    frac = np.mean(contains(u3, mc))
    vol_est = frac * (2.8 ** 3)
    print(f"3D union Monte-Carlo volume ≈ {vol_est:.2f} (2 cubes minus overlap)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
