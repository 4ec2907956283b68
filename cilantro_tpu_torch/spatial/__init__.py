"""Convex polytopes and space regions (port of ``cilantro_tpu.spatial``)."""

from .convex import (  # noqa: F401
    ConvexPolytope,
    find_feasible_point,
    flat_convex_hull_3d,
)
from .space_region import SpaceRegion  # noqa: F401
