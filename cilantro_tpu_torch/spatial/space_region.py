"""Space regions: unions of convex polytopes with set algebra (port of
``cilantro_tpu/spatial/space_region.py``). Union concatenates, intersection
intersects pairwise, the complement expands De Morgan's law over facet
tuples (on the host); containment is any polytope's, on the device.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Sequence

import numpy as np
import torch

from .. import on_device
from .convex import ConvexPolytope, find_feasible_point


@dataclasses.dataclass(frozen=True)
class SpaceRegion:
    """A (possibly non-convex) region represented as a union of polytopes."""

    polytopes: Sequence[ConvexPolytope]

    def is_empty(self) -> bool:
        return all(p.empty for p in self.polytopes)

    def union(self, other: "SpaceRegion") -> "SpaceRegion":
        return SpaceRegion(list(self.polytopes) + list(other.polytopes))

    def intersection(self, other: "SpaceRegion") -> "SpaceRegion":
        out: List[ConvexPolytope] = []
        for a in self.polytopes:
            for b in other.polytopes:
                c = a.intersection(b)
                if not c.empty:
                    out.append(c)
        return SpaceRegion(out)

    def complement(self) -> "SpaceRegion":
        """De Morgan: ¬(∪_i P_i) = ∩_i ¬P_i, with ¬P = ∪_f {flipped facet f};
        the intersection distributes into one polytope per facet tuple. Each
        surviving tuple is *fully evaluated* through the halfspace-
        intersection machinery (as the reference, ``space_region.hpp:84-89``:
        finite vertices enumerated, minimal H-rep, ``bounded`` flag), so
        complement outputs support ``area_volume``/``transformed``/
        re-complement like any other polytope."""
        live = [p for p in self.polytopes if not p.empty and len(p.normals)]
        if not live:
            # Complement of the empty region is all of space (one polytope
            # with no constraints).
            d = (
                self.polytopes[0].normals.shape[1]
                if self.polytopes
                else 3
            )
            return SpaceRegion(
                [
                    ConvexPolytope(
                        vertices=np.zeros((0, d)),
                        normals=np.zeros((0, d)),
                        offsets=np.zeros((0,)),
                        bounded=False,
                    )
                ]
            )
        out: List[ConvexPolytope] = []
        facet_lists = [range(len(p.normals)) for p in live]
        for combo in itertools.product(*facet_lists):
            normals = np.stack(
                [-live[i].normals[f] for i, f in enumerate(combo)]
            )
            offsets = np.array(
                [-live[i].offsets[f] for i, f in enumerate(combo)]
            )
            feasible = find_feasible_point(normals, offsets)
            if feasible is None:
                continue
            poly = ConvexPolytope.from_halfspaces(
                normals, offsets, interior_point=feasible
            )
            if not poly.empty:
                out.append(poly)
        return SpaceRegion(out)

    def contains(self, points, tolerance: float = 0.0, device=None) -> torch.Tensor:
        """Membership of any polytope, on the points' device (numpy:
        ``device``, the card by default)."""
        pts = on_device(points, device, torch.float32)
        inside = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
        for p in self.polytopes:
            if not p.empty:
                inside = inside | p.contains(pts, tolerance)
        return inside
