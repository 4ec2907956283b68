"""Convex polytopes: V-rep and H-rep, topology, set operations (port of
``cilantro_tpu/spatial/convex.py``).

Hulls, vertex enumeration, redundancy and feasibility LPs stay on the host
(scipy's qhull and ``linprog``, as in the JAX package: hulls are small and
latency-bound); the queries applied to large point sets, signed distances
and containment, run in PyTorch on the device. Degenerate inputs (rank <
D) give empty polytopes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import on_device


@dataclasses.dataclass(frozen=True)
class ConvexPolytope:
    """Dual-representation convex polytope.

    ``vertices (V, D)`` and halfspaces ``A x + b ≤ 0`` as ``normals (F, D)``,
    ``offsets (F,)``; ``faces`` = vertex-index tuples per facet (3D),
    ``empty`` flags an infeasible/degenerate polytope, ``bounded`` mirrors
    the reference's ``isBounded()`` (``convex_polytope.hpp:95``: halfspace
    intersections may be unbounded — finite vertices are still enumerated,
    area/volume are infinite). Topology (``face_neighbors`` = facet-adjacent
    facet indices, ``vertex_faces`` = facet indices incident to each vertex)
    maps ``convex_polytope.hpp:143-153`` and is populated for bounded
    full-dimensional polytopes on both construction paths.
    """

    vertices: np.ndarray
    normals: np.ndarray
    offsets: np.ndarray
    faces: Optional[Sequence[np.ndarray]] = None
    empty: bool = False
    bounded: bool = True
    interior_point: Optional[np.ndarray] = None
    face_neighbors: Optional[np.ndarray] = None
    vertex_faces: Optional[Sequence[np.ndarray]] = None

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_points(points: np.ndarray) -> "ConvexPolytope":
        """Hull of a point set (reference ``convexHullFromPoints``,
        ``convex_hull_utilities.hpp:630-636``)."""
        from scipy.spatial import ConvexHull, QhullError

        points = np.asarray(points, np.float64)
        d = points.shape[1]
        if len(points) <= d or np.linalg.matrix_rank(points - points.mean(0)) < d:
            return ConvexPolytope(
                vertices=np.zeros((0, d)),
                normals=np.zeros((0, d)),
                offsets=np.zeros((0,)),
                empty=True,
            )
        try:
            hull = ConvexHull(points)
        except QhullError:
            return ConvexPolytope(
                vertices=np.zeros((0, d)),
                normals=np.zeros((0, d)),
                offsets=np.zeros((0,)),
                empty=True,
            )
        verts = points[hull.vertices]
        # qhull equations: normals·x + offset ≤ 0 for interior.
        eq = hull.equations
        faces = None
        vertex_faces = None
        if d >= 2:
            # Remap simplex indices to hull-vertex indices.
            remap = {v: i for i, v in enumerate(hull.vertices)}
            faces = [
                np.array([remap[v] for v in simplex], np.int64)
                for simplex in hull.simplices
            ]
            incidence: list = [[] for _ in range(len(verts))]
            for fi, face in enumerate(faces):
                for v in face:
                    incidence[v].append(fi)
            vertex_faces = [np.array(sorted(ix), np.int64) for ix in incidence]
        return ConvexPolytope(
            vertices=verts,
            normals=eq[:, :d].copy(),
            offsets=eq[:, d].copy(),
            faces=faces,
            interior_point=verts.mean(0),
            face_neighbors=hull.neighbors.copy(),
            vertex_faces=vertex_faces,
        )

    @staticmethod
    def from_halfspaces(
        normals: np.ndarray,
        offsets: np.ndarray,
        interior_point: Optional[np.ndarray] = None,
    ) -> "ConvexPolytope":
        """Vertex enumeration of ``A x + b ≤ 0`` by the dual transform
        (reference ``evaluateHalfspaceIntersection``,
        ``convex_hull_utilities.hpp:195-314``): normalize, shift to a strict
        interior point, hull the dual points ``aᵢ/(−bᵢ)``; each dual facet
        with negative offset is a primal vertex, a nonnegative dual offset
        marks the region unbounded (finite vertices still returned, matching
        the reference's ``is_bounded=false`` path)."""
        from scipy.spatial import ConvexHull, QhullError

        normals = np.asarray(normals, np.float64)
        offsets = np.asarray(offsets, np.float64)
        d = normals.shape[1]
        scale = np.linalg.norm(normals, axis=1)
        keep = scale > 0
        a = normals[keep] / scale[keep, None]
        b = offsets[keep] / scale[keep]
        if interior_point is None:
            interior_point = find_feasible_point(a, b)
        if interior_point is None:
            return ConvexPolytope(
                vertices=np.zeros((0, d)),
                normals=normals,
                offsets=offsets,
                empty=True,
            )
        c = np.asarray(interior_point, np.float64)
        if len(a) == 0:
            # No constraints: all of space (complement of the empty region).
            return ConvexPolytope(
                vertices=np.zeros((0, d)),
                normals=np.zeros((0, d)),
                offsets=np.zeros((0,)),
                bounded=False,
                interior_point=c,
            )

        def unbounded_no_vertices() -> "ConvexPolytope":
            a2, b2 = _drop_redundant_halfspaces(a, b)
            return ConvexPolytope(
                vertices=np.zeros((0, d)),
                normals=a2,
                offsets=b2,
                bounded=False,
                interior_point=c,
            )

        if len(a) <= d or np.linalg.matrix_rank(a) < d:
            # Cone/slab-like region with no vertices (reference rank guard,
            # ``convex_hull_utilities.hpp:232-255``).
            return unbounded_no_vertices()
        b_shift = np.minimum(a @ c + b, -1e-12)  # strictly < 0 at interior
        dual = a / (-b_shift[:, None])
        try:
            dual_hull = ConvexHull(dual)
        except QhullError:
            return unbounded_no_vertices()
        eq = dual_hull.equations  # n·y + off ≤ 0 for the dual interior
        finite = eq[:, d] < -1e-12
        bounded = bool(finite.all())
        verts = _dedup_rows(eq[finite, :d] / (-eq[finite, d][:, None]) + c)
        if bounded and len(verts) > d:
            # Re-hull for clean topology + minimal H-rep (the reference's
            # facet extraction from the dual vertices).
            poly = ConvexPolytope.from_points(verts)
            if not poly.empty:
                return dataclasses.replace(poly, interior_point=c)
        a2, b2 = _drop_redundant_halfspaces(a, b)
        return ConvexPolytope(
            vertices=verts,
            normals=a2,
            offsets=b2,
            bounded=bounded,
            interior_point=c,
        )

    # -- queries (on the device) -------------------------------------------

    def signed_distances(self, points, device=None) -> torch.Tensor:
        """Max halfspace violation per point (≤ 0 inside), the H-rep
        containment test, on the points' device (numpy: ``device``, the
        card by default)."""
        pts = on_device(points, device, torch.float32)
        if self.empty:
            return torch.full((pts.shape[0],), torch.inf, device=pts.device)
        if len(self.normals) == 0:
            # No constraints = all of space: every point is strictly inside.
            return torch.full((pts.shape[0],), -torch.inf, device=pts.device)
        a = torch.as_tensor(np.asarray(self.normals, np.float32), device=pts.device)
        b = torch.as_tensor(np.asarray(self.offsets, np.float32), device=pts.device)
        return torch.amax(pts @ a.T + b, dim=-1)

    def contains(self, points, tolerance: float = 0.0, device=None) -> torch.Tensor:
        pts = on_device(points, device, torch.float32)
        if self.empty:
            return torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
        return self.signed_distances(pts) <= tolerance

    # -- geometry ----------------------------------------------------------

    def area_volume(self) -> Tuple[float, float]:
        """Surface area + volume (reference ``convex_hull_utilities.hpp:494+``;
        unbounded polytopes report infinity, ``convex_polytope.hpp:264-265``)."""
        from scipy.spatial import ConvexHull

        if self.empty:
            return 0.0, 0.0
        if not self.bounded:
            return float("inf"), float("inf")
        if len(self.vertices) == 0:
            return 0.0, 0.0
        hull = ConvexHull(self.vertices)
        return float(hull.area), float(hull.volume)

    def intersection(self, other: "ConvexPolytope") -> "ConvexPolytope":
        """H-rep concatenation + re-enumeration (``convex_polytope.hpp:71-89``)."""
        if self.empty or other.empty:
            return dataclasses.replace(self, empty=True)
        return ConvexPolytope.from_halfspaces(
            np.vstack([self.normals, other.normals]),
            np.concatenate([self.offsets, other.offsets]),
        )

    def transformed(self, linear: np.ndarray, translation: np.ndarray) -> "ConvexPolytope":
        """Transform both representations (``convex_polytope.hpp:155-205``);
        halfspaces map by the inverse-transpose rule."""
        if self.empty:
            return self
        linear = np.asarray(linear, np.float64)
        translation = np.asarray(translation, np.float64)
        verts = self.vertices @ linear.T + translation
        inv_t = np.linalg.inv(linear).T
        nrm = self.normals @ inv_t.T
        # n'·(A x + t) + b' = n·x + b  ⇒  n' = A^{-T} n, b' = b − n'·t.
        off = self.offsets - nrm @ translation
        scale = np.linalg.norm(nrm, axis=1)
        scale = np.where(scale > 0, scale, 1.0)
        ip = self.interior_point
        if ip is not None:
            ip = ip @ linear.T + translation
        return dataclasses.replace(
            self,
            vertices=verts,
            normals=nrm / scale[:, None],
            offsets=off / scale,
            interior_point=ip,
        )


def _dedup_rows(rows: np.ndarray, decimals: int = 9) -> np.ndarray:
    """Drop near-duplicate rows (dual-hull facets of one primal vertex repeat
    when qhull triangulates)."""
    if len(rows) == 0:
        return rows
    _, ix = np.unique(np.round(rows, decimals), axis=0, return_index=True)
    return rows[np.sort(ix)]


def _drop_redundant_halfspaces(
    a: np.ndarray, b: np.ndarray, tol: float = 1e-9
) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal H-rep of ``A x + b ≤ 0``: halfspace *i* is redundant when
    ``max aᵢ·x + bᵢ`` over the others' feasible set is ≤ 0 (the reference's
    per-halfspace LP, ``checkLinearInequalityConstraintRedundancy``,
    ``convex_hull_utilities.hpp:12-73``). Exact duplicates drop first."""
    from scipy.optimize import linprog

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    _, ix = np.unique(
        np.round(np.column_stack([a, b]), 9), axis=0, return_index=True
    )
    a, b = a[np.sort(ix)], b[np.sort(ix)]
    if len(a) <= 1:
        return a, b
    keep = np.ones(len(a), bool)
    bounds = [(-1e6, 1e6)] * a.shape[1]
    for i in range(len(a)):
        others = keep.copy()
        others[i] = False
        if not others.any():
            continue
        res = linprog(
            -a[i],
            A_ub=a[others],
            b_ub=-b[others],
            bounds=bounds,
            method="highs",
        )
        if res.success and -res.fun + b[i] <= tol:
            keep[i] = False
    return a[keep], b[keep]


def find_feasible_point(
    normals: np.ndarray, offsets: np.ndarray
) -> Optional[np.ndarray]:
    """Chebyshev center of ``A x + b ≤ 0`` via LP (replaces the eiquadprog QP
    path, ``convex_hull_utilities.hpp:74-193``). Returns None if infeasible
    or degenerate (zero-radius)."""
    from scipy.optimize import linprog

    a = np.asarray(normals, np.float64)
    b = np.asarray(offsets, np.float64)
    f, d = a.shape
    row_norm = np.linalg.norm(a, axis=1)
    # max r s.t. a·x + b + ‖a‖ r ≤ 0  →  minimize −r.
    a_ub = np.column_stack([a, row_norm])
    b_ub = -b
    c = np.zeros(d + 1)
    c[-1] = -1.0
    # Bound the box and radius so unbounded regions (e.g. single halfspaces
    # from a complement expansion) still yield a finite interior point.
    bounds = [(-1e6, 1e6)] * d + [(0, 1e3)]
    res = linprog(c, A_ub=a_ub, b_ub=b_ub, bounds=bounds, method="highs")
    if not res.success or res.x[-1] <= 1e-12:
        return None
    return res.x[:d]


def flat_convex_hull_3d(points: np.ndarray) -> Tuple[ConvexPolytope, np.ndarray]:
    """2D hull of near-planar 3D points via PCA projection (reference
    ``FlatConvexHull3``, ``spatial/flat_convex_hull_3d.hpp:8-66``).

    Returns the 2D polytope (in plane coordinates) and the 3×4 plane-to-world
    transform ``[basis | mean]``."""
    pts = np.asarray(points, np.float64)
    mean = pts.mean(0)
    centered = pts - mean
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    basis = vt[:2]  # (2, 3) plane basis
    proj = centered @ basis.T
    hull2 = ConvexPolytope.from_points(proj)
    plane_to_world = np.column_stack([basis.T, mean])  # (3, 3): 2 basis + origin
    return hull2, plane_to_world
