"""The port's convex polytopes and space regions
(``cilantro_tpu_torch/spatial/convex.py``, ``spatial/space_region.py``)
against the JAX package, on the CPU. Both build hulls, vertex enumerations
and LPs on the host with scipy: those results are held equal (the same
numpy code); the queries run in PyTorch on the device and are held to
JAX's: signed distances 1e-6 (float32 products in another order),
containment exactly on points off the boundary by more than that."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu import spatial as js
from cilantro_tpu_torch import interop
from cilantro_tpu_torch import spatial as ts

CUBE = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
                np.float64)


def _queries(seed=0, n=2000, lo=-0.5, hi=2.0, d=3):
    pts = np.random.default_rng(seed).uniform(lo, hi, (n, d)).astype(np.float32)
    return pts


def _same_polytope(t, j):
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if isinstance(b, (list, tuple)):
            assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)), f.name
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _held_queries(t, j, pts, tolerance=0.0):
    got = t.signed_distances(torch.as_tensor(pts)).numpy()
    want = np.asarray(j.signed_distances(jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    off = np.abs(want - tolerance) > 1e-6
    np.testing.assert_array_equal(t.contains(torch.as_tensor(pts), tolerance).numpy()[off],
                                  np.asarray(j.contains(jnp.asarray(pts), tolerance))[off])


def _cases():
    rng = np.random.default_rng(1)
    blob = rng.standard_normal((40, 3))
    return {
        "cube": lambda m: m.ConvexPolytope.from_points(CUBE),
        "blob": lambda m: m.ConvexPolytope.from_points(blob),
        "square_2d": lambda m: m.ConvexPolytope.from_points(CUBE[[0, 1, 2, 4], :2]),
        "halfspaces": lambda m: m.ConvexPolytope.from_halfspaces(
            np.vstack([np.eye(3), -np.eye(3), [[1.0, 1.0, 1.0]]]), np.array([-1, -1, -1, 0, 0, 0, -2.0])),
        "orthant": lambda m: m.ConvexPolytope.from_halfspaces(-np.eye(3), np.zeros(3)),
        "degenerate": lambda m: m.ConvexPolytope.from_points(CUBE[:3]),
        "intersection": lambda m: m.ConvexPolytope.from_points(CUBE).intersection(
            m.ConvexPolytope.from_points(CUBE + 0.5)),
        "transformed": lambda m: m.ConvexPolytope.from_points(CUBE).transformed(
            np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]), np.array([0.2, 0.1, 0.0])),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_polytopes_match_jax(name):
    make = _cases()[name]
    j, t = make(js), make(ts)
    _same_polytope(t, j)
    assert t.area_volume() == j.area_volume()
    d = j.normals.shape[1] if j.normals.size else 3
    _held_queries(t, j, _queries(2, d=d))
    _held_queries(t, j, _queries(3, d=d), tolerance=0.05)


def test_feasible_point_and_flat_hull_match_jax():
    p = js.ConvexPolytope.from_points(CUBE)
    np.testing.assert_array_equal(ts.find_feasible_point(p.normals, p.offsets),
                                  js.find_feasible_point(p.normals, p.offsets))
    assert ts.find_feasible_point(np.array([[1.0, 0, 0], [-1.0, 0, 0]]), np.array([1.0, 1.0])) is None
    rng = np.random.default_rng(4)
    flat = np.column_stack([rng.uniform(0, 1, (50, 2)), 1e-9 * rng.standard_normal(50)])
    (jh, jw), (th, tw) = js.flat_convex_hull_3d(flat), ts.flat_convex_hull_3d(flat)
    _same_polytope(th, jh)
    np.testing.assert_array_equal(tw, jw)


def test_space_regions_match_jax():
    def regions(m):
        a = m.SpaceRegion([m.ConvexPolytope.from_points(CUBE)])
        b = m.SpaceRegion([m.ConvexPolytope.from_points(CUBE + np.array([0.5, 0.0, 0.0]))])
        far = m.SpaceRegion([m.ConvexPolytope.from_points(CUBE + np.array([5.0, 0.0, 0.0]))])
        return {"union": a.union(far), "intersection": a.intersection(b), "complement": a.complement(),
                "empty_complement": m.SpaceRegion([m.ConvexPolytope.from_points(CUBE[:2])]).complement()}

    jr, tr = regions(js), regions(ts)
    pts = _queries(5, lo=-1.0, hi=6.5)
    for name in jr:
        assert len(tr[name].polytopes) == len(jr[name].polytopes), name
        assert tr[name].is_empty() == jr[name].is_empty()
        for tp, jp in zip(tr[name].polytopes, jr[name].polytopes):
            _same_polytope(tp, jp)
        got = tr[name].contains(torch.as_tensor(pts)).numpy()
        want = np.asarray(jr[name].contains(jnp.asarray(pts)))
        near = np.zeros(len(pts), bool)
        for jp in jr[name].polytopes:
            if not jp.empty and len(jp.normals):
                near |= np.abs(np.asarray(jp.signed_distances(jnp.asarray(pts)))) <= 1e-6
        np.testing.assert_array_equal(got[~near], want[~near], err_msg=name)


def test_polytope_from_jax_fields_and_device_default(monkeypatch):
    j = js.ConvexPolytope.from_points(CUBE)
    t = interop.convex_polytope_from_numpy(**{f.name: getattr(j, f.name) for f in dataclasses.fields(j)})
    _same_polytope(t, j)
    assert t.vertices is not j.vertices
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = _queries(6, n=10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t.contains(pts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ts.SpaceRegion([t]).contains(pts)
    assert t.contains(pts, device="cpu").device.type == "cpu"
    assert t.contains(torch.as_tensor(pts)).device.type == "cpu"
