"""The port's non-rigid warp fields (``cilantro_tpu_torch/registration/
warp_field.py``) against the JAX package on the CPU.

The same numpy inputs (a seed, the JAX tests' surfaces and control grids)
go through both packages. Tolerances:

* the graph: every cache built from JAX's kNN results equals JAX's
  exactly. The port's own kNN results equal JAX's up to near-ties (a
  neighbour swapped for one whose float64 distance is within 1e-6: the two
  scans sum ‖q‖² + ‖k‖² − 2q·k in another order, 1 arc of 3,600 on the
  dense 600-point graph), and the weights of equal anchor rows agree
  within 2e-6, not 1e-6: those squared distances differ by up to 4.8e-7 on
  the 1,500-point surface and the RBF scales that by up to 0.5/σ²
  (measured 1.10e-6 on one weight of 6,000);
* warped points and resampled transforms within 1e-5;
* one GN step's node transforms within 1e-4 on the direct routes and 5e-4
  on CG. The CG iteration counts are equal with the block-Jacobi
  preconditioner (30 iterations). With the lumped diagonal on affine nodes
  (over 100 iterations) float32 rounding grows along the iteration
  (iterates within 1.4e-7 at iteration 10, 1.1e-5 at 80) and moves the
  iteration at which the residual crosses the relative tolerance:
  measured 131 against JAX's 132 (3-D) and 108 against 114 (4-D), so
  those counts are held within 10%, and those cases are also held at a
  fixed 10 iterations, where the iterates agree within 1e-5;
* whole registrations within 1e-4 m of JAX's warped points at the median
  and 1e-3 m at the max, with the same outer iteration count.

The affine 3-D GN cases use a volume of points, as
``tests/test_warp_field.py::test_direct_solver_matches_cg`` does: on a
surface the affine z-column is so weakly constrained that both packages
sit ~2e-3 from a float64 solve of the same system.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu.core.rgbd import CameraIntrinsics as JIntrinsics
from cilantro_tpu.core.rgbd import depth_to_points_normals as j_depth_to_points_normals
from cilantro_tpu.core.transforms import Transform as JTransform
from cilantro_tpu.registration import warp_field as jw
from cilantro_tpu_torch import interop
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics
from cilantro_tpu_torch.core.transforms import Transform
from cilantro_tpu_torch.registration import warp_field as tw
from test_warp_field import control_nodes, smooth_bend, surface

_CACHES = ("pair_order", "pair_seg_ids", "pair_uniq_keys", "ps_kkf", "ps_llf", "ps_w2",
           "ps_swap", "ps_seg", "arc_sorted_order", "arc_sorted_seg")


def _assert_graphs_equal(gt, gj, atol=0.0):
    """Every JAX field of the port's graph equals JAX's: integers and masks
    exactly, float fields within ``atol``."""
    for f in dataclasses.fields(gj):
        a, b = getattr(gj, f.name), getattr(gt, f.name)
        if a is None or isinstance(a, bool):
            assert b == a, f.name
            continue
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f.name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=f.name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f.name)


def _assert_knn_fields_match(gt, gj, src):
    """The port's kNN-derived fields against JAX's: equal up to near-ties,
    weights within 2e-6 where the anchor rows are equal; then the caches of
    JAX's kNN results built by the port equal JAX's exactly."""
    nodes = np.asarray(gj.node_positions, np.float64)
    for name, queries in (("anchors", src), ("arc_j", nodes)):
        a, b = np.asarray(getattr(gj, name)), getattr(gt, name).numpy()
        a, b = a.reshape(len(queries), -1), b.reshape(len(queries), -1)
        rows = np.nonzero((a != b).any(axis=1))[0]
        assert len(rows) <= max(1, len(a) // 500), (name, len(rows))
        for r in rows:
            q = np.asarray(queries[r], np.float64)
            da = np.sum((nodes[a[r]] - q) ** 2, axis=1)
            db = np.sum((nodes[b[r]] - q) ** 2, axis=1)
            np.testing.assert_allclose(np.sort(db), np.sort(da), rtol=0, atol=1e-6, err_msg=name)
    same = (np.asarray(gj.anchors) == gt.anchors.numpy()).all(axis=1)
    np.testing.assert_allclose(
        gt.anchor_weights.numpy()[same], np.asarray(gj.anchor_weights)[same], rtol=0, atol=2e-6
    )
    for name in ("node_positions", "node_valid", "arc_i", "arc_mask"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(gj, name)))
    bare = tw._bare_graph(*(torch.from_numpy(np.array(getattr(gj, name))) for name in (
        "node_positions", "node_valid", "anchors", "anchor_weights", "arc_i", "arc_j", "arc_mask")))
    _assert_graphs_equal(tw._with_sort_caches(bare), gj)


def _leaves(gj):
    return {
        f.name: getattr(gj, f.name) if f.name == "caches_sorted" or getattr(gj, f.name) is None
        else np.asarray(getattr(gj, f.name))
        for f in dataclasses.fields(gj)
    }


def _strip(g):
    return dataclasses.replace(g, **{name: None for name in _CACHES})


def _surface_case(seed=0, n=1200):
    rng = np.random.default_rng(seed)
    src = surface(rng, n)
    return rng, src, control_nodes(src)


@pytest.mark.parametrize("masked", [False, True])
def test_build_deformation_graph_matches_jax(masked):
    rng, src, nodes = _surface_case(n=1500)
    kw = dict(k_anchors=4, k_arcs=6)
    if masked:
        kw.update(src_valid=rng.random(len(src)) > 0.1, node_valid=rng.random(len(nodes)) > 0.2,
                  weight_sigma=0.3)
    gj = jw.build_deformation_graph(
        jnp.asarray(src), jnp.asarray(nodes), **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                               for k, v in kw.items()}
    )
    gt = tw.build_deformation_graph(src, nodes, device="cpu", **kw)
    _assert_knn_fields_match(gt, gj, src)
    assert gt.pair_uniq_count == int(np.sum(np.asarray(gj.pair_uniq_keys) < len(nodes) ** 2))


def test_build_dense_graph_matches_jax():
    _, src, _ = _surface_case(n=600)
    gj = jw.build_dense_graph(jnp.asarray(src), k_arcs=6)
    _assert_knn_fields_match(tw.build_dense_graph(src, k_arcs=6, device="cpu"), gj, src)


def _random_node_tf(rng, m, rigid=True):
    lin = np.eye(3, dtype=np.float32) + 0.05 * rng.standard_normal((m, 3, 3)).astype(np.float32)
    if rigid:
        u, _, vt = np.linalg.svd(lin.astype(np.float64))
        lin = (u @ vt).astype(np.float32)
    return lin, (0.02 * rng.standard_normal((m, 3))).astype(np.float32)


def test_warp_points_and_resample_match_jax():
    rng, src, nodes = _surface_case(n=1000)
    gj = jw.build_deformation_graph(jnp.asarray(src), jnp.asarray(nodes))
    gt = interop.deformation_graph_from_numpy(device="cpu", **_leaves(gj))
    lin, tr = _random_node_tf(rng, len(nodes))
    got = tw.warp_points(gt, Transform(torch.from_numpy(lin), torch.from_numpy(tr)), src, device="cpu")
    want = jw.warp_points(gj, JTransform(jnp.asarray(lin), jnp.asarray(tr)), jnp.asarray(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    idx = rng.integers(0, len(nodes), (50, 4)).astype(np.int32)
    w = rng.random((50, 4)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    for rigid in (True, False):
        a = tw.resample_transforms(Transform(torch.from_numpy(lin), torch.from_numpy(tr)), idx, w,
                                   rigid=rigid, device="cpu")
        b = jw.resample_transforms(JTransform(jnp.asarray(lin), jnp.asarray(tr)), jnp.asarray(idx),
                                   jnp.asarray(w), rigid=rigid)
        np.testing.assert_allclose(a.linear.numpy(), np.asarray(b.linear), rtol=0, atol=1e-5)
        np.testing.assert_allclose(a.translation.numpy(), np.asarray(b.translation), rtol=0, atol=1e-5)


def _gn_case(kind, metric):
    """``(graph pair, src, dst, normals, weights, solver, node_type, route)``
    of one GN-step case: rigid 3-D on a surface, affine 3-D in a volume,
    rigid 2-D on a square and affine 4-D in a hypercube."""
    rng = np.random.default_rng({"rigid3": 0, "affine3": 11, "rigid2": 2, "affine4": 4}[kind])
    if kind == "rigid3":
        src = surface(rng, 1200)
        dst = smooth_bend(src)
        nodes = control_nodes(src)
    else:
        d, n, m = {"affine3": (3, 600, 40), "rigid2": (2, 800, 30), "affine4": (4, 1500, 48)}[kind]
        src = rng.uniform(-0.5, 0.5, (n, d)).astype(np.float32)
        a_mat = np.eye(d, dtype=np.float32) + 0.03 * rng.standard_normal((d, d)).astype(np.float32)
        if kind == "rigid2":
            a_mat = np.float32([[np.cos(0.05), -np.sin(0.05)], [np.sin(0.05), np.cos(0.05)]])
        dst = (src @ a_mat.T + 0.02 * np.sin(3.0 * src[:, :1])).astype(np.float32)
        nodes = rng.uniform(-0.5, 0.5, (m, d)).astype(np.float32)
    nrm = None
    if metric == "plane":
        nrm = rng.standard_normal(src.shape).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    w = (rng.random(len(src)) > 0.1).astype(np.float32)
    gj = jw.build_deformation_graph(jnp.asarray(src), jnp.asarray(nodes), k_anchors=4, k_arcs=6)
    return gj, src, dst, nrm, w


# (case, node kind, solver, graph caches, the port's route: the assembly for
# the direct solver, the preconditioner for CG)
_GN_CASES = [
    ("sorted-direct", "rigid3", "direct", True, "sorted"),
    ("pair-direct", "affine3", "direct", True, "pair"),
    ("scatter-direct", "rigid3", "direct", False, "scatter"),
    ("cg-block-jacobi", "rigid3", "cg", True, "block-jacobi"),
    ("cg-lumped", "affine3", "cg", True, "lumped"),
]


@pytest.mark.parametrize("metric", ["point", "plane"])
@pytest.mark.parametrize("case", _GN_CASES, ids=[c[0] for c in _GN_CASES])
def test_gn_step_matches_jax(case, metric):
    _, kind, solver, caches, route = case
    _run_gn_step(kind, metric, solver, caches, route)


@pytest.mark.parametrize(
    "kind, solver, route",
    [("rigid2", "direct", "pair"), ("affine4", "direct", "pair"), ("affine4", "cg", "lumped")],
)
def test_gn_step_other_dimensions_match_jax(kind, solver, route):
    _run_gn_step(kind, "point", solver, True, route)


def _run_gn_step(kind, metric, solver, caches, route):
    gj, src, dst, nrm, w = _gn_case(kind, metric)
    gt = interop.deformation_graph_from_numpy(device="cpu", **_leaves(gj))
    if not caches:
        gj, gt = _strip(gj), _strip(gt)
    affine = kind.startswith("affine")
    d = src.shape[1]
    if solver == "direct":
        assert tw.direct_route(gt, len(src), d, affine) == route
    else:
        assert (not affine and d == 3) == (route == "block-jacobi")
    pw, plw = (1.0, 0.0) if metric == "point" else (0.0, 1.0)
    kw = dict(point_weight=pw, plane_weight=plw, stiffness=10.0, max_gn_iterations=1, solver=solver,
              node_type="affine" if affine else "rigid")
    tf_j, _, cg_j = jw.estimate_warp_field(
        gj, jnp.asarray(src), jnp.asarray(dst), None if nrm is None else jnp.asarray(nrm),
        jnp.asarray(w), **kw,
    )
    tf_t, _, cg_t = tw.estimate_warp_field(gt, src, dst, nrm, w, device="cpu", **kw)
    atol = 1e-4 if solver == "direct" else 5e-4
    _assert_tf_close(tf_t, tf_j, atol)
    if route == "lumped":
        assert abs(int(cg_t) - int(cg_j)) <= 0.1 * int(cg_j), (int(cg_t), int(cg_j))
    else:
        assert int(cg_t) == int(cg_j)
    assert (int(cg_t) == 0) == (solver == "direct")
    if route == "lumped":
        kw["max_cg_iterations"] = 10
        tf_j, _, cg_j = jw.estimate_warp_field(
            gj, jnp.asarray(src), jnp.asarray(dst), None if nrm is None else jnp.asarray(nrm),
            jnp.asarray(w), **kw,
        )
        tf_t, _, cg_t = tw.estimate_warp_field(gt, src, dst, nrm, w, device="cpu", **kw)
        assert int(cg_t) == int(cg_j)
        _assert_tf_close(tf_t, tf_j, 1e-5)


def _assert_tf_close(tf_t, tf_j, atol):
    np.testing.assert_allclose(tf_t.linear.numpy(), np.asarray(tf_j.linear), rtol=0, atol=atol)
    np.testing.assert_allclose(tf_t.translation.numpy(), np.asarray(tf_j.translation), rtol=0, atol=atol)


def _assert_warped_close(gt, tf_t, gj, tf_j, src):
    got = tw.warp_points(gt, tf_t, src, device="cpu").numpy()
    want = np.asarray(jw.warp_points(gj, tf_j, jnp.asarray(src)))
    diff = np.linalg.norm(got - want, axis=1)
    assert np.median(diff) < 1e-4 and diff.max() < 1e-3, (np.median(diff), diff.max())
    return got


@pytest.mark.parametrize("solver", ["auto", "cg"])
def test_icp_warp_field_matches_jax(solver):
    """``tests/test_warp_field.py::test_edg_recovers_smooth_deformation``
    through both packages (``auto`` takes the direct solver here)."""
    _, src, nodes = _surface_case(n=1500)
    dst = smooth_bend(src)
    gj = jw.build_deformation_graph(jnp.asarray(src), jnp.asarray(nodes), k_anchors=4, k_arcs=6)
    gt = tw.build_deformation_graph(src, nodes, k_anchors=4, k_arcs=6, device="cpu")
    kw = dict(max_corr_dist_sq=0.04, point_weight=1.0, plane_weight=0.0, stiffness=10.0,
              max_iterations=12, convergence_tol=1e-4, max_cg_iterations=60, solver=solver)
    tf_j, it_j, conv_j = jw.icp_warp_field(gj, jnp.asarray(src), jnp.asarray(dst), **kw)
    tf_t, it_t, conv_t = tw.icp_warp_field(gt, src, dst, device="cpu", **kw)
    assert int(it_t) == int(it_j) and bool(conv_t) == bool(conv_j)
    warped = _assert_warped_close(gt, tf_t, gj, tf_j, src)
    assert np.median(np.linalg.norm(warped - dst, axis=1)) < 0.01


def test_dense_icp_warp_field_matches_jax():
    """The dense field with CG: ``TestDenseWarpField`` through both."""
    _, src, _ = _surface_case(n=600)
    dst = src + np.float32([0.0, 0.0, 0.03])
    gj = jw.build_dense_graph(jnp.asarray(src), k_arcs=6)
    gt = tw.build_dense_graph(src, k_arcs=6, device="cpu")
    kw = dict(max_corr_dist_sq=0.04, point_weight=1.0, plane_weight=0.0, stiffness=5.0,
              max_iterations=10, max_cg_iterations=60, solver="cg")
    tf_j, it_j, _ = jw.icp_warp_field(gj, jnp.asarray(src), jnp.asarray(dst), **kw)
    tf_t, it_t, _ = tw.icp_warp_field(gt, src, dst, device="cpu", **kw)
    assert int(it_t) == int(it_j)
    warped = _assert_warped_close(gt, tf_t, gj, tf_j, src)
    assert np.median(np.linalg.norm(warped - dst, axis=1)) < 0.005


def test_icp_warp_field_projective_matches_jax():
    """``TestProjectiveWarpField`` through both packages."""
    from cilantro_tpu_torch.core.rgbd import depth_to_points_normals

    h, w = 48, 64
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = (1.2 + 0.04 * np.sin(0.25 * u) + 0.03 * np.cos(0.2 * v)).astype(np.float32)
    kj = JIntrinsics.make(80.0, 80.0, 31.5, 23.5)
    src_j, _, ok_j = j_depth_to_points_normals(jnp.asarray(depth), kj)
    src, _, ok = depth_to_points_normals(torch.from_numpy(depth), CameraIntrinsics.make(80.0, 80.0, 31.5, 23.5))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(src.numpy(), np.asarray(src_j))
    src, ok = src.numpy(), ok.numpy()
    dst = src.copy()
    dst[:, 2] += 0.03 * np.sin(2.5 * src[:, 0])
    nodes = control_nodes(src[ok], step=0.15)
    gj = jw.build_deformation_graph(jnp.asarray(src), jnp.asarray(nodes), k_anchors=4, k_arcs=6)
    gt = tw.build_deformation_graph(src, nodes, k_anchors=4, k_arcs=6, device="cpu")
    kw = dict(height=h, width=w, max_corr_dist_sq=0.01, point_weight=1.0, plane_weight=0.0,
              stiffness=5.0, max_iterations=12, convergence_tol=1e-4, max_cg_iterations=60)
    tf_j, it_j, _ = jw.icp_warp_field_projective(
        gj, src_j, jnp.asarray(dst), kj, src_valid=ok_j, dst_valid=ok_j, **kw
    )
    tf_t, it_t, _ = tw.icp_warp_field_projective(
        gt, src, dst, CameraIntrinsics.make(80.0, 80.0, 31.5, 23.5), src_valid=ok, dst_valid=ok,
        device="cpu", **kw,
    )
    assert int(it_t) == int(it_j)
    warped = _assert_warped_close(gt, tf_t, gj, tf_j, src)
    assert np.median(np.linalg.norm(warped[ok] - dst[ok], axis=1)) < 5e-3


def test_deformation_graph_from_numpy_round_trip():
    """A JAX graph's leaves give the graph the port builds from the same
    kNN results, lengths and pair count included, and the port solves on it
    as on its own."""
    rng, src, nodes = _surface_case(n=800)
    gj = jw.build_deformation_graph(jnp.asarray(src), jnp.asarray(nodes), k_anchors=4, k_arcs=6)
    from_jax = interop.deformation_graph_from_numpy(device="cpu", **_leaves(gj))
    own = tw._with_sort_caches(from_jax)
    _assert_graphs_equal(from_jax, gj)
    for f in dataclasses.fields(own):
        a, b = getattr(own, f.name), getattr(from_jax, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    dst = smooth_bend(src)
    w = np.ones(len(src), np.float32)
    kw = dict(point_weight=1.0, plane_weight=0.0, stiffness=10.0, max_gn_iterations=2, device="cpu")
    a, _, _ = tw.estimate_warp_field(from_jax, src, dst, None, w, **kw)
    b, _, _ = tw.estimate_warp_field(own, src, dst, None, w, **kw)
    assert torch.equal(a.linear, b.linear) and torch.equal(a.translation, b.translation)


@pytest.fixture
def one_thread():
    """torch's CPU ops on one thread for the test, the count restored
    after. On several threads the dense solve's bits follow the thread
    count MKL picks, which changes with the machine's load: the direct
    step below then moved by up to 1.1e-5 from run to run at 8 threads,
    while on one thread it is the same every run (2.2e-6 from the sorted
    graph's)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("solver", ["direct", "cg"])
def test_unsorted_caches_give_the_sorted_step(solver, one_thread):
    """A graph whose sort caches are identity permutations
    (``caches_sorted=False``, no pair caches: the sharded layout) scatters
    its sums and takes the scatter assembly; one GN step equals the sorted
    graph's within 1e-5."""
    _, src, nodes = _surface_case(n=800)
    dst = smooth_bend(src)
    g = tw.build_deformation_graph(src, nodes, k_anchors=4, k_arcs=6, device="cpu")
    flat = g.anchors.reshape(-1)
    ident = _strip(dataclasses.replace(
        g, anchor_order=torch.arange(flat.shape[0], dtype=torch.int32), anchor_sorted_ids=flat,
        arc_j_order=torch.arange(g.arc_j.shape[0], dtype=torch.int32), arc_j_sorted=g.arc_j,
        caches_sorted=False,
    ))
    ident = tw._with_segment_lengths(ident)
    assert ident.anchor_lengths is None and tw.direct_route(ident, len(src), 3, False) == "scatter"
    w = np.ones(len(src), np.float32)
    kw = dict(point_weight=1.0, plane_weight=0.0, stiffness=10.0, max_gn_iterations=1, solver=solver,
              device="cpu")
    a, _, cg_a = tw.estimate_warp_field(ident, src, dst, None, w, **kw)
    b, _, cg_b = tw.estimate_warp_field(g, src, dst, None, w, **kw)
    assert int(cg_a) == int(cg_b)
    np.testing.assert_allclose(a.linear.numpy(), b.linear.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(a.translation.numpy(), b.translation.numpy(), rtol=0, atol=1e-5)


def test_port_keeps_jax_signatures():
    """Every name JAX's registration package exports from the two warp
    modules exists in the port's with the same parameters, kinds and
    defaults, plus ``device`` (default the card) on the functions, and
    after it the ``psum`` hook of a point-sharded solve on
    ``estimate_warp_field`` and ``icp_warp_field`` (default None)."""
    import inspect

    import cilantro_tpu.registration as jreg
    from cilantro_tpu.registration import warp_field_batched as jwb

    import cilantro_tpu_torch.registration as treg

    names = [n for n in dir(jreg) if getattr(getattr(jreg, n), "__module__", "") in (jw.__name__, jwb.__name__)]
    assert len(names) == 13, names
    for name in names:
        j, t = getattr(jreg, name), getattr(treg, name)
        if inspect.isclass(j):
            assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)][
                : len(dataclasses.fields(j))], name
            continue
        jp = list(inspect.signature(j).parameters.values())
        tp = list(inspect.signature(t).parameters.values())
        if name in ("estimate_warp_field", "icp_warp_field"):
            assert (tp[-1].name, tp[-1].kind, tp[-1].default) == ("psum", inspect.Parameter.KEYWORD_ONLY, None)
            tp = tp[:-1]
        assert [(p.name, p.kind, p.default) for p in jp] == [(p.name, p.kind, p.default) for p in tp[:-1]], name
        assert tp[-1].name == "device" and tp[-1].default == "cuda", name


def test_chunked_cg_equals_a_per_iteration_loop(monkeypatch):
    """The CG's device flag freezes the iterates once the loop condition
    fails, so chunks of 16 give the bits and count of a loop that tests
    the condition before every iteration (a chunk of 1)."""
    _, src, nodes = _surface_case(n=800)
    dst = smooth_bend(src)
    g = tw.build_deformation_graph(src, nodes, k_anchors=4, k_arcs=6, device="cpu")
    w = np.ones(len(src), np.float32)
    kw = dict(point_weight=1.0, plane_weight=0.0, stiffness=10.0, max_gn_iterations=1, solver="cg",
              max_cg_iterations=45, device="cpu")
    out = []
    for chunk in (16, 1):
        monkeypatch.setattr(tw, "_CG_CHUNK", chunk)
        out.append(tw.estimate_warp_field(g, src, dst, None, w, **kw))
    (a, _, ka), (b, _, kb) = out
    assert int(ka) == int(kb) and 0 < int(ka) < 45
    assert torch.equal(a.linear, b.linear) and torch.equal(a.translation, b.translation)
