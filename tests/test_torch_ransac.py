"""The port's batched RANSAC (``cilantro_tpu_torch/model_estimation/ransac.py``)
and the hypothesis axis of its point-to-point estimators
(``registration/transform_estimation.py``) against the JAX package, on the
CPU, on JAX's own draws: the ``(H, N)`` uniforms of
``jax.random.uniform(key, (H, N))`` go into ``_ransac_*_from_scores``.

Tolerances: per-hypothesis inlier counts equal (float order can move a
point across the gate; these inputs keep every point off it), except for
affine hypotheses whose minimal set is near-degenerate (cond(XᵀX) > 1e3),
where a float32 solve in another order is another fit; the same winner;
winning models within 1e-5 (planes up to the normal's sign, with the
offset) and the final inlier masks equal."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu.registration import transform_estimation as jte
from cilantro_tpu_torch import interop
from cilantro_tpu_torch.model_estimation import ransac as tr
from cilantro_tpu_torch.registration import transform_estimation as tte

jr = importlib.import_module("cilantro_tpu.model_estimation.ransac")
H = 64


def _scores(seed, n, h=H):
    key = jax.random.PRNGKey(seed)
    return key, np.array(jax.random.uniform(key, (h, n)))


def _plane_cloud(seed=0, n=1500, outliers=500):
    rng = np.random.default_rng(seed)
    pts = np.zeros((n, 3), np.float32)
    pts[:, :2] = rng.uniform(-1, 1, (n, 2))
    pts[:, 2] = 0.5 + rng.normal(0, 0.003, n)
    pts[n - outliers:] = rng.uniform(-1.5, 1.5, (outliers, 3))
    return pts


def _same_plane(tp, jp, atol=1e-5):
    jn, jo = np.asarray(jp.normal), float(jp.offset)
    sign = np.sign(np.dot(tp.normal.numpy(), jn))
    np.testing.assert_allclose(tp.normal.numpy() * sign, jn, rtol=0, atol=atol)
    assert abs(float(tp.offset) * sign - jo) < atol


@pytest.mark.parametrize("case", ["default", "valid", "sample_size", "no_re_estimate"])
def test_ransac_plane_matches_jax(case):
    pts = _plane_cloud()
    key, scores = _scores(3, len(pts))
    valid = np.random.default_rng(1).random(len(pts)) < 0.8 if case == "valid" else None
    kw = dict(sample_size=5 if case == "sample_size" else None, re_estimate=case != "no_re_estimate")
    jp, jres = jr.ransac_plane(key, jnp.asarray(pts), 0.01, num_hypotheses=H,
                               valid=None if valid is None else jnp.asarray(valid), **kw)
    tp, tres = tr._ransac_plane_from_scores(torch.as_tensor(scores), torch.as_tensor(pts), 0.01,
                                            valid=None if valid is None else torch.as_tensor(valid), **kw)
    np.testing.assert_array_equal(tres.hypothesis_inliers.numpy(), np.asarray(jres.hypothesis_inliers))
    _same_plane(tp, jp)
    np.testing.assert_array_equal(tres.inlier_mask.numpy(), np.asarray(jres.inlier_mask))
    planted = 1000 if valid is None else int(valid[:1000].sum())
    assert int(tres.num_inliers) == int(jres.num_inliers) > 0.9 * planted
    assert tres.hypothesis_inliers.dtype == torch.int32


def _transform_case(seed, d, n=800, wrong=200):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((n, d)).astype(np.float32)
    ang = 0.4
    r = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)[:d, :d]
    dst = (src @ r.T + np.float32([0.3, -0.2, 0.5][:d])).astype(np.float32)
    dst[:wrong] = rng.uniform(-3, 3, (wrong, d))
    return src, dst, r


def _well_conditioned(src, idx, d):
    x = src[idx] - src[idx].mean(axis=1, keepdims=True)
    x = np.concatenate([x, np.ones(x.shape[:2] + (1,), np.float32)], -1).astype(np.float64)
    return np.linalg.cond(np.einsum("hni,hnj->hij", x, x)) < 1e3


@pytest.mark.parametrize("rigid", [True, False])
@pytest.mark.parametrize("d", [3, 2])
def test_ransac_transform_matches_jax(rigid, d):
    src, dst, r = _transform_case(4, d)
    key, scores = _scores(5, len(src))
    jtf, jres = jr.ransac_transform(key, jnp.asarray(src), jnp.asarray(dst), 0.02, num_hypotheses=H, rigid=rigid)
    ttf, tres = tr._ransac_transform_from_scores(torch.as_tensor(scores), torch.as_tensor(src),
                                                 torch.as_tensor(dst), 0.02, rigid=rigid)
    got, want = tres.hypothesis_inliers.numpy(), np.asarray(jres.hypothesis_inliers)
    if rigid:
        np.testing.assert_array_equal(got, want)
    else:
        idx = np.asarray(jr._sample_minimal_sets(key, len(src), jnp.ones(len(src), bool), H, d + 1))
        ok = _well_conditioned(src, idx, d)
        assert ok.sum() > H // 2
        np.testing.assert_array_equal(got[ok], want[ok])
    assert int(np.argmax(got)) == int(np.argmax(want))
    np.testing.assert_allclose(ttf.linear.numpy(), np.asarray(jtf.linear), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ttf.translation.numpy(), np.asarray(jtf.translation), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tres.inlier_mask.numpy(), np.asarray(jres.inlier_mask))
    np.testing.assert_allclose(ttf.linear.numpy(), r, rtol=0, atol=1e-4)


@pytest.mark.parametrize("rigid", [True, False])
@pytest.mark.parametrize("d", [3, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_point_to_point_hypothesis_axis_matches_jax_vmap(rigid, d, weighted):
    """A leading ``(H,)`` axis gives what JAX's ``vmap`` gives; rank-2 calls
    give each hypothesis alone."""
    rng = np.random.default_rng(6)
    src = rng.standard_normal((16, 6, d)).astype(np.float32)
    dst = (src @ rng.standard_normal((d, d)).astype(np.float32) + 0.1).astype(np.float32)
    w = rng.random((16, 6)).astype(np.float32) if weighted else None
    jfn = jte.estimate_rigid_point_to_point if rigid else jte.estimate_affine_point_to_point
    tfn = tte.estimate_rigid_point_to_point if rigid else tte.estimate_affine_point_to_point
    if weighted:
        jtf, jok = jax.vmap(jfn)(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
        ttf, tok = tfn(torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(w))
    else:
        jtf, jok = jax.vmap(jfn)(jnp.asarray(src), jnp.asarray(dst))
        ttf, tok = tfn(torch.as_tensor(src), torch.as_tensor(dst))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(ttf.linear.numpy(), np.asarray(jtf.linear), rtol=0, atol=2e-5)
    np.testing.assert_allclose(ttf.translation.numpy(), np.asarray(jtf.translation), rtol=0, atol=2e-5)
    one, _ = tfn(torch.as_tensor(src[3]), torch.as_tensor(dst[3]), None if w is None else torch.as_tensor(w[3]))
    np.testing.assert_allclose(one.linear.numpy(), ttf.linear[3].numpy(), rtol=0, atol=2e-5)


def test_public_entry_points_with_a_generator():
    """``ransac_plane`` / ``ransac_transform`` with a ``torch.Generator``
    (the port's own draws) find the planted models; one seed, one result."""
    pts = _plane_cloud(7)
    gen = torch.Generator().manual_seed(0)
    plane, res = tr.ransac_plane(gen, pts, 0.01, num_hypotheses=H, device="cpu")
    assert abs(abs(float(plane.normal[2])) - 1.0) < 1e-3
    assert abs(float(plane.offset) * float(torch.sign(plane.normal[2])) + 0.5) < 2e-3
    assert int(res.num_inliers) > 950 and res.inlier_mask.device.type == "cpu"
    again, _ = tr.ransac_plane(torch.Generator().manual_seed(0), torch.as_tensor(pts), 0.01, num_hypotheses=H)
    assert torch.equal(again.normal, plane.normal)
    np.testing.assert_allclose(plane.signed_distance(torch.as_tensor(pts[:5])).numpy(),
                               pts[:5] @ plane.normal.numpy() + float(plane.offset), rtol=0, atol=1e-6)
    src, dst, r = _transform_case(8, 3)
    tf, res = tr.ransac_transform(torch.Generator().manual_seed(1), torch.as_tensor(src), torch.as_tensor(dst),
                                  0.02, num_hypotheses=H)
    np.testing.assert_allclose(tf.linear.numpy(), r, rtol=0, atol=1e-4)
    assert int(res.num_inliers) == 600


def test_hyperplane_from_jax_leaves():
    pts = _plane_cloud(9, n=600, outliers=100)
    jp, _ = jr.ransac_plane(jax.random.PRNGKey(0), jnp.asarray(pts), 0.01, num_hypotheses=16)
    tp = interop.hyperplane_from_numpy(np.asarray(jp.normal), np.asarray(jp.offset), device="cpu")
    np.testing.assert_allclose(tp.signed_distance(torch.as_tensor(pts)).numpy(),
                               np.asarray(jp.signed_distance(jnp.asarray(pts))), rtol=0, atol=1e-6)


def test_numpy_input_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = _plane_cloud(10, n=100, outliers=10)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.ransac_plane(None, pts, 0.01)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.ransac_transform(None, pts, pts, 0.01)
