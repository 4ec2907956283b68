"""The port's z-buffer (``cilantro_tpu_torch/core/rgbd.py``), projective
correspondences (``correspondence/projective.py``) and projective ICP
(``registration/icp.py``) against the JAX package on the CPU.

The same numpy inputs go through both packages. Tolerances: index maps,
hit masks and weights exactly (the winner rule is the same packed-key
scatter-min, the projections the same float32 expressions); depths and
gathered rows exactly (copies of the same values); transformed points and
squared distances 1e-6 (a 3-term float32 product summed in another
order); poses after a whole registration 1e-4 (the card-vs-CPU bound:
float32 normal equations summed in another order).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu.core import containers as jcont
from cilantro_tpu.core import rgbd as jrgbd
from cilantro_tpu.core.transforms import Transform as JTransform
from cilantro_tpu.correspondence import projective as jproj
from cilantro_tpu_torch import interop
from cilantro_tpu_torch.core import containers as tcont
from cilantro_tpu_torch.core import rgbd as trgbd
from cilantro_tpu_torch.correspondence import projective as tproj
from cilantro_tpu_torch.registration import icp as ticp

jicp = importlib.import_module("cilantro_tpu.registration.icp")

H, W = 48, 64
JK = jrgbd.CameraIntrinsics.make(100.0, 100.0, 31.5, 23.5)
TK = trgbd.CameraIntrinsics.make(100.0, 100.0, 31.5, 23.5)


def _cloud(n, h, w, seed):
    """Camera-frame points crowding an ``h×w`` image (many per pixel),
    depths drawn from a few values so that whole z buckets tie, with
    points behind the camera, out of the image, and 10% invalid."""
    rng = np.random.default_rng(seed)
    z = rng.choice(np.float32([0.7, 1.1, 1.1000001, 1.6, 2.4]), n) + rng.normal(0, 1e-3, n) * (
        rng.random(n) < 0.5
    )
    u = rng.uniform(-3, w + 3, n)
    v = rng.uniform(-3, h + 3, n)
    x = (u - 0.5 * (w - 1)) * z / 100.0
    y = (v - 0.5 * (h - 1)) * z / 100.0
    pts = np.stack([x, y, z], 1).astype(np.float32)
    pts[rng.random(n) < 0.02, 2] *= -1
    valid = rng.random(n) < 0.9
    return pts, valid


def _k(h, w):
    args = (100.0, 100.0, 0.5 * (w - 1), 0.5 * (h - 1))
    return jrgbd.CameraIntrinsics.make(*args), trgbd.CameraIntrinsics.make(*args)


@pytest.mark.parametrize("n,h,w", [(5000, 12, 16), (40000, 48, 64), ((1 << 20) + 3000, 24, 32)])
def test_zbuffer_winner_matches_jax(n, h, w):
    """Index maps equal exactly and depths bit for bit; the last case has
    more than 2^20 points and takes the grouped path."""
    pts, valid = _cloud(n, h, w, seed=n)
    jk, tk = _k(h, w)
    ji, jd = jrgbd._zbuffer_winner(jnp.asarray(pts), jnp.asarray(valid), jk, h, w)
    ti, td = trgbd._zbuffer_winner(torch.from_numpy(pts), torch.from_numpy(valid), tk, h, w)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (ti >= 0).sum() > 0.9 * h * w
    if n > 1 << 20:
        assert int(ti.max()) >= 1 << 20  # a winner from the second group


def test_project_points_matches_jax():
    pts, _ = _cloud(20000, H, W, seed=1)
    pts[:5] = [[1e30, 1e30, 1e30], [-1e30, 2.0, 1e30], [0.1, 0.2, 0.0], [3.0, -3.0, 1e-30], [0.0, 0.0, -1.0]]
    ju, jv, jz = jrgbd.project_points(jnp.asarray(pts), JK)
    tu, tv, tz = trgbd.project_points(torch.from_numpy(pts), TK)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


def test_depth_image_and_cloud_to_rgbd_match_jax():
    pts, valid = _cloud(20000, H, W, seed=2)
    cols = np.random.default_rng(3).random((len(pts), 3)).astype(np.float32)
    jdep = jrgbd.points_to_depth_image(jnp.asarray(pts), JK, H, W, valid=jnp.asarray(valid))
    tdep = trgbd.points_to_depth_image(torch.from_numpy(pts), TK, H, W, valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(tdep.numpy(), np.asarray(jdep))
    jimap = jrgbd.points_to_index_map(jnp.asarray(pts), JK, H, W)
    timap = trgbd.points_to_index_map(torch.from_numpy(pts), TK, H, W)
    np.testing.assert_array_equal(timap.numpy(), np.asarray(jimap))
    for c in (cols, None):
        jc = jcont.PointCloud(points=jnp.asarray(pts), colors=None if c is None else jnp.asarray(c),
                              valid=jnp.asarray(valid))
        tcl = tcont.PointCloud(points=torch.from_numpy(pts), colors=None if c is None else torch.from_numpy(c),
                               valid=torch.from_numpy(valid))
        (jd, jrgb), (td, trgb) = jrgbd.cloud_to_rgbd(jc, JK, H, W), trgbd.cloud_to_rgbd(tcl, TK, H, W)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(trgb.numpy(), np.asarray(jrgb))


def _wavy_depth(phase=0.0):
    """``tests/test_fusion.py``'s scene."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    return (1.5 + 0.05 * np.sin(0.2 * u + phase) + 0.05 * np.cos(0.15 * v)).astype(np.float32)


def _small_pose(ang=0.008, t=(0.004, -0.002, 0.003)):
    r = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    return r, np.array(t, np.float32)


@pytest.fixture(scope="module")
def scene():
    """dst = the wavy frame; src = the same surface seen from a moved camera
    (``tests/test_fusion.py::test_localize_recovers_pose``), as numpy."""
    pts, nrm, valid = (np.asarray(a) for a in jrgbd.depth_to_points_normals(jnp.asarray(_wavy_depth()), JK))
    r, t = _small_pose()
    src = ((pts - t) @ r).astype(np.float32)  # R^T (p - t)
    src_n = (nrm @ r).astype(np.float32)
    return dict(dst=pts, dst_n=nrm, valid=valid, src=src, src_n=src_n, r=r, t=t)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def test_pack_and_correspondences_match_jax(scene):
    (jdst, tdst), (jn, tn), (jv, tv) = (_both(scene[k]) for k in ("dst", "dst_n", "valid"))
    jimap = jproj.build_projective_target(jdst, JK, H, W, dst_valid=jv)
    timap = tproj.build_projective_target(tdst, TK, H, W, dst_valid=tv)
    np.testing.assert_array_equal(timap.numpy(), np.asarray(jimap))
    for normals in ((jn, tn), (None, None)):
        jp = jproj.pack_projective_target(jdst, normals[0], jimap, dst_valid=jv)
        tp = tproj.pack_projective_target(tdst, normals[1], timap, dst_valid=tv)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))

    r, t = _small_pose(0.003, (0.002, 0.001, -0.002))
    jtf, ttf = JTransform(jnp.asarray(r), jnp.asarray(t)), interop.transform_from_numpy(r, t, device="cpu")
    (jsrc, tsrc) = _both(scene["src"])
    jc = jproj.find_projective_correspondences(jsrc, jdst, jimap, JK, tf=jtf, src_valid=jv, dst_valid=jv,
                                               max_distance=0.01)
    tc = tproj.find_projective_correspondences(tsrc, tdst, timap, TK, tf=ttf, src_valid=tv, dst_valid=tv,
                                               max_distance=0.01)
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_array_equal(tc.dst_idx.numpy(), np.asarray(jc.dst_idx))
    np.testing.assert_array_equal(tc.weights.numpy(), np.asarray(jc.weights))
    np.testing.assert_allclose(tc.distances.numpy(), np.asarray(jc.distances), rtol=0, atol=1e-6)
    assert int(tc.mask.sum()) > 0.8 * H * W

    jp = jproj.pack_projective_target(jdst, jn, jimap, dst_valid=jv)
    tp = tproj.pack_projective_target(tdst, tn, timap, dst_valid=tv)
    to = tproj.find_projective_correspondences_packed(tsrc, tp, TK, H, W, tf=ttf, src_valid=tv,
                                                      max_distance=0.01)
    for coalesced in (False, True):  # JAX's plain gather and its kernel (interpret mode)
        jo = jproj.find_projective_correspondences_packed(jsrc, jp, JK, H, W, tf=jtf, src_valid=jv,
                                                          max_distance=0.01, coalesced=coalesced)
        np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), rtol=0, atol=1e-6)
        live = np.asarray(jo[3]) > 0
        np.testing.assert_array_equal(to[3].numpy(), np.asarray(jo[3]))
        for k in (1, 2):  # JAX's wildcard rows are unspecified: compare live ones
            np.testing.assert_array_equal(to[k].numpy()[live], np.asarray(jo[k])[live])


@pytest.mark.parametrize("variant", ["symmetric", "combined", "point_to_point"])
def test_icp_projective_matches_jax(scene, variant):
    (jdst, tdst), (jn, tn), (jv, tv), (jsrc, tsrc), (jsn, tsn) = (
        _both(scene[k]) for k in ("dst", "dst_n", "valid", "src", "src_n")
    )
    metric = "point_to_point" if variant == "point_to_point" else "combined"
    # The update norm of a converged step is float32 noise near 1e-6, so a
    # tolerance there makes the stopping iteration a coin toss; 1e-5 is
    # well above it and the iteration counts are held equal.
    kw = dict(height=H, width=W, metric=metric, max_iterations=10, convergence_tol=1e-5)
    sym = variant == "symmetric"
    rj = jicp.icp_projective(jsrc, jdst, JK, src_normals=jsn if sym else None, dst_normals=jn,
                             src_valid=jv, dst_valid=jv, **kw)
    rt = ticp.icp_projective(tsrc, tdst, TK, src_normals=tsn if sym else None, dst_normals=tn,
                             src_valid=tv, dst_valid=tv, **kw)
    got = interop.icp_result_to_numpy(rt)
    np.testing.assert_allclose(got["linear"], np.asarray(rj.transform.linear), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["translation"], np.asarray(rj.transform.translation), rtol=0, atol=1e-4)
    assert got["iterations"] == int(rj.iterations)
    # The registration recovers the camera motion that made the pair.
    np.testing.assert_allclose(got["translation"], scene["t"], atol=2e-3)
    np.testing.assert_allclose(got["linear"], scene["r"], atol=2e-3)
