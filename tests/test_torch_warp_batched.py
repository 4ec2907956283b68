"""The port's batched warp-field solves (``cilantro_tpu_torch/registration/
warp_field_batched.py``) against the JAX package on the CPU, and against
the port's own single solves (the twins of
``tests/test_warp_field.py::test_batched_warp_matches_single_streams`` and
``::test_batched_gn_matches_single_plane_metric``).

Tolerances: one batched GN step's node transforms within 1e-4 of JAX's and
2e-5 of the port's single step on each stream (JAX's own bound between its
batched and single solvers); whole registrations within 1e-4 m of JAX's
warped points at the median and 1e-3 m at the max, with the same outer
iteration count, and each stream within 1e-4 m (median) of the port's
single solve.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from cilantro_tpu.core.containers import PointCloud as JPointCloud
from cilantro_tpu.core.grid import grid_downsample as j_grid_downsample
from cilantro_tpu.registration import warp_field as jw
from cilantro_tpu.registration import warp_field_batched as jwb
from cilantro_tpu_torch import interop
from cilantro_tpu_torch.registration import warp_field as tw
from cilantro_tpu_torch.registration import warp_field_batched as twb


def _graph_pair(src, step):
    ctrl = j_grid_downsample(JPointCloud(points=jnp.asarray(src)), step, capacity=128)
    gj = jw.build_deformation_graph(
        jnp.asarray(src), ctrl.points, node_valid=ctrl.valid, k_anchors=4, k_arcs=8
    )
    leaves = {
        f.name: getattr(gj, f.name) if f.name == "caches_sorted" or getattr(gj, f.name) is None
        else np.asarray(getattr(gj, f.name))
        for f in dataclasses.fields(gj)
    }
    return gj, interop.deformation_graph_from_numpy(device="cpu", **leaves)


def _plane_case(seed=0, n=3000, bsz=2):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    src[:, 2] *= 0.2
    dst = np.stack([src + 0.01 * rng.standard_normal((n, 3)).astype(np.float32) for _ in range(bsz)])
    nrm = rng.standard_normal((bsz, n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    w = (rng.random((bsz, n)) > 0.2).astype(np.float32)
    return src, dst, nrm, w


@pytest.mark.parametrize("route", ["sorted", "pair"])
@pytest.mark.parametrize("metric", ["point", "plane"])
def test_batched_gn_step_matches_jax_and_single_steps(route, metric):
    src, dst, nrm, w = _plane_case()
    gj, gt = _graph_pair(src, 0.12)
    if route == "pair":
        strip = {name: None for name in ("ps_kkf", "ps_llf", "ps_w2", "ps_swap", "ps_seg",
                                         "arc_sorted_order", "arc_sorted_seg")}
        gj, gt = dataclasses.replace(gj, **strip), dataclasses.replace(gt, **strip)
    if metric == "point":
        nrm = None
        kw = dict(point_weight=1.0, plane_weight=0.0, stiffness=20.0, max_gn_iterations=1)
    else:
        kw = dict(point_weight=0.3, plane_weight=1.0, stiffness=20.0, max_gn_iterations=1)
    nrm_t = None if nrm is None else nrm.transpose(1, 0, 2)
    tf_j, upd_j = jwb.estimate_warp_field_batched(
        gj, jnp.asarray(src), jnp.asarray(dst.transpose(1, 0, 2)),
        None if nrm is None else jnp.asarray(nrm_t), jnp.asarray(w.T), **kw,
    )
    tf_t, upd_t = twb.estimate_warp_field_batched(
        gt, src, dst.transpose(1, 0, 2), nrm_t, w.T, device="cpu", **kw
    )
    np.testing.assert_allclose(tf_t.linear.numpy(), np.asarray(tf_j.linear), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tf_t.translation.numpy(), np.asarray(tf_j.translation), rtol=0, atol=1e-4)
    np.testing.assert_allclose(upd_t.numpy(), np.asarray(upd_j), rtol=1e-3)
    for b in range(len(dst)):
        single, _, _ = tw.estimate_warp_field(
            gt, src, dst[b], None if nrm is None else nrm[b], w[b], solver="direct", device="cpu", **kw
        )
        np.testing.assert_allclose(tf_t.linear[b].numpy(), single.linear.numpy(), rtol=0, atol=2e-5)
        np.testing.assert_allclose(tf_t.translation[b].numpy(), single.translation.numpy(), rtol=0,
                                   atol=2e-5)


def test_icp_warp_field_batched_matches_jax_and_single_solves():
    rng = np.random.default_rng(0)
    n, bsz = 4000, 3
    src = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    src[:, 2] *= 0.1
    dsts = []
    for b in range(bsz):
        d = src.copy()
        d[:, 2] += 0.015 * np.sin((4 + b) * src[:, 0])
        d[:, 1] += 0.008 * np.cos((3 + b) * src[:, 0])
        dsts.append(d)
    dsts = np.stack(dsts)
    gj, gt = _graph_pair(src, 0.1)
    kw = dict(max_corr_dist_sq=0.0025, point_weight=1.0, plane_weight=0.0, stiffness=50.0,
              max_iterations=6)
    tf_j, it_j, conv_j = jwb.icp_warp_field_batched(gj, jnp.asarray(src), jnp.asarray(dsts), **kw)
    tf_t, it_t, conv_t = twb.icp_warp_field_batched(gt, src, dsts, device="cpu", **kw)
    assert int(it_t) == int(it_j)
    np.testing.assert_array_equal(conv_t.numpy(), np.asarray(conv_j))
    got = twb.warp_points_batched(gt, tf_t, src, device="cpu").numpy()
    want = np.asarray(jwb.warp_points_batched(gj, tf_j, jnp.asarray(src)))
    diff = np.linalg.norm(got - want, axis=-1)
    assert np.median(diff) < 1e-4 and diff.max() < 1e-3, (np.median(diff), diff.max())
    for b in range(bsz):
        tf_s, _, _ = tw.icp_warp_field(gt, src, dsts[b], solver="direct", device="cpu", **kw)
        single = tw.warp_points(gt, tf_s, src, device="cpu").numpy()
        agree = np.median(np.linalg.norm(single - got[:, b], axis=1))
        err = np.median(np.linalg.norm(got[:, b] - dsts[b], axis=1))
        assert agree < 1e-4, f"stream {b}: {agree}"
        assert err < 5e-3, f"stream {b}: recovery {err}"


def test_batched_rejects_caches_of_another_cloud():
    src, dst, _, w = _plane_case(n=1000, bsz=2)
    _, gt = _graph_pair(src, 0.12)
    big = 5  # 5,000 points: past the caches' 4,096-row padding
    with pytest.raises(ValueError, match="different cloud/graph shape"):
        twb.estimate_warp_field_batched(
            gt, np.tile(src, (big, 1)), np.tile(dst, (1, big, 1)).transpose(1, 0, 2), None,
            np.tile(w, (1, big)).T, device="cpu",
        )
    with pytest.raises(ValueError, match="needs the pair caches"):
        twb.estimate_warp_field_batched(
            dataclasses.replace(gt, pair_order=None), src, dst.transpose(1, 0, 2), None, w.T,
            device="cpu",
        )
