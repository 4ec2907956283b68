"""The port's pool fusion (``cilantro_tpu_torch/slam/fusion.py``) and its
driver (``slam/driver.py``) against the JAX package on the CPU, with JAX's
gather kernel in interpret mode where ``coalesced_gathers`` reaches it.

Each comparison starts both packages from the same numpy frames and the
same pool (``interop.fusion_map_from_numpy``). Tolerances: index maps and
valid flags exactly (the same z-buffer rule on the same camera-frame
points); pools and packed targets 1e-5 (float32 blends of the same rows,
summed in another order); poses 1e-4 (the card-vs-CPU bound). Over a whole
sequence a pose difference of 1e-7 can flip one z-buffer winner in a
later frame, so the driver's maps are compared by point count (0.5%) and
its poses and ICP iteration counts as above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cilantro_tpu.core import CameraIntrinsics as JK
from cilantro_tpu.core import depth_to_points_normals as j_frame
from cilantro_tpu.core.transforms import Transform as JTransform
from cilantro_tpu.core.transforms import identity as j_identity
from cilantro_tpu.slam import driver as jdrv
from cilantro_tpu.slam import fusion as jf
from cilantro_tpu_torch import interop, native
from cilantro_tpu_torch.core import coalesced
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics as TK
from cilantro_tpu_torch.core.transforms import identity as t_identity
from cilantro_tpu_torch.slam import driver as tdrv
from cilantro_tpu_torch.slam import fusion as tf_

H, W = 48, 64
JKS = JK.make(100.0, 100.0, 31.5, 23.5)
TKS = TK.make(100.0, 100.0, 31.5, 23.5)
CAP = 2 * H * W


def wavy_depth(phase=0.0):
    """``tests/test_fusion.py``'s scene."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float32)
    return (1.5 + 0.05 * np.sin(0.2 * u + phase) + 0.05 * np.cos(0.15 * v)).astype(np.float32)


def frame(depth):
    """``(jax leaves, torch leaves)`` of one frame's points, normals, valid,
    back-projected by JAX."""
    leaves = [np.asarray(a) for a in j_frame(jnp.asarray(depth), JKS)]
    return [jnp.asarray(a) for a in leaves], [torch.from_numpy(np.array(a)) for a in leaves]


def pose(ang=0.008, t=(0.004, -0.002, 0.003)):
    r = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    t = np.array(t, np.float32)
    return JTransform(jnp.asarray(r), jnp.asarray(t)), interop.transform_from_numpy(r, t, device="cpu")


def port_tf(j_tf):
    return interop.transform_from_numpy(np.array(j_tf.linear), np.array(j_tf.translation), device="cpu")


def pool(jmap):
    return interop.fusion_map_from_numpy(np.asarray(jmap.data), device="cpu")


def assert_pools_close(t_data, j_data, atol=1e-5):
    t_data, j_data = t_data.numpy(), np.asarray(j_data)
    np.testing.assert_array_equal(t_data[:, -6 if t_data.shape[1] == 16 else -1] > 0.5,
                                  j_data[:, -6 if j_data.shape[1] == 16 else -1] > 0.5)
    np.testing.assert_allclose(t_data, j_data, rtol=0, atol=atol)


def assert_tf_close(t_tf, j_tf, atol=1e-4):
    np.testing.assert_allclose(t_tf.linear.numpy(), np.asarray(j_tf.linear), rtol=0, atol=atol)
    np.testing.assert_allclose(t_tf.translation.numpy(), np.asarray(j_tf.translation), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def two_frame_map():
    """A JAX pool after frame 0 and one fusion step of frame 1 (so that it
    holds fused, augmented and carved rows), the pose it reached, and
    frame 2."""
    (j0, _), (j1, _) = frame(wavy_depth(0.0)), frame(wavy_depth(0.2))
    jm = jf.init_map_from_frame(CAP, j0[0], j0[1], None, j0[2])
    jm, jpose, _, _, _ = jf.fusion_step(jm, *j1[:2], None, j1[2], j_identity(3), JKS, height=H, width=W)
    return jm, jpose, frame(wavy_depth(0.4))


def test_localize_matches_jax(two_frame_map):
    jm, jpose, (jfr, tfr) = two_frame_map
    tpose = port_tf(jpose)
    cfg_kw = dict(localize_stride=2)
    sub = np.arange(0, H, 2)[:, None] * W + np.arange(0, W, 2)[None, :]
    sub = sub.reshape(-1)
    jp, jr = jf.localize(jm, *(a[sub] for a in jfr), jpose, JKS, height=H, width=W,
                         cfg=jf.FusionConfig(**cfg_kw))
    tp, tr = tf_.localize(pool(jm), *(a[sub] for a in tfr), tpose, TKS, height=H, width=W,
                          cfg=tf_.FusionConfig(**cfg_kw))
    assert_tf_close(tp, jp)
    assert int(tr.iterations) == int(jr.iterations)
    assert int(tr.num_correspondences) == int(jr.num_correspondences)


@pytest.mark.parametrize("colors", [False, True])
def test_integrate_frame_with_imap_matches_jax(two_frame_map, colors):
    jm, jpose, (jfr, tfr) = two_frame_map
    cols = np.random.default_rng(0).random((H * W, 3)).astype(np.float32) if colors else None
    jcol = None if cols is None else jnp.asarray(cols)
    tcol = None if cols is None else torch.from_numpy(cols)
    tmat_j, tmat_t = pose(0.002, (0.001, 0.0, -0.001))
    jmap, imap_j, packed_j = jf.integrate_frame_with_imap(
        jm, jfr[0], jfr[1], jcol, jfr[2], tmat_j, JKS, height=H, width=W)
    tmap, imap_t, packed_t = tf_.integrate_frame_with_imap(
        pool(jm), tfr[0], tfr[1], tcol, tfr[2], tmat_t, TKS, height=H, width=W)
    np.testing.assert_array_equal(imap_t.numpy(), np.asarray(imap_j))
    assert_pools_close(tmap.data, jmap.data)
    np.testing.assert_allclose(packed_t.numpy(), np.asarray(packed_j), rtol=0, atol=1e-5)
    assert int(tmap.num_points()) == int(jmap.num_points())


def test_fusion_step_matches_jax(two_frame_map):
    jm, jpose, (jfr, tfr) = two_frame_map
    tpose = port_tf(jpose)
    jout = jf.fusion_step(jm, *jfr[:2], None, jfr[2], jpose, JKS, height=H, width=W)
    tout = tf_.fusion_step(pool(jm), *tfr[:2], None, tfr[2], tpose, TKS, height=H, width=W)
    assert_tf_close(tout[1], jout[1])
    assert int(tout[2].iterations) == int(jout[2].iterations)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    assert_pools_close(tout[0].data, jout[0].data)
    np.testing.assert_allclose(tout[4].numpy(), np.asarray(jout[4]), rtol=0, atol=1e-5)
    # A warm step from the cached render and packed target, and a skipped
    # integrate (no packed target comes back).
    jw = jf.fusion_step(jout[0], *jfr[:2], None, jfr[2], jout[1], JKS, cached_index_map=jout[3],
                        cached_packed_target=jout[4], height=H, width=W, do_integrate=False)
    tw = tf_.fusion_step(pool(jout[0]), *tfr[:2], None, tfr[2], tout[1], TKS, cached_index_map=tout[3],
                         cached_packed_target=tout[4], height=H, width=W, do_integrate=False)
    assert_tf_close(tw[1], jw[1])
    assert tw[4] is None and jw[4] is None
    np.testing.assert_array_equal(tw[0].data.numpy(), pool(jout[0]).data.numpy())


def test_seed_localize_target_matches_jax(two_frame_map):
    jm, jpose, _ = two_frame_map
    tpose = port_tf(jpose)
    ji, jp = jf.seed_localize_target(jm, jpose, JKS, H, W)
    ti, tp = tf_.seed_localize_target(pool(jm), tpose, TKS, H, W)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-5)


def test_free_slot_table_compact_and_cleanup_match_jax(two_frame_map):
    jm = two_frame_map[0]
    v = np.asarray(jm.valid).copy()
    v[np.flatnonzero(v)[10:400:3]] = False
    conf = np.asarray(jm.confidence).copy()
    conf[::7] = 5.0
    jm = jm.replace_fields(valid=jnp.asarray(v), confidence=jnp.asarray(conf))
    tm = pool(jm)
    js, jn = jf.free_slot_table(jm.valid)
    ts, tn = tf_.free_slot_table(tm.valid)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tf_.compact_map(tm).data.numpy(), np.asarray(jf.compact_map(jm).data))
    for thresh in (3.0, 1.5):
        np.testing.assert_array_equal(
            tf_.cleanup_map(tm, thresh).data.numpy(), np.asarray(jf.cleanup_map(jm, thresh).data)
        )
    # exp differs by an ulp between XLA's CPU kernel and torch's.
    np.testing.assert_allclose(tf_.radial_weights(H, W, TKS, device="cpu").numpy(),
                               np.asarray(jf.radial_weights(H, W, JKS)), rtol=2e-7, atol=0)


def test_width8_and_width16_match_jax_and_each_other():
    """``tests/test_fusion.py::test_width8_width16_same_geometry`` on both
    packages: the same geometry in both layouts, each equal to JAX's."""
    (j0, t0), (j1, t1) = frame(wavy_depth(0.0)), frame(wavy_depth(0.35))
    c0, c1 = np.full((H * W, 3), 0.5, np.float32), np.full((H * W, 3), 0.8, np.float32)
    out = {}
    for width, cols in ((8, None), (16, (c0, c1))):
        jm = jf.init_map_from_frame(CAP, j0[0], j0[1], None if cols is None else jnp.asarray(cols[0]),
                                    j0[2], with_color_slots=width == 16)
        tm = tf_.init_map_from_frame(CAP, t0[0], t0[1], None if cols is None else torch.from_numpy(cols[0]),
                                     t0[2], with_color_slots=width == 16)
        np.testing.assert_array_equal(tm.data.numpy(), np.asarray(jm.data))
        jo = jf.fusion_step(jm, j1[0], j1[1], None if cols is None else jnp.asarray(cols[1]), j1[2],
                            j_identity(3), JKS, height=H, width=W)
        to = tf_.fusion_step(tm, t1[0], t1[1], None if cols is None else torch.from_numpy(cols[1]), t1[2],
                             t_identity(3, device="cpu"), TKS, height=H, width=W)
        assert_tf_close(to[1], jo[1])
        assert_pools_close(to[0].data, jo[0].data)
        out[width] = to
    d8, d16 = out[8][0].data.numpy(), out[16][0].data.numpy()
    v8, v16 = d8[:, 7] > 0.5, d16[:, 10] > 0.5
    np.testing.assert_array_equal(v8, v16)
    np.testing.assert_allclose(d8[v8, 0:6], d16[v16, 0:6], atol=1e-6)
    np.testing.assert_allclose(d8[v8, 6], d16[v16, 9], atol=1e-6)
    with pytest.raises(ValueError, match="width-8"):
        tf_.integrate_frame(out[8][0], t1[0], t1[1], torch.zeros((H * W, 3)), t1[2],
                            t_identity(3, device="cpu"), TKS, height=H, width=W)


def test_reuse_carved_slots_matches_jax():
    """``tests/test_fusion.py::test_reuse_carved_slots_mode`` on both
    packages: exact reuse reclaims holes below the highest valid slot, the
    tail allocator appends past it."""
    (j0, _), (j2, t2) = frame(wavy_depth(0.0)), frame(wavy_depth(0.5))
    jm = jf.init_map_from_frame(CAP, j0[0], j0[1], None, j0[2])
    v = np.asarray(jm.valid).copy()
    v[np.flatnonzero(v)[:100]] = False
    jm = jm.replace_fields(valid=jnp.asarray(v))
    out = {}
    for reuse in (True, False):
        jo = jf.integrate_frame(jm, j2[0], j2[1], None, j2[2], j_identity(3), JKS, height=H, width=W,
                                cfg=jf.FusionConfig(reuse_carved_slots=reuse))
        to = tf_.integrate_frame(pool(jm), t2[0], t2[1], None, t2[2], t_identity(3, device="cpu"), TKS,
                                 height=H, width=W, cfg=tf_.FusionConfig(reuse_carved_slots=reuse))
        assert_pools_close(to.data, jo.data)
        out[reuse] = to.valid.numpy()
    new_exact, new_tail = np.flatnonzero(out[True] & ~v), np.flatnonzero(out[False] & ~v)
    top_old = np.flatnonzero(v).max()
    assert len(new_exact) > 0 and (new_tail > top_old).all() and (new_exact < top_old).any()


def test_update_modes_match_jax_and_each_other():
    """``tests/test_fusion.py::test_update_modes_bit_identical`` on both
    packages, augments and a carve included."""
    d1 = wavy_depth()
    d1[:, W // 2:] = 0.0
    (j1, _), (j2, t2) = frame(d1), frame(wavy_depth())
    jpts = j1[0].at[5 * W + 5].set(jnp.array([0.0, 0.0, 0.8]))
    jm = jf.init_map_from_frame(CAP, jpts, j1[1], None, j1[2])
    datas = []
    for mode in ("row_scatter", "inverse_gather", "auto"):
        jo = jf.integrate_frame(jm, *j2[:2], None, j2[2], j_identity(3), JKS, height=H, width=W,
                                cfg=jf.FusionConfig(update_mode=mode))
        to = tf_.integrate_frame(pool(jm), *t2[:2], None, t2[2], t_identity(3, device="cpu"), TKS,
                                 height=H, width=W, cfg=tf_.FusionConfig(update_mode=mode))
        assert_pools_close(to.data, jo.data)
        datas.append(to.data.numpy())
    for d in datas[1:]:
        np.testing.assert_array_equal(d, datas[0])
    assert (datas[0][:, 10] > 0.5).sum() > (np.asarray(jm.valid)).sum()  # augments landed
    with pytest.raises(ValueError, match="update_mode"):
        tf_.apply_pool_update(pool(jm).data, torch.zeros(3, dtype=torch.int32), torch.zeros((3, 16)),
                              tf_.FusionConfig(update_mode="bogus"))


def _three_frames(pkg_fusion, frames, ident, k, cfg):
    pts, nrm, valid = frames[0]
    fmap = pkg_fusion.init_map_from_frame(CAP, pts, nrm, None, valid)
    p, mats, iters = ident, [], []
    imap = packed = None
    for pts, nrm, valid in frames[1:]:
        fmap, p, res, imap, packed = pkg_fusion.fusion_step(
            fmap, pts, nrm, None, valid, p, k, cached_index_map=imap, cached_packed_target=packed,
            height=H, width=W, cfg=cfg)
        mats.append(np.asarray(p.matrix()))
        iters.append(int(res.iterations))
    return fmap, np.stack(mats), iters


def test_coalesced_gathers_match_jax_and_flag_off():
    """Three frames of the port against JAX with ``coalesced_gathers`` on
    (its kernel in interpret mode) and off (its plain gathers): poses and
    pools as JAX's either way. The port has no such flag; its gathers read
    the rows both JAX paths read."""
    fr = [frame(wavy_depth(p)) for p in (0.0, 0.2, 0.4)]
    tmap, tmats, tit = _three_frames(tf_, [f[1] for f in fr], t_identity(3, device="cpu"), TKS,
                                     tf_.FusionConfig())
    for coal in (True, False):
        jmap, jmats, jit = _three_frames(jf, [f[0] for f in fr], j_identity(3), JKS,
                                         jf.FusionConfig(coalesced_gathers=coal))
        np.testing.assert_allclose(tmats, jmats, rtol=0, atol=1e-4)
        assert tit == jit
        assert_pools_close(tmap.data, jmap.data)


def test_run_fusion_sequence_matches_jax():
    """The drivers on 6 synthetic 96×128 frames with the bench's settings
    (stride-2 localize, gather kernel on; capacity 4·H·W, a multiple of 16,
    so JAX runs its kernel in interpret mode)."""
    h, w = 96, 128
    args = (105.0, 105.0, 63.5, 47.5)
    depths, gt = jdrv.synthetic_sequence(6, h, w, JK.make(*args), seed=0)
    jmap, jm = jdrv.run_fusion_sequence(depths, JK.make(*args), map_capacity=4 * h * w,
                                        cfg=jf.FusionConfig(localize_stride=2, coalesced_gathers=True))
    seen = []
    native.reset_launch_counts()
    tmap, tm = tdrv.run_fusion_sequence(depths, TK.make(*args), map_capacity=4 * h * w,
                                        cfg=tf_.FusionConfig(localize_stride=2), device="cpu",
                                        on_frame=lambda i, m, p: seen.append(i))
    assert native.launch_counts["coalesced_gather"] == 0  # CPU tensors: the plain version
    assert seen == list(range(1, 6)) and tm.frames == 6
    np.testing.assert_allclose(np.stack(tm.poses), np.stack(jm.poses), rtol=0, atol=1e-4)
    assert tm.icp_iterations == jm.icp_iterations
    assert abs(tm.num_map_points - jm.num_map_points) <= 0.005 * jm.num_map_points
    assert tm.num_map_points == int(tmap.num_points())
    assert tdrv.ate_rmse(tm.poses, gt, device="cpu") < 0.01
    assert tm.seconds_per_frame > 0
