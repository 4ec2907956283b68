"""The port's splat fusion (``cilantro_tpu_torch/slam/splat_fusion.py``)
against ``cilantro_tpu/slam/splat_fusion.py`` on a 128×160 synthetic
sequence, with the JAX kernels in interpret mode.

Single steps start from the exact state JAX reached (passed over with
``cilantro_tpu_torch.interop``). Tolerances: poses 1e-5 for one step and
1e-4 over a sequence (float32 reductions summed in another order, and the
GN early exit may take one step more or less); per-pixel decisions
(projected offsets, live masks, winner codes) ≥ 99.9% agreement, since a
pixel whose projection lands on a rounding boundary may round the other
way; rows 1e-5 where both packages elected the same surfels.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cilantro_tpu.core.rgbd import CameraIntrinsics as JIntrinsics
from cilantro_tpu.core.transforms import (
    Transform as JTransform,
    identity as j_identity,
    inverse as j_inverse,
)
from cilantro_tpu.slam import splat as jsplat
from cilantro_tpu.slam import splat_fusion as jsf
from cilantro_tpu.slam.driver import ate_rmse as j_ate, synthetic_sequence
from cilantro_tpu_torch import interop, native
from cilantro_tpu_torch.core.transforms import inverse as t_inverse
from cilantro_tpu_torch.slam import splat as tsplat
from cilantro_tpu_torch.slam import splat_fusion as tsf
from cilantro_tpu_torch.slam.driver import ate_rmse as t_ate

H, W = 128, 160
FX, FY, CX, CY = 140.0, 140.0, W / 2 - 0.5, H / 2 - 0.5
CFG_J = jsf.SplatConfig(radius=2, margin=16)
CFG_T = tsf.SplatConfig(radius=2, margin=16)


@pytest.fixture(scope="module")
def seq():
    jk = JIntrinsics.make(FX, FY, CX, CY)
    depths, gt = synthetic_sequence(4, H, W, jk, seed=0)
    return depths, gt, jk, interop.intrinsics_from_numpy(jk.fx, jk.fy, jk.cx, jk.cy)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_step(seq):
    """JAX state after seeding from frame 0, frame 1's images, and JAX's
    localize + integrate of frame 1 (all as numpy)."""
    depths, _, jk, _ = seq
    f0 = jsf._frame_images(jnp.asarray(depths[0]), jk, H, W)
    smap = jsf.init_splat_map(*f0, CFG_J)
    f1 = jsf._frame_images(jnp.asarray(depths[1]), jk, H, W)
    pose = jsf.splat_localize(smap, *f1, j_identity(3), jk, cfg=CFG_J)
    smap1 = jsf.splat_integrate(smap, *f1, pose, jk, cfg=CFG_J)
    return {
        "rows0": np.array(smap.rows),
        "frame1": [np.array(a) for a in f1],
        "pose1": (np.array(pose.linear), np.array(pose.translation)),
        "rows1": np.array(smap1.rows),
    }


def _port_state(jax_step):
    smap = interop.splat_map_from_numpy(jax_step["rows0"], np.eye(3), np.zeros(3), device="cpu")
    frame = [_t(a) for a in jax_step["frame1"]]
    return smap, frame


def _winner_codes_jax(rows, pose, jk, cfg):
    cw = j_inverse(JTransform(jnp.asarray(pose[0]), jnp.asarray(pose[1])))
    zc, off, _ = jsf._project_model(jnp.asarray(rows), cw, jk, cfg.margin, cfg.radius)
    key = jnp.where(off >= 0, zc, jnp.inf)
    r = cfg.radius
    _, bc, _, sc = jsplat.splat_argmin2(
        jsplat.pad_hw(key, r, jnp.inf)[None], jsplat.pad_hw(off, r, -1)[None], radius=r
    )
    return np.asarray(bc[0]), np.asarray(sc[0])


def _winner_codes_port(rows, pose, tk, cfg):
    zc, off, _ = tsf._project_model(rows, t_inverse(pose), tk, cfg.margin, cfg.radius)
    key = torch.where(off >= 0, zc, float("inf"))
    r = cfg.radius
    _, bc, _, sc = tsplat.splat_argmin2(
        tsplat.pad_hw(key, r, float("inf"))[None], tsplat.pad_hw(off, r, -1)[None], radius=r
    )
    return bc[0].numpy(), sc[0].numpy()


def test_project_model_matches_jax(seq, jax_step):
    _, _, jk, tk = seq
    rng = np.random.default_rng(0)
    from cilantro_tpu.core.transforms import axis_angle_to_rotation

    lin = np.array(axis_angle_to_rotation(jnp.asarray(0.01 * rng.standard_normal(3), jnp.float32)))
    t = (0.01 * rng.standard_normal(3)).astype(np.float32)
    rows = jax_step["rows0"]
    jz, joff, jval = jsf._project_model(
        jnp.asarray(rows), JTransform(jnp.asarray(lin), jnp.asarray(t)), jk, 16, 2
    )
    tz, toff, tval = tsf._project_model(
        _t(rows), interop.transform_from_numpy(lin, t, device="cpu"), tk, 16, 2
    )
    np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5, rtol=0)
    assert tval.float().mean() > 0.2
    assert (toff.numpy() == np.asarray(joff)).mean() >= 0.999


def test_localize_step_from_jax_state_matches_jax(seq, jax_step):
    _, _, _, tk = seq
    smap, frame = _port_state(jax_step)
    guess = interop.transform_from_numpy(np.eye(3), np.zeros(3), device="cpu")
    pose = tsf.splat_localize(smap, *frame, guess, tk, cfg=CFG_T)
    np.testing.assert_allclose(pose.linear.numpy(), jax_step["pose1"][0], atol=1e-5)
    np.testing.assert_allclose(pose.translation.numpy(), jax_step["pose1"][1], atol=1e-5)


def test_integrate_step_from_jax_state_matches_jax(seq, jax_step):
    _, _, jk, tk = seq
    smap, frame = _port_state(jax_step)
    pose = interop.transform_from_numpy(*jax_step["pose1"], device="cpu")
    out = tsf.splat_integrate(smap, *frame, pose, tk, cfg=CFG_T)
    got, want = out.rows.numpy(), jax_step["rows1"]
    assert got.shape == want.shape
    live_g, live_w = got[:, 7] > 0.5, want[:, 7] > 0.5
    assert (live_g == live_w).mean() >= 0.999
    assert live_w[0].mean() > 0.5

    jbc, jsc = _winner_codes_jax(jax_step["rows0"], jax_step["pose1"], jk, CFG_J)
    tbc, tsc = _winner_codes_port(smap.rows, pose, tk, CFG_T)
    assert (tbc == jbc).mean() >= 0.999 and (tsc == jsc).mean() >= 0.999
    same = (tbc == jbc) & (tsc == jsc) & (live_g == live_w).all(axis=0)
    np.testing.assert_allclose(
        np.moveaxis(got, 1, -1)[:, same], np.moveaxis(want, 1, -1)[:, same], atol=1e-5, rtol=0
    )


def test_integrate_with_colors_matches_jax(seq, jax_step):
    """The ``with_colors`` branch (11 channels), at radius 1 to keep the
    interpret-mode reference cheap."""
    _, _, jk, tk = seq
    cfg_j = jsf.SplatConfig(radius=1, margin=16, with_colors=True)
    cfg_t = tsf.SplatConfig(radius=1, margin=16, with_colors=True)
    rng = np.random.default_rng(5)
    rows = np.concatenate(
        [jax_step["rows0"], rng.random((2, 3) + jax_step["rows0"].shape[2:]).astype(np.float32)],
        axis=1,
    )
    frame = jax_step["frame1"]
    colors = rng.random((3, H, W)).astype(np.float32)
    lin, t = jax_step["pose1"]
    want = jsf.splat_integrate(
        jsf.SplatMap(rows=jnp.asarray(rows), pose=j_identity(3)),
        *(jnp.asarray(a) for a in frame),
        JTransform(jnp.asarray(lin), jnp.asarray(t)), jk, cfg=cfg_j,
        frame_colors=jnp.asarray(colors),
    )
    got = tsf.splat_integrate(
        interop.splat_map_from_numpy(rows, np.eye(3), np.zeros(3), device="cpu"),
        *(_t(a) for a in frame),
        interop.transform_from_numpy(lin, t, device="cpu"), tk, cfg=cfg_t,
        frame_colors=_t(colors),
    )
    got, want = got.rows.numpy(), np.asarray(want.rows)
    assert got.shape == want.shape == (2, 11, H + 32, W + 32)
    close = np.isclose(got, want, atol=1e-5, rtol=0).all(axis=1)
    assert close.mean() >= 0.999


@pytest.fixture(scope="module")
def radius2_runs(seq):
    depths, gt, jk, tk = seq
    _, jposes, _ = jsf.run_splat_sequence(depths[:3], jk, cfg=CFG_J)
    smap, tposes, _, launches = tsf.run_splat_sequence(depths[:3], tk, cfg=CFG_T, device="cpu")
    return jposes, tposes, smap, launches, gt[:3]


def test_sequence_radius2_matches_jax(radius2_runs):
    jposes, tposes, _, _, gt = radius2_runs
    assert len(tposes) == len(jposes) == 3
    for a, b in zip(tposes, jposes):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
    assert t_ate(tposes, gt, device="cpu") < 2e-3
    assert j_ate(jposes, gt) < 2e-3


def test_sequence_radius2_map_and_launches(radius2_runs):
    """The CPU run used the plain versions: no kernel launched."""
    _, _, smap, launches, _ = radius2_runs
    assert launches == [dict.fromkeys(tsplat.KERNELS, 0)] * 2
    pts, nrm, conf = tsf.extract_cloud(smap)
    assert len(pts) > 0.5 * H * W
    assert np.isfinite(pts).all() and np.isfinite(nrm).all() and (conf > 0).all()


def test_sequence_radius4_tracks(seq):
    """The bench's configuration (radius 4), port only: the interpret-mode
    JAX reference costs minutes at this radius."""
    depths, gt, _, tk = seq
    smap, poses, spf, _ = tsf.run_splat_sequence(
        depths, tk, cfg=tsf.SplatConfig(radius=4, margin=16), device="cpu"
    )
    assert len(poses) == 4 and spf > 0
    assert t_ate(poses, gt, device="cpu") < 2e-3
    assert len(tsf.extract_cloud(smap)[0]) > 0.5 * H * W
