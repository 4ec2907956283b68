"""The port's host-side driver parts against ``cilantro_tpu``: the
``synthetic_sequence`` copy (bit-identical), ``ate_rmse`` and
``estimate_rigid_point_to_point`` (1e-5: float32 SVD roundoff)."""

import numpy as np
import jax.numpy as jnp
import torch

from cilantro_tpu.core.rgbd import CameraIntrinsics as JIntrinsics
from cilantro_tpu.registration.transform_estimation import (
    estimate_rigid_point_to_point as j_estimate,
)
from cilantro_tpu.slam import driver as jd
from cilantro_tpu_torch.core.rgbd import CameraIntrinsics as TIntrinsics
from cilantro_tpu_torch.registration.transform_estimation import (
    estimate_rigid_point_to_point as t_estimate,
)
from cilantro_tpu_torch.slam import driver as td


def test_synthetic_sequence_is_bit_identical():
    jk = JIntrinsics.make(140.0, 140.0, 79.5, 63.5)
    tk = TIntrinsics.make(140.0, 140.0, 79.5, 63.5)
    for seed in (0, 3):
        jdep, jpose = jd.synthetic_sequence(3, 64, 80, jk, seed=seed, motion_scale=0.01)
        tdep, tpose = td.synthetic_sequence(3, 64, 80, tk, seed=seed, motion_scale=0.01)
        for a, b in zip(jdep + jpose, tdep + tpose):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_estimate_rigid_point_to_point_matches_jax():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((40, 3)).astype(np.float32)
    lin = np.asarray(jnp.linalg.qr(jnp.asarray(rng.standard_normal((3, 3)), jnp.float32))[0])
    lin = lin * np.sign(np.linalg.det(lin))
    dst = (src @ lin.T + np.array([0.3, -0.2, 1.0], np.float32)).astype(np.float32)
    dst += 1e-3 * rng.standard_normal(dst.shape).astype(np.float32)
    wts = rng.random(40).astype(np.float32)
    for w in (None, wts):
        jtf, jok = j_estimate(jnp.asarray(src), jnp.asarray(dst), None if w is None else jnp.asarray(w))
        ttf, tok = t_estimate(torch.from_numpy(src), torch.from_numpy(dst), None if w is None else torch.from_numpy(w))
        assert bool(tok) == bool(jok) is True
        np.testing.assert_allclose(ttf.linear.numpy(), np.asarray(jtf.linear), atol=1e-5)
        np.testing.assert_allclose(ttf.translation.numpy(), np.asarray(jtf.translation), atol=1e-5)
    # Too few weighted correspondences: not valid.
    _, tok = t_estimate(torch.from_numpy(src[:2]), torch.from_numpy(dst[:2]))
    assert not bool(tok)


def test_ate_rmse_matches_jax():
    jk = JIntrinsics.make(140.0, 140.0, 79.5, 63.5)
    _, gt = jd.synthetic_sequence(6, 32, 40, jk, seed=1, motion_scale=0.02)
    rng = np.random.default_rng(1)
    est = []
    for p in gt:
        q = p.copy()
        q[:3, 3] += 1e-3 * rng.standard_normal(3).astype(np.float32)
        est.append(q)
    want = jd.ate_rmse(est, gt)
    got = td.ate_rmse(est, gt, device="cpu")
    assert 0.0 < want < 2e-3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-8)
    assert td.ate_rmse(gt, gt, device="cpu") < 1e-6
