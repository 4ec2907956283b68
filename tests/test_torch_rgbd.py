"""The port's depth conversions (``cilantro_tpu_torch/core/rgbd.py``)
against ``cilantro_tpu/core/rgbd.py`` on a 128×160 ``synthetic_sequence``
frame. Valid masks must agree exactly; points and normals to 1e-5
(float32 roundoff of the same expressions; invalid points are 1e30 in
both)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cilantro_tpu.core import rgbd as jr
from cilantro_tpu.core.transforms import Transform as JTransform
from cilantro_tpu.slam.driver import synthetic_sequence
from cilantro_tpu_torch.core import rgbd as tr
from cilantro_tpu_torch.core.transforms import Transform as TTransform

H, W = 128, 160
ATOL = 1e-5


@pytest.fixture(scope="module")
def frame():
    jk = jr.CameraIntrinsics.make(140.0, 140.0, W / 2 - 0.5, H / 2 - 0.5)
    depths, _ = synthetic_sequence(2, H, W, jk, seed=0)
    depth = depths[1].copy()
    depth[40:44, 50:60] = 0.0  # a hole: invalid points and a depth jump
    tk = tr.CameraIntrinsics.make(140.0, 140.0, W / 2 - 0.5, H / 2 - 0.5)
    return depth, jk, tk


def _pose(seed):
    from cilantro_tpu.core.transforms import axis_angle_to_rotation

    rng = np.random.default_rng(seed)
    lin = np.array(axis_angle_to_rotation(jnp.asarray(0.1 * rng.standard_normal(3), jnp.float32)))
    t = (0.1 * rng.standard_normal(3)).astype(np.float32)
    return (
        JTransform(jnp.asarray(lin), jnp.asarray(t)),
        TTransform(torch.from_numpy(lin), torch.from_numpy(t)),
    )


@pytest.mark.parametrize("posed", [False, True])
def test_depth_to_points_matches_jax(frame, posed):
    depth, jk, tk = frame
    jpose, tpose = _pose(1) if posed else (None, None)
    jp, jv = jr.depth_to_points(jnp.asarray(depth), jk, jpose)
    tp, tv = tr.depth_to_points(torch.from_numpy(depth), tk, tpose)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL, rtol=0)


@pytest.mark.parametrize("posed", [False, True])
def test_depth_to_points_normals_matches_jax(frame, posed):
    depth, jk, tk = frame
    jpose, tpose = _pose(2) if posed else (None, None)
    jp, jn, jv = jr.depth_to_points_normals(jnp.asarray(depth), jk, jpose)
    tp, tn, tv = tr.depth_to_points_normals(torch.from_numpy(depth), tk, tpose)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0.5 < tv.float().mean() < 1.0  # the border, hole and jumps are out
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=ATOL, rtol=0)
