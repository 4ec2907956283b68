"""The port's transforms (``cilantro_tpu_torch/core/transforms.py``)
against ``cilantro_tpu/core/transforms.py`` on the same random inputs.
Tolerance 1e-6 absolute: float32 roundoff of the same expressions."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cilantro_tpu.core import transforms as jt
from cilantro_tpu_torch.core import transforms as tt

ATOL = 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _rotations(rng, n):
    omega = rng.standard_normal((n, 3)).astype(np.float32)
    return np.array(jt.axis_angle_to_rotation(jnp.asarray(omega)))


def _pair(rng, n=()):
    """A rigid transform (batch shape ``n``) in both packages."""
    lin = _rotations(rng, int(np.prod(n)) if n else 1).reshape(n + (3, 3))
    t = rng.standard_normal(n + (3,)).astype(np.float32)
    return (
        jt.Transform(jnp.asarray(lin), jnp.asarray(t)),
        tt.Transform(torch.from_numpy(lin), torch.from_numpy(t)),
    )


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _close_tf(got, want):
    _close(got.linear, want.linear)
    _close(got.translation, want.translation)


def case_matrix_and_from_matrix(rng):
    ja, ta = _pair(rng, (4,))
    _close(ta.matrix(), ja.matrix())
    m = ja.matrix()
    _close_tf(tt.from_matrix(torch.from_numpy(np.array(m))), jt.from_matrix(m))


def case_identity(rng):
    _close_tf(tt.identity(3, (2,), device="cpu"), jt.identity(3, (2,)))


def case_compose(rng):
    (ja, ta), (jb, tb) = _pair(rng, (5,)), _pair(rng, (5,))
    _close_tf(tt.compose(ta, tb), jt.compose(ja, jb))


def case_inverse_rigid_and_affine(rng):
    ja, ta = _pair(rng, (5,))
    _close_tf(tt.inverse(ta), jt.inverse(ja))
    lin = rng.standard_normal((3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    t = rng.standard_normal(3).astype(np.float32)
    _close_tf(
        tt.inverse(tt.Transform(torch.from_numpy(lin), torch.from_numpy(t)), rigid=False),
        jt.inverse(jt.Transform(jnp.asarray(lin), jnp.asarray(t)), rigid=False),
    )


def case_transform_points_and_normals(rng):
    ja, ta = _pair(rng)
    pts = rng.standard_normal((50, 3)).astype(np.float32)
    _close(tt.transform_points(ta, torch.from_numpy(pts)), jt.transform_points(ja, jnp.asarray(pts)))
    _close(tt.transform_normals(ta, torch.from_numpy(pts)), jt.transform_normals(ja, jnp.asarray(pts)))
    # A transform set applied point by point.
    js, ts = _pair(rng, (50,))
    _close(tt.transform_points(ts, torch.from_numpy(pts)), jt.transform_points(js, jnp.asarray(pts)))
    # Affine normals: inverse-transpose, renormalised.
    lin = rng.standard_normal((3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    t = np.zeros(3, np.float32)
    _close(
        tt.transform_normals(tt.Transform(torch.from_numpy(lin), torch.from_numpy(t)), torch.from_numpy(pts), rigid=False),
        jt.transform_normals(jt.Transform(jnp.asarray(lin), jnp.asarray(t)), jnp.asarray(pts), rigid=False),
    )


def case_project_to_rotation(rng):
    # Noisy rotations, and reflections (det < 0) that need the sign fix.
    # The reflections get well-separated singular values: where two are
    # nearly equal, the singular vector the fix flips is ill-determined and
    # any two SVDs may disagree far above roundoff.
    near = _rotations(rng, 4) + 0.05 * rng.standard_normal((4, 3, 3)).astype(np.float32)
    refl = _rotations(rng, 4) * np.array([1.6, 1.0, 0.4], np.float32) @ _rotations(rng, 4)
    refl[:, :, 0] *= -1
    lin = np.concatenate([near, refl]).astype(np.float32)
    assert (np.linalg.det(lin) < 0).sum() == 4
    got = tt.project_to_rotation(torch.from_numpy(lin))
    _close(got, jt.project_to_rotation(jnp.asarray(lin)))
    np.testing.assert_allclose(np.linalg.det(got.numpy()), 1.0, atol=1e-5)
    _close_tf(
        tt.reproject_rigid(tt.Transform(torch.from_numpy(lin), torch.zeros(8, 3))),
        jt.reproject_rigid(jt.Transform(jnp.asarray(lin), jnp.zeros((8, 3)))),
    )


def case_skew3(rng):
    v = rng.standard_normal((6, 3)).astype(np.float32)
    _close(tt.skew3(torch.from_numpy(v)), jt.skew3(jnp.asarray(v)))


def case_axis_angle_to_rotation(rng):
    omega = rng.standard_normal((16, 3)).astype(np.float32)
    omega[0] = 0.0  # the small-angle branch
    omega[1] = 1e-9
    _close(tt.axis_angle_to_rotation(torch.from_numpy(omega)), jt.axis_angle_to_rotation(jnp.asarray(omega)))


def case_gn_update_3d(rng):
    steps = (0.1 * rng.standard_normal((16, 6))).astype(np.float32)
    steps[0, :3] = 0.0  # zero rotation: the atan scale's guard
    for s in steps:
        _close_tf(tt.gn_update_3d(torch.from_numpy(s)), jt.gn_update_3d(jnp.asarray(s)))


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


@pytest.mark.parametrize(
    "seed, case", list(enumerate(CASES)), ids=[c.__name__[5:] for c in CASES]
)
def test_transform_matches_jax(seed, case):
    case(_rng(seed))
