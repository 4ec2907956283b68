"""Rigid/affine transforms (port of ``cilantro_tpu/core/transforms.py``).

A transform is a frozen ``Transform(linear, translation)`` of tensors whose
leading dimensions are batch dimensions; every op broadcasts over them. The
arithmetic follows the JAX module expression for expression, so the two
agree to float32 roundoff.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class Transform:
    """A (possibly batched) transform ``x -> A x + t``: ``linear``
    ``(..., D, D)``, ``translation`` ``(..., D)``. Rigidity is maintained
    by the ops that produce transforms (:func:`reproject_rigid`)."""

    linear: torch.Tensor
    translation: torch.Tensor

    @property
    def dim(self) -> int:
        return self.linear.shape[-1]

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        return transform_points(self, points)

    def apply_normals(self, normals: torch.Tensor, rigid: bool = True) -> torch.Tensor:
        return transform_normals(self, normals, rigid=rigid)

    def matrix(self) -> torch.Tensor:
        """Homogeneous ``(..., D+1, D+1)`` matrix."""
        d = self.dim
        m = self.linear.new_zeros(self.linear.shape[:-2] + (d + 1, d + 1))
        m[..., :d, :d] = self.linear
        m[..., :d, d] = self.translation
        m[..., d, d] = 1.0
        return m


def identity(
    dim: int = 3, batch_shape=(), dtype=torch.float32, device="cuda"
) -> Transform:
    dev = resolve_device(device)
    eye = torch.eye(dim, dtype=dtype, device=dev).expand(
        tuple(batch_shape) + (dim, dim)
    )
    t = torch.zeros(tuple(batch_shape) + (dim,), dtype=dtype, device=dev)
    return Transform(eye, t)


def from_matrix(m: torch.Tensor) -> Transform:
    """Build from a homogeneous ``(..., D+1, D+1)`` (or ``(..., D, D+1)``)
    matrix."""
    d = m.shape[-1] - 1
    return Transform(m[..., :d, :d], m[..., :d, d])


def compose(a: Transform, b: Transform) -> Transform:
    """``a ∘ b``: apply ``b`` first, then ``a``."""
    linear = torch.einsum("...ij,...jk->...ik", a.linear, b.linear)
    translation = (
        torch.einsum("...ij,...j->...i", a.linear, b.translation)
        + a.translation
    )
    return Transform(linear, translation)


def inverse(tf: Transform, rigid: bool = True) -> Transform:
    if rigid:
        rt = tf.linear.transpose(-1, -2)
    else:
        rt = torch.linalg.inv(tf.linear)
    return Transform(rt, -torch.einsum("...ij,...j->...i", rt, tf.translation))


def transform_points(tf: Transform, points: torch.Tensor) -> torch.Tensor:
    """One transform applied to points ``(..., D)``, or a transform set
    ``(N,)`` applied point by point to ``(N, D)``."""
    return torch.einsum("...ij,...j->...i", tf.linear, points) + tf.translation


def normal_matrix(tf: Transform, rigid: bool = True) -> torch.Tensor:
    """Rotation for rigid transforms, inverse-transpose for affine ones."""
    if rigid:
        return tf.linear
    return torch.linalg.inv(tf.linear).transpose(-1, -2)


def transform_normals(
    tf: Transform, normals: torch.Tensor, rigid: bool = True
) -> torch.Tensor:
    n = torch.einsum("...ij,...j->...i", normal_matrix(tf, rigid), normals)
    if not rigid:
        n = n / torch.clamp(
            torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-30
        )
    return n


def project_to_rotation(linear: torch.Tensor) -> torch.Tensor:
    """Closest rotation (SVD, det-sign-corrected)."""
    u, _, vt = torch.linalg.svd(linear)
    r = torch.einsum("...ij,...jk->...ik", u, vt)
    det = torch.linalg.det(r)
    # Flip the last column of U where det < 0 to land in SO(D).
    sign = torch.where(det < 0, -1.0, 1.0).to(u.dtype)
    u_fix = torch.cat([u[..., :, :-1], u[..., :, -1:] * sign[..., None, None]], -1)
    return torch.einsum("...ij,...jk->...ik", u_fix, vt)


def reproject_rigid(tf: Transform) -> Transform:
    return Transform(project_to_rotation(tf.linear), tf.translation)


def _cross_matrix(x, y, z) -> torch.Tensor:
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


def skew3(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix ``[v]×`` for ``v (..., 3)`` → ``(..., 3, 3)``."""
    return _cross_matrix(v[..., 0], v[..., 1], v[..., 2])


def axis_angle_to_rotation(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, ``omega`` ``(..., 3)``. Safe at ``omega == 0``."""
    theta = torch.linalg.vector_norm(omega, dim=-1, keepdim=True)
    small = theta < 1e-8
    axis = omega / torch.where(small, torch.ones_like(theta), theta)
    k = skew3(axis)
    th = theta[..., None]
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    r = eye + torch.sin(th) * k + (1.0 - torch.cos(th)) * (k @ k)
    return torch.where(small[..., None], eye + k * th, r)


def gn_update_3d(step: torch.Tensor) -> Transform:
    """Small-angle GN step ``[omega; t]`` (6,) → rigid transform, with the
    rotation ``R(atan‖ω‖, ω̂)``."""
    omega, t = step[..., :3], step[..., 3:]
    theta = torch.linalg.vector_norm(omega, dim=-1, keepdim=True)
    scale = torch.where(
        theta > 1e-12,
        torch.atan(theta) / torch.clamp(theta, min=1e-30),
        torch.ones_like(theta),
    )
    return Transform(axis_angle_to_rotation(omega * scale), t)
