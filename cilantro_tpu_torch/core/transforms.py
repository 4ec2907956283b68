"""Rigid/affine transforms (port of ``cilantro_tpu/core/transforms.py``).

A transform is a frozen ``Transform(linear, translation)`` of tensors whose
leading dimensions are batch dimensions; every op broadcasts over them. The
arithmetic follows the JAX module expression for expression, so the two
agree to float32 roundoff.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import native, resolve_device


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

    @property
    def batch_shape(self):
        return self.linear.shape[:-2]

    def __matmul__(self, other: "Transform") -> "Transform":
        return compose(self, other)

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        return transform_points(self, points)

    def apply_normals(self, normals: torch.Tensor, rigid: bool = True) -> torch.Tensor:
        return transform_normals(self, normals, rigid=rigid)

    def inverse(self, rigid: bool = True) -> "Transform":
        return inverse(self, rigid=rigid)

    def matrix(self) -> torch.Tensor:
        """Homogeneous ``(..., D+1, D+1)`` matrix."""
        d = self.dim
        m = self.linear.new_zeros(self.linear.shape[:-2] + (d + 1, d + 1))
        m[..., :d, :d] = self.linear
        m[..., :d, d] = self.translation
        m[..., d, d].fill_(1.0)  # a fill kernel: a CUDA graph capture can hold it
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


def transform_points_normals(
    tf: Transform, points: torch.Tensor, normals: torch.Tensor, rigid: bool = True
):
    return transform_points(tf, points), transform_normals(tf, normals, rigid=rigid)


def per_stream(tf: Transform) -> Transform:
    """A batch ``(B,)`` of transforms with a point axis added, ``(B, 1)``:
    applied to points ``(B, N, D)``, stream ``b``'s transform moves stream
    ``b``'s points (what the JAX package writes as a ``vmap`` over
    streams)."""
    return Transform(tf.linear[..., None, :, :], tf.translation[..., None, :])


_JACOBI_SWEEPS = 4


def _dot3(x, y):
    return (x[0] * y[0] + x[1] * y[1]) + x[2] * y[2]


def _cross3(x, y):
    return [x[1] * y[2] - x[2] * y[1], x[2] * y[0] - x[0] * y[2], x[0] * y[1] - x[1] * y[0]]


def project_to_rotation_plain(linear: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`project_to_rotation` for ``(..., 3, 3)``:
    ``R = u1 v1ᵀ + u2 v2ᵀ + (u1 × u2)(v1 × v2)ᵀ`` with ``v1, v2`` the
    eigenvectors of ``AᵀA`` of its two largest eigenvalues (cyclic Jacobi,
    4 sweeps, as :func:`.covariance.eigh_sym` but with ``1/sqrt`` for
    ``rsqrt``), ``u1 = A v1 / ‖A v1‖`` and ``u2`` the unit part of ``A v2``
    orthogonal to ``u1``. That is ``U diag(1, 1, det(U Vᵀ)) Vᵀ`` of the SVD,
    with no third singular value needed. Exact zeros fall back so that
    ``A = 0`` gives the identity, as the SVD does. Elementwise ops only,
    each one rounding, in the kernel's order: the two agree bit for bit."""
    a = [[linear[..., i, j] for j in range(3)] for i in range(3)]
    b = [[_dot3([a[0][i], a[1][i], a[2][i]], [a[0][j], a[1][j], a[2][j]]) for j in range(3)]
         for i in range(3)]
    one, zero = torch.ones_like(a[0][0]), torch.zeros_like(a[0][0])
    v = [[one if i == j else zero for j in range(3)] for i in range(3)]
    for _ in range(_JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            r = 3 - p - q
            apq = b[p][q]
            theta = (b[q][q] - b[p][p]) / (2.0 * apq)
            t = torch.where(theta >= 0, 1.0, -1.0) / (
                torch.abs(theta) + torch.sqrt(theta * theta + 1.0)
            )
            t = torch.where(apq == 0, 0.0, t)
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            b[p][p] = b[p][p] - t * apq
            b[q][q] = b[q][q] + t * apq
            b[p][q] = b[q][p] = zero
            brp, brq = b[r][p], b[r][q]
            b[r][p] = b[p][r] = c * brp - s * brq
            b[r][q] = b[q][r] = s * brp + c * brq
            for k in range(3):
                vkp, vkq = v[k][p], v[k][q]
                v[k][p] = c * vkp - s * vkq
                v[k][q] = s * vkp + c * vkq
    # Largest eigenvalue (the first among equals) and smallest (the last).
    d0, d1, d2 = b[0][0], b[1][1], b[2][2]
    i1 = torch.where((d0 >= d1) & (d0 >= d2), 0, torch.where(d1 >= d2, 1, 2))
    i3 = torch.where((d2 <= d1) & (d2 <= d0), 2, torch.where(d1 <= d0, 1, 0))
    i2 = 3 - i1 - i3

    def column(i):
        return [torch.where(i == 0, v[k][0], torch.where(i == 1, v[k][1], v[k][2]))
                for k in range(3)]

    v1, v2 = column(i1), column(i2)
    w1 = [_dot3(a[i], v1) for i in range(3)]
    w2 = [_dot3(a[i], v2) for i in range(3)]
    n1 = torch.sqrt(_dot3(w1, w1))
    u1 = [torch.where(n1 > 0, w1[i] / n1, v1[i]) for i in range(3)]
    d12, e12 = _dot3(u1, w2), _dot3(u1, v2)
    w2 = [w2[i] - d12 * u1[i] for i in range(3)]
    g = [v2[i] - e12 * u1[i] for i in range(3)]
    n2, ng = torch.sqrt(_dot3(w2, w2)), torch.sqrt(_dot3(g, g))
    h = _cross3(u1, v1)
    u2 = [torch.where(n2 > 0, w2[i] / n2, torch.where(ng > 0, g[i] / ng, h[i]))
          for i in range(3)]
    u3, v3 = _cross3(u1, u2), _cross3(v1, v2)
    rows = [torch.stack([(u1[i] * v1[j] + u2[i] * v2[j]) + u3[i] * v3[j] for j in range(3)], -1)
            for i in range(3)]
    return torch.stack(rows, -2)


def project_to_rotation(linear: torch.Tensor) -> torch.Tensor:
    """Closest rotation (det-sign-corrected SVD ``U diag(1, .., det) Vᵀ``).
    3×3 float32 matrices on the card go through the
    ``csrc/rotation_kernels.cu`` kernel, which never waits on the host (a
    GN loop captured in a CUDA graph re-projects through it); on the CPU
    they take its plain version. Other sizes and types take the SVD."""
    if linear.shape[-2:] != (3, 3) or linear.dtype != torch.float32:
        u, _, vt = torch.linalg.svd(linear)
        r = torch.einsum("...ij,...jk->...ik", u, vt)
        det = torch.linalg.det(r)
        # Flip the last column of U where det < 0 to land in SO(D).
        sign = torch.where(det < 0, -1.0, 1.0).to(u.dtype)
        u_fix = torch.cat([u[..., :, :-1], u[..., :, -1:] * sign[..., None, None]], -1)
        return torch.einsum("...ij,...jk->...ik", u_fix, vt)
    name = "project_to_rotation"
    if native.on_cpu(name, linear):
        return project_to_rotation_plain(linear)
    src = linear.contiguous()
    out = torch.empty_like(src)
    n = src.numel() // 9
    if n == 0:
        return out
    if n >= 2**31 // 9:
        raise ValueError(f"{name}: {n} matrices, the kernel indexes with 32 bits")
    native.launch("project_to_rotation_launch", src.data_ptr(), out.data_ptr(), n)
    return out


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


def rot2d(theta: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """2-D rotations ``(..., 2, 2)`` of the angles ``theta (...)``."""
    theta = torch.as_tensor(theta)
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2).to(dtype)


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


def gn_update_2d(step: torch.Tensor) -> Transform:
    """GN step ``[theta; t]`` (3,) → rigid 2-D transform."""
    theta, t = step[..., 0], step[..., 1:]
    return Transform(rot2d(theta, dtype=step.dtype), t)
