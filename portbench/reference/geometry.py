"""Plain PyTorch geometry for the reference pipelines: rigid transforms,
depth back-projection with normals, pixel projection, the z-buffer winner
and the 3×3 rotation projection.

A frozen copy of the float32 expressions of the fusion pipelines the
benchmark measures, in plain tensor operations (no kernel, no CUDA graph,
nothing imported from the measured package), so that run eagerly on the
same depth frames they give the same poses and maps to float32 round-off.

Every matrix product goes through :func:`ein`. Inside :func:`tf32` its
operands are rounded to TF32 (a 10-bit mantissa) before the float32
product, as a tensor core computes a float32 GEMM with TF32 allowed: the
benchmark's control runs the reference so, one precision below the float32
with TF32 off that the configurations state. Inside :func:`float64` it
computes in float64: how far that moves a clip's poses shows how far
rounding alone decides them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import numpy as np
import torch

_STATE = {"tf32": False, "real": torch.float32}


def real() -> torch.dtype:
    """The floating type the reference computes in: float32, or float64
    inside :func:`float64`."""
    return _STATE["real"]


@contextlib.contextmanager
def _set(key, value):
    old = _STATE[key]
    _STATE[key] = value
    try:
        yield
    finally:
        _STATE[key] = old


def tf32():
    """Round every matrix product's operands to TF32 inside the block."""
    return _set("tf32", True)


def float64():
    """Compute in float64 inside the block: the probe of how far rounding
    alone moves a clip's result."""
    return _set("real", torch.float64)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties to even:
    the low 13 mantissa bits cleared. Inf and NaN pass unchanged."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + lsb) >> 13) << 13
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)


def ein(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``, with TF32 operands inside :func:`tf32`."""
    if _STATE["tf32"]:
        ops = tuple(round_tf32(o) for o in ops)
    return torch.einsum(spec, *ops)


def f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of ``like``'s type: dividing by it is a true division
    on every device (CUDA turns a division by a Python number into a
    product)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def make(fx, fy, cx, cy) -> "Intrinsics":
        return Intrinsics(*(float(np.float32(v)) for v in (fx, fy, cx, cy)))


@dataclasses.dataclass(frozen=True)
class Rigid:
    """``x -> R x + t``; leading dimensions are a batch."""

    linear: torch.Tensor
    translation: torch.Tensor

    def apply(self, p: torch.Tensor) -> torch.Tensor:
        return ein("...ij,...j->...i", self.linear, p) + self.translation

    def rotate(self, n: torch.Tensor) -> torch.Tensor:
        return ein("...ij,...j->...i", self.linear, n)

    def per_stream(self) -> "Rigid":
        """A batch ``(B,)`` with a point axis added, ``(B, 1)``."""
        return Rigid(self.linear[..., None, :, :], self.translation[..., None, :])

    def matrix(self) -> torch.Tensor:
        m = self.linear.new_zeros(self.linear.shape[:-2] + (4, 4))
        m[..., :3, :3] = self.linear
        m[..., :3, 3] = self.translation
        m[..., 3, 3] = 1.0
        return m


def identity(batch=(), device="cpu") -> Rigid:
    eye = torch.eye(3, dtype=real(), device=device).expand(tuple(batch) + (3, 3))
    return Rigid(eye, torch.zeros(tuple(batch) + (3,), dtype=real(), device=device))


def compose(a: Rigid, b: Rigid) -> Rigid:
    """``a ∘ b``: ``b`` first."""
    return Rigid(ein("...ij,...jk->...ik", a.linear, b.linear),
                 ein("...ij,...j->...i", a.linear, b.translation) + a.translation)


def inverse(tf: Rigid) -> Rigid:
    rt = tf.linear.transpose(-1, -2)
    return Rigid(rt, -ein("...ij,...j->...i", rt, tf.translation))


def skew3(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def axis_angle_to_rotation(omega: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.vector_norm(omega, dim=-1, keepdim=True)
    small = theta < 1e-8
    k = skew3(omega / torch.where(small, torch.ones_like(theta), theta))
    th = theta[..., None]
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    r = eye + torch.sin(th) * k + (1.0 - torch.cos(th)) * ein("...ij,...jk->...ik", k, k)
    return torch.where(small[..., None], eye + k * th, r)


def gn_update(step: torch.Tensor) -> Rigid:
    """GN step ``[ω; t]`` → ``(R(atan‖ω‖, ω̂), t)``."""
    omega, t = step[..., :3], step[..., 3:]
    theta = torch.linalg.vector_norm(omega, dim=-1, keepdim=True)
    scale = torch.where(theta > 1e-12, torch.atan(theta) / torch.clamp(theta, min=1e-30),
                        torch.ones_like(theta))
    return Rigid(axis_angle_to_rotation(omega * scale), t)


def _dot3(x, y):
    return (x[0] * y[0] + x[1] * y[1]) + x[2] * y[2]


def _cross3(x, y):
    return [x[1] * y[2] - x[2] * y[1], x[2] * y[0] - x[0] * y[2], x[0] * y[1] - x[1] * y[0]]


def project_to_rotation(linear: torch.Tensor) -> torch.Tensor:
    """Closest rotation to ``(..., 3, 3)``: ``u1 v1ᵀ + u2 v2ᵀ + (u1 × u2)(v1
    × v2)ᵀ`` from the two largest eigenvectors of ``AᵀA`` (cyclic Jacobi,
    4 sweeps), elementwise ops in a fixed order."""
    a = [[linear[..., i, j] for j in range(3)] for i in range(3)]
    b = [[_dot3([a[0][i], a[1][i], a[2][i]], [a[0][j], a[1][j], a[2][j]]) for j in range(3)]
         for i in range(3)]
    one, zero = torch.ones_like(a[0][0]), torch.zeros_like(a[0][0])
    v = [[one if i == j else zero for j in range(3)] for i in range(3)]
    for _ in range(4):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            r = 3 - p - q
            apq = b[p][q]
            theta = (b[q][q] - b[p][p]) / (2.0 * apq)
            t = torch.where(theta >= 0, 1.0, -1.0) / (
                torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
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


def reproject(tf: Rigid) -> Rigid:
    return Rigid(project_to_rotation(tf.linear), tf.translation)


def depth_to_points_normals(depth: torch.Tensor, k: Intrinsics, max_jump: float = 0.05):
    """``(points (..., H·W, 3), normals, valid)`` in the camera frame from
    ``depth (..., H, W)``: normals from the cross product of the central
    differences, flipped toward the camera, zero and invalid next to a
    depth jump or on the border; invalid points at 1e30."""
    h, w = depth.shape[-2:]
    batch = depth.shape[:-2]
    u = torch.arange(w, dtype=real(), device=depth.device)[None, :]
    v = torch.arange(h, dtype=real(), device=depth.device)[:, None]
    z = depth
    x = (u - k.cx) * z / f32(k.fx, z)
    y = (v - k.cy) * z / f32(k.fy, z)
    pts = torch.stack([x, y, z], dim=-1)
    valid = z > 0
    du = torch.roll(pts, -1, dims=-2) - torch.roll(pts, 1, dims=-2)
    dv = torch.roll(pts, -1, dims=-3) - torch.roll(pts, 1, dims=-3)
    nrm = torch.linalg.cross(dv, du, dim=-1)
    nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1, keepdim=True), min=1e-30)
    nrm = torch.where(torch.sum(nrm * pts, dim=-1, keepdim=True) > 0, -nrm, nrm)
    nvalid = valid.clone()
    for shift, dim in ((-1, -1), (1, -1), (-1, -2), (1, -2)):
        nvalid &= torch.roll(valid, shift, dims=dim)
        nvalid &= ~(torch.abs(torch.roll(z, shift, dims=dim) - z) > max_jump)
    nvalid[..., 0, :] = False
    nvalid[..., -1, :] = False
    nvalid[..., :, 0] = False
    nvalid[..., :, -1] = False
    pts = torch.where(valid[..., None], pts, 1e30).reshape(batch + (-1, 3))
    nrm = torch.where(nvalid[..., None], nrm, 0.0).reshape(batch + (-1, 3))
    return pts, nrm, (valid & nvalid).reshape(batch + (-1,))


def _floor_int32(x: torch.Tensor) -> torch.Tensor:
    f = torch.floor(x)
    big, small = f >= 2.0**31, f < -(2.0**31)
    i = torch.where(big | small | torch.isnan(f), 0.0, f).to(torch.int32)
    return torch.where(big, 2**31 - 1, torch.where(small, -(2**31), i))


def project(points: torch.Tensor, k: Intrinsics):
    """Camera-frame points → ``(u, v)`` int32 (rounded half to even,
    saturating) and depth."""
    z = points[..., 2]
    safe = torch.where(z > 0, z, 1.0)
    u = torch.round(points[..., 0] * k.fx / safe + k.cx)
    v = torch.round(points[..., 1] * k.fy / safe + k.cy)
    return _floor_int32(u), _floor_int32(v), z


_EMPTY = 2**31 - 1


def zbuffer(points: torch.Tensor, valid: torch.Tensor, k: Intrinsics, h: int, w: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel winner of B streams' camera-frame ``points (B, N, 3)``:
    ``(index (B, H, W) int32 local to the stream, -1 empty; depth (B, H,
    W), 0 empty)``. The winner holds the smallest packed key, depth
    quantized to ``2^(31 - bits)`` levels of ``[0, z_max]`` above the row's
    index, over all streams' rows at once (``bits`` from ``B·N``, capped at
    20; rows in groups of 2^20 whose images merge by a key min, earlier
    group first on ties)."""
    bsz, n, _ = points.shape
    dev = points.device
    u, v, z = project(points.reshape(bsz * n, 3), k)
    ok = valid.reshape(-1) & (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    total, npix, group = bsz * n, bsz * h * w, 1 << 20
    bits = min(max(total - 1, 1).bit_length(), 20)
    levels = float(1 << (31 - bits))
    stream = torch.arange(total, dtype=torch.int32, device=dev) // n
    tgt = torch.where(ok, stream * (h * w) + (v * w + u), npix).long()
    z_max = torch.max(torch.where(ok, z, 0.0)) + 1e-6
    zq = torch.clamp(z * (f32(levels, z) / z_max), 0, levels - 2).to(torch.int32)
    best = best_g = None
    for g in range((total + group - 1) // group):
        lo, hi = g * group, min((g + 1) * group, total)
        key = torch.where(ok[lo:hi], (zq[lo:hi] << bits)
                          | torch.arange(hi - lo, dtype=torch.int32, device=dev), _EMPTY)
        img = torch.full((npix + 1,), _EMPTY, dtype=torch.int32, device=dev)
        img = img.scatter_reduce_(0, tgt[lo:hi], key, "amin")[:npix]
        if best is None:
            best, best_g = img, torch.zeros_like(img)
        else:
            better = img < best
            best, best_g = torch.where(better, img, best), torch.where(better, g, best_g)
    has = best != _EMPTY
    glob = torch.where(has, (best & ((1 << bits) - 1)) + best_g * group, 0)
    pix_stream = torch.arange(npix, dtype=torch.int32, device=dev) // (h * w)
    idx = torch.where(has, glob - pix_stream * n, -1)
    depth = torch.where(has, z[glob.long()], 0.0)
    return idx.reshape(bsz, h, w), depth.reshape(bsz, h, w)
