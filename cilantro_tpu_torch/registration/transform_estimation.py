"""Closed-form and Gauss-Newton transform estimators (port of
``cilantro_tpu/registration/transform_estimation.py``).

Every estimator takes gathered, weighted correspondence arrays (weight 0
drops a row) and returns ``(Transform, valid)``. The JAX package's
``lax.while_loop`` of the GN estimators is a Python loop here; it reads the
step norm back to the host (one sync) only when another iteration is
allowed, so the default single iteration never syncs.

A batch of independent problems is told by the input's rank, and rank-2
inputs keep their exact ops. The point-to-point fits take a leading
hypothesis axis (``(H, N, D)``, what the JAX package's RANSAC gets from a
``vmap``); the 3-D combined and symmetric metrics take a batch of B
problems (``(B, N, 3)`` arrays, ``(B, N)`` weights) and return ``(B,)``
transforms. A GN batch runs every iteration, each problem's estimate
frozen once its own step norm falls below the tolerance, and never reads
back to the host. The 2-D metrics take one problem.

One 3-D problem of float32 CUDA tensors takes the three launches of
``csrc/gn_kernels.cu`` (:mod:`.gn_step`) instead of the einsum path: the
same step, summed in float64 in a fixed order. Every other input (the CPU,
2-D, a batch, another type, no GN iteration: the uncentred identity) keeps
the einsum path's ops. Each GN iteration leaves a ``gn_step_route_fused``
or ``gn_step_route_plain`` counter (:func:`..utils.profiling.count`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.transforms import (
    Transform,
    axis_angle_to_rotation,
    compose,
    per_stream,
    project_to_rotation,
    rot2d,
    skew3,
)
from ..utils.profiling import count
from . import gn_step

_EPS = 1e-12


def _weighted_means(src, dst, w):
    if w.dim() > 1:  # a batch of problems: sums over the point axis
        wsum = torch.clamp(torch.sum(w, -1), min=_EPS)[..., None]
        return (torch.sum(w[..., None] * src, -2) / wsum, torch.sum(w[..., None] * dst, -2) / wsum,
                wsum)
    wsum = torch.clamp(torch.sum(w), min=_EPS)
    mu_s = torch.einsum("n,ni->i", w, src) / wsum
    mu_d = torch.einsum("n,ni->i", w, dst) / wsum
    return mu_s, mu_d, wsum


def _ones(shape, like):
    return torch.ones(shape, dtype=like.dtype, device=like.device)


def _zeros(shape, like):
    return torch.zeros(shape, dtype=like.dtype, device=like.device)


def _eye(d, like):
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _batched_outer_sum(w, a, b):
    """``Σ_n w a bᵀ`` over the point axis of ``(..., N, I)``, ``(..., N, J)``
    as a broadcast product: each hypothesis's sum, not a batched GEMM."""
    return torch.sum((w[..., None] * a)[..., :, None] * b[..., None, :], -3)


def estimate_rigid_point_to_point(
    src: torch.Tensor,
    dst: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[Transform, torch.Tensor]:
    """Closed-form weighted Kabsch/Umeyama rigid fit ``R src + t ≈ dst``
    for ``(N, D)`` correspondences, or a batch ``(H, N, D)`` of them.
    Returns the transform and whether at least D correspondences carry
    weight. 3×3 float32 fits on the card project through the rotation
    kernel, other sizes through the SVD."""
    d = src.shape[-1]
    if src.dim() > 2:
        w = _ones(src.shape[:-1], src) if weights is None else weights
        mu_s, mu_d, _ = _weighted_means(src, dst, w)
        c = _batched_outer_sum(w, dst - mu_d[..., None, :], src - mu_s[..., None, :])
        r = project_to_rotation(c)
        t = mu_d - torch.einsum("...ij,...j->...i", r, mu_s)
        return Transform(r, t), torch.sum(w > 0, -1) >= d
    n = src.shape[0]
    w = _ones(n, src) if weights is None else weights
    mu_s, mu_d, _ = _weighted_means(src, dst, w)
    cs = src - mu_s
    cd = dst - mu_d
    # Cross-covariance C = Σ w d̃ s̃ᵀ  → R = U diag(1..det) Vᵀ.
    c = torch.einsum("n,ni,nj->ij", w, cd, cs)
    r = project_to_rotation(c)
    t = mu_d - r @ mu_s
    valid = torch.sum(w > 0) >= d
    return Transform(r, t), valid


def estimate_affine_point_to_point(
    src: torch.Tensor,
    dst: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[Transform, torch.Tensor]:
    """Closed-form weighted affine least-squares fit on mean-centred
    homogeneous coordinates, for ``(N, D)`` or a batch ``(H, N, D)``."""
    d = src.shape[-1]
    if src.dim() > 2:
        w = _ones(src.shape[:-1], src) if weights is None else weights
        mu_s, mu_d, _ = _weighted_means(src, dst, w)
        x = torch.cat([src - mu_s[..., None, :], _ones(src.shape[:-1] + (1,), src)], dim=-1)
        xtx = _batched_outer_sum(w, x, x) + _EPS * _eye(d + 1, src)
        xtd = _batched_outer_sum(w, x, dst - mu_d[..., None, :])
        beta = torch.linalg.solve_ex(xtx, xtd, check_errors=False)[0]
        a = beta[..., :d, :].transpose(-1, -2)
        t = beta[..., d, :] + mu_d - torch.einsum("...ij,...j->...i", a, mu_s)
        return Transform(a, t), torch.sum(w > 0, -1) >= d + 1
    n = src.shape[0]
    w = _ones(n, src) if weights is None else weights
    mu_s, mu_d, _ = _weighted_means(src, dst, w)
    cs = src - mu_s
    cd = dst - mu_d
    x = torch.cat([cs, _ones(n, src)[:, None]], dim=1)  # (N, D+1)
    xtx = torch.einsum("n,ni,nj->ij", w, x, x)
    xtd = torch.einsum("n,ni,nj->ij", w, x, cd)  # (D+1, D)
    xtx = xtx + _EPS * _eye(d + 1, src)
    beta = torch.linalg.solve(xtx, xtd)
    a = beta[:d].T
    t0 = beta[d]
    # Undo centring: A (s - mu_s) + t0 + mu_d = A s + (t0 + mu_d - A mu_s).
    t = t0 + mu_d - a @ mu_s
    valid = torch.sum(w > 0) >= d + 1
    return Transform(a, t), valid


def _solve_normal_equations(jtj, jtr, dof, damping=0.0):
    """``solve_ex`` without its error check: ``solve`` checks the info
    code on the host, which a CUDA graph capture cannot hold. The damping
    keeps ``jtj`` regular."""
    jtj = jtj + (damping + _EPS) * _eye(dof, jtj)
    return torch.linalg.solve_ex(jtj, jtr, check_errors=False)[0]


def _gn_accumulate_3d(src, dst, dst_normals, w_pp, w_pl, omega_points=None):
    """One JᵀJ / Jᵀr accumulation for the 3-D combined metric, unknowns
    ``x = [ω; t]``. Point-to-plane rows: residual ``nᵀ(s − d)``,
    ``J = [(p × n)ᵀ | nᵀ]``; point-to-point rows: residual ``s − d``,
    ``J = [−[p]× | I]``, accumulated blockwise. ``p`` is ``omega_points``
    (default ``src``)."""
    if src.dim() > 2:
        return _gn_accumulate_3d_batched(src, dst, dst_normals, w_pp, w_pl, omega_points)
    p = src if omega_points is None else omega_points

    sxn = torch.linalg.cross(p, dst_normals, dim=-1)
    j_pl = torch.cat([sxn, dst_normals], dim=1)  # (N, 6)
    r_pl = torch.einsum("ni,ni->n", dst_normals, src - dst)
    jtj = torch.einsum("n,ni,nj->ij", w_pl, j_pl, j_pl)
    jtr = -torch.einsum("n,ni,n->i", w_pl, j_pl, r_pl)

    sk = skew3(p)  # (N, 3, 3); J_ω = −sk
    r_pp = src - dst
    jtj_ww = torch.einsum("n,nki,nkj->ij", w_pp, sk, sk)
    jtj_wt = torch.einsum("n,nij->ij", w_pp, sk)
    jtj_tt = torch.sum(w_pp) * _eye(3, src)
    jtr_w = -torch.einsum("n,nki,nk->i", w_pp, -sk, r_pp)
    jtr_t = -torch.einsum("n,ni->i", w_pp, r_pp)

    block = torch.cat(
        [torch.cat([jtj_ww, jtj_wt], dim=1), torch.cat([jtj_wt.T, jtj_tt], dim=1)], dim=0
    )
    return jtj + block, jtr + torch.cat([jtr_w, jtr_t])


def _gn_accumulate_3d_batched(src, dst, dst_normals, w_pp, w_pl, omega_points=None):
    """:func:`_gn_accumulate_3d` for a batch of problems (``(B, N, 3)``,
    weights ``(B, N)``): the same sums, each a broadcast product summed over
    the point axis. As batched GEMMs (``torch.einsum``'s route), cuBLAS
    takes about 2 ms for each 6×6 sum over 8 × 76,800 rows on an H100."""
    p = src if omega_points is None else omega_points

    sxn = torch.linalg.cross(p, dst_normals, dim=-1)
    j_pl = torch.cat([sxn, dst_normals], dim=-1)  # (B, N, 6)
    r_pl = torch.sum(dst_normals * (src - dst), -1)
    wj = w_pl[..., None] * j_pl
    jtj = torch.sum(wj[..., :, None] * j_pl[..., None, :], -3)
    jtr = -torch.sum(wj * r_pl[..., None], -2)

    sk = skew3(p)  # (B, N, 3, 3); J_ω = −sk
    r_pp = src - dst
    wsk = w_pp[..., None, None] * sk
    jtj_ww = torch.sum(wsk[..., :, :, None] * sk[..., :, None, :], (-4, -3))
    jtj_wt = torch.sum(wsk, -3)
    jtj_tt = torch.sum(w_pp, -1)[..., None, None] * _eye(3, src)
    jtr_w = torch.sum(wsk * r_pp[..., None], (-3, -2))
    jtr_t = -torch.sum(w_pp[..., None] * r_pp, -2)

    block = torch.cat(
        [torch.cat([jtj_ww, jtj_wt], dim=-1),
         torch.cat([jtj_wt.transpose(-1, -2), jtj_tt], dim=-1)], dim=-2
    )
    return jtj + block, jtr + torch.cat([jtr_w, jtr_t], dim=-1)


def _gn_accumulate_2d(src, dst, dst_normals, w_pp, w_pl, omega_points=None):
    """The 2-D combined metric's JᵀJ / Jᵀr, unknowns ``x = [θ; t]``, with
    ``dR/dθ|₀ p = (−p_y, p_x)``; one problem ``(N, 2)``."""
    if src.dim() > 2:
        raise ValueError("the 2-D metrics take one problem (N, 2), not a batch")
    p = src if omega_points is None else omega_points
    ds = torch.stack([-p[:, 1], p[:, 0]], dim=1)  # (N, 2)

    j_pl = torch.cat([torch.einsum("ni,ni->n", ds, dst_normals)[:, None], dst_normals], dim=1)
    r_pl = torch.einsum("ni,ni->n", dst_normals, src - dst)
    jtj = torch.einsum("n,ni,nj->ij", w_pl, j_pl, j_pl)
    jtr = -torch.einsum("n,ni,n->i", w_pl, j_pl, r_pl)

    r_pp = src - dst
    # J_pp = [ds | I] (2 rows per correspondence).
    jtj_tt = torch.sum(w_pp) * _eye(2, src)
    jtj_aa = torch.einsum("n,ni,ni->", w_pp, ds, ds)[None, None]
    jtj_at = torch.einsum("n,ni->i", w_pp, ds)[None, :]
    jtr_a = -torch.einsum("n,ni,ni->", w_pp, ds, r_pp)[None]
    jtr_t = -torch.einsum("n,ni->i", w_pp, r_pp)
    block = torch.cat(
        [torch.cat([jtj_aa, jtj_at], dim=1), torch.cat([jtj_at.T, jtj_tt], dim=1)], dim=0
    )
    return jtj + block, jtr + torch.cat([jtr_a, jtr_t])


def _two_sided_update_3d(step):
    """GN update ``Ra · T(cos θ · t) · Ra`` with ``θ = atan‖ω‖``: the
    rotation on both sides of the cos-scaled translation. ``step (..., 6)``."""
    omega, t = step[..., :3], step[..., 3:]
    na = torch.linalg.vector_norm(omega, dim=-1)
    theta = torch.atan(na)
    scale = torch.where(na > _EPS, theta / torch.clamp(na, min=_EPS), 1.0)
    half_r = axis_angle_to_rotation(omega * scale[..., None])
    ta = torch.cos(theta)[..., None] * t
    zero = torch.zeros_like(t)
    return compose(
        Transform(half_r, zero),
        compose(Transform(_eye(3, step), ta), Transform(half_r, zero)),
    )


def _two_sided_update_2d(step):
    """2-D analogue: ``Ra · T(cos θ · t) · Ra`` with ``θ = atan(step₀)``."""
    theta = torch.atan(step[0])
    half_r = rot2d(theta, dtype=step.dtype)
    ta = torch.cos(theta) * step[1:]
    zero = torch.zeros_like(ta)
    return compose(
        Transform(half_r, zero),
        compose(Transform(_eye(2, step), ta), Transform(half_r, zero)),
    )


def _gauss_newton(src_c, dst_c, w_pp, w_pl, normals_of, max_iterations, convergence_tol):
    """The GN loop shared by the combined and symmetric metrics, in centred
    coordinates: iterate while ``it < max_iterations`` and the last step
    norm ≥ ``convergence_tol``. A batch of problems runs every iteration
    with each problem's transform frozen once its condition fails."""
    d = src_c.shape[-1]
    acc, delta_of, dof = ((_gn_accumulate_3d, _two_sided_update_3d, 6) if d == 3
                          else (_gn_accumulate_2d, _two_sided_update_2d, 3))
    batch = src_c.shape[:-2]
    tf = Transform(_eye(d, src_c).expand(batch + (d, d)), _zeros(batch + (d,), src_c))
    active = torch.ones(batch, dtype=torch.bool, device=src_c.device) if batch else None
    for it in range(max_iterations):
        count("gn_step_route_plain", 1)
        s = (per_stream(tf) if batch else tf).apply(src_c)
        # Rotation rows couple (d + s): the two-sided linearization.
        jtj, jtr = acc(s, dst_c, normals_of(tf), w_pp, w_pl, omega_points=s + dst_c)
        step = _solve_normal_equations(jtj, jtr, dof)
        new_tf = compose(delta_of(step), tf)
        if batch:
            tf = Transform(torch.where(active[..., None, None], new_tf.linear, tf.linear),
                           torch.where(active[..., None], new_tf.translation, tf.translation))
            active = active & (torch.linalg.vector_norm(step, dim=-1) >= convergence_tol)
            continue
        tf = new_tf
        if it + 1 < max_iterations and not (
            torch.linalg.vector_norm(step).item() >= convergence_tol
        ):
            break
    return tf


def _uncentre(tf, mu_s, mu_d):
    """``T(μ_d) ∘ tf ∘ T(−μ_s)``, ``μ`` of shape ``(..., D)``."""
    eye = _eye(tf.dim, mu_s)
    return compose(Transform(eye, mu_d), compose(tf, Transform(eye, -mu_s)))


def estimate_rigid_combined_metric(
    src: torch.Tensor,
    dst: torch.Tensor,
    dst_normals: torch.Tensor,
    *,
    point_weights: Optional[torch.Tensor] = None,
    plane_weights: Optional[torch.Tensor] = None,
    max_iterations: int = 1,
    convergence_tol: float = 1e-5,
) -> Tuple[Transform, torch.Tensor]:
    """Rigid combined point-to-point + point-to-plane Gauss-Newton (2-D or
    3-D): mean-centred coordinates, (d + s)-coupled rotation rows and the
    two-sided update."""
    d = src.shape[-1]
    if d not in (2, 3):
        raise ValueError(f"the rigid metrics take 2-D or 3-D points, got D={d}")
    if max_iterations >= 1 and gn_step.takes(src, dst, dst_normals, point_weights, plane_weights):
        return gn_step.gauss_newton_3d(src, dst, None, dst_normals, point_weights, plane_weights,
                                       max_iterations, convergence_tol)
    w_pp = _zeros(src.shape[:-1], src) if point_weights is None else point_weights
    w_pl = _ones(src.shape[:-1], src) if plane_weights is None else plane_weights
    mu_s, mu_d, _ = _weighted_means(src, dst, w_pp + w_pl)
    tf = _gauss_newton(
        src - mu_s[..., None, :], dst - mu_d[..., None, :], w_pp, w_pl, lambda tf: dst_normals,
        max_iterations, convergence_tol,
    )
    valid = torch.sum((w_pp + w_pl) > 0, -1) >= d
    return _uncentre(tf, mu_s, mu_d), valid


def estimate_rigid_symmetric_metric(
    src: torch.Tensor,
    dst: torch.Tensor,
    src_normals: torch.Tensor,
    dst_normals: torch.Tensor,
    *,
    point_weights: Optional[torch.Tensor] = None,
    plane_weights: Optional[torch.Tensor] = None,
    max_iterations: int = 1,
    convergence_tol: float = 1e-5,
) -> Tuple[Transform, torch.Tensor]:
    """Symmetric-metric rigid Gauss-Newton (2-D or 3-D): plane rows use the
    un-normalized ``n = n_dst + R n_src``, the update is two-sided."""
    d = src.shape[-1]
    if d not in (2, 3):
        raise ValueError(f"the rigid metrics take 2-D or 3-D points, got D={d}")
    if max_iterations >= 1 and gn_step.takes(src, dst, src_normals, dst_normals, point_weights,
                                             plane_weights):
        return gn_step.gauss_newton_3d(src, dst, src_normals, dst_normals, point_weights,
                                       plane_weights, max_iterations, convergence_tol)
    w_pp = _zeros(src.shape[:-1], src) if point_weights is None else point_weights
    w_pl = _ones(src.shape[:-1], src) if plane_weights is None else plane_weights
    mu_s, mu_d, _ = _weighted_means(src, dst, w_pp + w_pl)
    batched = src.dim() == 3
    tf = _gauss_newton(
        src - mu_s[..., None, :], dst - mu_d[..., None, :], w_pp, w_pl,
        lambda tf: dst_normals + (per_stream(tf) if batched else tf).apply_normals(src_normals),
        max_iterations, convergence_tol,
    )
    valid = torch.sum((w_pp + w_pl) > 0, -1) >= d
    return _uncentre(tf, mu_s, mu_d), valid


def estimate_affine_combined_metric(
    src: torch.Tensor,
    dst: torch.Tensor,
    dst_normals: torch.Tensor,
    *,
    point_weights: Optional[torch.Tensor] = None,
    plane_weights: Optional[torch.Tensor] = None,
) -> Tuple[Transform, torch.Tensor]:
    """Affine combined-metric closed form: one least-squares solve over the
    D(D+1) unknowns ``x = vec_rows(A − I) ++ t`` in centred coordinates."""
    n, d = src.shape
    w_pp = _zeros(n, src) if point_weights is None else point_weights
    w_pl = _ones(n, src) if plane_weights is None else plane_weights
    dof = d * d + d

    mu_s, mu_d, _ = _weighted_means(src, dst, w_pp + w_pl)
    cs = src - mu_s
    cd = dst - mu_d

    j_pl = torch.cat(
        [torch.einsum("ni,nj->nij", dst_normals, cs).reshape(n, d * d), dst_normals], dim=1
    )
    r_pl = torch.einsum("ni,ni->n", dst_normals, cs - cd)
    jtj = torch.einsum("n,ni,nj->ij", w_pl, j_pl, j_pl)
    jtr = -torch.einsum("n,ni,n->i", w_pl, j_pl, r_pl)

    ss = torch.einsum("n,ni,nj->ij", w_pp, cs, cs)
    s1 = torch.einsum("n,ni->i", w_pp, cs)
    wsum = torch.sum(w_pp)
    sd = torch.einsum("n,ni,nj->ij", w_pp, cs, cd)
    d1 = torch.einsum("n,ni->i", w_pp, cd)
    jtj = jtj.clone()
    jtr = jtr.clone()
    for k in range(d):
        rows = slice(k * d, (k + 1) * d)
        jtj[rows, rows] += ss
        jtj[rows, d * d + k] += s1
        jtj[d * d + k, rows] += s1
        jtj[d * d + k, d * d + k] += wsum
        jtr[rows] += sd[:, k] - ss[:, k]
        jtr[d * d + k] += d1[k] - s1[k]

    x = _solve_normal_equations(jtj, jtr, dof)
    a = _eye(d, src) + x[: d * d].reshape(d, d)
    t = x[d * d :] + mu_d - a @ mu_s
    valid = torch.sum((w_pp + w_pl) > 0) >= d + 1
    return Transform(a, t), valid


def residuals_combined_metric(
    tf: Transform,
    src: torch.Tensor,
    dst: torch.Tensor,
    dst_normals: Optional[torch.Tensor],
    point_weight: float = 0.0,
    plane_weight: float = 1.0,
) -> torch.Tensor:
    """Per-correspondence residual ``w_p‖d−s‖² + w_n (n·(d−s))²``."""
    s = tf.apply(src)
    diff = dst - s
    r = point_weight * torch.sum(diff * diff, dim=-1)
    if dst_normals is not None and plane_weight != 0.0:
        dn = torch.einsum("ni,ni->n", dst_normals, diff)
        r = r + plane_weight * dn * dn
    return r
