"""Closed-form and Gauss-Newton transform estimators (port of the 3-D part of
``cilantro_tpu/registration/transform_estimation.py``; the 2-D variants
wait for a later slice).

Every estimator takes gathered, weighted correspondence arrays (weight 0
drops a row) and returns ``(Transform, valid)``. The JAX package's
``lax.while_loop`` of the GN estimators is a Python loop here; it reads the
step norm back to the host (one sync) only when another iteration is
allowed, so the default single iteration never syncs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.transforms import Transform, axis_angle_to_rotation, compose, skew3

_EPS = 1e-12


def _weighted_means(src, dst, w):
    wsum = torch.clamp(torch.sum(w), min=_EPS)
    mu_s = torch.einsum("n,ni->i", w, src) / wsum
    mu_d = torch.einsum("n,ni->i", w, dst) / wsum
    return mu_s, mu_d, wsum


def _ones(n, like):
    return torch.ones(n, dtype=like.dtype, device=like.device)


def _zeros(n, like):
    return torch.zeros(n, dtype=like.dtype, device=like.device)


def _eye(d, like):
    return torch.eye(d, dtype=like.dtype, device=like.device)


def estimate_rigid_point_to_point(
    src: torch.Tensor,
    dst: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[Transform, torch.Tensor]:
    """Closed-form weighted Kabsch/Umeyama rigid fit ``R src + t ≈ dst``
    for ``(N, D)`` correspondences. Returns the transform and whether at
    least D correspondences carry weight."""
    n, d = src.shape
    w = _ones(n, src) if weights is None else weights
    mu_s, mu_d, _ = _weighted_means(src, dst, w)
    cs = src - mu_s
    cd = dst - mu_d
    # Cross-covariance C = Σ w d̃ s̃ᵀ  → R = U diag(1..det) Vᵀ.
    c = torch.einsum("n,ni,nj->ij", w, cd, cs)
    u, _, vt = torch.linalg.svd(c)
    det = torch.linalg.det(u @ vt)
    sign = torch.where(det < 0, -1.0, 1.0).to(u.dtype)
    u_fix = torch.cat([u[:, :-1], u[:, -1:] * sign], dim=1)
    r = u_fix @ vt
    t = mu_d - r @ mu_s
    valid = torch.sum(w > 0) >= d
    return Transform(r, t), valid


def estimate_affine_point_to_point(
    src: torch.Tensor,
    dst: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[Transform, torch.Tensor]:
    """Closed-form weighted affine least-squares fit on mean-centred
    homogeneous coordinates."""
    n, d = src.shape
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
    jtj = jtj + (damping + _EPS) * _eye(dof, jtj)
    return torch.linalg.solve(jtj, jtr)


def _gn_accumulate_3d(src, dst, dst_normals, w_pp, w_pl, omega_points=None):
    """One JᵀJ / Jᵀr accumulation for the 3-D combined metric, unknowns
    ``x = [ω; t]``. Point-to-plane rows: residual ``nᵀ(s − d)``,
    ``J = [(p × n)ᵀ | nᵀ]``; point-to-point rows: residual ``s − d``,
    ``J = [−[p]× | I]``, accumulated blockwise. ``p`` is ``omega_points``
    (default ``src``)."""
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


def _two_sided_update_3d(step):
    """GN update ``Ra · T(cos θ · t) · Ra`` with ``θ = atan‖ω‖``: the
    rotation on both sides of the cos-scaled translation."""
    omega, t = step[:3], step[3:]
    na = torch.linalg.vector_norm(omega)
    theta = torch.atan(na)
    scale = torch.where(na > _EPS, theta / torch.clamp(na, min=_EPS), 1.0)
    half_r = axis_angle_to_rotation(omega * scale)
    ta = torch.cos(theta) * t
    zero = _zeros(3, step)
    return compose(
        Transform(half_r, zero),
        compose(Transform(_eye(3, step), ta), Transform(half_r, zero)),
    )


def _gauss_newton(src_c, dst_c, w_pp, w_pl, normals_of, max_iterations, convergence_tol):
    """The GN loop shared by the combined and symmetric metrics, in centred
    coordinates: iterate while ``it < max_iterations`` and the last step
    norm ≥ ``convergence_tol``."""
    d = src_c.shape[1]
    tf = Transform(_eye(d, src_c), _zeros(d, src_c))
    for it in range(max_iterations):
        s = tf.apply(src_c)
        # Rotation rows couple (d + s): the two-sided linearization.
        jtj, jtr = _gn_accumulate_3d(
            s, dst_c, normals_of(tf), w_pp, w_pl, omega_points=s + dst_c
        )
        step = _solve_normal_equations(jtj, jtr, 6)
        tf = compose(_two_sided_update_3d(step), tf)
        if it + 1 < max_iterations and not (
            torch.linalg.vector_norm(step).item() >= convergence_tol
        ):
            break
    return tf


def _uncentre(tf, mu_s, mu_d):
    """``T(μ_d) ∘ tf ∘ T(−μ_s)``."""
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
    """Rigid combined point-to-point + point-to-plane Gauss-Newton (3-D):
    mean-centred coordinates, (d + s)-coupled rotation rows and the
    two-sided update."""
    n, d = src.shape
    if d != 3:
        raise ValueError(f"the port has the 3-D combined metric only, got D={d}")
    w_pp = _zeros(n, src) if point_weights is None else point_weights
    w_pl = _ones(n, src) if plane_weights is None else plane_weights
    mu_s, mu_d, _ = _weighted_means(src, dst, w_pp + w_pl)
    tf = _gauss_newton(
        src - mu_s, dst - mu_d, w_pp, w_pl, lambda tf: dst_normals,
        max_iterations, convergence_tol,
    )
    valid = torch.sum((w_pp + w_pl) > 0) >= d
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
    """Symmetric-metric rigid Gauss-Newton (3-D): plane rows use the
    un-normalized ``n = n_dst + R n_src``, the update is two-sided."""
    n, d = src.shape
    if d != 3:
        raise ValueError(f"the port has the 3-D symmetric metric only, got D={d}")
    w_pp = _zeros(n, src) if point_weights is None else point_weights
    w_pl = _ones(n, src) if plane_weights is None else plane_weights
    mu_s, mu_d, _ = _weighted_means(src, dst, w_pp + w_pl)
    tf = _gauss_newton(
        src - mu_s, dst - mu_d, w_pp, w_pl,
        lambda tf: dst_normals + tf.apply_normals(src_normals),
        max_iterations, convergence_tol,
    )
    valid = torch.sum((w_pp + w_pl) > 0) >= d
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
