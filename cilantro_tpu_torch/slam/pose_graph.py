"""Keyframe pose-graph optimization (port of
``cilantro_tpu/slam/pose_graph.py``).

Nodes are keyframe poses ``T_i`` (camera-to-world), edges relative
measurements ``Z_ij ≈ T_i⁻¹ T_j``. Gauss-Newton minimizes
``Σ ‖log(Z_ij⁻¹ T_i⁻¹ T_j)‖²`` with local increments ``T_i ← T_i·Exp(δ_i)``
and numeric Jacobians (forward differences, ``eps = 1e-5``), in the JAX
module's expression order: the differences amplify float32 rounding by
1e5, so the two packages agree at the converged poses, not step by step.

JAX's ``lax.while_loop`` is a host loop here with one host read an
iteration (the update norm against ``tol``). The scatter-adds into the
``(K, K, 6, 6)`` normal matrix are sorted segment reductions over an
order counted once a call (:func:`..core.segment.sorted_scatter_sum`), so two card runs
give the same bits; the 6K × 6K system goes through
``torch.linalg.solve_ex``, which leaves its status on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.segment import sorted_scatter_plan, sorted_scatter_sum
from ..core.transforms import (
    Transform,
    axis_angle_to_rotation,
    compose,
    inverse,
    project_to_rotation,
)

_EPS = 1e-12


def _log_so3(r: torch.Tensor) -> torch.Tensor:
    """Rotation log through the skew part, scaled by ``θ / sin θ``."""
    skew = 0.5 * torch.stack(
        [
            r[..., 2, 1] - r[..., 1, 2],
            r[..., 0, 2] - r[..., 2, 0],
            r[..., 1, 0] - r[..., 0, 1],
        ],
        dim=-1,
    )
    trace = (r[..., 0, 0] + r[..., 1, 1]) + r[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    scale = torch.where(
        theta > 1e-6, theta / torch.clamp(torch.sin(theta), min=_EPS), torch.ones_like(theta)
    )
    return skew * scale[..., None]


def pose_error(t_i: Transform, t_j: Transform, z_ij: Transform) -> torch.Tensor:
    """6-vector edge residual ``[rot; trans]`` of ``Z⁻¹ T_i⁻¹ T_j``."""
    rel = compose(inverse(t_i), t_j)
    err = compose(inverse(z_ij), rel)
    return torch.cat([_log_so3(err.linear), err.translation], dim=-1)


def _retract(p: Transform, delta: torch.Tensor) -> Transform:
    """Per-pose local increments ``δ (..., K, 6)``: ``T · Exp(δ)``."""
    rot = axis_angle_to_rotation(delta[..., :3])
    lin = torch.einsum("...kij,...kjl->...kil", p.linear, rot)
    tr = torch.einsum("...kij,...kj->...ki", p.linear, delta[..., 3:]) + p.translation
    return Transform(lin, tr)


def optimize_pose_graph(
    poses: Transform,  # batched (K,)
    edge_i: torch.Tensor,  # (E,) int
    edge_j: torch.Tensor,  # (E,)
    measurements: Transform,  # batched (E,) relative transforms Z_ij
    *,
    edge_weights: Optional[torch.Tensor] = None,
    fixed_mask: Optional[torch.Tensor] = None,  # (K,) True = gauge-fixed pose
    max_iterations: int = 20,
    damping: float = 1e-6,
    tol: float = 1e-8,
) -> Tuple[Transform, torch.Tensor]:
    """Batched GN pose-graph optimization on the poses' device; pose 0 is
    fixed by default. Returns ``(poses, final update norm)``."""
    dev = poses.translation.device
    k = poses.translation.shape[0]
    e = edge_i.shape[0]
    if edge_weights is None:
        edge_weights = torch.ones(e, device=dev)
    if fixed_mask is None:
        fixed_mask = torch.zeros(k, dtype=torch.bool, device=dev)
        fixed_mask[0] = True
    edge_weights = torch.as_tensor(edge_weights, dtype=torch.float32, device=dev)
    fixed_mask = torch.as_tensor(fixed_mask, dtype=torch.bool, device=dev)
    free = (~fixed_mask).to(torch.float32)
    ei_np = np.asarray(torch.as_tensor(edge_i).cpu(), np.int64)
    ej_np = np.asarray(torch.as_tensor(edge_j).cpu(), np.int64)
    ei, ej = torch.as_tensor(ei_np, device=dev), torch.as_tensor(ej_np, device=dev)
    # H's blocks in JAX's scatter order: (i, i), (j, j), (i, j), (j, i).
    h_plan = sorted_scatter_plan(
        np.concatenate([ei_np * k + ei_np, ej_np * k + ej_np, ei_np * k + ej_np, ej_np * k + ei_np]),
        k * k, dev,
    )
    b_plan = sorted_scatter_plan(np.concatenate([ei_np, ej_np]), k, dev)
    eps = 1e-5
    # (6, K, 6): basis[c, :, c] = eps, zero on the fixed poses.
    basis = torch.eye(6, device=dev)[:, None, :] * eps * free[None, :, None]
    fix = fixed_mask.to(torch.float32)
    keep = 1.0 - fix
    eye6 = torch.eye(6, device=dev)

    def edge_error(pi: Transform, pj: Transform) -> torch.Tensor:
        t_i = Transform(pi.linear[..., ei, :, :], pi.translation[..., ei, :])
        t_j = Transform(pj.linear[..., ej, :, :], pj.translation[..., ej, :])
        return pose_error(t_i, t_j, measurements)

    def gn_step(p: Transform):
        r0 = edge_error(p, p)  # (E, 6)
        # Numeric Jacobians per edge endpoint: the 6 local coordinates of
        # every pose perturbed at once, used on one side of each edge only.
        p_pert = _retract(Transform(p.linear[None], p.translation[None]), basis)
        p_b = Transform(p.linear[None], p.translation[None])
        j_i = ((edge_error(p_pert, p_b) - r0) / eps).permute(1, 2, 0)  # (E, 6 res, 6 coord)
        j_j = ((edge_error(p_b, p_pert) - r0) / eps).permute(1, 2, 0)

        w = edge_weights[:, None, None]
        h_ii = torch.einsum("eri,erj->eij", j_i * w, j_i)
        h_jj = torch.einsum("eri,erj->eij", j_j * w, j_j)
        h_ij = torch.einsum("eri,erj->eij", j_i * w, j_j)
        b_i = -torch.einsum("eri,er->ei", j_i * w, r0)
        b_j = -torch.einsum("eri,er->ei", j_j * w, r0)
        h = sorted_scatter_sum(torch.cat([h_ii, h_jj, h_ij, h_ij.transpose(-1, -2)]), h_plan, k * k)
        h = h.reshape(k, k, 6, 6)
        b = sorted_scatter_sum(torch.cat([b_i, b_j]), b_plan, k)

        # Gauge fixing: zero rows / columns of fixed poses, identity diagonal.
        h = h * keep[:, None, None, None] * keep[None, :, None, None]
        diag = torch.arange(k, device=dev)
        h[diag, diag] += fix[:, None, None] * eye6
        b = b * keep[:, None]

        h_full = h.permute(0, 2, 1, 3).reshape(6 * k, 6 * k)
        h_full = h_full + damping * torch.eye(6 * k, device=dev)
        delta = torch.linalg.solve_ex(h_full, b.reshape(-1))[0].reshape(k, 6)
        delta = delta * free[:, None]
        new_p = _retract(p, delta)
        new_p = Transform(project_to_rotation(new_p.linear), new_p.translation)
        return new_p, torch.linalg.vector_norm(delta)

    p = poses
    dn = torch.full((), float("inf"), device=dev)
    it = 0
    while it < max_iterations and (it == 0 or bool(dn >= tol)):
        p, dn = gn_step(p)
        it += 1
    return p, dn
