"""Bundle adjustment with Schur-complement landmark elimination, on one
device and with landmarks sharded over ranks (port of
``cilantro_tpu/slam/bundle_adjustment.py``).

Keyframe poses ``T_c`` (camera-to-world) and world landmarks ``X_l``;
observation ``o`` sees landmark ``lmk[o]`` at ``Y_o`` in camera ``cam[o]``:
``r_o = T_{cam[o]}⁻¹ X_{lmk[o]} − Y_o``. ``H_ll`` is 3×3 block-diagonal,
eliminated in closed form; the reduced camera system is solved by
block-Jacobi PCG, matrix-free: each matvec is gathers and segment sums over
the observations, nothing camera × landmark is built.

Every sum over observations by camera or by landmark (JAX's
``jax.ops.segment_sum``) is a sorted segment reduction over an order and
lengths counted once a call, so two card solves give the same bits and the
rows of a segment add in observation order, as a sequential scatter-add
does. JAX's two ``lax.while_loop`` s: the outer loop is a host loop with
one host read an iteration; the PCG runs all ``max_cg`` iterations, each
frozen by a device flag once JAX's loop condition fails, so its iterates
equal JAX's loop's and the host never reads the flag. One outer iteration
(:func:`_ba_step`) never waits on the host.

:func:`bundle_adjust_sharded` splits landmarks and their observations over
the mesh's ``points`` axis: landmark elimination and back-substitution stay
on each rank, and every camera-side sum (the gradient, the preconditioner
blocks, each PCG matvec, the residual) is reduced over the ranks by the
``psum`` hook of :func:`_ba_blocks`, :func:`_schur_matvec` and
:func:`_pcg_schur`, a sum in rank order, so every rank holds the same
camera state to the bit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from .. import resolve_device
from ..core.transforms import (
    Transform,
    axis_angle_to_rotation,
    project_to_rotation,
    skew3,
)
from ..core.segment import sorted_scatter_plan, sorted_scatter_sum

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class _Segments:
    """The observations' sorted-sum plans by camera and by landmark
    (:func:`..core.segment.sorted_scatter_plan`, counted once a call on the
    host)."""

    cam: tuple
    lmk: tuple
    k: int
    l: int

    @staticmethod
    def of(cam_idx: torch.Tensor, lmk_idx: torch.Tensor, k: int, l: int) -> "_Segments":
        dev = cam_idx.device
        return _Segments(sorted_scatter_plan(cam_idx.cpu().numpy(), k, dev),
                         sorted_scatter_plan(lmk_idx.cpu().numpy(), l, dev), k, l)

    def by_camera(self, values: torch.Tensor) -> torch.Tensor:
        return sorted_scatter_sum(values, self.cam, self.k)

    def by_landmark(self, values: torch.Tensor) -> torch.Tensor:
        return sorted_scatter_sum(values, self.lmk, self.l)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched ``m @ v``: ``(..., i, j) × (..., j) → (..., i)``."""
    return torch.einsum("...ij,...j->...i", m, v)


def _mtv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched ``mᵀ @ v``: ``(..., i, j) × (..., i) → (..., j)``."""
    return torch.einsum("...ij,...i->...j", m, v)


def _inv(m: torch.Tensor) -> torch.Tensor:
    """Batched inverse; ``inv_ex`` leaves its status on the device."""
    return torch.linalg.inv_ex(m)[0]


def _identity(x):
    return x


def _ba_blocks(poses, landmarks, cam_idx, lmk_idx, obs, w, seg: _Segments, psum: Callable = _identity):
    """Per-observation GN blocks and their per-landmark / per-camera sums:
    ``(h_cc (K,6,6), h_cl (O,6,3), h_ll_inv (L,3,3), b_l (L,3), g (K,6) =
    b_c − A H_ll⁻¹ b_l, resid)``. ``psum`` reduces ``g`` and ``resid``
    over landmark shards; ``h_cc`` stays this shard's."""
    rt = poses.linear.transpose(-1, -2)
    x_w = landmarks[lmk_idx]  # (O, 3)
    rt_o = rt[cam_idx]  # (O, 3, 3)
    x_c = _mv(rt_o, x_w - poses.translation[cam_idx])
    r = x_c - obs  # (O, 3)

    # T ← T·Exp(δ): x_c(δ) ≈ x_c − δω × x_c − δt, so J_c = [[x_c]× | −I].
    j_rot = skew3(x_c)
    j_x = rt_o  # ∂r/∂X = Rᵀ
    eye = torch.eye(3, dtype=x_c.dtype, device=x_c.device)
    j_c = torch.cat([j_rot, -eye.expand(j_rot.shape)], dim=2)  # (O, 3, 6)

    h_cc_o = torch.einsum("o,oki,okj->oij", w, j_c, j_c)  # (O, 6, 6)
    h_cl = torch.einsum("o,oki,okj->oij", w, j_c, j_x)  # (O, 6, 3)
    h_ll_o = torch.einsum("o,oki,okj->oij", w, j_x, j_x)  # (O, 3, 3)
    b_c_o = -torch.einsum("o,oki,ok->oi", w, j_c, r)  # (O, 6)
    b_l_o = -torch.einsum("o,oki,ok->oi", w, j_x, r)  # (O, 3)

    h_cc = seg.by_camera(h_cc_o)
    h_ll = seg.by_landmark(h_ll_o)
    b_l = seg.by_landmark(b_l_o)
    h_ll_inv = _inv(h_ll + 1e-8 * eye)

    # g = b_c − A H_ll⁻¹ b_l, evaluated per observation.
    y_l = _mv(h_ll_inv, b_l)
    g = psum(seg.by_camera(b_c_o - _mv(h_cl, y_l[lmk_idx])))
    resid = psum(torch.sum(w * torch.sum(r * r, dim=-1)))
    return h_cc, h_cl, h_ll_inv, b_l, g, resid


def _schur_matvec(v, h_cc, h_cl, h_ll_inv, cam_idx, lmk_idx, seg: _Segments, damping,
                  psum: Callable = _identity):
    """``(S + λI) v`` with ``S = H_cc − A H_ll⁻¹ Aᵀ``, matrix-free;
    ``psum`` reduces the camera-indexed partials over landmark shards."""
    u_o = _mtv(h_cl, v[cam_idx])  # Aᵀv pieces (O, 3)
    y_l = _mv(h_ll_inv, seg.by_landmark(u_o))
    corr = seg.by_camera(_mv(h_cl, y_l[lmk_idx]))  # A·y (K, 6)
    return psum(_mv(h_cc, v) - corr) + damping * v


def _pcg_schur(g, h_cc, h_cl, h_ll_inv, cam_idx, lmk_idx, seg: _Segments, keep, damping,
               psum: Callable = _identity, max_cg: int = 60, cg_tol: float = 1e-10):
    """Block-Jacobi PCG on the gauge-fixed reduced camera system (``keep``
    zeroes the fixed cameras' rows). Returns ``(δc, iterations)``, the
    count on the device. ``psum`` reduces the preconditioner blocks and
    each matvec over landmark shards; the loop flag comes from reduced
    values, so every shard freezes at the same iteration."""
    keep6 = keep[:, None]
    eye6 = torch.eye(6, dtype=g.dtype, device=g.device)
    prec = _inv(psum(h_cc) + (damping + 1e-8) * eye6)

    def mv(v):
        v = v * keep6
        out = _schur_matvec(v, h_cc, h_cl, h_ll_inv, cam_idx, lmk_idx, seg, damping, psum)
        return out * keep6 + v * (1.0 - keep6)

    def apply_prec(r):
        return _mv(prec, r) * keep6

    b = g * keep6
    x = torch.zeros_like(b)
    r = b
    z = apply_prec(r)
    p = z
    rz = torch.sum(r * z)
    k = torch.zeros((), dtype=torch.int32, device=g.device)
    for _ in range(max_cg):
        active = torch.sum(r * r) > cg_tol
        ap = mv(p)
        alpha = rz / torch.clamp(torch.sum(p * ap), min=_EPS)
        x = torch.where(active, x + alpha * p, x)
        r1 = r - alpha * ap
        z1 = apply_prec(r1)
        rz1 = torch.sum(r1 * z1)
        beta = rz1 / torch.clamp(rz, min=_EPS)
        p = torch.where(active, z1 + beta * p, p)
        r = torch.where(active, r1, r)
        rz = torch.where(active, rz1, rz)
        k = k + active.to(torch.int32)
    return x, k


def _back_substitute(dc, h_cl, h_ll_inv, b_l, cam_idx, seg: _Segments):
    """``δx_l = H_ll⁻¹ (b_l − Aᵀ δc)``, per observation."""
    at_dc = seg.by_landmark(_mtv(h_cl, dc[cam_idx]))
    return _mv(h_ll_inv, b_l - at_dc)


def _apply_camera_update(poses: Transform, delta, fixed_mask) -> Transform:
    delta = delta * (~fixed_mask)[:, None]
    rot = axis_angle_to_rotation(delta[:, :3])
    lin = torch.einsum("kij,kjl->kil", poses.linear, rot)
    tr = _mv(poses.linear, delta[:, 3:]) + poses.translation
    return Transform(project_to_rotation(lin), tr)


def _ba_step(poses, landmarks, cam_idx, lmk_idx, obs, w, seg, fixed_mask, keep, damping, max_cg):
    """One outer GN iteration: ``(poses, landmarks, step norm, CG
    iterations)``."""
    h_cc, h_cl, h_ll_inv, b_l, g, _ = _ba_blocks(poses, landmarks, cam_idx, lmk_idx, obs, w, seg)
    dc, cg_it = _pcg_schur(g, h_cc, h_cl, h_ll_inv, cam_idx, lmk_idx, seg, keep, damping, max_cg=max_cg)
    dx = _back_substitute(dc, h_cl, h_ll_inv, b_l, cam_idx, seg)
    step = torch.linalg.vector_norm(dc) + torch.linalg.vector_norm(dx)
    return _apply_camera_update(poses, dc, fixed_mask), landmarks + dx, step, cg_it


def bundle_adjust(
    poses: Transform,  # batched (K,)
    landmarks,  # (L, 3) world points
    cam_idx,  # (O,) int
    lmk_idx,  # (O,) int
    observations,  # (O, 3) points in camera frame
    *,
    obs_weights=None,
    fixed_mask=None,
    max_iterations: int = 10,
    damping: float = 1e-6,
    tol: float = 1e-8,
    max_cg: int = 60,
    device="cuda",
    stats: Optional[dict] = None,
) -> Tuple[Transform, torch.Tensor, torch.Tensor]:
    """Single-device Schur-complement BA (matrix-free PCG reduced solve) on
    ``device``; arrays may be numpy or tensors. Returns ``(poses,
    landmarks, final residual)``; pose 0 is gauge-fixed by default. Memory
    is O(O + L + K). ``stats``, if given, receives ``iterations`` (outer)
    and ``cg_iterations`` (one count an outer iteration)."""
    dev = resolve_device(device)
    poses = Transform(
        torch.as_tensor(poses.linear, dtype=torch.float32, device=dev),
        torch.as_tensor(poses.translation, dtype=torch.float32, device=dev),
    )
    landmarks = torch.as_tensor(landmarks, dtype=torch.float32, device=dev)
    cam_idx = torch.as_tensor(cam_idx, device=dev).long()
    lmk_idx = torch.as_tensor(lmk_idx, device=dev).long()
    obs = torch.as_tensor(observations, dtype=torch.float32, device=dev)
    k, l = poses.translation.shape[0], landmarks.shape[0]
    w = (torch.ones(cam_idx.shape[0], device=dev) if obs_weights is None
         else torch.as_tensor(obs_weights, dtype=torch.float32, device=dev))
    if fixed_mask is None:
        fixed_mask = torch.zeros(k, dtype=torch.bool, device=dev)
        fixed_mask[0] = True
    fixed_mask = torch.as_tensor(fixed_mask, dtype=torch.bool, device=dev)
    keep = 1.0 - fixed_mask.to(torch.float32)
    seg = _Segments.of(cam_idx, lmk_idx, k, l)

    it, step, cg_its = 0, None, []
    while it < max_iterations and (it == 0 or bool(step >= tol)):
        poses, landmarks, step, cg_it = _ba_step(
            poses, landmarks, cam_idx, lmk_idx, obs, w, seg, fixed_mask, keep, damping, max_cg
        )
        cg_its.append(cg_it)
        it += 1
    resid = _ba_blocks(poses, landmarks, cam_idx, lmk_idx, obs, w, seg)[5]
    if stats is not None:
        stats.update(iterations=it, cg_iterations=[int(c) for c in cg_its])
    return poses, landmarks, resid


def bundle_adjust_sharded(
    poses: Transform,  # replicated (K,)
    landmarks,  # (L/D, 3): this rank's landmark shard
    cam_idx,  # (O/D,) this shard's observations
    lmk_idx,  # (O/D,) LOCAL landmark ids within the shard
    observations,  # (O/D, 3)
    obs_valid,  # (O/D,)
    *,
    mesh,
    fixed_mask=None,
    max_iterations: int = 10,
    damping: float = 1e-6,
    max_cg: int = 60,
    stats: Optional[dict] = None,
) -> Tuple[Transform, torch.Tensor, torch.Tensor]:
    """Multi-rank Schur BA: landmarks and their observations split over
    the mesh's ``points`` axis (a landmark's observations live on its
    shard: partition by landmark, :func:`..parallel.sharded.shard_cloud_arrays`
    cuts equal blocks). Every array but ``poses`` and ``fixed_mask`` is this
    rank's shard, on the mesh's device. The camera-side sums (gradient,
    preconditioner blocks, each PCG matvec, the residual) are each reduced
    over the shards in rank order; landmark elimination and
    back-substitution stay on the rank. ``max_iterations`` outer iterations
    run, as in the JAX package, with no host read. Returns ``(poses``
    (the same on every rank), ``this rank's landmarks, residual)``.
    ``stats``, if given, receives ``cg_iterations`` (one count an outer
    iteration)."""
    from ..parallel import collectives as cc
    from ..parallel.sharded import mesh_device

    dev = mesh_device(mesh)

    def psum(x):
        return cc.psum_ordered(x, mesh, "points")

    poses = Transform(
        torch.as_tensor(poses.linear, dtype=torch.float32).to(dev),
        torch.as_tensor(poses.translation, dtype=torch.float32).to(dev),
    )
    landmarks = torch.as_tensor(landmarks, dtype=torch.float32).to(dev)
    cam_idx = torch.as_tensor(cam_idx).to(dev).long()
    lmk_idx = torch.as_tensor(lmk_idx).to(dev).long()
    obs = torch.as_tensor(observations, dtype=torch.float32).to(dev)
    w = torch.as_tensor(obs_valid).to(dev).to(torch.float32)
    k, l_local = poses.translation.shape[0], landmarks.shape[0]
    if fixed_mask is None:
        fixed_mask = torch.zeros(k, dtype=torch.bool, device=dev)
        fixed_mask[0] = True
    fixed_mask = torch.as_tensor(fixed_mask, dtype=torch.bool).to(dev)
    keep = 1.0 - fixed_mask.to(torch.float32)
    seg = _Segments.of(cam_idx, lmk_idx, k, l_local)

    cg_its = []
    for _ in range(max_iterations):
        h_cc, h_cl, h_ll_inv, b_l, g, _ = _ba_blocks(poses, landmarks, cam_idx, lmk_idx, obs, w, seg, psum)
        dc, cg_it = _pcg_schur(g, h_cc, h_cl, h_ll_inv, cam_idx, lmk_idx, seg, keep, damping, psum,
                               max_cg=max_cg)
        landmarks = landmarks + _back_substitute(dc, h_cl, h_ll_inv, b_l, cam_idx, seg)
        poses = _apply_camera_update(poses, dc, fixed_mask)
        cg_its.append(cg_it)
    resid = _ba_blocks(poses, landmarks, cam_idx, lmk_idx, obs, w, seg, psum)[5]
    if stats is not None:
        stats.update(cg_iterations=[int(c) for c in cg_its])
    return poses, landmarks, resid
