"""Multi-stream batched fusion: B independent RGBD streams advance in one
step (port of ``cilantro_tpu/slam/batched_fusion.py``).

The B pools are one flat ``(B·C, 16)`` pool and the B frames one
``(B·H·W,)`` pixel space with per-stream offsets, so every indexed op of a
frame runs once for all streams: one z-buffer scatter-min
(:func:`..core.rgbd._zbuffer_winner_batched`), one model-row gather, one
pool update and, in localize, one target gather an ICP iteration, each
through :func:`..core.coalesced.coalesced_gather` on the card. The
elementwise stages take a leading stream axis. A step's kernel launches do
not grow with B. Per-stream semantics are those of :mod:`.fusion`.

The JAX module issues its wide gathers in groups of streams below a
wide-gather row cliff of XLA on its TPU; the card has no such cliff, so
each is one launch over the whole flat operand here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.coalesced import coalesced_gather
from ..core.rgbd import CameraIntrinsics, _zbuffer_winner_batched, depth_to_points_normals
from ..core.transforms import Transform, compose, identity, inverse, per_stream
from ..registration.icp import ICPResult, icp_projective_packed
from .fusion import (
    FusionConfig,
    FusionMap,
    _classify_and_build_rows,
    _valid_col,
    apply_pool_update,
    init_map_from_frame,
    pack_camera_target,
)
from ..utils.profiling import annotate_function, count, span
from .scan import scan


def stack_maps(maps: List[FusionMap]) -> torch.Tensor:
    """B single-stream pools → one ``(B, C, W)`` batched pool."""
    return torch.stack([m.data for m in maps])


def unstack_maps(data: torch.Tensor) -> List[FusionMap]:
    return [FusionMap(data=data[b]) for b in range(data.shape[0])]


def _grouped_wide_gather(
    flat: torch.Tensor,  # (B·R, W) operand laid out as B blocks of R rows
    idx_local: torch.Tensor,  # (B, Q) block-local row indices
    rows_per_block: int,
) -> torch.Tensor:
    """``stack([flat[b·R + idx_local[b]] for b])``, ``(B, Q, W)``, in one
    gather over the whole flat operand."""
    bsz, q = idx_local.shape
    offs = torch.arange(bsz, dtype=torch.int32, device=flat.device)[:, None] * rows_per_block
    return coalesced_gather(flat, (idx_local + offs).reshape(-1)).reshape(bsz, q, flat.shape[1])


def batched_seed_localize_target(
    data: torch.Tensor,
    poses: Transform,
    intrinsics: CameraIntrinsics,
    height: int,
    width: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Initial ``(index maps (B, H, W), packed targets (B, H·W, 8))`` from a
    fresh render of every stream's pool at its pose: the batched
    :func:`.fusion.seed_localize_target`."""
    bsz, cap, wcol = data.shape
    cams = per_stream(inverse(poses))
    vcol = _valid_col(wcol)
    imap, _ = _zbuffer_winner_batched(
        cams.apply(data[..., 0:3]), data[..., vcol] > 0.5, intrinsics, height, width
    )
    hit = imap.reshape(bsz, -1)
    ok = hit >= 0
    rows = _grouped_wide_gather(data.reshape(bsz * cap, wcol), torch.where(ok, hit, 0), cap)
    ok = ok & (rows[..., vcol] > 0.5)
    return imap, pack_camera_target(rows, ok, cams)


def batched_integrate(
    data: torch.Tensor,  # (B, C, W) batched pool
    frame_points: torch.Tensor,  # (B, H·W, 3) organized, camera frame
    frame_normals: torch.Tensor,
    frame_colors: Optional[torch.Tensor],
    frame_valid: torch.Tensor,
    poses: Transform,  # batch (B,), camera-to-world per stream
    intrinsics: CameraIntrinsics,
    *,
    height: int,
    width: int,
    cfg: FusionConfig = FusionConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fuse / augment / carve one frame into each of B pools. Returns
    ``(data, index maps (B, H, W), packed_next (B, H·W, 8))``, as
    :func:`.fusion.integrate_frame_with_imap` returns for one stream."""
    bsz, cap, wcol = data.shape
    npix = height * width
    dev = data.device
    vcol = _valid_col(wcol)
    cams = per_stream(inverse(poses))
    valid = data[..., vcol] > 0.5

    # Render: one scatter-min over the (B·H·W,) pixels.
    imap, mdepth = _zbuffer_winner_batched(
        cams.apply(data[..., 0:3]), valid, intrinsics, height, width
    )
    imap_flat = imap.reshape(bsz, npix)
    m_ok = imap_flat >= 0
    m_idx = torch.where(m_ok, imap_flat, 0)

    # Model rows: one gather of B·H·W rows from the flat pool.
    flat = data.reshape(bsz * cap, wcol)
    mrows = torch.where(m_ok[..., None], _grouped_wide_gather(flat, m_idx, cap), 0.0)

    do_fuse, do_augment, do_carve, fuse_rows, aug_rows, carve_row = _classify_and_build_rows(
        mrows, m_ok, mdepth.reshape(bsz, npix), frame_points, frame_normals, frame_valid,
        frame_colors, per_stream(poses), cams, intrinsics, height, width, cfg,
    )

    # Tail-append allocator per stream: every slot past the stream's
    # highest valid one is free.
    aug_rank = torch.cumsum(do_augment.to(torch.int32), 1).to(torch.int32) - 1
    cap_ids = torch.arange(cap, dtype=torch.int32, device=dev)
    tail = torch.max(torch.where(valid, cap_ids, -1), dim=1).values + 1
    aug_slot = tail[:, None] + aug_rank
    aug_ok = do_augment & (aug_slot < cap)
    aug_slot = aug_slot.clamp(0, cap - 1)

    # One update over the flat pool. Fuse and carve hit distinct valid
    # slots, augments free ones, each in its own stream's block; the other
    # lanes get globally distinct targets past the flat pool, which drop.
    offs = torch.arange(bsz, dtype=torch.int32, device=dev)[:, None] * cap
    tgt_local = torch.where(do_fuse | do_carve, m_idx, torch.where(aug_ok, aug_slot, cap))
    lane = torch.arange(bsz * npix, dtype=torch.int32, device=dev).reshape(bsz, npix)
    tgt = torch.where(tgt_local < cap, tgt_local + offs, bsz * cap + lane).reshape(-1)
    rows_out = torch.where(
        do_fuse[..., None], fuse_rows, torch.where(do_carve[..., None], carve_row, aug_rows)
    ).reshape(bsz * npix, wcol)
    # apply_pool_update's "auto" (flat capacity ≤ 3 × flat pixels) is the
    # JAX module's per-stream cap ≤ 3 · npix.
    new_flat = apply_pool_update(flat, tgt, rows_out, cfg)

    # The next localize's target from the rows already in hand, as the
    # single-stream integrate builds it.
    post_rows = torch.where(do_fuse[..., None], fuse_rows, mrows)
    alive = m_ok & ~do_carve & (post_rows[..., vcol] > 0.5)
    packed_next = pack_camera_target(post_rows, alive, cams)
    return new_flat.reshape(bsz, cap, wcol), imap, packed_next


def batched_fusion_step(
    data: torch.Tensor,  # (B, C, W)
    frame_points: torch.Tensor,  # (B, H·W, 3)
    frame_normals: torch.Tensor,
    frame_colors: Optional[torch.Tensor],
    frame_valid: torch.Tensor,
    pose_guess: Transform,  # batch (B,)
    intrinsics: CameraIntrinsics,
    cached_packed_target: torch.Tensor,  # (B, H·W, 8)
    *,
    height: int,
    width: int,
    cfg: FusionConfig = FusionConfig(),
    do_integrate: bool = True,
) -> Tuple[torch.Tensor, Transform, ICPResult, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One localize + integrate frame for B streams. Localize rides the
    cached packed targets (each built at its stream's ``pose_guess`` by the
    previous integrate): projective ICP over the batch in the graph loop
    form, all ``cfg.icp_iterations`` with each stream's estimate frozen
    once its own loop would have stopped, as the JAX module's ``vmap`` of
    the ``while_loop`` freezes it. Nothing waits on the host. Returns
    ``(data, poses, icp result, index maps, packed targets)``; the last two
    are ``None`` when ``do_integrate`` is False."""
    s = cfg.localize_stride
    if s > 1:
        dev = frame_points.device
        rows = torch.arange(0, height, s, device=dev)
        cols = torch.arange(0, width, s, device=dev)
        sub = (rows[:, None] * width + cols[None, :]).reshape(-1)
        loc = frame_points[:, sub], frame_normals[:, sub], frame_valid[:, sub]
    else:
        loc = frame_points, frame_normals, frame_valid
    res = icp_projective_packed(
        loc[0], cached_packed_target, intrinsics, height=height, width=width,
        src_normals=loc[1], src_valid=loc[2], metric="combined",
        point_weight=cfg.icp_point_weight, plane_weight=cfg.icp_plane_weight,
        max_iterations=cfg.icp_iterations, convergence_tol=cfg.icp_convergence_tol,
        max_gn_iterations=cfg.icp_gn_iterations, max_corr_dist_sq=cfg.icp_max_corr_dist_sq,
        loop="graph",
    )
    poses = compose(pose_guess, res.transform)
    if not do_integrate:
        return data, poses, res, None, None
    data, imap, packed_next = batched_integrate(
        data, frame_points, frame_normals, frame_colors, frame_valid, poses, intrinsics,
        height=height, width=width, cfg=cfg,
    )
    return data, poses, res, imap, packed_next


@dataclasses.dataclass
class BatchedFusionMetrics:
    poses: np.ndarray  # (B, F, 4, 4) per-stream trajectories
    streams: int
    frames: int
    seconds_per_step: float  # one step advances all B streams one frame
    aggregate_fps: float  # B / seconds_per_step
    num_map_points: np.ndarray  # (B,)


@annotate_function("cilantro.entry.batched_fusion")
def run_batched_fusion_sequences(
    depth_stacks,  # (B, F, H, W) array-like, metric depth
    intrinsics: CameraIntrinsics,
    *,
    map_capacity: Optional[int] = None,
    cfg: FusionConfig = FusionConfig(),
    device="cuda",
    stats: Optional[dict] = None,
) -> Tuple[torch.Tensor, BatchedFusionMetrics]:
    """B independent fusion streams, whole sequences: one
    :func:`batched_fusion_step` (depth → points and normals included)
    captured in a CUDA graph and replayed once a frame (:func:`.scan.scan`);
    eager steps on the CPU. Each step advances every stream one frame, so
    the aggregate rate is ``B / seconds_per_step`` frames/s, with
    ``seconds_per_step`` that of the fastest of 3 runs by the host clock
    (capture and a first run excluded, as the JAX driver excludes its
    compile). Returns the final ``(B, C, 16)`` pools and per-stream
    metrics. ``stats``, if given, receives ``device_seconds_per_step``
    (CUDA events, ``None`` on the CPU), ``launches_per_step`` (every kernel
    counter) and ``icp_iterations`` (``(B, F)``, 0 for the seed frame).
    The call is a ``cilantro.entry.batched_fusion`` span, with
    ``entry.prepare`` and ``entry.finish`` spans and the
    ``gn_iterations_kept`` / ``gn_iterations_run`` counters inside
    (:mod:`..utils.profiling`).

    On the card a later call with the same ``cfg``, ``intrinsics``, B,
    frame shape, ``map_capacity`` and device replays the step the first
    captured, with no warm-up and no capture (:func:`.scan.scan`'s
    ``key``); ``seconds_per_step`` keeps its meaning. Between calls the
    entry keeps that one graph, its pool and its static buffers (the B
    pools, poses and packed targets, a step's frames and outputs); a call
    with another key replaces them, :func:`.scan.clear` frees them."""
    dev = resolve_device(device)
    with span("cilantro.entry.prepare"):
        stacks = np.asarray(depth_stacks, np.float32)
        bsz, nf, h, w = stacks.shape
        if map_capacity is None:
            map_capacity = 4 * h * w
        pts, nrm, valid = depth_to_points_normals(torch.as_tensor(stacks[:, 0], device=dev),
                                                  intrinsics)
        data0 = stack_maps([init_map_from_frame(map_capacity, pts[b], nrm[b], None, valid[b])
                            for b in range(bsz)])
        pose0 = identity(3, batch_shape=(bsz,), device=dev)
        if nf > 1:
            _, packed0 = batched_seed_localize_target(data0, pose0, intrinsics, h, w)
            rest = torch.as_tensor(np.ascontiguousarray(stacks[:, 1:].transpose(1, 0, 2, 3)),
                                   device=dev)
    if nf == 1:  # nothing to track: the seeded pools are the result
        mats = np.zeros((0, bsz, 4, 4), np.float32)
        iterations = np.zeros((0, bsz), np.int32)
        data, per_step, dev_per_step, launches = data0, 0.0, None, {}
    else:

        def step(carry, depth_b):
            data, linear, translation, packed = carry
            p, n, v = depth_to_points_normals(depth_b, intrinsics)
            data, poses, res, _, packed = batched_fusion_step(
                data, p, n, None, v, Transform(linear, translation), intrinsics, packed,
                height=h, width=w, cfg=cfg,
            )
            return (data, poses.linear, poses.translation, packed), (poses.matrix(), res.iterations)

        out = scan(
            step, (data0, pose0.linear, pose0.translation, packed0), rest,
            key=("batched_fusion", cfg, intrinsics, h, w),
        )
        data = out.carry[0]
        mats, iterations = out.ys  # (F-1, B, 4, 4), (F-1, B)
        per_step, dev_per_step = out.seconds_per_step, out.device_seconds_per_step
        launches = dict(out.launches_per_step)
    with span("cilantro.entry.finish"):
        count("gn_iterations_kept", iterations.sum())
        count("gn_iterations_run", cfg.icp_iterations * iterations.size)
        eye = np.broadcast_to(np.eye(4, dtype=np.float32), (bsz, 1, 4, 4))
        poses = np.concatenate([eye, mats.transpose(1, 0, 2, 3)], axis=1)
        n_pts = torch.sum(data[..., _valid_col(data.shape[-1])] > 0.5, dim=1).cpu().numpy()
        if stats is not None:
            stats.update(
                device_seconds_per_step=dev_per_step, launches_per_step=launches,
                icp_iterations=np.concatenate([np.zeros((bsz, 1), np.int32), iterations.T],
                                              axis=1),
            )
    return data, BatchedFusionMetrics(
        poses=poses,
        streams=bsz,
        frames=nf,
        seconds_per_step=per_step,
        aggregate_fps=bsz / per_step if per_step > 0 else 0.0,
        num_map_points=n_pts,
    )
