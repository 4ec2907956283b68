"""Map-sharded frame-to-model fusion (port of
``cilantro_tpu/parallel/sharded_fusion.py``).

The ``(C, 16)`` pool is split over the mesh's ``map`` axis: rank ``d``
holds rows ``[d·C/D, (d+1)·C/D)`` and never another shard. A frame:

1. **render**: each rank z-buffers its shard; the global winner of a pixel
   is the least depth, then the least global row (two ``MIN``
   all-reduces, exact);
2. **model image**: each rank contributes the rows of the pixels it won
   (one pool gather, :func:`..core.coalesced.coalesced_gather`) and one
   all-reduce sum completes the ``(H·W, 16)`` image on every rank: one
   owner a pixel, so the sum is exact and every rank holds the same bits;
3. **localize**: the projective ICP against that image, run whole on every
   rank (the frame is replicated; its GN sums are small next to the
   render), so the pose is the same on every rank;
4. **integrate**: the gates and rows are computed on every rank; each rank
   writes the fuses and carves of the pixels it owns, and augments are
   dealt round-robin by augment rank, claiming free slots of their shard.

Collectives a frame: 4 ``MIN`` all-reduces of H·W values and 2 sums of
the (H·W, 16) image. Every argument JAX shards is this rank's shard here;
replicated ones are whole.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core.coalesced import coalesced_gather
from ..core.rgbd import CameraIntrinsics, _zbuffer_winner
from ..core.transforms import Transform, compose, inverse
from ..registration.icp import icp_projective_packed
from ..slam.fusion import (
    FusionConfig,
    _MAP_WIDTH,
    _classify_and_build_rows,
    _conf_col,
    _valid_col,
    apply_pool_update,
    free_slot_table,
    pack_camera_target,
)
from . import collectives as cc
from .sharded import mesh_device

_INT_MAX = 2**31 - 1


def _local_render(data_local, base, intrinsics, cam_from_world, h, w, mesh, axis):
    """Shard z-buffer and cross-shard winner election: ``(widx (H·W,)
    global winner row or -1, wdepth (H·W,))``, the same on every rank."""
    valid = data_local[:, _valid_col(data_local.shape[1])] > 0.5
    imap, mdepth = _zbuffer_winner(cam_from_world.apply(data_local[:, 0:3]), valid, intrinsics, h, w)
    li, ld = imap.reshape(-1), mdepth.reshape(-1)
    has = li >= 0
    ld = torch.where(has, ld, 3e38)
    # The exact global winner: least depth, ties to the least global row.
    dmin = cc.pmin(ld, mesh, axis)
    cand = torch.where(has & (ld == dmin), base + li, _INT_MAX)
    widx = cc.pmin(cand, mesh, axis)
    wok = widx < _INT_MAX
    return torch.where(wok, widx, -1), torch.where(wok, dmin, 0.0)


def _model_image(data_local, base, widx, mesh, axis):
    """The ``(H·W, 16)`` model row image on every rank: each rank gathers
    the rows of the pixels it won, one sum completes the image. Returns
    ``(image, owned, local row)``."""
    c_local = data_local.shape[0]
    rel = widx - base
    owned = (widx >= 0) & (rel >= 0) & (rel < c_local)
    rel = torch.clamp(rel, 0, c_local - 1).to(torch.int32)
    rows = torch.where(owned[:, None], coalesced_gather(data_local, rel), 0.0)
    return cc.psum(rows, mesh, axis), owned, rel


def sharded_fusion_step(
    map_data,  # (C/D, 16): this rank's shard of the pool
    frame_points,  # (H·W, 3) organized, replicated
    frame_normals,
    frame_colors,
    frame_valid,
    pose_guess: Transform,  # replicated
    intrinsics: CameraIntrinsics,
    *,
    mesh: DeviceMesh,
    axis: str = "map",
    height: int,
    width: int,
    cfg: FusionConfig = FusionConfig(),
) -> Tuple[torch.Tensor, Transform, torch.Tensor]:
    """One fusion frame (localize, integrate) on a map-sharded pool.
    Returns ``(this rank's new shard, refined pose, winner image (H·W,)
    int32 global rows)``, the last two the same on every rank. Matches
    :func:`..slam.fusion.fusion_step` up to z-buffer ties and augment
    placement (augments are dealt round-robin across shards)."""
    nshards = cc.axis_size(mesh, axis)
    d_id = cc.axis_index(mesh, axis)
    data = map_data
    dev = data.device
    c_local = data.shape[0]
    base = d_id * c_local
    hw = height * width

    # ---------------- localize --------------------------------------------
    cam_g = inverse(pose_guess)
    widx, _ = _local_render(data, base, intrinsics, cam_g, height, width, mesh, axis)
    mimg, _, _ = _model_image(data, base, widx, mesh, axis)
    ok = (widx >= 0) & (mimg[:, _valid_col(mimg.shape[1])] > 0.5)
    packed = pack_camera_target(mimg, ok, cam_g)
    s = cfg.localize_stride
    if s > 1:
        rows = torch.arange(0, height, s, device=dev)
        cols = torch.arange(0, width, s, device=dev)
        sub = (rows[:, None] * width + cols[None, :]).reshape(-1)
        loc = frame_points[sub], frame_normals[sub], frame_valid[sub]
    else:
        loc = frame_points, frame_normals, frame_valid
    # The ICP runs whole on every rank: its inputs are the same bits
    # everywhere, so its iterations and pose are too.
    res = icp_projective_packed(
        loc[0], packed, intrinsics, height=height, width=width, src_normals=loc[1],
        src_valid=loc[2], metric="combined", point_weight=cfg.icp_point_weight,
        plane_weight=cfg.icp_plane_weight, max_iterations=cfg.icp_iterations,
        convergence_tol=cfg.icp_convergence_tol, max_corr_dist_sq=cfg.icp_max_corr_dist_sq,
    )
    pose = compose(pose_guess, res.transform)

    # ---------------- integrate -------------------------------------------
    cam = inverse(pose)
    widx, wdepth = _local_render(data, base, intrinsics, cam, height, width, mesh, axis)
    mimg, owned, rel = _model_image(data, base, widx, mesh, axis)
    m_ok = widx >= 0
    do_fuse, do_augment, do_carve, fuse_rows, aug_rows, carve_row = _classify_and_build_rows(
        mimg, m_ok, wdepth, frame_points, frame_normals, frame_valid, frame_colors, pose, cam,
        intrinsics, height, width, cfg,
    )

    # Augment dealing: the pixel of augment rank r goes to shard r % D and
    # claims that shard's (r // D)-th free slot.
    valid_local = data[:, _valid_col(data.shape[1])] > 0.5
    slot_of_rank, num_free = free_slot_table(valid_local)
    aug_rank = torch.cumsum(do_augment.to(torch.int32), 0).to(torch.int32) - 1
    mine = do_augment & (aug_rank % nshards == d_id)
    local_rank = torch.div(aug_rank, nshards, rounding_mode="floor")
    aug_slot = slot_of_rank[torch.clamp(local_rank, 0, c_local - 1).long()]
    aug_ok = mine & (local_rank < num_free)

    # One local update: fuses and carves on owned winners, augments on this
    # shard's dealt free slots, every other pixel a distinct target past
    # the shard (dropped).
    oob = c_local + torch.arange(hw, dtype=torch.int32, device=dev)
    fuse_or_carve = (do_fuse | do_carve) & owned
    tgt = torch.where(fuse_or_carve, rel, torch.where(aug_ok, aug_slot, oob))
    rows_out = torch.where(
        do_fuse[:, None], fuse_rows, torch.where(do_carve[:, None], carve_row[None, :], aug_rows)
    )
    return apply_pool_update(data, tgt, rows_out, cfg), pose, widx


def _seed_pool(capacity, nshards, frame_points, frame_normals, frame_colors, frame_valid, confidence):
    """The whole seeded ``(C, 16)`` pool on the host: the frame's valid
    points compacted and dealt round-robin (kept row i → shard i % D,
    local slot i // D)."""
    def host(a):
        return None if a is None else (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                                       else np.asarray(a))

    val = host(frame_valid).astype(bool)
    pts = host(frame_points)[val]
    nrm = host(frame_normals)[val]
    cols = host(frame_colors)[val] if frame_colors is not None else None
    conf = host(confidence)[val] if confidence is not None else np.ones(len(pts), np.float32)
    n = min(len(pts), capacity)
    w = _MAP_WIDTH
    data = np.zeros((capacity, w), np.float32)
    data[:, 0:3] = 1e30
    c_local = capacity // nshards
    idx = np.arange(n)
    slots = (idx % nshards) * c_local + idx // nshards
    data[slots, 0:3] = pts[:n]
    data[slots, 3:6] = nrm[:n]
    if cols is not None:
        data[slots, 6:9] = cols[:n]
    data[slots, _conf_col(w)] = conf[:n]
    data[slots, _valid_col(w)] = 1.0
    return data


def init_sharded_map(
    mesh: DeviceMesh,
    capacity: int,
    frame_points,
    frame_normals,
    frame_colors,
    frame_valid,
    *,
    axis: str = "map",
    confidence=None,
) -> torch.Tensor:
    """Seed a sharded pool from the first frame: the frame's points are
    dealt round-robin across shards (each shard starts with a balanced
    slice), as the JAX module deals them. Returns this rank's ``(C/D,
    16)`` shard on the mesh's device."""
    nshards = cc.axis_size(mesh, axis)
    if capacity % nshards:
        raise ValueError(f"capacity {capacity} does not divide the {nshards} shards of {axis!r}")
    data = _seed_pool(capacity, nshards, frame_points, frame_normals, frame_colors, frame_valid,
                      confidence)
    c_local = capacity // nshards
    d = cc.axis_index(mesh, axis)
    return torch.as_tensor(data[d * c_local:(d + 1) * c_local]).to(mesh_device(mesh))
