"""Point-based RGBD fusion over a fixed-capacity pool (port of
``cilantro_tpu/slam/fusion.py``).

Each frame:

* **localize** — projective ICP (symmetric metric when both sides have
  normals) of the frame against the model rendered at the predicted pose;
  after the first frame the target is the previous integrate's packed
  camera-frame target, so localize renders nothing;
* **integrate** — z-buffer the pool into the new camera, gather each
  pixel's model row, classify pixels into fuse / augment / carve (the
  reference's gates), append augments at the pool's tail and write every
  update into the pool at once.

The pool is one ``(C, 16)`` float32 tensor (``(C, 8)`` without colors).
Every function returns new tensors and leaves its arguments unchanged.
The three wide-row gathers of a frame (integrate's model rows, the
inverse-gather update, each ICP iteration's target rows) go through
:func:`..core.coalesced.coalesced_gather`: the CUDA kernel on the card, the
plain gather on the CPU. Both read the rows the JAX package's plain
gathers read.

Scatters the JAX module makes with ``mode="drop"`` and distinct
out-of-range targets write here into one extra slot past the end, which is
then cut off; the other targets are unique by construction, so the result
does not depend on the order of the writes, and no boolean mask makes the
host wait for the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import resolve_device
from ..core.coalesced import coalesced_gather
from ..core.rgbd import CameraIntrinsics, _zbuffer_winner
from ..core.transforms import Transform, compose, inverse
from ..registration.icp import ICPResult, icp_projective_packed

# Packed pool rows:
#   width 16 (colors):  [pts 0:3 | nrm 3:6 | col 6:9 | conf 9 | valid 10]
#   width  8 (none):    [pts 0:3 | nrm 3:6 |           conf 6 | valid 7 ]
_MAP_WIDTH = 16
_MAP_WIDTH_NC = 8


def _conf_col(width: int) -> int:
    return 6 if width == _MAP_WIDTH_NC else 9


def _valid_col(width: int) -> int:
    return 7 if width == _MAP_WIDTH_NC else 10


@dataclasses.dataclass(frozen=True)
class FusionMap:
    """World-frame model: one packed ``(C, 16)`` (or ``(C, 8)``) pool with
    field views."""

    data: torch.Tensor

    @property
    def points(self) -> torch.Tensor:
        return self.data[:, 0:3]

    @property
    def normals(self) -> torch.Tensor:
        return self.data[:, 3:6]

    @property
    def colors(self) -> Optional[torch.Tensor]:
        if self.data.shape[1] == _MAP_WIDTH_NC:
            return None
        return self.data[:, 6:9]

    @property
    def confidence(self) -> torch.Tensor:
        return self.data[:, _conf_col(self.data.shape[1])]

    @property
    def valid(self) -> torch.Tensor:
        return self.data[:, _valid_col(self.data.shape[1])] > 0.5

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def num_points(self) -> torch.Tensor:
        return torch.sum(self.valid)

    @classmethod
    def from_fields(cls, points, normals, colors, confidence, valid) -> "FusionMap":
        c = points.shape[0]
        w = _MAP_WIDTH_NC if colors is None else _MAP_WIDTH
        data = torch.zeros((c, w), dtype=torch.float32, device=points.device)
        data[:, 0:3] = points
        data[:, 3:6] = normals
        if colors is not None:
            data[:, 6:9] = colors
        data[:, _conf_col(w)] = confidence
        data[:, _valid_col(w)] = valid.to(torch.float32)
        return cls(data=data)

    def replace_fields(self, **kw) -> "FusionMap":
        """A map with some of points / normals / colors / confidence / valid
        replaced."""
        return FusionMap.from_fields(
            points=kw.get("points", self.points),
            normals=kw.get("normals", self.normals),
            colors=kw.get("colors", self.colors),
            confidence=kw.get("confidence", self.confidence),
            valid=kw.get("valid", self.valid),
        )


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """The JAX package's knobs and defaults (the reference fusion example's
    thresholds: fuse within 0.01 m and 75°, augment past 105°, carve 0.025 m
    behind a point seen within 45°; ICP 6 iterations, tolerance 5e-4).

    ``update_mode`` picks how update rows reach the pool: ``row_scatter``
    writes them at their slots, ``inverse_gather`` inverts pixel → slot
    into slot → pixel and gathers each touched slot's row, ``auto`` takes
    ``inverse_gather`` when capacity ≤ 3 × pixels. All give the same pool.
    The JAX package's ``coalesced_gathers`` has no counterpart: the port's
    wide-row gathers always go through the gather kernel on the card."""

    fuse_depth: float = 0.01
    occlusion_depth: float = 0.025
    fuse_normal_cos: float = 0.25881904  # cos 75°
    augment_normal_cos: float = -0.25881904  # cos 105°
    carve_view_cos: float = 0.70710678  # cos 45°
    radial_sigma_px: float = 120.0
    confidence_thresh: float = 3.0  # cleanup_map
    icp_iterations: int = 6
    icp_convergence_tol: float = 5e-4
    icp_max_corr_dist_sq: float = 0.01
    icp_point_weight: float = 0.0
    icp_plane_weight: float = 1.0
    icp_gn_iterations: int = 1
    # Localize on every k-th pixel row and column; integrate uses all.
    localize_stride: int = 1
    # False: augments append past the highest valid slot (carved holes are
    # reclaimed by compact_map). True: they reuse free slots anywhere.
    reuse_carved_slots: bool = False
    update_mode: str = "auto"


def radial_weights(
    height: int,
    width: int,
    intrinsics: CameraIntrinsics,
    sigma_px: float = 120.0,
    dtype=torch.float32,
    device="cuda",
) -> torch.Tensor:
    """Per-pixel radial confidence ``exp(-0.5 r² / σ²)``, ``r`` the pixel
    distance from the principal point, flattened row-major, in ``dtype``."""
    device = resolve_device(device)
    u = (torch.arange(width, dtype=dtype, device=device) - intrinsics.cx)[None, :]
    v = (torch.arange(height, dtype=dtype, device=device) - intrinsics.cy)[:, None]
    r2 = u * u + v * v
    sigma2 = torch.full((), sigma_px * sigma_px, dtype=dtype, device=device)
    return torch.exp(-0.5 * r2 / sigma2).reshape(-1)


def compact_map(fmap: FusionMap) -> FusionMap:
    """Valid rows moved to the leading slots in their order, freeing the
    tail for the tail-append allocator."""
    order = torch.argsort((~fmap.valid).to(torch.uint8), stable=True)
    return FusionMap(data=fmap.data[order])


def cleanup_map(fmap: FusionMap, confidence_thresh: float = 3.0) -> FusionMap:
    """Drop points below ``confidence_thresh`` (the reference's cleanup)."""
    valid = fmap.valid & (fmap.confidence >= confidence_thresh)
    return fmap.replace_fields(
        points=torch.where(valid[:, None], fmap.points, 1e30), valid=valid
    )


def empty_map(capacity: int, with_colors: bool = True, device="cuda") -> FusionMap:
    w = _MAP_WIDTH if with_colors else _MAP_WIDTH_NC
    data = torch.zeros((capacity, w), dtype=torch.float32, device=resolve_device(device))
    data[:, 0:3] = 1e30
    return FusionMap(data=data)


def init_map_from_frame(
    capacity: int,
    frame_points: torch.Tensor,
    frame_normals: torch.Tensor,
    frame_colors: Optional[torch.Tensor],
    frame_valid: torch.Tensor,
    pose: Optional[Transform] = None,
    confidence: Optional[torch.Tensor] = None,
    with_color_slots: Optional[bool] = None,
) -> FusionMap:
    """Seed the model with the first frame (world frame = first camera),
    confidence 1 unless ``confidence`` is given. ``with_color_slots``
    picks the pool width (default 16, even without colors)."""
    if with_color_slots is None:
        with_color_slots = True
    if frame_colors is not None and not with_color_slots:
        raise ValueError("with_color_slots=False but frame_colors given")
    m = empty_map(capacity, with_colors=with_color_slots, device=frame_points.device)
    w = m.data.shape[1]
    n = frame_points.shape[0]
    if n > capacity:
        raise ValueError(f"frame of {n} points exceeds the capacity {capacity}")
    pts = frame_points if pose is None else pose.apply(frame_points)
    nrm = frame_normals if pose is None else pose.apply_normals(frame_normals)
    conf = frame_valid.to(torch.float32)
    if confidence is not None:
        conf = conf * confidence
    data = m.data
    data[:n, 0:3] = torch.where(frame_valid[:, None], pts, 1e30)
    data[:n, 3:6] = nrm
    if frame_colors is not None:
        data[:n, 6:9] = frame_colors
    data[:n, _conf_col(w)] = conf
    data[:n, _valid_col(w)] = frame_valid.to(torch.float32)
    return FusionMap(data=data)


def localize(
    fmap: FusionMap,
    frame_points: torch.Tensor,
    frame_normals: torch.Tensor,
    frame_valid: torch.Tensor,
    pose_guess: Transform,
    intrinsics: CameraIntrinsics,
    *,
    height: int,
    width: int,
    cfg: FusionConfig = FusionConfig(),
    index_map: Optional[torch.Tensor] = None,
    packed_target: Optional[torch.Tensor] = None,
    loop: str = "host",
) -> Tuple[Transform, ICPResult]:
    """Frame-to-model projective ICP: the refined world pose of the frame
    camera. ``packed_target`` (the previous integrate's, keyed to
    ``pose_guess``) skips the render and the pool gather; ``index_map`` (a
    render at ``pose_guess``) skips the render only. ``loop`` is
    :func:`..registration.icp.icp_projective_packed`'s loop form."""
    if packed_target is not None:
        packed = packed_target
    else:
        cam_from_world = inverse(pose_guess)
        if index_map is None:
            index_map, _ = _zbuffer_winner(
                cam_from_world.apply(fmap.points), fmap.valid, intrinsics, height, width
            )
        hit = index_map.reshape(-1)
        ok = hit >= 0
        rows = fmap.data[torch.where(ok, hit, 0).long()]
        ok = ok & (rows[:, _valid_col(rows.shape[1])] > 0.5)
        packed = pack_camera_target(rows, ok, cam_from_world)
    res = icp_projective_packed(
        frame_points, packed, intrinsics, height=height, width=width,
        src_normals=frame_normals, src_valid=frame_valid, metric="combined",
        point_weight=cfg.icp_point_weight, plane_weight=cfg.icp_plane_weight,
        max_iterations=cfg.icp_iterations, convergence_tol=cfg.icp_convergence_tol,
        max_gn_iterations=cfg.icp_gn_iterations, max_corr_dist_sq=cfg.icp_max_corr_dist_sq,
        loop=loop,
    )
    # res.transform maps frame points onto the model in the predicted camera
    # frame: the world pose is pose_guess ∘ delta.
    return compose(pose_guess, res.transform), res


def free_slot_table(valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(slot_of_rank, num_free)``: rank ``r`` → index of the ``r``-th free
    slot (0 past the last free slot)."""
    free = ~valid
    c = valid.shape[0]
    rank_of_slot = torch.cumsum(free.to(torch.int32), 0).to(torch.int32) - 1
    cap_ids = torch.arange(c, dtype=torch.int32, device=valid.device)
    # Valid slots write into the extra slot c, which is cut off.
    slot_of_rank = torch.zeros((c + 1,), dtype=torch.int32, device=valid.device)
    slot_of_rank[torch.where(free, rank_of_slot, c).long()] = cap_ids
    return slot_of_rank[:c], torch.sum(free)


def apply_pool_update(
    data: torch.Tensor, tgt: torch.Tensor, rows_out: torch.Tensor, cfg: FusionConfig
) -> torch.Tensor:
    """The pool with ``rows_out[i]`` written to slot ``tgt[i]`` wherever
    ``tgt[i] < C`` (targets are unique). ``cfg.update_mode`` picks the
    route; all routes give the same pool."""
    c = data.shape[0]
    n_upd = tgt.shape[0]
    mode = cfg.update_mode
    if mode == "auto":
        mode = "inverse_gather" if c <= 3 * n_upd else "row_scatter"
    # Dropped targets write into the extra slot c, which is cut off.
    dst = torch.where(tgt < c, tgt, c).long()
    if mode == "inverse_gather":
        pix_of_slot = torch.full((c + 1,), -1, dtype=torch.int32, device=data.device)
        pix_of_slot[dst] = torch.arange(n_upd, dtype=torch.int32, device=data.device)
        pix_of_slot = pix_of_slot[:c]
        touched = pix_of_slot >= 0
        rows = coalesced_gather(rows_out, pix_of_slot)
        return torch.where(touched[:, None], rows, data)
    if mode == "row_scatter":
        out = torch.cat([data, data[:1]])
        out[dst] = rows_out
        return out[:c]
    raise ValueError(f"unknown update_mode {cfg.update_mode!r}")


def pack_camera_target(rows: torch.Tensor, ok: torch.Tensor, cam: Transform) -> torch.Tensor:
    """The ``(H·W, 8)`` camera-frame localize target ``[pts_cam | nrm_cam |
    flag | 0]`` from world-frame pool rows, zero where ``~ok``. Leading
    dimensions are a batch of streams (``cam`` then applies to each
    stream's rows, see :func:`..core.transforms.per_stream`)."""
    rows = torch.where(ok[..., None], rows, 0.0)
    flag = ok.to(torch.float32)[..., None]
    packed = torch.cat(
        [cam.apply(rows[..., 0:3]), cam.apply_normals(rows[..., 3:6]), flag, torch.zeros_like(flag)],
        dim=-1,
    )
    return torch.where(ok[..., None], packed, 0.0)


def _classify_and_build_rows(
    mrows: torch.Tensor,  # (H·W, w) model row per pixel (0 where no hit)
    m_ok: torch.Tensor,  # (H·W,) model hit
    mdepth_flat: torch.Tensor,  # (H·W,) model depth per pixel
    frame_points: torch.Tensor,
    frame_normals: torch.Tensor,
    frame_valid: torch.Tensor,
    frame_colors: Optional[torch.Tensor],
    pose: Transform,
    cam_from_world: Transform,
    intrinsics: CameraIntrinsics,
    height: int,
    width: int,
    cfg: FusionConfig,
):
    """Per-pixel fuse / augment / carve classification and update rows.
    Returns ``(do_fuse, do_augment, do_carve, fuse_rows, aug_rows,
    carve_row)``. Leading dimensions of the per-pixel arrays are a batch of
    streams (``pose`` and ``cam_from_world`` then apply to each stream's
    pixels, see :func:`..core.transforms.per_stream`)."""
    dev = mrows.device
    fd = frame_points[..., 2]
    f_ok = frame_valid & (fd > 0)
    # Interior pixels only (the reference loops over 1..h-2 × 1..w-2).
    pix = torch.arange(height * width, dtype=torch.int32, device=dev)
    pix_u, pix_v = pix % width, pix // width
    f_ok = f_ok & (pix_u >= 1) & (pix_u <= width - 2) & (pix_v >= 1) & (pix_v <= height - 2)

    radial = radial_weights(height, width, intrinsics, cfg.radial_sigma_px, device=dev)

    w = mrows.shape[-1]
    m_pts_w = mrows[..., 0:3]
    m_nrm_w = mrows[..., 3:6]
    c_old = mrows[..., _conf_col(w)]
    m_pts_cam = cam_from_world.apply(m_pts_w)
    m_nrm_cam = cam_from_world.apply_normals(m_nrm_w)

    ncos = torch.sum(frame_normals * m_nrm_cam, dim=-1)
    depth_diff = fd - mdepth_flat

    # fuse: model hit, depth agrees, normals within 75°.
    do_fuse = (
        f_ok & m_ok & (torch.abs(depth_diff) < cfg.fuse_depth) & (ncos > cfg.fuse_normal_cos)
    )
    # augment: the pixel and its 4 neighbours model-empty, or normals apart
    # by more than 105°.
    m_img = m_ok.reshape(m_ok.shape[:-1] + (height, width))
    nb_occ = (
        torch.roll(m_img, 1, -2) | torch.roll(m_img, -1, -2)
        | torch.roll(m_img, 1, -1) | torch.roll(m_img, -1, -1)
    ).reshape(m_ok.shape)
    do_augment = (
        ~do_fuse & f_ok & ((~m_ok & ~nb_occ) | (m_ok & (ncos < cfg.augment_normal_cos)))
    )
    # carve: the frame surface well behind a model point seen head-on.
    m_dir = m_pts_cam / torch.clamp(
        torch.linalg.vector_norm(m_pts_cam, dim=-1, keepdim=True), min=1e-30
    )
    view_cos = -torch.sum(m_dir * m_nrm_cam, dim=-1)
    do_carve = (
        ~do_fuse & ~do_augment & f_ok & m_ok
        & (depth_diff > cfg.occlusion_depth) & (view_cos > cfg.carve_view_cos)
    )

    # fuse: radial-confidence blend w = radial / (radial + conf); augment: a
    # fresh row with confidence = radial; carve: a dead row (points at 1e30).
    pts_w = pose.apply(frame_points)
    nrm_w = pose.apply_normals(frame_normals)
    pix_shape = mrows.shape[:-1]
    w_f = (radial / torch.clamp(radial + c_old, min=1e-30))[..., None]
    fused_nrm = m_nrm_w * (1.0 - w_f) + nrm_w * w_f
    fused_nrm = fused_nrm / torch.clamp(
        torch.linalg.vector_norm(fused_nrm, dim=-1, keepdim=True), min=1e-30
    )
    one = torch.ones(pix_shape + (1,), dtype=torch.float32, device=dev)
    zeros_tail = torch.zeros(pix_shape + (w - _conf_col(w) - 2,), dtype=torch.float32, device=dev)
    fuse_parts = [m_pts_w * (1.0 - w_f) + pts_w * w_f, fused_nrm]
    aug_parts = [pts_w, nrm_w]
    if w == _MAP_WIDTH:
        cols = frame_colors if frame_colors is not None else torch.zeros_like(frame_points)
        fuse_parts.append(mrows[..., 6:9] * (1.0 - w_f) + cols * w_f)
        aug_parts.append(cols)
    fuse_rows = torch.cat(fuse_parts + [c_old[..., None] + w_f, one, zeros_tail], dim=-1)
    radial_col = radial[:, None].expand(pix_shape + (1,))
    aug_rows = torch.cat(aug_parts + [radial_col, one, zeros_tail], dim=-1)
    carve_row = torch.zeros((w,), dtype=torch.float32, device=dev)
    carve_row[0:3] = 1e30
    return do_fuse, do_augment, do_carve, fuse_rows, aug_rows, carve_row


def integrate_frame_with_imap(
    fmap: FusionMap,
    frame_points: torch.Tensor,  # (H·W, 3) organized, camera frame
    frame_normals: torch.Tensor,
    frame_colors: Optional[torch.Tensor],
    frame_valid: torch.Tensor,
    pose: Transform,  # camera-to-world
    intrinsics: CameraIntrinsics,
    *,
    height: int,
    width: int,
    cfg: FusionConfig = FusionConfig(),
) -> Tuple[FusionMap, torch.Tensor, torch.Tensor]:
    """Fuse / augment / carve one organized frame into the model. Returns
    ``(map, index_map, packed_next)``: the render at ``pose`` and the next
    frame's localize target, packed in this camera's frame."""
    if frame_colors is not None and fmap.data.shape[1] == _MAP_WIDTH_NC:
        raise ValueError(
            "map was initialized without colors (width-8 pool); "
            "re-init with frame_colors to fuse colors"
        )
    dev = fmap.data.device
    cam_from_world = inverse(pose)
    imap, mdepth = _zbuffer_winner(
        cam_from_world.apply(fmap.points), fmap.valid, intrinsics, height, width
    )
    imap_flat = imap.reshape(-1)  # (H·W,) model index or -1
    # The frame is organized: pixel p ↔ frame point p.
    m_ok = imap_flat >= 0
    m_idx = torch.where(m_ok, imap_flat, 0)
    # One pool gather serves every per-pixel model read below.
    mrows = torch.where(m_ok[:, None], coalesced_gather(fmap.data, imap_flat), 0.0)

    do_fuse, do_augment, do_carve, fuse_rows, aug_rows, carve_row = _classify_and_build_rows(
        mrows, m_ok, mdepth.reshape(-1), frame_points, frame_normals, frame_valid,
        frame_colors, pose, cam_from_world, intrinsics, height, width, cfg,
    )
    npix = m_idx.shape[0]
    cap = fmap.capacity

    # Free slots for augments.
    aug_rank = torch.cumsum(do_augment.to(torch.int32), 0).to(torch.int32) - 1
    if cfg.reuse_carved_slots:
        # Carved slots become reusable from the next frame on.
        slot_of_rank, num_free = free_slot_table(fmap.valid)
        aug_slot = slot_of_rank[aug_rank.clamp(0, cap - 1).long()]
        aug_ok = do_augment & (aug_rank < num_free)
    else:
        # Tail append: every slot past the highest valid one is free.
        cap_ids = torch.arange(cap, dtype=torch.int32, device=dev)
        tail_start = torch.max(torch.where(fmap.valid, cap_ids, -1)) + 1
        aug_slot = tail_start + aug_rank
        aug_ok = do_augment & (aug_slot < cap)
        aug_slot = aug_slot.clamp(0, cap - 1)

    # One combined update. Fuse and carve hit distinct valid slots (each
    # model point wins at most one pixel), augments hit free slots, and
    # the other pixels get distinct targets past the pool, which drop.
    oob = cap + torch.arange(npix, dtype=torch.int32, device=dev)
    tgt = torch.where(do_fuse | do_carve, m_idx, torch.where(aug_ok, aug_slot, oob))
    rows_out = torch.where(
        do_fuse[:, None], fuse_rows, torch.where(do_carve[:, None], carve_row[None, :], aug_rows)
    )
    data = apply_pool_update(fmap.data, tgt, rows_out, cfg)

    # The next localize starts at this pose against this render: fused
    # pixels take their new rows, carved pixels drop out, augments appear
    # one frame later.
    post_rows = torch.where(do_fuse[:, None], fuse_rows, mrows)
    alive = m_ok & ~do_carve & (post_rows[:, _valid_col(post_rows.shape[1])] > 0.5)
    packed_next = pack_camera_target(post_rows, alive, cam_from_world)
    return FusionMap(data=data), imap, packed_next


def integrate_frame(*args, **kwargs) -> FusionMap:
    """:func:`integrate_frame_with_imap` without the render and target."""
    return integrate_frame_with_imap(*args, **kwargs)[0]


def seed_localize_target(
    fmap: FusionMap,
    pose: Transform,
    intrinsics: CameraIntrinsics,
    height: int,
    width: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(index map, packed localize target)`` from a fresh render of the
    map at ``pose``: what :func:`fusion_step` otherwise gets from the
    previous integrate."""
    cam = inverse(pose)
    imap, _ = _zbuffer_winner(cam.apply(fmap.points), fmap.valid, intrinsics, height, width)
    hit = imap.reshape(-1)
    ok = hit >= 0
    rows = fmap.data[torch.where(ok, hit, 0).long()]
    ok = ok & (rows[:, _valid_col(rows.shape[1])] > 0.5)
    return imap, pack_camera_target(rows, ok, cam)


def fusion_step(
    fmap: FusionMap,
    frame_points: torch.Tensor,
    frame_normals: torch.Tensor,
    frame_colors: Optional[torch.Tensor],
    frame_valid: torch.Tensor,
    pose_guess: Transform,
    intrinsics: CameraIntrinsics,
    *,
    cached_index_map: Optional[torch.Tensor] = None,
    cached_packed_target: Optional[torch.Tensor] = None,
    height: int,
    width: int,
    cfg: FusionConfig = FusionConfig(),
    do_integrate: bool = True,
    loop: str = "host",
) -> Tuple[FusionMap, Transform, ICPResult, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One fusion frame: localize (on every ``cfg.localize_stride``-th
    pixel row and column; ``loop`` is the ICP loop form, see
    :func:`localize`), then integrate. Returns ``(map, pose, icp result,
    index map, packed target)``; the last two feed the next frame's
    ``cached_index_map`` / ``cached_packed_target``. A skipped integrate
    returns no packed target: the old one is keyed to an older pose.
    Nothing in it waits on the host but the host loop form of ICP."""
    s = cfg.localize_stride
    if s > 1:
        dev = frame_points.device
        rows = torch.arange(0, height, s, device=dev)
        cols = torch.arange(0, width, s, device=dev)
        sub = (rows[:, None] * width + cols[None, :]).reshape(-1)
        loc = frame_points[sub], frame_normals[sub], frame_valid[sub]
    else:
        loc = frame_points, frame_normals, frame_valid
    pose, res = localize(
        fmap, *loc, pose_guess, intrinsics, height=height, width=width, cfg=cfg,
        index_map=cached_index_map, packed_target=cached_packed_target, loop=loop,
    )
    new_imap, new_packed = cached_index_map, None
    if do_integrate:
        fmap, new_imap, new_packed = integrate_frame_with_imap(
            fmap, frame_points, frame_normals, frame_colors, frame_valid, pose,
            intrinsics, height=height, width=width, cfg=cfg,
        )
    return fmap, pose, res, new_imap, new_packed
