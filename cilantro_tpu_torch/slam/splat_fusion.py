"""Splat fusion — frame-to-model RGBD fusion over an image-organized model
(port of ``cilantro_tpu/slam/splat_fusion.py``).

The model is a two-layer surfel image homed to the current camera, padded
by ``cfg.margin``. Every frame:

* **localize** — model→frame projective point-to-plane Gauss-Newton (GN):
  each iteration projects the surfels through the current estimate and
  window-reads the frame at the projected pixel
  (:func:`.splat.window_read_codes` on the bit-cast float32 frame);
* **re-associate** — project under the refined pose, elect winner and
  runner-up per target pixel (:func:`.splat.splat_argmin2`) and rebuild
  both row images (:func:`.splat.flow_select_rows`, one launch for both);
* **integrate** — fuse / augment / carve as elementwise selects.

The arithmetic follows the JAX module expression for expression. The JAX
``lax.while_loop`` of localize has two forms here (:func:`splat_localize`):
a Python loop that reads the step norm back once an iteration and stops
early, used by :func:`run_splat_sequence`, and a fixed count with a device
flag, which a CUDA graph can hold, used by
:func:`run_splat_sequence_scanned`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import native, resolve_device
from ..core.rgbd import CameraIntrinsics, depth_to_points_normals, scalar_like
from ..core.transforms import (
    Transform,
    compose,
    gn_update_3d,
    identity,
    inverse,
    reproject_rigid,
)
from ..utils.profiling import annotate_function, count, span
from .scan import scan
from .splat import (
    KERNELS,
    flow_select_rows,
    offset_code,
    pad_hw,
    splat_argmin2,
    window_read_codes,
)

# Channel layout of the surfel image (colors appended when enabled).
_CH_PT = slice(0, 3)  # world-frame position
_CH_NRM = slice(3, 6)  # world-frame normal
_CH_CONF = 6  # accumulated confidence weight
_CH_VALID = 7  # 1.0 = live surfel
_C_BASE = 8
_CH_COL = slice(8, 11)


@dataclasses.dataclass(frozen=True)
class SplatConfig:
    """Static knobs; the defaults are the JAX package's (thresholds follow
    the reference fusion example: fuse depth gate 0.01, occlusion gate
    0.025, fuse normal angle 75°; GN up to 6 iterations, tol 5e-4)."""

    radius: int = 4  # re-association window (±px per frame)
    margin: int = 16  # off-frustum survival band
    icp_iterations: int = 6
    icp_convergence_tol: float = 5e-4
    icp_max_corr_dist_sq: float = 0.01
    icp_normal_dot_min: float = 0.0  # correspondence gate (off by default)
    depth_fuse_thresh: float = 0.01
    occlusion_thresh: float = 0.025
    fuse_normal_dot_min: float = 0.2588  # cos 75°
    max_confidence: float = 100.0
    carve_penalty: float = 2.0
    with_colors: bool = False

    @property
    def channels(self) -> int:
        return _C_BASE + (3 if self.with_colors else 0)


@dataclasses.dataclass(frozen=True)
class SplatMap:
    """Two-layer surfel image homed to the camera at ``pose`` (layer 0 =
    front surface). ``rows``: ``(2, C, Hm, Wm)`` with ``Hm = H + 2·margin``,
    ``Wm = W + 2·margin``; model pixel ``(margin+i, margin+j)`` is frame
    pixel ``(i, j)``."""

    rows: torch.Tensor
    pose: Transform  # camera-to-world of the home frame

    @property
    def layers(self) -> int:
        return self.rows.shape[0]


def _img(flat: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H·W, C) → (C, H, W)."""
    return flat.reshape(h, w, -1).permute(2, 0, 1)


def _frame_images(depth, intrinsics, h, w):
    pts, nrm, valid = depth_to_points_normals(depth, intrinsics)
    return _img(pts, h, w), _img(nrm, h, w), valid.reshape(h, w)


def init_splat_map(
    frame_pts: torch.Tensor,  # (3, H, W) camera frame
    frame_nrm: torch.Tensor,  # (3, H, W)
    frame_valid: torch.Tensor,  # (H, W) bool
    cfg: SplatConfig,
    *,
    colors: Optional[torch.Tensor] = None,  # (3, H, W)
) -> SplatMap:
    """Seed the model from the first frame (world frame = first camera)."""
    h, w = frame_valid.shape
    m = cfg.margin
    dev = frame_pts.device
    rows = torch.zeros((2, cfg.channels, h + 2 * m, w + 2 * m), device=dev)
    v = frame_valid.to(torch.float32)
    chans = [frame_pts, frame_nrm, v[None], v[None]]
    if cfg.with_colors:
        chans.append(colors if colors is not None else torch.zeros((3, h, w), device=dev))
    rows[0, :, m : m + h, m : m + w] = torch.cat(chans, dim=0)
    return SplatMap(rows=rows, pose=identity(3, device=dev))


def _project_model(
    rows: torch.Tensor,  # (L, C, Hm, Wm)
    cam_from_world: Transform,
    intrinsics: CameraIntrinsics,
    margin: int,
    radius: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project every surfel through ``cam_from_world``. Returns ``(z
    (L,Hm,Wm) camera depth, off (L,Hm,Wm) window offset code from the
    surfel's home to its projected MODEL pixel, valid (L,Hm,Wm))``; ``off``
    is -1 where invalid, behind the camera, or out of window."""
    l, _, hm, wm = rows.shape
    x, y, z = rows[:, 0], rows[:, 1], rows[:, 2]
    rl, t = cam_from_world.linear, cam_from_world.translation
    xc = rl[0, 0] * x + rl[0, 1] * y + rl[0, 2] * z + t[0]
    yc = rl[1, 0] * x + rl[1, 1] * y + rl[1, 2] * z + t[1]
    zc = rl[2, 0] * x + rl[2, 1] * y + rl[2, 2] * z + t[2]
    valid = (rows[:, _CH_VALID] > 0.5) & (zc > 1e-6)
    zsafe = torch.where(valid, zc, 1.0)
    # Projected pixel in MODEL coords (frame pixel + margin); torch.round
    # rounds half to even, as jnp.round does. The clamp only keeps the
    # int32 cast defined: anything that far is out of window either way.
    u = torch.round(xc * intrinsics.fx / zsafe + intrinsics.cx) + margin
    v = torch.round(yc * intrinsics.fy / zsafe + intrinsics.cy) + margin
    u = u.clamp(-(2.0**30), 2.0**30).to(torch.int32)
    v = v.clamp(-(2.0**30), 2.0**30).to(torch.int32)
    cols = torch.arange(wm, dtype=torch.int32, device=rows.device)
    rows_i = torch.arange(hm, dtype=torch.int32, device=rows.device)[:, None]
    off = torch.where(valid, offset_code(u - cols, v - rows_i, radius), -1)
    return zc, off, valid


def splat_localize(
    smap: SplatMap,
    frame_pts: torch.Tensor,  # (3, H, W) camera frame
    frame_nrm: torch.Tensor,  # (3, H, W)
    frame_valid: torch.Tensor,  # (H, W) bool
    pose_guess: Transform,
    intrinsics: CameraIntrinsics,
    *,
    cfg: SplatConfig,
    loop: str = "host",
) -> Transform:
    """Model→frame projective point-to-plane ICP. Each iteration projects
    the model surfels through the current estimate, window-reads the
    frame's point/normal at the projected pixel and takes one GN step on the
    6-DoF pose; the loop stops after ``cfg.icp_iterations`` or once the step
    norm drops below ``cfg.icp_convergence_tol``. Returns the refined
    camera-to-world pose. ``loop`` picks the loop form (see
    :func:`splat_localize_counted`)."""
    return splat_localize_counted(
        smap, frame_pts, frame_nrm, frame_valid, pose_guess, intrinsics, cfg=cfg, loop=loop
    )[0]


def splat_localize_counted(
    smap: SplatMap,
    frame_pts: torch.Tensor,
    frame_nrm: torch.Tensor,
    frame_valid: torch.Tensor,
    pose_guess: Transform,
    intrinsics: CameraIntrinsics,
    *,
    cfg: SplatConfig,
    loop: str = "host",
) -> Tuple[Transform, torch.Tensor]:
    """:func:`splat_localize` and the GN iterations it kept (int32 on the
    pose's device). Two forms of one iteration body:

    * ``"host"`` reads the step norm back once an iteration and stops
      early;
    * ``"graph"`` runs all ``cfg.icp_iterations`` and never waits on the
      host (a CUDA graph can hold it). A device flag keeps an iteration's
      pose only while the JAX loop's ``gn_cond`` holds: fewer than
      ``cfg.icp_iterations`` iterations and the previous step norm at or
      above the tolerance (the step that drops below it is applied).

    With the same arithmetic the two give the same pose bit for bit."""
    if loop not in ("host", "graph"):
        raise ValueError(f"unknown loop form {loop!r}")
    m, r = cfg.margin, cfg.radius
    l = smap.rows.shape[0]
    dev = smap.rows.device
    # Frame channels [pt(3) | nrm(3) | valid] padded to the model grid and
    # bit-cast for the integer window-read kernel (pure selects: any bits).
    # One frame serves every layer: the batch dim is a stride-0 broadcast.
    fv = frame_valid.to(torch.float32)
    fimg = torch.cat([frame_pts, frame_nrm, fv[None]], dim=0)
    fimg = F.pad(fimg, (m + r,) * 4)
    fimg_i = fimg.view(torch.int32)[None].expand(l, -1, -1, -1)

    mdl_pts = smap.rows[:, _CH_PT]  # (L, 3, Hm, Wm) world
    mdl_nrm = smap.rows[:, _CH_NRM]
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def gn_iter(cw: Transform) -> Tuple[Transform, torch.Tensor]:
        _, off, mvalid = _project_model(smap.rows, cw, intrinsics, m, r)
        read = window_read_codes(fimg_i, off, radius=r).view(torch.float32)
        fok = read[:, 6] > 0.5  # NaN (unwritten -1 bits) compares False
        # Zero the unwritten lanes: their -1 bit pattern is NaN, and NaN·0
        # would poison the JᵀJ reduction.
        read = torch.where(fok[:, None], read, 0.0)
        fpt = read[:, 0:3]  # (L, 3, Hm, Wm) camera frame
        fnm = read[:, 3:6]
        # Model point/normal in the CURRENT camera frame.
        xc = torch.einsum("ij,ljyx->liyx", cw.linear, mdl_pts) + (
            cw.translation[None, :, None, None]
        )
        nc = torch.einsum("ij,ljyx->liyx", cw.linear, mdl_nrm)
        diff = fpt - xc
        dist2 = torch.sum(diff * diff, dim=1)
        ok = mvalid & fok & (off >= 0) & (dist2 <= cfg.icp_max_corr_dist_sq)
        if cfg.icp_normal_dot_min > 0.0:
            ok &= torch.sum(nc * fnm, dim=1) > cfg.icp_normal_dot_min
        wgt = ok.to(torch.float32)
        # Point-to-plane on the frame normal: r = n_f · (x_c − x_f);
        # d r = (x_c × n_f)·ω + n_f·dt for x_c ← x_c + ω×x_c + dt.
        res = torch.sum(fnm * (xc - fpt), dim=1)
        fnm_last = fnm.movedim(1, -1)
        cxn = torch.linalg.cross(xc.movedim(1, -1), fnm_last, dim=-1)
        jrow = torch.cat([cxn, fnm_last], dim=-1)  # (L, Hm, Wm, 6)
        jw = jrow * wgt[..., None]
        jtj = torch.einsum("lyxi,lyxj->ij", jw, jrow) + 1e-8 * eye6
        jtr = torch.einsum("lyxi,lyx->i", jw, res)
        # solve_ex: solve checks its info code on the host.
        step = -torch.linalg.solve_ex(jtj, jtr, check_errors=False)[0]
        return reproject_rigid(compose(gn_update_3d(step), cw)), torch.linalg.vector_norm(step)

    cw = inverse(pose_guess)
    if loop == "host":
        it = 0
        while it < cfg.icp_iterations:
            cw, step_norm = gn_iter(cw)
            it += 1
            if step_norm.item() < cfg.icp_convergence_tol:
                break
        iterations = torch.full((), it, dtype=torch.int32, device=dev)
    else:
        active = torch.ones((), dtype=torch.bool, device=dev)
        iterations = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(cfg.icp_iterations):
            new_cw, step_norm = gn_iter(cw)
            cw = Transform(
                torch.where(active, new_cw.linear, cw.linear),
                torch.where(active, new_cw.translation, cw.translation),
            )
            iterations = iterations + active.to(torch.int32)
            active = active & (step_norm >= cfg.icp_convergence_tol)
    return inverse(cw), iterations


def splat_integrate(
    smap: SplatMap,
    frame_pts: torch.Tensor,  # (3, H, W) camera frame
    frame_nrm: torch.Tensor,
    frame_valid: torch.Tensor,
    new_pose: Transform,
    intrinsics: CameraIntrinsics,
    *,
    cfg: SplatConfig,
    frame_colors: Optional[torch.Tensor] = None,
) -> SplatMap:
    """Re-home the model to ``new_pose`` (bounded-window argmin election +
    row rebuild) and run the fuse/augment/carve classify against the frame
    as dense selects."""
    m, r = cfg.margin, cfg.radius
    _, _, hm, wm = smap.rows.shape
    h, w = hm - 2 * m, wm - 2 * m
    dev = smap.rows.device
    cw = inverse(new_pose)

    # --- re-association: elect winner/runner-up per new home pixel ---
    zc, off, _ = _project_model(smap.rows, cw, intrinsics, m, r)
    key = torch.where(off >= 0, zc, float("inf"))
    bk, bc, sk, sc = splat_argmin2(
        pad_hw(key, r, float("inf"))[None], pad_hw(off, r, -1)[None], radius=r
    )
    rows_p = pad_hw(smap.rows, r, 0.0)[None]
    both = flow_select_rows(
        rows_p.expand(2, -1, -1, -1, -1), torch.cat([bc, sc]), radius=r
    )
    win, sec = both[0], both[1]  # (C, Hm, Wm) each
    bk, bc, sc = bk[0], bc[0], sc[0]
    w_ok = (bc >= 0) & (win[_CH_VALID] > 0.5)
    s_ok = (sc >= 0) & (sec[_CH_VALID] > 0.5)

    # --- frame data on the model grid ---
    pad_m = (m, m, m, m)
    fv = F.pad(frame_valid, pad_m)
    zf = F.pad(frame_pts[2], pad_m)
    fpt_w = torch.einsum(
        "ij,jyx->iyx", new_pose.linear, F.pad(frame_pts, pad_m)
    ) + new_pose.translation[:, None, None]
    fnm_w = torch.einsum("ij,jyx->iyx", new_pose.linear, F.pad(frame_nrm, pad_m))
    # Radial confidence weight (the reference's distance-from-center weight).
    ys = torch.arange(hm, dtype=torch.float32, device=dev)[:, None] - (intrinsics.cy + m)
    xs = torch.arange(wm, dtype=torch.float32, device=dev)[None, :] - (intrinsics.cx + m)
    rad2 = torch.square(ys / scalar_like(h, ys)) + torch.square(xs / scalar_like(w, xs))
    wf = torch.exp(-2.0 * rad2) * fv

    conf_w = win[_CH_CONF]
    zw = torch.where(w_ok, bk, float("inf"))
    ndot = torch.sum(win[_CH_NRM] * fnm_w, dim=0)

    fuse = (
        fv
        & w_ok
        & (torch.abs(zw - zf) <= cfg.depth_fuse_thresh)
        & (ndot > cfg.fuse_normal_dot_min)
    )
    carve = fv & w_ok & ~fuse & (zw < zf - cfg.occlusion_thresh)
    infront = fv & w_ok & ~fuse & (zf < zw - cfg.occlusion_thresh)
    augment = fv & (~w_ok | infront)

    # fused winner rows: confidence-weighted average of position/normal(s).
    tot = conf_w + wf
    tsafe = torch.clamp(tot, min=1e-12)

    def avg(a, b):
        return (a * conf_w[None] + b * wf[None]) / tsafe[None]

    fused = win.clone()
    fused[_CH_PT] = avg(win[_CH_PT], fpt_w)
    nrm_avg = avg(win[_CH_NRM], fnm_w)
    nn = torch.linalg.vector_norm(nrm_avg, dim=0, keepdim=True)
    fused[_CH_NRM] = nrm_avg / torch.clamp(nn, min=1e-12)
    if cfg.with_colors:
        fcol = (
            F.pad(frame_colors, pad_m)
            if frame_colors is not None
            else torch.zeros((3, hm, wm), device=dev)
        )
        fused[_CH_COL] = avg(win[_CH_COL], fcol)
    fused[_CH_CONF] = torch.clamp(tot, max=cfg.max_confidence)

    # carved winner: confidence decays; drops at ≤ 0.
    carved_conf = conf_w - cfg.carve_penalty
    carved = win.clone()
    carved[_CH_CONF] = carved_conf
    carved[_CH_VALID] = torch.where(carved_conf > 0.0, win[_CH_VALID], 0.0)

    # new surfel from the frame.
    newrow_chans = [fpt_w, fnm_w, wf[None], fv.to(torch.float32)[None]]
    if cfg.with_colors:
        newrow_chans.append(fcol)
    newrow = torch.cat(newrow_chans, dim=0)

    sec_live = torch.where(s_ok[None], sec, 0.0)
    win_live = torch.where(w_ok[None], win, 0.0)

    # Layer assembly (front-to-back):
    #   fuse    → [fused, second]
    #   carve   → [carved-or-dropped winner, second]  (frame saw through it)
    #   infront → [new, winner]                        (second dropped)
    #   augment w/o winner → [new, second]
    #   no frame data      → [winner, second]
    l0 = torch.where(fuse[None], fused, win_live)
    l0 = torch.where(carve[None], carved, l0)
    l0 = torch.where(augment[None], newrow, l0)
    l1 = torch.where(infront[None], win_live, sec_live)
    return SplatMap(rows=torch.stack([l0, l1], dim=0), pose=new_pose)


def splat_fusion_step(
    smap: SplatMap,
    depth: torch.Tensor,  # (H, W) metric depth
    pose_guess: Transform,
    intrinsics: CameraIntrinsics,
    *,
    cfg: SplatConfig,
    loop: str = "host",
) -> Tuple[SplatMap, Transform]:
    """One frame: localize (``loop``: :func:`splat_localize_counted`), then
    integrate."""
    smap, pose, _ = _fusion_step_counted(smap, depth, pose_guess, intrinsics, cfg=cfg, loop=loop)
    return smap, pose


def _fusion_step_counted(smap, depth, pose_guess, intrinsics, *, cfg, loop):
    h, w = depth.shape
    fpt, fnm, fval = _frame_images(depth, intrinsics, h, w)
    pose, iterations = splat_localize_counted(
        smap, fpt, fnm, fval, pose_guess, intrinsics, cfg=cfg, loop=loop
    )
    smap = splat_integrate(smap, fpt, fnm, fval, pose, intrinsics, cfg=cfg)
    return smap, pose, iterations


def extract_cloud(
    smap: SplatMap, min_confidence: float = 0.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Live surfels as host arrays ``(points, normals, confidence)``."""
    rows = smap.rows.cpu().numpy()
    live = (rows[:, _CH_VALID] > 0.5) & (rows[:, _CH_CONF] >= min_confidence)
    pts = np.moveaxis(rows[:, _CH_PT], 1, -1)[live]
    nrm = np.moveaxis(rows[:, _CH_NRM], 1, -1)[live]
    conf = rows[:, _CH_CONF][live]
    return pts, nrm, conf


def run_splat_sequence(
    depths: Sequence[np.ndarray],
    intrinsics: CameraIntrinsics,
    *,
    cfg: SplatConfig = SplatConfig(),
    device="cuda",
) -> Tuple[SplatMap, List[np.ndarray], float, List[Dict[str, int]]]:
    """Host-loop splat fusion over a depth sequence on ``device``. Returns
    the final map, the per-frame camera-to-world pose matrices, the
    steady-state seconds/frame (the first fused frame excluded, as in the
    JAX driver) and, for each fused frame, the kernel launches it made."""
    dev = resolve_device(device)
    h, w = depths[0].shape
    staged = [torch.as_tensor(np.asarray(d, np.float32), device=dev) for d in depths]
    fpt, fnm, fval = _frame_images(staged[0], intrinsics, h, w)
    smap = init_splat_map(fpt, fnm, fval, cfg)
    pose = identity(3, device=dev)
    poses_dev = [pose.matrix()]
    launches = []
    t0 = time.perf_counter()
    t_first = None
    for fi in range(1, len(depths)):
        before = {k: native.launch_counts[k] for k in KERNELS}
        smap, pose = splat_fusion_step(smap, staged[fi], pose, intrinsics, cfg=cfg)
        poses_dev.append(pose.matrix())
        launches.append({k: native.launch_counts[k] - before[k] for k in KERNELS})
        if fi == 1:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t_first = time.perf_counter()
    poses = [p.cpu().numpy() for p in poses_dev]
    t1 = time.perf_counter()
    n_steady = max(len(depths) - 2, 1)
    sec_per_frame = (t1 - (t_first or t0)) / n_steady
    return smap, poses, sec_per_frame, launches


@annotate_function("cilantro.entry.splat_scanned")
def run_splat_sequence_scanned(
    depths: Sequence[np.ndarray],
    intrinsics: CameraIntrinsics,
    *,
    cfg: SplatConfig = SplatConfig(),
    device="cuda",
    stats: Optional[dict] = None,
) -> Tuple[SplatMap, List[np.ndarray], float, List[Dict[str, int]]]:
    """Whole-sequence splat fusion, the counterpart of the JAX package's one
    jitted ``lax.scan``: one fusion step with the graph form of localize
    (all ``cfg.icp_iterations`` GN iterations, the early exit by a device
    flag) captured in a CUDA graph and replayed once a frame
    (:func:`.scan.scan`); eager steps on the CPU. Returns what
    :func:`run_splat_sequence` returns: the final map, the per-frame
    camera-to-world poses, the seconds a frame of the fastest of 3 runs of
    the sequence by the host clock (capture and a first run excluded, as
    the JAX driver excludes its compile; each run ended by the read-back of
    the poses) and, for each fused frame, the kernel launches it made.
    ``stats``, if given, receives ``device_seconds_per_frame`` (CUDA
    events, ``None`` on the CPU), ``iterations`` (GN iterations kept, a
    frame) and ``launches_per_frame`` (every kernel counter). The call is
    a ``cilantro.entry.splat_scanned`` span, with ``entry.prepare`` and
    ``entry.finish`` spans and the ``gn_iterations_kept`` /
    ``gn_iterations_run`` counters inside (:mod:`..utils.profiling`).

    On the card a later call with the same ``cfg``, ``intrinsics``, frame
    shape and device replays the step the first captured, with no warm-up
    and no capture (:func:`.scan.scan`'s ``key``); the returned seconds keep
    their meaning. Between calls the entry keeps that one graph, its pool
    and its static buffers (the map, a pose, a frame, a step's outputs);
    a call with another key replaces them, :func:`.scan.clear` frees
    them."""
    dev = resolve_device(device)
    h, w = depths[0].shape
    with span("cilantro.entry.prepare"):
        fpt, fnm, fval = _frame_images(
            torch.as_tensor(np.asarray(depths[0], np.float32), device=dev), intrinsics, h, w
        )
        smap0 = init_splat_map(fpt, fnm, fval, cfg)
        if len(depths) == 1:  # nothing to track: the seeded map is the result
            if stats is not None:
                stats.update(device_seconds_per_frame=None, iterations=[], launches_per_frame={})
            return smap0, [np.eye(4, dtype=np.float32)], 0.0, []
        depth_stack = torch.as_tensor(np.stack([np.asarray(d, np.float32) for d in depths[1:]]),
                                      device=dev)

    def step(carry, depth):
        rows, linear, translation = carry
        pose = Transform(linear, translation)
        smap, pose, iterations = _fusion_step_counted(
            SplatMap(rows=rows, pose=pose), depth, pose, intrinsics, cfg=cfg, loop="graph"
        )
        return (smap.rows, pose.linear, pose.translation), (pose.matrix(), iterations)

    pose0 = identity(3, device=dev)
    out = scan(
        step, (smap0.rows, pose0.linear, pose0.translation), depth_stack,
        key=("splat_scanned", cfg, intrinsics),
    )
    with span("cilantro.entry.finish"):
        rows, linear, translation = out.carry
        mats, iterations = out.ys
        count("gn_iterations_kept", iterations.sum())
        count("gn_iterations_run", cfg.icp_iterations * len(iterations))
        if stats is not None:
            stats.update(
                device_seconds_per_frame=out.device_seconds_per_step,
                iterations=[int(i) for i in iterations],
                launches_per_frame=dict(out.launches_per_step),
            )
        per_frame = {k: out.launches_per_step[k] for k in KERNELS}
        poses = [np.eye(4, dtype=np.float32)] + list(mats)
        smap = SplatMap(rows=rows, pose=Transform(linear, translation))
    return smap, poses, out.seconds_per_step, [dict(per_frame) for _ in mats]
